"""Training step with global-norm clipping, Adam and EMA (port of
``training/trainer.py``).

One step is loss -> backward -> clip -> Adam -> EMA, run eagerly on the
model's device. The JAX package fuses it into one jitted program and can
scan ``chunk_steps`` steps per dispatch; that knob changes nothing in the
results there, so the port reads it from ``config.json`` and still runs
step by step (a CUDA graph over a step is later performance work).

Randomness: a step of the device-resident trainer draws its batch indices,
timesteps and noise from one ``torch.Generator`` seeded with (seed, step),
as the JAX trainer folds the step into its key, so a resumed run repeats an
uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from physicsinformeddiffusionmodels_tpu_torch.diffusion.ema import ema_init, ema_update_after


class ClipAdam:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))`` on a
    module's parameters: the gradients are scaled by grad_clip / ||g|| only
    when ||g|| > grad_clip (no epsilon added to the norm), then Adam
    (b1 0.9, b2 0.999, eps 1e-8) takes the step with the learning rate of
    the optimizer's own count: constant, or a cosine decay to ``final_frac``
    * lr over ``total_steps`` (``optax.cosine_decay_schedule``). Like optax's
    count, which lives in ``opt_state``, ``count`` starts at 0 with the
    optimizer, goes up by one a step, and is saved and restored with the
    Adam state, so a run resumed without optimizer state starts the
    schedule again."""

    def __init__(self, params, learning_rate: float = 1e-4, grad_clip: float = 1.0,
                 schedule: str = "constant", total_steps: int = 0, final_frac: float = 0.1):
        if schedule == "cosine" and total_steps <= 0:
            raise ValueError("cosine lr schedule needs total_steps > 0")
        if schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr schedule: {schedule!r}")
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate, self.grad_clip = learning_rate, grad_clip
        self.schedule, self.total_steps, self.final_frac = schedule, total_steps, final_frac
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def lr_at(self, count: int) -> float:
        if self.schedule == "constant":
            return self.learning_rate
        frac = min(count, self.total_steps) / self.total_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.learning_rate * ((1.0 - self.final_frac) * cosine + self.final_frac)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients in place, then one Adam step at ``lr_at(count)``;
        the count goes up by one."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm > self.grad_clip, self.grad_clip / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4, grad_clip: float = 1.0,
                   schedule: str = "constant", total_steps: int = 0,
                   final_frac: float = 0.1) -> ClipAdam:
    """Global-norm clip then Adam over ``model``'s parameters."""
    return ClipAdam(model.parameters(), learning_rate, grad_clip, schedule, total_steps,
                    final_frac)


@dataclasses.dataclass
class TrainState:
    """The raw model, its EMA copy, the optimizer and the step count."""

    model: nn.Module
    ema: nn.Module
    optimizer: ClipAdam
    step: int = 0


def create_train_state(model: nn.Module, optimizer: ClipAdam) -> TrainState:
    return TrainState(model=model, ema=ema_init(model), optimizer=optimizer, step=0)


def train_step(state: TrainState, loss_fn: Callable, *args, ema_mu: float = 0.99,
               ema_start: int = 1000):
    """One optimizer step: ``loss_fn(model, *args) -> (loss, aux)``, backward,
    clip, Adam, EMA (gated on the step before its increment). Returns aux."""
    state.optimizer.zero_grad()
    loss, aux = loss_fn(state.model, *args)
    loss.backward()
    state.optimizer.step()
    ema_update_after(state.ema, state.model, state.step, mu=ema_mu, ema_start=ema_start)
    state.step += 1
    return aux


def step_generator(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    """Reseed ``generator`` for ``step`` of a run with ``seed``."""
    return generator.manual_seed((seed << 32) + step)


def resident_batch(data: torch.Tensor, batch_size: int, n_steps: int,
                   generator: torch.Generator):
    """(batch, t, noise) drawn on ``data``'s device: batch indices uniform
    over the resident dataset, timesteps uniform on [0, n_steps), standard
    normal noise of the batch's shape."""
    dev = data.device
    idx = torch.randint(0, data.shape[0], (batch_size,), generator=generator, device=dev)
    batch = data[idx]
    t = torch.randint(0, n_steps, (batch_size,), generator=generator, device=dev)
    noise = torch.randn(batch.shape, generator=generator, device=dev, dtype=batch.dtype)
    return batch, t, noise


def resident_train_step(state: TrainState, loss_fn: Callable, data: torch.Tensor,
                        batch_size: int, n_steps: int, seed: int, generator: torch.Generator,
                        ema_mu: float = 0.99, ema_start: int = 1000):
    """``train_step`` on a batch sampled from the device-resident ``data``
    with the randomness of (seed, state.step), drawn by ``generator`` (on
    data's device; reseeded here). ``loss_fn(model, batch, t, noise)``.
    Returns aux."""
    batch, t, noise = resident_batch(data, batch_size, n_steps,
                                     step_generator(generator, seed, state.step))
    return train_step(state, loss_fn, batch, t, noise, ema_mu=ema_mu, ema_start=ema_start)
