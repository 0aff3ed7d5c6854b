"""Training step with global-norm clipping, Adam and EMA (port of
``training/trainer.py``).

One step is loss -> backward -> clip -> Adam -> EMA. ``train_step`` runs it
eagerly on the model's device. The JAX package fuses it into one jitted
program and scans ``chunk_steps`` steps per dispatch, bit-identical to
stepping one at a time; the port's counterpart on the card is
``GraphedTrainStep``, which captures one step in a ``torch.cuda.CUDAGraph``
(one graph each side of ``ema_start``) and replays it, bit-identical to the
eager card step. The ``train`` CLI replays it within chunks when
``chunk_steps > 1``; the CPU runs those chunks as a plain loop of eager
steps.

Randomness: a step of the device-resident trainer draws its batch indices,
timesteps, noise and, for guidance training, the null-conditioning mask
from one ``torch.Generator`` seeded with (seed, step), as the JAX trainer
folds the step into its key, so a resumed run repeats an uninterrupted one.
The draws stay out of the graph: they are made eagerly and copied into the
graph's input buffers before each replay.

On a mesh (``parallel.mesh``) every rank draws the global batch and keeps
its rows, so a step at any world size computes the one-rank step's
numbers up to the order of the gradient sum: after the backward the
gradients are summed over the data ranks in one flat all-reduce and
divided by their count, the clip takes the global norm of the tp shards,
Adam and the EMA keep each rank's shards, and the logged losses are the
means over the data ranks. There is no CUDA graph of a step on a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from physicsinformeddiffusionmodels_tpu_torch.diffusion.ema import ema_init, ema_update_after
from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
    Mesh,
    shard_batch,
    sharded_dims,
)


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
    schedule again.

    On the card Adam runs with ``capturable=True`` (its step count on the
    device) and reads its learning rate from a device tensor, ``lr``, that
    ``set_lr`` fills before each step, so that a CUDA graph of the step
    (``GraphedTrainStep``) and the eager step compute the same bits. On the
    CPU Adam takes the Python float, as before.

    On a ``mesh`` the gradients are first summed over its data ranks and
    divided by their count, and the global norm counts each tp shard
    (``sharded``: the parameters split over tp) and each replicated
    parameter once."""

    def __init__(self, params, learning_rate: float = 1e-4, grad_clip: float = 1.0,
                 schedule: str = "constant", total_steps: int = 0, final_frac: float = 0.1,
                 mesh: Optional[Mesh] = None, sharded=()):
        if schedule == "cosine" and total_steps <= 0:
            raise ValueError("cosine lr schedule needs total_steps > 0")
        if schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr schedule: {schedule!r}")
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate, self.grad_clip = learning_rate, grad_clip
        self.schedule, self.total_steps, self.final_frac = schedule, total_steps, final_frac
        cuda = bool(self.params) and self.params[0].is_cuda
        self.lr = (torch.tensor(float(learning_rate), device=self.params[0].device) if cuda
                   else learning_rate)
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                     capturable=cuda)
        self.count = 0
        self.mesh = mesh
        self.sharded = {id(p) for p in sharded}
        self.has_grad: Optional[list] = None  # on a mesh: which parameters get a gradient

    def lr_at(self, count: int) -> float:
        if self.schedule == "constant":
            return self.learning_rate
        frac = min(count, self.total_steps) / self.total_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.learning_rate * ((1.0 - self.final_frac) * cosine + self.final_frac)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def set_lr(self) -> None:
        """Give Adam the learning rate ``lr_at(count)``: fill the device
        tensor on the card, set the float on the CPU."""
        value = self.lr_at(self.count)
        if torch.is_tensor(self.lr):
            self.lr.fill_(value)
        else:
            for group in self.adam.param_groups:
                group["lr"] = value

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """The gradients summed over the mesh's data ranks and divided by
        their count, in one flat all-reduce. A parameter without a gradient
        adds zeros (every rank must reduce the same list); it gets one where
        any rank has one. Which parameters get one is fixed by the model and
        the loss: the ranks agree on it at the first step (one host-device
        sync) and keep it."""
        mesh = self.mesh
        if mesh is None or mesh.n_data == 1:
            return
        ref = self.params[0]
        if self.has_grad is None:
            flags = ref.new_tensor([float(p.grad is not None) for p in self.params])
            dist.all_reduce(flags, group=mesh.data_group)
            self.has_grad = (flags > 0).tolist()
        elif any(p.grad is not None and not h for p, h in zip(self.params, self.has_grad)):
            raise RuntimeError("a parameter got a gradient that no rank gave it at the first "
                               "step: the set of trained parameters changed")
        flat = torch.cat([p.grad.reshape(-1) if p.grad is not None
                          else ref.new_zeros(p.numel()) for p in self.params])
        dist.all_reduce(flat, group=mesh.data_group)
        flat /= mesh.n_data
        offset = 0
        for p, h in zip(self.params, self.has_grad):
            if h:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    def _global_norm(self, grads: list) -> torch.Tensor:
        """The L2 norm of every gradient; under tp, of the whole parameters'."""
        if self.mesh is None or self.mesh.tp == 1:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

        def sum_sq(gs):
            return (torch.stack(torch._foreach_norm(gs)).square().sum() if gs
                    else grads[0].new_zeros(()))

        split = [p.grad for p in self.params if p.grad is not None and id(p) in self.sharded]
        rest = [p.grad for p in self.params if p.grad is not None and id(p) not in self.sharded]
        split_sq = sum_sq(split)
        dist.all_reduce(split_sq, group=self.mesh.tp_group)
        return torch.sqrt(sum_sq(rest) + split_sq)

    @torch.no_grad()
    def clip_and_update(self) -> None:
        """Clip the gradients in place, then one Adam step at the learning
        rate ``set_lr`` gave: device work only, which a CUDA graph captures
        (on a mesh the gradients are reduced first, which none does)."""
        self.reduce_grads()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self._global_norm(grads)
        scale = torch.where(norm > self.grad_clip, self.grad_clip / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
        self.adam.step()

    def step(self) -> None:
        """Clip, then one Adam step at ``lr_at(count)``; the count goes up by
        one."""
        self.set_lr()
        self.clip_and_update()
        self.count += 1

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)
        if torch.is_tensor(self.lr):  # loading replaces the groups' lr by a copy
            for group in self.adam.param_groups:
                group["lr"] = self.lr


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4, grad_clip: float = 1.0,
                   schedule: str = "constant", total_steps: int = 0,
                   final_frac: float = 0.1, mesh: Optional[Mesh] = None) -> ClipAdam:
    """Global-norm clip then Adam over ``model``'s parameters (on a
    ``mesh``, after ``shard_params``: its shards)."""
    dims = sharded_dims(model)
    return ClipAdam(model.parameters(), learning_rate, grad_clip, schedule, total_steps,
                    final_frac, mesh, [p for k, p in model.named_parameters() if k in dims])


@dataclasses.dataclass
class TrainState:
    """The raw model, its EMA copy, the optimizer and the step count."""

    model: nn.Module
    ema: nn.Module
    optimizer: ClipAdam
    step: int = 0


def create_train_state(model: nn.Module, optimizer: ClipAdam) -> TrainState:
    return TrainState(model=model, ema=ema_init(model), optimizer=optimizer, step=0)


def _detached(aux):
    """A named tuple of tensors without their autograd graph: a step's graph
    (and the gradient accumulators it holds, bound to the step's stream)
    must not outlive the step, or the next step, on another stream, syncs
    with it."""
    if hasattr(aux, "_fields"):
        return type(aux)(*(a.detach() if torch.is_tensor(a) else a for a in aux))
    return aux


def _data_mean(aux, mesh: Optional[Mesh]):
    """A named tuple of scalars averaged over the mesh's data ranks."""
    if mesh is None or mesh.n_data == 1 or not hasattr(aux, "_fields"):
        return aux
    values = torch.stack([a.float().reshape(()) for a in aux])
    dist.all_reduce(values, group=mesh.data_group)
    return type(aux)(*(values / mesh.n_data).unbind())


def train_step(state: TrainState, loss_fn: Callable, *args, ema_mu: float = 0.99,
               ema_start: int = 1000):
    """One optimizer step: ``loss_fn(model, *args) -> (loss, aux)``, backward,
    clip, Adam, EMA (gated on the step before its increment). Returns aux,
    detached; on the optimizer's mesh, each scalar the data ranks' mean."""
    state.optimizer.zero_grad()
    loss, aux = loss_fn(state.model, *args)
    loss.backward()
    state.optimizer.step()
    ema_update_after(state.ema, state.model, state.step, mu=ema_mu, ema_start=ema_start)
    state.step += 1
    return _data_mean(_detached(aux), state.optimizer.mesh)


def _device_step(state: TrainState, loss_fn: Callable, args, ema_after: bool, ema_mu: float):
    """``train_step``'s device work, with the EMA branch fixed and no host
    counter touched: what ``GraphedTrainStep`` captures."""
    state.optimizer.zero_grad()
    loss, aux = loss_fn(state.model, *args)
    loss.backward()
    state.optimizer.clip_and_update()
    ema_update_after(state.ema, state.model, int(ema_after), mu=ema_mu, ema_start=0)
    return _detached(aux)


def _snapshot(state: TrainState) -> tuple:
    """Copies of the weights, the EMA and Adam's state."""
    return ([p.detach().clone() for p in state.model.parameters()],
            [p.detach().clone() for p in state.ema.parameters()],
            {p: {k: v.clone() for k, v in s.items()}
             for p, s in state.optimizer.adam.state.items()})


@torch.no_grad()
def _restore(state: TrainState, snapshot: tuple) -> None:
    """Put back a ``_snapshot`` in place (the same tensors, which a graph
    reads). Adam state that did not exist then is zeroed: the state Adam
    makes on a parameter's first step is zeros, step count included."""
    params, ema, adam = snapshot
    torch._foreach_copy_([p.detach() for p in state.model.parameters()], params)
    torch._foreach_copy_(list(state.ema.parameters()), ema)
    for p, s in state.optimizer.adam.state.items():
        saved = adam.get(p)
        for k, v in s.items():
            if saved is None:
                v.zero_()
            else:
                v.copy_(saved[k])


class GraphedTrainStep:
    """``train_step`` on the card, replayed from a ``torch.cuda.CUDAGraph``
    of one step: loss, backward, clip, Adam and EMA.

    ``step(*args)`` takes the step's inputs (batch, t, noise[, null mask]),
    copies them into the graph's input buffers, fills the learning rate
    (``ClipAdam.set_lr``), replays, and advances the host counters (the
    optimizer's count, ``state.step``), as ``train_step`` does; it returns
    the graph's aux, which the next replay overwrites. The EMA branch is
    fixed in a graph, so there is one on each side of ``ema_start``,
    captured when first needed (the one before it is dropped then). Before
    a capture, two eager steps on a side stream build the kernels and make
    cuDNN's choices, K2's launch plans and Adam's state; the weights, EMA
    and Adam state are then put back as they were, so capturing changes
    nothing. A capture or replay that fails raises; nothing falls back to
    eager stepping.
    """

    WARMUP = 2

    def __init__(self, state: TrainState, loss_fn: Callable, ema_mu: float = 0.99,
                 ema_start: int = 1000):
        if not next(state.model.parameters()).is_cuda:
            raise ValueError("GraphedTrainStep needs the model on a CUDA device")
        if state.optimizer.mesh is not None:
            raise ValueError("GraphedTrainStep captures no collective: step per dispatch "
                             "on a mesh")
        self.state, self.loss_fn = state, loss_fn
        self.ema_mu, self.ema_start = ema_mu, ema_start
        self.graphs: dict[bool, tuple] = {}
        self.captures = 0

    def _capture(self, ema_after: bool, args) -> tuple:
        self.graphs.clear()
        st = self.state
        static = tuple(a.clone() for a in args)
        snapshot = _snapshot(st)
        st.optimizer.set_lr()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                _device_step(st, self.loss_fn, static, ema_after, self.ema_mu)
        torch.cuda.current_stream().wait_stream(side)
        _restore(st, snapshot)
        st.optimizer.zero_grad()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            aux = _device_step(st, self.loss_fn, static, ema_after, self.ema_mu)
        self.captures += 1
        self.graphs[ema_after] = (graph, static, aux)
        return self.graphs[ema_after]

    def __call__(self, *args):
        st = self.state
        ema_after = st.step > self.ema_start
        graph, static, aux = self.graphs.get(ema_after) or self._capture(ema_after, args)
        for buf, a in zip(static, args):
            buf.copy_(a)
        st.optimizer.set_lr()
        graph.replay()
        st.optimizer.count += 1
        st.step += 1
        return aux


def step_generator(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    """Reseed ``generator`` for ``step`` of a run with ``seed``."""
    return generator.manual_seed((seed << 32) + step)


def resident_batch(data: torch.Tensor, batch_size: int, n_steps: int,
                   generator: torch.Generator, null_cond_prob: Optional[float] = None,
                   noise_channels: Optional[int] = None):
    """(batch, t, noise) drawn on ``data``'s device: batch indices uniform
    over the resident dataset, timesteps uniform on [0, n_steps), standard
    normal noise of the batch's shape (with ``noise_channels`` channels in
    place of the batch's: the diffusion target's, where the batch also holds
    conditioning); with ``null_cond_prob``, also the [B] null-conditioning
    mask of guidance training, uniform < p (all True at p >= 1)."""
    dev = data.device
    idx = torch.randint(0, data.shape[0], (batch_size,), generator=generator, device=dev)
    batch = data[idx]
    t = torch.randint(0, n_steps, (batch_size,), generator=generator, device=dev)
    shape = batch.shape if noise_channels is None else (*batch.shape[:-1], noise_channels)
    noise = torch.randn(shape, generator=generator, device=dev, dtype=batch.dtype)
    if null_cond_prob is None:
        return batch, t, noise
    mask = torch.rand((batch_size,), generator=generator, device=dev) < null_cond_prob
    return batch, t, noise, mask


def resident_train_step(state: TrainState, loss_fn: Callable, data: torch.Tensor,
                        batch_size: int, n_steps: int, seed: int, generator: torch.Generator,
                        ema_mu: float = 0.99, ema_start: int = 1000,
                        null_cond_prob: Optional[float] = None,
                        graphed: Optional[GraphedTrainStep] = None,
                        noise_channels: Optional[int] = None):
    """``train_step`` on a batch sampled from the device-resident ``data``
    with the randomness of (seed, state.step), drawn by ``generator`` (on
    data's device; reseeded here). ``loss_fn(model, batch, t, noise[,
    null_mask])``, the mask drawn when ``null_cond_prob`` is given, the noise
    with ``noise_channels`` channels when given. With ``graphed`` (over the
    same state and loss), the step is its replay. On the optimizer's mesh
    every rank draws the global batch and keeps its rows. Returns aux."""
    args = resident_batch(data, batch_size, n_steps,
                          step_generator(generator, seed, state.step), null_cond_prob,
                          noise_channels)
    args = tuple(shard_batch(a, state.optimizer.mesh) for a in args)
    if graphed is not None:
        return graphed(*args)
    return train_step(state, loss_fn, *args, ema_mu=ema_mu, ema_start=ema_start)
