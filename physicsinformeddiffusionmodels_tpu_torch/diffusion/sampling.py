"""Ancestral (DDPM) sampling (port of ``diffusion/sampling.py``).

The sampler for a model that predicts x0, eps or the posterior mean mu
(``pred_mode``), by default with the noise suppressed at the last step
(``suppress_noise``), which is how the Darcy, mechanics and toy studies
sample, with the inference-time options of the JAX sampler: Imagen-style
dynamic thresholding, CoCoGen residual corrections
(arXiv 2312.10527) on the x0 prediction or on the sampled state in the last
``n_correction`` steps plus ``m_correction`` post-steps, and the per-step
history; and the short DDIM chain that estimates x0 inside the training
loss of ``x0_estimation='sample'`` (``ddim_sample_x0``).

JAX draws the noise from split keys inside a ``lax.scan``; here the loop is
a Python loop over the T model calls, and the noise comes either from a
``torch.Generator`` or from an explicit [T, B, ...] tensor (row i is used
at step i, i.e. at t = T-1-i), so that a test can replay JAX's draws, or,
for a batch split over data ranks, from ``RowNoise``: each step draws the
whole batch's noise and keeps the rank's rows, so that the rows equal the
one-rank run's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    extract,
    posterior_mean,
    predict_noise_from_mean,
    predict_start_from_noise,
)

class RowNoise(NamedTuple):
    """Per-step noise of rows ``rows`` of a batch of ``batch``: each step
    draws [batch, ...] from ``generator`` and keeps those rows."""

    generator: torch.Generator
    batch: int
    rows: slice


Noise = Union[torch.Generator, torch.Tensor, RowNoise]
DYNAMIC_THRESHOLD_PERCENTILE = 0.9


def dynamic_threshold(x: torch.Tensor,
                      percentile: float = DYNAMIC_THRESHOLD_PERCENTILE) -> torch.Tensor:
    """Imagen-style dynamic thresholding: per sample, s = max(1, the
    ``percentile`` quantile of |x|) (linear interpolation, as
    ``jnp.quantile``); x is clipped to [-s, s] and divided by s."""
    b = x.shape[0]
    s = torch.quantile(x.reshape(b, -1).abs(), percentile, dim=-1)
    s = s.clamp(min=1.0).reshape(b, *((1,) * (x.ndim - 1)))
    return torch.clamp(x, -s, s) / s


def _derive_x0_mean(sched: DiffusionSchedule, model_out: torch.Tensor, x: torch.Tensor,
                    t: int, pred_mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(x0 prediction, posterior mean) of one model output at timestep t,
    as JAX's ``_derive_x0_eps_mean``; the eps mode's factor (1 - alpha_t) /
    sqrt(1 - abar_t) in float32, as JAX computes it from its float32
    tables."""
    if pred_mode == "x0":
        return model_out, posterior_mean(sched, model_out, x, t)
    if pred_mode == "eps":
        eps_factor = float((np.float32(1.0) - sched.alphas[t]) / sched.one_minus_alphas_bar_sqrt[t])
        mean = extract(sched.sqrt_recip_alphas, t, x.ndim) * (x - eps_factor * model_out)
        return predict_start_from_noise(sched, x, t, model_out), mean
    if pred_mode == "mu":
        eps_theta = predict_noise_from_mean(sched, x, t, model_out)
        return predict_start_from_noise(sched, x, t, eps_theta), model_out
    raise ValueError(f"Unknown pred_mode: {pred_mode!r}")


def p_sample_step(sched: DiffusionSchedule, denoise_fn: Callable, x: torch.Tensor, t: int,
                  z: torch.Tensor | None, *, pred_mode: str = "x0", suppress_noise: bool = True,
                  use_dynamic_threshold: bool = False,
                  x0_correction_fn: Optional[Callable] = None,
                  xt_correction_fn: Optional[Callable] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step x_t -> x_{t-1} with ``denoise_fn(x, t_batch)`` predicting x0,
    eps or the posterior mean (``pred_mode``). ``z`` is the step's standard
    normal noise; at t = 0 it is not used when ``suppress_noise``. In JAX's
    order: correct the x0 prediction and recompute the mean from it, add
    the noise, correct the sample, then threshold it. Returns (x_{t-1},
    x0_pred)."""
    tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    x0_pred, mean = _derive_x0_mean(sched, denoise_fn(x, tb), x, t, pred_mode)
    if x0_correction_fn is not None:
        x0_pred = x0_correction_fn(x0_pred).to(x0_pred.dtype)
        mean = posterior_mean(sched, x0_pred, x, t)
    if t == 0 and suppress_noise:
        sample = mean
    else:
        sample = mean + float(np.sqrt(sched.betas[t])) * z  # float32 sqrt of the float32 beta
    if xt_correction_fn is not None:
        sample = xt_correction_fn(sample).to(sample.dtype)
    if use_dynamic_threshold:
        sample = dynamic_threshold(sample)
    return sample, x0_pred


class SampleResult(NamedTuple):
    """x: the final sample; x0_pred: the last step's x0 prediction (x itself
    without history, as in JAX); history and x0_history: [T, B, ...] per-step
    samples (x_{T-1} ... x_0) and x0 predictions, or None."""

    x: torch.Tensor
    x0_pred: torch.Tensor
    history: Optional[torch.Tensor] = None
    x0_history: Optional[torch.Tensor] = None


def p_sample_loop(sched: DiffusionSchedule, denoise_fn: Callable, x_init: torch.Tensor,
                  noise: Noise, *, pred_mode: str = "x0", suppress_noise: bool = True,
                  use_dynamic_threshold: bool = False,
                  save_history: bool = False, correction_fn: Optional[Callable] = None,
                  correction_mode: str = "none", n_correction: int = 0,
                  m_correction: int = 0) -> SampleResult:
    """T ancestral steps from ``x_init`` (cast to float32), ``pred_mode``
    and ``suppress_noise`` as in ``p_sample_step``.

    ``noise`` is a ``torch.Generator`` on x_init's device, a
    [T, *x_init.shape] tensor of per-step draws, or a ``RowNoise`` (a
    generator draws nothing for t = 0 while the noise is suppressed there). ``correction_fn`` (x ->
    corrected x) is applied while t < ``n_correction``, to the x0 prediction
    (``correction_mode`` 'x0') or to the sampled state ('xt'), and
    ``m_correction`` more times after the loop.
    """
    T = sched.n_steps
    if isinstance(noise, torch.Tensor) and tuple(noise.shape) != (T, *x_init.shape):
        raise ValueError(f"noise must be [{T}, {', '.join(map(str, x_init.shape))}], "
                         f"got {tuple(noise.shape)}")
    use_corr = correction_fn is not None and correction_mode in ("x0", "xt") and n_correction > 0
    x = x_init.float()
    history, x0_history = [], []
    for i, t in enumerate(range(T - 1, -1, -1)):
        if t == 0 and suppress_noise:
            z = None
        elif isinstance(noise, torch.Tensor):
            z = noise[i].to(device=x.device, dtype=x.dtype)
        elif isinstance(noise, RowNoise):
            z = torch.randn((noise.batch, *x.shape[1:]), generator=noise.generator,
                            device=x.device, dtype=x.dtype)[noise.rows]
        else:
            z = torch.randn(x.shape, generator=noise, device=x.device, dtype=x.dtype)
        corr = use_corr and t < n_correction
        x, x0_pred = p_sample_step(
            sched, denoise_fn, x, t, z, pred_mode=pred_mode, suppress_noise=suppress_noise,
            use_dynamic_threshold=use_dynamic_threshold,
            x0_correction_fn=correction_fn if corr and correction_mode == "x0" else None,
            xt_correction_fn=correction_fn if corr and correction_mode == "xt" else None)
        if save_history:
            history.append(x)
            x0_history.append(x0_pred)
    if m_correction > 0 and correction_fn is None:
        raise ValueError("m_correction > 0 requires a correction_fn")
    final = x
    for _ in range(m_correction):
        x = correction_fn(x)
    if not save_history:
        return SampleResult(x=x, x0_pred=final)
    return SampleResult(x=x, x0_pred=x0_history[-1], history=torch.stack(history),
                        x0_history=torch.stack(x0_history))


def ddim_time_ladders(t: torch.Tensor, ddim_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample descending DDIM time ladders: for a start time t_b, k =
    ddim_steps + 2 times spread evenly over [0, t_b] and truncated to
    integers, descending, each paired with the next (the last pair is (0,
    -1)). Returns (cur_times, next_times), each [k, B] int64 on t's device.

    The float32 arithmetic is ``jnp.linspace``'s: t * (i / (k - 1)) for i <
    k - 1, and t itself last, so the ladders equal JAX's exactly.
    """
    k = ddim_steps + 2
    t = torch.atleast_1d(t)
    tf = t.float()
    div = k - 1
    step = torch.arange(div, dtype=torch.float32, device=t.device) / float(div)
    asc = torch.cat([tf[None, :] * step[:, None], tf[None, :]], dim=0).floor().long()
    cur = asc.flip(0)
    nxt = torch.cat([cur[1:], torch.full_like(cur[:1], -1)], dim=0)
    return cur, nxt


def ddim_sample_x0(sched: DiffusionSchedule, denoise_fn: Callable, x_t: torch.Tensor,
                   t: torch.Tensor, *, ddim_steps: int = 0, eta: float = 0.0,
                   noise: Optional[torch.Tensor] = None,
                   pred_mode: str = "x0") -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate x0 from x_t with a short DDIM chain down to t = 0; autograd
    flows through it (the training loss of x0_estimation='sample').

    The per-sample ladders (``ddim_time_ladders``) have a fixed length of
    ddim_steps + 2 model calls, ``denoise_fn(x, t_batch)`` each. Where a
    ladder stalls (cur == next, as at small t) the state is kept bit for
    bit; the last entry (next = -1) returns the x0 prediction itself.
    ``noise`` is the [k, *x_t.shape] standard normal draw of each entry,
    needed only when ``eta > 0`` (every call site of the JAX package has eta
    = 0, where the noise term is exactly 0). Returns (x0_sample, the first
    call's model output), the latter the direct prediction at (x_t, t).
    """
    b = x_t.shape[0]
    t = torch.broadcast_to(torch.atleast_1d(t), (b,))
    cur_times, next_times = ddim_time_ladders(t, ddim_steps)
    k = cur_times.shape[0]
    if eta > 0 and (noise is None or tuple(noise.shape) != (k, *x_t.shape)):
        raise ValueError(f"eta > 0 needs a noise tensor of shape [{k}, "
                         f"{', '.join(map(str, x_t.shape))}]")
    bshape = (-1, *((1,) * (x_t.ndim - 1)))
    cur_x, first_out = x_t, None
    for i in range(k):
        tc, tn = cur_times[i], next_times[i]
        model_out = denoise_fn(cur_x, tc)
        if pred_mode == "x0":
            x0_pred = model_out
            mean = posterior_mean(sched, x0_pred, cur_x, tc)
            eps_theta = predict_noise_from_mean(sched, cur_x, tc, mean)
        elif pred_mode == "eps":
            eps_theta = model_out
            x0_pred = predict_start_from_noise(sched, cur_x, tc, eps_theta)
        elif pred_mode == "mu":
            eps_theta = predict_noise_from_mean(sched, cur_x, tc, model_out)
            x0_pred = predict_start_from_noise(sched, cur_x, tc, eps_theta)
        else:
            raise ValueError(f"Unknown pred_mode: {pred_mode!r}")
        if first_out is None:
            first_out = model_out

        alpha = extract(sched.alphas_prod, tc, cur_x.ndim)
        alpha_next = extract(sched.alphas_prod, tn.clamp(min=0), cur_x.ndim)
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = torch.sqrt(torch.clamp(1 - alpha_next - sigma**2, min=0.0))
        update = x0_pred * torch.sqrt(alpha_next) + c * eps_theta
        if eta > 0:
            update = update + sigma * noise[i].to(update.dtype)
        # the final entry (t_next < 0): the x0 prediction itself
        nxt = torch.where(tn.reshape(bshape) < 0, x0_pred, update)
        # no update where the ladder stalls (cur == next)
        stall = (tc == tn).to(cur_x.dtype).reshape(bshape)
        cur_x = stall * cur_x + (1.0 - stall) * nxt
    return cur_x, first_out
