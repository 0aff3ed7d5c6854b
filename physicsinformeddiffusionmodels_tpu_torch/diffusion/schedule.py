"""Diffusion schedule tables (port of ``diffusion/schedule.py``).

The tables are built in float64 with numpy and cast to float32, as the JAX
package builds them. They stay numpy arrays on the host: the sampling loop
reads one scalar per step, and a Python float multiplied into a float32
tensor is applied at float32, so the device sees exactly the JAX values
without a host-device copy per table. A per-sample gather (training, where
t is a [B] tensor) reads a copy of the table on t's device, made once per
table and device, so that a training step makes no host-device copy (a
CUDA graph of it could not).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str = "cosine", n_timesteps: int = 100,
                       start: float = 1e-5, end: float = 1e-2) -> np.ndarray:
    """Beta schedule in float64. The cosine schedule uses s=0.008 and clips
    the betas to [0, 0.999]; start/end only affect the other schedules."""
    if schedule == "linear":
        betas = np.linspace(start, end, n_timesteps)
    elif schedule == "quad":
        betas = np.linspace(start**0.5, end**0.5, n_timesteps) ** 2
    elif schedule == "sigmoid":
        x = np.linspace(-6, 6, n_timesteps)
        betas = 1.0 / (1.0 + np.exp(-x)) * (end - start) + start
    elif schedule == "cosine":
        s = 0.008
        x = np.linspace(0, n_timesteps, n_timesteps + 1)
        alphas_cumprod = np.cos(((x / n_timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = np.clip(1 - (alphas_cumprod[1:] / alphas_cumprod[:-1]), 0, 0.999)
    else:
        raise ValueError(f"Unknown beta schedule: {schedule!r}")
    return betas.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The per-timestep tables, each a float32 [T] array."""

    betas: np.ndarray
    alphas: np.ndarray
    sqrt_recip_alphas: np.ndarray
    alphas_prod: np.ndarray
    alphas_bar_sqrt: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    one_minus_alphas_bar_sqrt: np.ndarray
    alphas_prod_prev: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    noise_mean_coeff: np.ndarray
    posterior_variance: np.ndarray
    posterior_variance_clipped: np.ndarray
    p2_loss_weight: np.ndarray

    @property
    def n_steps(self) -> int:
        return self.betas.shape[0]


def create_schedule(n_steps: int, schedule: str = "cosine",
                    start: float = 1e-5, end: float = 1e-2, p2_mode: str = "min_snr",
                    min_snr_gamma: float = 5.0) -> DiffusionSchedule:
    """Tables from a beta schedule (same derivations as the JAX package).
    ``posterior_variance_clipped`` repeats entry 1 at t = 0; the p2 loss
    weight is min(SNR, gamma) (``min_snr``) or 1 / (1 + SNR)
    (``constant_p2``)."""
    betas = make_beta_schedule(schedule, n_steps, start, end)
    alphas = 1.0 - betas
    alphas_prod = np.cumprod(alphas)
    alphas_prod_prev = np.concatenate([[1.0], alphas_prod[:-1]])
    posterior_variance = betas * (1.0 - alphas_prod_prev) / (1.0 - alphas_prod)
    posterior_variance_clipped = posterior_variance.copy()
    posterior_variance_clipped[0] = posterior_variance[1]
    snr = alphas_prod / (1.0 - alphas_prod)
    if p2_mode == "min_snr":
        p2_loss_weight = np.minimum(snr, min_snr_gamma)
    elif p2_mode == "constant_p2":
        p2_loss_weight = (1.0 + snr) ** -1.0
    else:
        raise ValueError(f"Unknown p2 mode: {p2_mode!r}")
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        sqrt_recip_alphas=f32(np.sqrt(1.0 / alphas)),
        alphas_prod=f32(alphas_prod),
        alphas_bar_sqrt=f32(np.sqrt(alphas_prod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_prod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_prod - 1.0)),
        one_minus_alphas_bar_sqrt=f32(np.sqrt(1.0 - alphas_prod)),
        alphas_prod_prev=f32(alphas_prod_prev),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_prod_prev) / (1.0 - alphas_prod)),
        posterior_mean_coef2=f32((1.0 - alphas_prod_prev) * np.sqrt(alphas) / (1.0 - alphas_prod)),
        noise_mean_coeff=f32(np.sqrt(1.0 / alphas) * (1.0 - alphas) / np.sqrt(1.0 - alphas_prod)),
        posterior_variance=f32(posterior_variance),
        posterior_variance_clipped=f32(posterior_variance_clipped),
        p2_loss_weight=f32(p2_loss_weight),
    )


# (id of a table, device) -> (the table, kept alive so that its id stays
# unique, and its copy on the device)
_DEVICE_TABLES: dict = {}


def _on_device(table: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (id(table), str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = _DEVICE_TABLES[key] = (table, torch.as_tensor(table, device=device))
    return hit[1]


def extract(table: np.ndarray, t: int | torch.Tensor, ndim: int) -> float | torch.Tensor:
    """Coefficient ``table[t]``: a Python float for one timestep shared by
    the batch (no device copy), else per-sample values shaped [B, 1, ..., 1]
    on t's device."""
    if isinstance(t, int):
        return float(table[t])
    t = torch.atleast_1d(t)
    out = _on_device(table, t.device)[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(sched: DiffusionSchedule, x0: torch.Tensor, t: int | torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward noising x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    a = extract(sched.alphas_bar_sqrt, t, x0.ndim)
    am1 = extract(sched.one_minus_alphas_bar_sqrt, t, x0.ndim)
    return a * x0 + am1 * noise


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor,
                             t: int | torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x0-hat from an eps prediction."""
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def predict_noise_from_start(sched: DiffusionSchedule, x_t: torch.Tensor,
                             t: int | torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """eps-hat from an x0 prediction."""
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


def predict_noise_from_mean(sched: DiffusionSchedule, x_t: torch.Tensor,
                            t: int | torch.Tensor, mean_t: torch.Tensor) -> torch.Tensor:
    """eps-hat from a posterior-mean prediction."""
    return ((extract(sched.sqrt_recip_alphas, t, x_t.ndim) * x_t - mean_t)
            / extract(sched.noise_mean_coeff, t, x_t.ndim))


def posterior_mean(sched: DiffusionSchedule, x0_pred: torch.Tensor,
                   x_t: torch.Tensor, t: int | torch.Tensor) -> torch.Tensor:
    """Mean of q(x_{t-1} | x_t, x0)."""
    c1 = extract(sched.posterior_mean_coef1, t, x_t.ndim)
    c2 = extract(sched.posterior_mean_coef2, t, x_t.ndim)
    return c1 * x0_pred + c2 * x_t
