"""Physics-informed diffusion training losses (port of ``diffusion/losses.py``).

On top of the DDPM data loss the total loss adds, per minibatch, a virtual
residual log-likelihood ``-log p(r=0 | x0_pred)``, where ``r`` is a PDE
residual of the model's x0 prediction, plus optional inequality and
optimisation terms. The caller passes ``denoise_fn(x_t, t) -> model_out``
and ``physics_fn(x0_pred) -> PhysicsTerms``; the loss is one differentiable
scalar, so autograd flows through the residual, the FD operators and the
denoiser.

Randomness is injected: ``pidm_loss`` takes the timesteps ``t`` and the
noise explicitly (torch and JAX draw different numbers from one seed), and
the timestep samplers take a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    extract,
    posterior_mean,
    predict_noise_from_mean,
    predict_start_from_noise,
    q_sample,
)

# log(1e-12): the toy study clamps log-likelihoods here to avoid -inf
TOY_LL_CLAMP = -27.6310211159


class PhysicsTerms(NamedTuple):
    """Physics evaluated on an x0 prediction: the [B, ...] residual field, and
    optional [B] inequality and optimisation values."""

    residual: Optional[torch.Tensor] = None
    inequality: Optional[torch.Tensor] = None
    optimizer: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss-term weights (model.yaml keys c_data/c_residual/c_ineq/lambda_opt)."""

    c_data: float = 1.0
    c_residual: float = 0.0
    c_ineq: float = 0.0
    lambda_opt: float = 0.0


class LossAux(NamedTuple):
    """Tracked scalars: loss, data loss, mean |residual|, inequality and
    optimisation means."""

    loss: torch.Tensor
    data_loss: torch.Tensor
    residual_mean_abs: torch.Tensor
    ineq_mean: torch.Tensor
    opt_mean: torch.Tensor


def gaussian_log_likelihood(x, means, variance, clamp: Optional[float] = None):
    """-0.5 (x - mean)^2 / var (constant terms dropped); ``clamp`` floors it."""
    log_probs = -0.5 * (x - means) ** 2 / variance
    if clamp is not None:
        log_probs = torch.clamp(log_probs, min=clamp)
    return log_probs


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) for diagonal Gaussians."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def loss_variational(sched: DiffusionSchedule, model_mean, x0, x_t, t,
                     clamp: Optional[float] = None):
    """Variational (mu-prediction) loss: KL(q(x_{t-1} | x_t, x0) ||
    p(x_{t-1} | x_t)) for t > 0, the Gaussian NLL at t = 0."""
    batch = x0.shape[0]
    true_mean = posterior_mean(sched, x0, x_t, t)
    true_var = extract(sched.posterior_variance_clipped, t, x_t.ndim)
    log_var = torch.log(true_var)
    kl = normal_kl(true_mean, log_var, model_mean, log_var).reshape(batch, -1).mean(dim=1)
    ll = gaussian_log_likelihood(x0, model_mean, true_var, clamp).reshape(batch, -1).mean(dim=1)
    return torch.where(t == 0, -ll, kl).mean()


def data_loss_x0(sched: DiffusionSchedule, x0_target, model_out, t):
    """p2-weighted per-sample-mean MSE on x0."""
    batch = x0_target.shape[0]
    mse = ((x0_target - model_out) ** 2).reshape(batch, -1).mean(dim=1)
    return (mse * extract(sched.p2_loss_weight, t, 1)).mean()


def residual_log_likelihood_loss(sched: DiffusionSchedule, residual: torch.Tensor,
                                 t: torch.Tensor, clamp: Optional[float] = None) -> torch.Tensor:
    """Mean of -log p(r=0 | x0_pred) with per-sample variance
    posterior_variance_clipped[t]."""
    var = extract(sched.posterior_variance_clipped, t, residual.ndim)
    return (-gaussian_log_likelihood(torch.zeros_like(residual), residual, var, clamp)).mean()


def estimate_x0(sched: DiffusionSchedule, denoise_fn: Callable, x_t: torch.Tensor,
                t: torch.Tensor, pred_mode: str = "x0"):
    """Run the denoiser once; returns (x0_pred, model_out) for the x0, eps or
    mu prediction modes."""
    model_out = denoise_fn(x_t, t)
    if pred_mode == "x0":
        x0_pred = model_out
    elif pred_mode == "eps":
        x0_pred = predict_start_from_noise(sched, x_t, t, model_out)
    elif pred_mode == "mu":
        noise_pred = predict_noise_from_mean(sched, x_t, t, model_out)
        x0_pred = predict_start_from_noise(sched, x_t, t, noise_pred)
    else:
        raise ValueError(f"Unknown pred_mode: {pred_mode!r}")
    return x0_pred, model_out


def uniform_timesteps(generator: torch.Generator, batch: int, n_steps: int,
                      device=None) -> torch.Tensor:
    """[batch] timesteps uniform on [0, n_steps)."""
    return torch.randint(0, n_steps, (batch,), generator=generator, device=device)


def antithetic_timesteps(generator: torch.Generator, batch: int, n_steps: int,
                         device=None) -> torch.Tensor:
    """Antithetic timesteps: t and T - 1 - t, cut to ``batch``."""
    t = torch.randint(0, n_steps, (batch // 2 + 1,), generator=generator, device=device)
    return torch.cat([t, n_steps - t - 1])[:batch]


def pidm_loss(sched: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
              noise: torch.Tensor, *, denoise_fn: Callable,
              physics_fn: Optional[Callable[[torch.Tensor], PhysicsTerms]] = None,
              weights: LossWeights, pred_mode: str = "x0",
              x0_sampler: Optional[Callable] = None, ll_clamp: Optional[float] = None,
              model_out_transform: Optional[Callable] = None) -> tuple[torch.Tensor, LossAux]:
    """The physics-informed diffusion loss of one minibatch:

        c_data * L_data(model_out, x0)
      + c_residual * mean(-log p(r=0 | x0_est))       [var = sigma_t^2]
      + c_ineq     * mean(-log p(ineq=0 | x0_est))    [var = sigma_t^2]
      + lambda_opt * mean(optimizer)

    ``t`` [B] and ``noise`` (x0's shape) are given by the caller. The
    inequality term uses each sample's own variance; the reference
    broadcasts a [B] value against [B, 1] variances into a [B, B] matrix.
    ``x0_sampler(x_t, t) -> (x0_sample, first_model_out)`` is the DDIM
    estimate of x0_estimation='sample': the physics terms take x0_sample,
    and the data loss the chain's first model output, which is the direct
    prediction at (x_t, t), so ``denoise_fn`` is not called.
    """
    x_t = q_sample(sched, x0, t, noise)
    if x0_sampler is not None:
        x0_est, model_out = x0_sampler(x_t, t)
    else:
        x0_est, model_out = estimate_x0(sched, denoise_fn, x_t, t, pred_mode)
    if model_out_transform is not None:
        model_out = model_out_transform(model_out)

    if pred_mode == "x0":
        data_loss = data_loss_x0(sched, x0, model_out, t)
    elif pred_mode == "eps":
        data_loss = ((noise - model_out) ** 2).mean()
    else:
        data_loss = loss_variational(sched, model_out, x0, x_t, t, clamp=ll_clamp)
    loss = weights.c_data * data_loss
    data_loss_track = weights.c_data * data_loss

    terms = physics_fn(x0_est) if physics_fn is not None else PhysicsTerms()
    zero = torch.zeros((), dtype=x0.dtype, device=x0.device)
    residual_track = ineq_track = opt_track = zero
    if terms.residual is not None:
        loss = loss + weights.c_residual * residual_log_likelihood_loss(
            sched, terms.residual, t, clamp=ll_clamp)
        residual_track = terms.residual.abs().mean()
    if terms.inequality is not None:
        var_b = extract(sched.posterior_variance_clipped, t, 1)
        ineq_ll = gaussian_log_likelihood(torch.zeros_like(terms.inequality), terms.inequality,
                                          var_b, ll_clamp)
        loss = loss + weights.c_ineq * (-ineq_ll).mean()
        ineq_track = terms.inequality.mean()
    if terms.optimizer is not None:
        # log p(c = c_min | x0_est) under an exponential distribution is -lambda_opt * c
        loss = loss + weights.lambda_opt * terms.optimizer.mean()
        opt_track = terms.optimizer.mean()
    return loss, LossAux(loss, data_loss_track, residual_track, ineq_track, opt_track)
