"""Darcy-flow PDE residual on an NHWC (p, K) field (port of the residual of
``physics/darcy.py``).

    eq0 = (-K p_d00 - K_d0 p_d0) + (-K p_d11 - K_d1 p_d1) - f_s

with Neumann BC residuals (+-dp/dn on the four edges) as two more channels
and the static two-patch source field f_s. Calling the evaluator gives the
``PhysicsTerms`` the training loss takes; gradients flow through the FD
operators. ``residual_correction`` is the CoCoGen correction step of the
sampler (arXiv 2312.10527); ``residual_gradient`` is the conditioning
signal of residual-gradient guidance.
"""

from __future__ import annotations

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import PhysicsTerms
from physicsinformeddiffusionmodels_tpu_torch.ops.fd import StencilGradients


def source_field(pixels_per_dim: int, w: float = 0.125, r: float = 10.0) -> np.ndarray:
    """Two corner patches (+r, -r) of width w on the cell-centred grid."""
    pixel = 1.0 / pixels_per_dim
    x = np.linspace(pixel / 2, 1.0 - pixel / 2, pixels_per_dim)
    X, Y = np.meshgrid(x, x, indexing="ij")
    f = np.zeros_like(X)
    f[(np.abs(X - 0.5 * w) <= 0.5 * w) & (np.abs(Y - 0.5 * w) <= 0.5 * w)] = r
    f[(np.abs(X - 1 + 0.5 * w) <= 0.5 * w) & (np.abs(Y - 1 + 0.5 * w) <= 0.5 * w)] = -r
    return f


def trapezoidal_weights(pixels_per_dim: int) -> np.ndarray:
    """Trapezoid-rule weights on the boundary-inclusive grid: corners 1,
    edges 2, interior 4, scaled by (1/P)^2 / 4 (the pressure gauge)."""
    w = np.full((pixels_per_dim, pixels_per_dim), 4.0)
    w[0, :] = w[-1, :] = w[:, 0] = w[:, -1] = 2.0
    w[0, 0] = w[0, -1] = w[-1, 0] = w[-1, -1] = 1.0
    return w * (1.0 / pixels_per_dim) ** 2 / 4.0


class DarcyResidual:
    """Darcy residual evaluator; operators live on ``device``."""

    def __init__(self, pixels_per_dim: int = 64, fd_acc: int = 2,
                 pixels_at_boundary: bool = True, reverse_d1: bool = True,
                 domain_length: float = 1.0, periodic: bool = False,
                 device: torch.device | str = "cpu"):
        P = pixels_per_dim
        d0 = domain_length / (P - 1) if pixels_at_boundary else domain_length / P
        d1 = -d0 if reverse_d1 else d0
        self.reverse_d1 = reverse_d1
        self.pixels_at_boundary = pixels_at_boundary
        self.grads = StencilGradients(P, P, d0=d0, d1=d1, fd_acc=fd_acc,
                                      periodic=periodic, device=device)
        self.f_s = torch.as_tensor(source_field(P), dtype=torch.float32, device=device)
        self.quad_weights = torch.as_tensor(trapezoidal_weights(P), dtype=torch.float32,
                                            device=device)

    def __call__(self, x0_pred: torch.Tensor) -> PhysicsTerms:
        return PhysicsTerms(residual=self.residual(x0_pred))

    def zero_mean_pressure(self, x0_pred: torch.Tensor) -> torch.Tensor:
        """Subtract from p its trapezoid-rule integral (its mean when pixels
        are cell-centred), taken on a detached copy, so the gradient flows
        only through the uncorrected p."""
        p = x0_pred[..., 0]
        if self.pixels_at_boundary:
            corr = (self.quad_weights * p.detach()).sum(dim=(1, 2))
        else:
            corr = p.detach().mean(dim=(1, 2))
        return torch.stack([p - corr[:, None, None], x0_pred[..., 1]], dim=-1)

    def residual(self, x0_pred: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 2] (p, K) -> [B, H*W, 3]: the interior PDE residual,
        then the Neumann BC residuals on the d0 and d1 edges (zero inside).
        Computed in float32 whatever the model's dtype."""
        if x0_pred.ndim != 4 or x0_pred.shape[-1] != 2:
            raise ValueError(f"expected an NHWC (p, K) field, got {tuple(x0_pred.shape)}")
        B, H, W, _ = x0_pred.shape
        x0_pred = x0_pred.float()
        p, K = x0_pred[..., 0], x0_pred[..., 1]
        d0, d1, d00, d11 = self.grads.first_second_pair(torch.cat([p, K], dim=0))
        p_d0, K_d0 = d0[:B], d0[B:]
        p_d1, K_d1 = d1[:B], d1[B:]
        p_d00, p_d11 = d00[:B], d11[:B]

        eq0 = (-K * p_d00 - K_d0 * p_d0) + (-K * p_d11 - K_d1 * p_d1) - self.f_s

        bc0 = torch.zeros_like(p)
        bc0[:, 0, :] = -p_d0[:, 0, :]
        bc0[:, -1, :] = p_d0[:, -1, :]
        bc1 = torch.zeros_like(p)
        sign = 1.0 if self.reverse_d1 else -1.0
        bc1[:, :, 0] = sign * p_d1[:, :, 0]
        bc1[:, :, -1] = -sign * p_d1[:, :, -1]
        return torch.stack([eq0, bc0, bc1], dim=-1).reshape(B, H * W, 3)

    def _jacobian_max(self, K: torch.Tensor) -> torch.Tensor:
        """[B] max over (i, j) of the residual's Jacobian d r / d p, for the
        permeability K [B, H, W].

        eq0 is linear in p for fixed K, so the nonzero entries for pixel
        (i, j) are closed-form stencil rows: the same column (i' varies)
        -K D00[i, i'] - K_d0 D0[i, i'], plus the diagonal of the d1 terms;
        the same row (j' varies, off the diagonal) -K D11[j, j'] - K_d1
        D1[j, j']; and the constant +-D0 / +-D1 rows of the BC channels.
        [B, H, W, H] and [B, H, W, W] per term, as the JAX package builds
        it, never the dense [3HW, HW] Jacobian.
        """
        g = self.grads
        n0, n1 = g.Dc0.shape[1], g.Dc1.shape[1]
        D0, D00 = g.Dc0[:n0], g.Dc0[n0:]
        D1, D11 = g.Dc1[:n1], g.Dc1[n1:]
        K_d0, K_d1, _, _ = g.first_second_pair(K)
        colvals = -K[..., None] * D00[None, :, None, :] - K_d0[..., None] * D0[None, :, None, :]
        diag_extra = (-K * torch.diagonal(D11)[None, None, :]
                      - K_d1 * torch.diagonal(D1)[None, None, :])
        eye = torch.eye(n0, dtype=K.dtype, device=K.device)[None, :, None, :]
        colvals = colvals + diag_extra[..., None] * eye
        rowvals = -K[..., None] * D11[None, None, :, :] - K_d1[..., None] * D1[None, None, :, :]
        off_diag = ~torch.eye(n1, dtype=torch.bool, device=K.device)[None, None, :, :]
        rowvals = torch.where(off_diag, rowvals, -torch.inf)
        m = torch.maximum(colvals.amax(dim=(1, 2, 3)), rowvals.amax(dim=(1, 2, 3)))
        bc_max = torch.maximum(D0.abs().max(), D1.abs().max())
        return torch.maximum(m, bc_max)

    def residual_correction(self, x: torch.Tensor,
                            n_steps: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """``n_steps`` CoCoGen correction steps on an NHWC (p, K) state:
        p <- p - eps * d(sum r^2)/dp, eps = 1e-6 / min(max dr/dp, 1e12); K is
        kept. Returns (x corrected, its residual). The step is taken on a
        detached gradient, whether or not the caller records autograd."""
        x = x.float()
        for _ in range(n_steps):
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                dr = torch.autograd.grad(self.residual(xx).square().sum(), xx)[0][..., 0]
            eps = 1e-6 / self._jacobian_max(x[..., 1]).clamp(max=1e12)
            p = x[..., 0] - eps[:, None, None] * dr.detach()
            x = torch.stack([p, x[..., 1]], dim=-1)
        return x, self.residual(x)

    def residual_gradient(self, x: torch.Tensor) -> torch.Tensor:
        """d mean|r| / d x, the conditioning image of residual-gradient
        classifier-free guidance. The mean runs over the whole batch, as in
        the JAX package, so the signal scales with 1 / B. Taken on a
        detached leaf, with autograd on whether or not the caller records
        it (sampling runs under ``torch.no_grad``): a function of x alone,
        with no graph to the caller's parameters."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            return torch.autograd.grad(self.residual(xx).abs().mean(), xx)[0]
