"""Batched SIMP topology optimisation on a torch device (port of
``data/mechanics_generator_tpu.py``, whose generator is ``TpuSimpGenerator``).

The host generator (``mechanics_generator``) optimises one design at a time
with sparse-LU solves. Here the whole SIMP loop runs on the device, batched
over independent scenarios:

  * the FEM solve is the matrix-free Jacobi-PCG of ``physics/mechanics.py``
    (``pcg``: the whole batch as one system, JAX's stopping test, on the card
    a CUDA graph of 50 iterations between two host checks), warm-started
    from the previous SIMP iteration's displacements;
  * the sensitivity filter H @ (rho * dc) is a 3x3 zero-padded convolution
    with the linear-decay kernel (rmin = 1.5 reaches only the adjacent
    elements), and Hs = H @ 1 the same convolution of ones; JAX computes it
    with an XLA convolution, here ``F.conv2d`` with TF32 off;
  * the optimality-criteria update is vectorised over the batch: 64 fixed
    halvings of each sample's volume multiplier, in float32.

Everything is float32 and elementwise (the element compliance too: no
matmul, so no TF32). The final displacement solve and the channels stay on
the host (``fields_from_design``: exact float64 sparse LU), so every emitted
sample satisfies K(E) u - f ~= 0 to direct-solver precision.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
    E_MIN,
    SCENARIO_FAMILIES,
    MechanicsFEM,
    fields_from_design,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual, pcg
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import resolve_device

OC_HALVINGS = 64


class SimpScenario(NamedTuple):
    """A batch of load cases on the device."""

    f: torch.Tensor  # [B, neq] load vectors
    mask: torch.Tensor  # [B, neq] bool Dirichlet mask
    vf: torch.Tensor  # [B] target volume fractions


def _filter_kernel(rmin: float) -> np.ndarray:
    """The linear-decay filter weights as a dense (2r-1)^2 kernel."""
    reach = int(np.ceil(rmin)) - 1
    size = 2 * reach + 1
    k = np.zeros((size, size))
    for di in range(-reach, reach + 1):
        for dj in range(-reach, reach + 1):
            w = rmin - np.hypot(di, dj)
            if w > 0:
                k[di + reach, dj + reach] = w
    return k


def _conv_filter(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """[B, P, P] correlated with ``kernel``, zero-padded: H @ x on the element
    grid, in full float32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(x[:, None], kernel[None, None].to(x.dtype),
                        padding=kernel.shape[-1] // 2)[:, 0]


class GpuSimpGenerator:
    """Batched SIMP compliance minimisation on ``device`` (default cuda)."""

    def __init__(self, nels_per_side: int = 64, penal: float = 3.0, rmin: float = 1.5,
                 move: float = 0.2, n_iter: int = 30, cg_tol: float = 1e-5,
                 cg_maxiter: int = 600, device=None):
        self.device = resolve_device(device)
        self.P = nels_per_side
        self.penal, self.move, self.n_iter = penal, move, n_iter
        self.cg_tol, self.cg_maxiter = cg_tol, cg_maxiter
        self.mech = MechanicsResidual(pixels_per_dim=nels_per_side, device=self.device)
        self.kernel = torch.as_tensor(_filter_kernel(rmin), dtype=torch.float32,
                                      device=self.device)
        # Hs = H @ 1 (row sums; the boundary rows lose their out-of-domain weight)
        ones = torch.ones((1, self.P, self.P), dtype=torch.float32, device=self.device)
        self.Hs = _conv_filter(ones, self.kernel)[0]
        # the last ``optimize``'s CG iterations of each solve, and its relres
        self.cg_iterations: list[int] = []
        self.relres: torch.Tensor | None = None

    def scenarios_from_host(self, fixed: np.ndarray, f: np.ndarray,
                            vf: np.ndarray) -> SimpScenario:
        """Host-drawn load cases ([B, neq] fixed and f, [B] vf) on the device."""
        dev = self.device
        return SimpScenario(f=torch.as_tensor(f, dtype=torch.float32, device=dev),
                            mask=torch.as_tensor(fixed, dtype=torch.bool, device=dev),
                            vf=torch.as_tensor(vf, dtype=torch.float32, device=dev))

    def _solve_pcg(self, e_field: torch.Tensor, scen: SimpScenario,
                   u0: torch.Tensor) -> torch.Tensor:
        """K_bc(E) u = f for the batch, warm-started from u0 (zero at the
        fixed dofs)."""
        mech, mask = self.mech, scen.mask
        f = torch.where(mask, 0.0, scen.f)
        diag = mech._jacobi_diag(e_field, mask)

        def matvec(u):
            return torch.where(mask, u, mech._Ku(e_field, u))

        u, k = pcg(matvec, f, diag, torch.where(mask, 0.0, u0), self.cg_tol, self.cg_maxiter)
        self.cg_iterations.append(int(k))
        return u

    def _element_compliance(self, u: torch.Tensor) -> torch.Tensor:
        """ce_e = u_e^T k_loc u_e at unit density, [B, nels]: elementwise
        products and sums in float32."""
        u_e = u[:, self.mech.elem_dofs]
        ku_e = (u_e[:, :, None, :] * self.mech.k_loc).sum(-1)
        return (u_e * ku_e).sum(-1)

    def _oc_update(self, rho: torch.Tensor, dc: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        """Optimality-criteria update (Sigmund 2001) with OC_HALVINGS fixed
        halvings of each sample's volume multiplier over [0, 1e9]."""
        move = self.move
        sens = torch.sqrt(torch.clamp(-dc, min=0.0))
        lo, hi = torch.clamp(rho - move, min=1e-3), torch.clamp(rho + move, max=1.0)

        def candidate(lmid):
            cand = rho * sens / torch.sqrt(torch.clamp(lmid, min=1e-12))[:, None]
            return torch.minimum(torch.maximum(cand, lo), hi)

        l1 = torch.zeros(rho.shape[0], dtype=rho.dtype, device=rho.device)
        l2 = torch.full_like(l1, 1e9)
        for _ in range(OC_HALVINGS):
            lmid = 0.5 * (l1 + l2)
            over = candidate(lmid).mean(dim=1) > vf
            l1, l2 = torch.where(over, lmid, l1), torch.where(over, l2, lmid)
        return candidate(0.5 * (l1 + l2))

    def _simp_step(self, rho: torch.Tensor, u: torch.Tensor,
                   scen: SimpScenario) -> tuple[torch.Tensor, torch.Tensor]:
        """One SIMP iteration on (rho, u): solve, sensitivities, filter, OC."""
        b, P, penal = rho.shape[0], self.P, self.penal
        e_field = E_MIN + rho**penal * (1.0 - E_MIN)
        u = self._solve_pcg(e_field, scen, u)
        dc = -penal * rho ** (penal - 1) * (1.0 - E_MIN) * self._element_compliance(u)
        num = _conv_filter((rho * dc).reshape(b, P, P), self.kernel)
        dc_f = num.reshape(b, P * P) / (self.Hs.reshape(1, P * P) * torch.clamp(rho, min=1e-3))
        return self._oc_update(rho, dc_f, scen.vf), u

    def _final_residual(self, rho: torch.Tensor, u: torch.Tensor,
                        scen: SimpScenario) -> torch.Tensor:
        """[B] relative residual ||K_bc u - f|| / ||f|| (fixed rows left out)
        of one more warm-started solve on the final design."""
        e_field = E_MIN + rho**self.penal * (1.0 - E_MIN)
        f = torch.where(scen.mask, 0.0, scen.f)
        ku = self.mech._Ku(e_field, self._solve_pcg(e_field, scen, u))
        r = torch.where(scen.mask, 0.0, ku) - f
        return torch.linalg.vector_norm(r, dim=1) / torch.clamp(
            torch.linalg.vector_norm(f, dim=1), min=1e-30)

    @torch.no_grad()
    def optimize(self, scen: SimpScenario) -> tuple[torch.Tensor, torch.Tensor]:
        """``n_iter`` SIMP iterations for the whole batch from the uniform
        design rho = vf. Returns (rho [B, nels], relres [B] of the last
        solve's warm start). JAX splits the run into chunks of device calls
        only to stay within its TPU host's deadline; the loop here needs no
        such split, so there is no chunk argument."""
        b = scen.f.shape[0]
        self.cg_iterations = []
        rho = scen.vf[:, None].expand(b, self.P * self.P).contiguous()
        u = torch.zeros((b, self.mech.neq), dtype=torch.float32, device=self.device)
        for _ in range(self.n_iter):
            rho, u = self._simp_step(rho, u, scen)
        self.relres = self._final_residual(rho, u, scen)
        return rho, self.relres


def generate_dataset_gpu(n_samples: int, nels_per_side: int = 64, seed: int = 0,
                         out_dir: str | None = None, batch: int = 64, penal: float = 3.0,
                         n_iter: int = 30, families: tuple[str, ...] = ("cantilever",),
                         vf_range: tuple[float, float] = (0.3, 0.6), start_index: int = 0,
                         verbose: bool = False, device=None) -> np.ndarray:
    """The device twin of ``mechanics_generator.generate_dataset``: designs
    optimised on ``device`` in batches of ``batch`` scenarios (a batch draws
    all ``batch``, as JAX's generator does, and emits what is still needed),
    channels built on the host from an exact final solve. With ``out_dir``,
    per-sample ``<start_index + i>.npy`` files. Returns [N, nn, nn, 10]."""
    fem = MechanicsFEM(nels_per_side)
    gen = GpuSimpGenerator(nels_per_side, penal=penal, n_iter=n_iter, device=device)
    rng = np.random.default_rng(seed)
    out = None
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
    samples, idx, done = [], start_index, 0
    while done < n_samples:
        nb = min(batch, n_samples - done)
        fixed = np.zeros((batch, fem.neq), bool)
        f = np.zeros((batch, fem.neq))
        vf = np.zeros(batch)
        for b in range(batch):
            fam = families[(done + b) % len(families)]
            fixed[b], f[b] = SCENARIO_FAMILIES[fam](fem, rng)
            vf[b] = rng.uniform(*vf_range)
        rho, relres = gen.optimize(gen.scenarios_from_host(fixed, f, vf))
        rho = rho.cpu().numpy().astype(np.float64)
        if verbose:
            print(f"  batch of {nb}: device SIMP done, last-solve relres max "
                  f"{relres.max().item():.2e}")
        for b in range(nb):
            s = fields_from_design(fem, rho[b], fixed[b], f[b], penal=penal)
            samples.append(s)
            if out is not None:
                np.save(out / f"{idx}.npy", s)
            idx += 1
        done += nb
    return np.stack(samples)
