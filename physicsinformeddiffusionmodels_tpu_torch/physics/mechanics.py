"""Linear-elasticity FEM residual of the topology-optimisation study (port of
``physics/mechanics.py``).

The residual of a displacement field is r = K(rho) u - f with the Dirichlet
rows of K replaced by identity rows and their loads zeroed, computed
matrix-free: on the structured quad grid every element couples its four
corner nodes through the fixed 8x8 element stiffness, so

    (K u)_q = sum_e rho_e (k_loc u_e)_q

is a gather of each element's 8 dofs from the [B, nn, nn, 2] nodal image
(four shifted slices), one multiply by k_loc and a sum over its 8 columns,
a multiply by rho, and four shifted slice-adds back onto the nodes. This is
JAX's stencil form (``_Ku``) with its 16 per-corner 2x2 products summed as
one 8-term product per element row; the association differs, so the two
agree to a float32 rounding. All of it is elementwise multiplies and sums in
float32, whatever the model's dtype: no matmul, so TF32 cannot enter.
``_Ku_scatter`` (index gather and ``index_add_``) is kept as the test oracle.

The evaluation solves K_bc(rho) u = f with JAX's Jacobi-preconditioned CG
(``jax.scipy.sparse.linalg.cg``) on the whole [B, neq] batch as ONE system:
its inner products and its stopping test (||r||^2 <= tol^2 ||b||^2) sum over
every sample, so the samples share alpha and beta. The loop tests that
condition on the device at the top of every iteration and freezes the state
once it fails, as ``lax.while_loop`` stops, so the iterates are JAX's; the
host reads the flag every ``check_every`` iterations to end the loop. On the
card the ``check_every`` iterations between two reads replay one CUDA graph.
The loop is ``pcg``, which the batched SIMP generator shares.
``topopt_eval_checked`` re-checks each solution's residual in float64 on the
host and re-solves those above ``tol`` with SciPy's sparse LU.

Grid convention: node (i, j) of the (P+1) x (P+1) node image has id
n = i*(P+1) + j and dofs (2n, 2n+1) = (x, y); element (a, b) connects nodes
[(a,b), (a,b+1), (a+1,b+1), (a+1,b)]; unit element side.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import PhysicsTerms
from physicsinformeddiffusionmodels_tpu_torch.ops.reshape import resize_bilinear
from physicsinformeddiffusionmodels_tpu_torch.physics.fem_grid import (  # noqa: F401 (re-export)
    grid_topology,
    quad4_stiffness,
)

# the quad4 element's corner nodes as grid offsets (i, j), in grid_topology's order
NODE_OFFSETS = ((0, 0), (0, 1), (1, 1), (1, 0))


def image_to_dof_vector(img: torch.Tensor, dof: int) -> torch.Tensor:
    """[B, nn, nn] nodal image -> [B, neq] with the image at dofs 2n + dof."""
    b, nn, _ = img.shape
    flat = img.reshape(b, nn * nn, 1)
    zero = torch.zeros_like(flat)
    return torch.cat([flat, zero] if dof == 0 else [zero, flat], dim=-1).reshape(b, 2 * nn * nn)


def dof_vector_to_image(vec: torch.Tensor, dof: int) -> torch.Tensor:
    """[B, neq] -> the [B, nn, nn] nodal image of one dof."""
    nn = math.isqrt(vec.shape[1] // 2)
    return vec.reshape(vec.shape[0], nn, nn, 2)[..., dof]


class MechanicsBatch(NamedTuple):
    """The 10-channel NHWC (65x65) dataset tensor, split: conditioning (vf,
    strain-energy density, von Mises), solution (disp_x, disp_y, E field),
    bcs (BC_node_x, BC_node_y, load_x, load_y)."""

    conditioning: torch.Tensor
    solution: torch.Tensor
    bcs: torch.Tensor


def split_mechanics_batch(batch: torch.Tensor) -> MechanicsBatch:
    return MechanicsBatch(conditioning=batch[..., 0:3], solution=batch[..., 3:6],
                          bcs=batch[..., 6:10])


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The whole batch's inner product, a 0-d tensor."""
    return (a * b).sum()


@torch.no_grad()
def pcg(matvec, f: torch.Tensor, diag: torch.Tensor, x0: torch.Tensor, tol: float,
        maxiter: int, check_every: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """Jacobi-preconditioned CG of ``matvec(u) = f`` from ``x0``, as
    ``jax.scipy.sparse.linalg.cg(matvec, f, x0, tol=tol, maxiter=maxiter, M=r
    / diag)`` runs it on a [B, n] f: one system, whole-batch inner products,
    and the stopping test ||r||^2 <= tol^2 ||f||^2 evaluated on the device at
    the top of every iteration, which freezes the state once it fails (JAX's
    iterates and count). The host reads that flag every ``check_every``
    iterations; on the card those iterations replay one CUDA graph. Returns
    (x, iterations as a 0-d tensor)."""
    x = x0.clone()
    r = f - matvec(x)
    p = r / diag
    gamma = _vdot(r, p)
    k = torch.zeros((), dtype=torch.long, device=f.device)
    atol2 = tol**2 * _vdot(f, f)
    active = torch.ones((), dtype=torch.bool, device=f.device)

    def iterate():
        # lax.while_loop's cond, then its body, frozen once cond fails
        active.copy_((_vdot(r, r) > atol2) & (k < maxiter))
        ap = matvec(p)
        alpha = gamma / _vdot(p, ap)
        r_new = r - alpha * ap
        z = r_new / diag
        gamma_new = _vdot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x.copy_(torch.where(active, x + alpha * p, x))
        r.copy_(torch.where(active, r_new, r))
        p.copy_(torch.where(active, p_new, p))
        gamma.copy_(torch.where(active, gamma_new, gamma))
        k.add_(active.long())

    graph = None
    if f.is_cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture
            matvec(p)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(check_every):
                iterate()
    for _ in range(-(-maxiter // check_every)):
        if graph is not None:
            graph.replay()
        else:
            for _ in range(check_every):
                iterate()
        if not ((_vdot(r, r) > atol2) & (k < maxiter)).item():
            break
    return x, k


class MechanicsResidual:
    """FEM equilibrium residual r = K(rho) u - f with BC row-masking, the
    compliance objective and the volume-fraction constraint, on ``device``."""

    def __init__(self, pixels_per_dim: int = 64, E: float = 1.0, nu: float = 0.3,
                 device: torch.device | str = "cpu"):
        topo = grid_topology(pixels_per_dim)
        self.pixels_per_dim = pixels_per_dim
        self.nels, self.nn, self.neq = topo["nels"], topo["nn"], topo["neq"]
        self.elem_dofs_np = topo["elem_dofs"]
        self.elem_dofs = torch.as_tensor(topo["elem_dofs"], dtype=torch.long, device=device)
        # JAX keeps the element stiffness as a float32 array; the host
        # assembly casts that array back to float64
        self.k_loc = torch.as_tensor(quad4_stiffness(E, nu), dtype=torch.float32, device=device)

    @property
    def gov_eqs(self) -> str:
        return "mechanics"

    # ------------------------------------------------------------- assembly

    def _bc_data(self, bcs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The [B, neq] load vector (zero at fixed dofs) and Dirichlet mask
        from the four BC/load channels of ``bcs`` [B, nn, nn, 4]."""
        bc_x, bc_y, load_x, load_y = (bcs[..., i] for i in range(4))
        f = image_to_dof_vector(load_x, 0) + image_to_dof_vector(load_y, 1)
        mask = (image_to_dof_vector(bc_x, 0) + image_to_dof_vector(bc_y, 1)) != 0
        return torch.where(mask, torch.zeros_like(f), f), mask

    def _Ku(self, rho_e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K(rho) u without BC masking, matrix-free: rho_e [B, nels], u [B,
        neq] -> [B, neq], in float32."""
        u = u.float()
        rho = rho_e.float().reshape(-1, self.pixels_per_dim, self.pixels_per_dim, 1)
        b, P, nn = u.shape[0], self.pixels_per_dim, self.nn
        u_img = u.reshape(b, nn, nn, 2)
        u_e = torch.cat([u_img[:, i:i + P, j:j + P] for i, j in NODE_OFFSETS], dim=-1)
        ku_e = (u_e[..., None, :] * self.k_loc).sum(-1) * rho  # [B, P, P, 8]
        out = torch.zeros_like(u_img)
        for a, (i, j) in enumerate(NODE_OFFSETS):
            out[:, i:i + P, j:j + P] += ku_e[..., 2 * a:2 * a + 2]
        return out.reshape(b, self.neq)

    def _Ku_scatter(self, rho_e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The gather/scatter-add form of ``_Ku`` (the test oracle)."""
        u, rho_e = u.float(), rho_e.float()
        ku_e = (u[:, self.elem_dofs][:, :, None, :] * self.k_loc).sum(-1) * rho_e[..., None]
        out = torch.zeros_like(u)
        return out.index_add_(1, self.elem_dofs.reshape(-1), ku_e.reshape(u.shape[0], -1))

    def assemble_dense(self, rho_e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The dense global stiffness [B, neq, neq] of element densities
        rho_e [B, nels], with the Dirichlet dofs of ``mask`` [B, neq] (bool)
        replaced by identity rows and columns' diagonal, as JAX's: for
        evaluation and checks only (the solves are matrix-free)."""
        b = rho_e.shape[0]
        rows = self.elem_dofs[:, :, None].expand(-1, 8, 8).reshape(-1)
        cols = self.elem_dofs[:, None, :].expand(-1, 8, 8).reshape(-1)
        vals = (rho_e[:, :, None, None] * self.k_loc.to(rho_e.dtype)).reshape(b, -1)
        k = rho_e.new_zeros(b, self.neq * self.neq)
        k.index_add_(1, rows * self.neq + cols, vals)
        k = torch.where(mask[:, :, None], 0.0, k.reshape(b, self.neq, self.neq))
        return k + mask[:, :, None] * torch.eye(self.neq, dtype=rho_e.dtype,
                                                device=rho_e.device)

    # ------------------------------------------------------------- residual

    def displacements_to_dofs(self, disp: torch.Tensor) -> torch.Tensor:
        """[B, nn, nn, 2] displacement image -> [B, neq]."""
        return disp.reshape(disp.shape[0], self.neq)

    def residual_from_fields(self, disp_nodes: torch.Tensor, rho_e: torch.Tensor,
                             bcs: torch.Tensor):
        """r = K_bc(rho) u - f_bc from nodal displacements [B, nn, nn, 2],
        element densities [B, nels] and BCs [B, nn, nn, 4]. Returns
        (residual, u, f, mask), each [B, neq]."""
        u = self.displacements_to_dofs(disp_nodes)
        f, mask = self._bc_data(bcs)
        ku_bc = torch.where(mask, u.float(), self._Ku(rho_e, u))
        return ku_bc - f, u, f, mask

    def compliance(self, u: torch.Tensor, rho_e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """u^T K_bc u per sample."""
        ku_bc = torch.where(mask, u.float(), self._Ku(rho_e, u))
        return (u.float() * ku_bc).sum(-1)

    def evaluate(self, x0_pred: torch.Tensor, bcs: torch.Tensor, vf: torch.Tensor) -> PhysicsTerms:
        """Physics terms of a model x0 prediction [B, P, P, 3] (disp_x,
        disp_y, rho at 64x64) with BCs [B, nn, nn, 4] and target volume
        fractions [B]: the displacements regridded to the nodes bilinearly,
        rho on the elements; the volume mismatch is the inequality term and
        the compliance the optimisation term."""
        disp = resize_bilinear(x0_pred[..., :2], self.nn)
        rho_e = x0_pred[..., 2].reshape(x0_pred.shape[0], -1)
        residual, u, _, mask = self.residual_from_fields(disp, rho_e, bcs)
        comp = self.compliance(u, rho_e, mask)
        return PhysicsTerms(residual=residual, inequality=rho_e.mean(dim=1) - vf,
                            optimizer=comp)

    def model_out_to_nodes(self, x0_pred: torch.Tensor) -> torch.Tensor:
        """Model output (64x64) -> dataset layout (65x65): displacements
        upsampled, rho zero-padded at the bottom and right."""
        disp = resize_bilinear(x0_pred[..., :2], self.nn)
        rho = F.pad(x0_pred[..., 2], (0, 1, 0, 1))
        return torch.cat([disp, rho[..., None].to(disp.dtype)], dim=-1)

    # ------------------------------------------------------------ topopt eval

    def _jacobi_diag(self, rho_e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """diag(K_bc(rho)), matrix-free (1 at the fixed dofs)."""
        b, P = rho_e.shape[0], self.pixels_per_dim
        rho = rho_e.float().reshape(b, P, P, 1)
        diag_k = torch.diagonal(self.k_loc)
        d = torch.zeros((b, self.nn, self.nn, 2), dtype=torch.float32, device=rho_e.device)
        for a, (i, j) in enumerate(NODE_OFFSETS):
            d[:, i:i + P, j:j + P] += rho * diag_k[2 * a:2 * a + 2]
        return torch.where(mask, torch.ones_like(d.reshape(b, -1)), d.reshape(b, -1))

    @torch.no_grad()
    def solve(self, rho_e: torch.Tensor, bcs: torch.Tensor, tol: float = 1e-8,
              maxiter: int = 3000, check_every: int = 50):
        """K_bc(rho) u = f for the whole batch by Jacobi-preconditioned CG,
        as ``jax.scipy.sparse.linalg.cg`` runs it (one system, whole-batch
        inner products and stopping test, zero start). Returns (u [B, neq],
        relres [B] = ||K u - f|| / ||f||, iterations as a 0-d tensor). The
        caller must check relres: on binarised designs (contrast 1e3) float32
        CG stalls near relres 1e-2 (``topopt_eval_checked``)."""
        f, mask = self._bc_data(bcs.float())
        rho_e = rho_e.float()
        diag = self._jacobi_diag(rho_e, mask)
        zero = torch.zeros_like(f)

        def matvec(u):
            return torch.where(mask, u, self._Ku(rho_e, torch.where(mask, zero, u)))

        x, k = pcg(matvec, f, diag, torch.zeros_like(f), tol, maxiter, check_every)
        res = matvec(x) - f
        relres = torch.linalg.vector_norm(res, dim=1) / torch.clamp(
            torch.linalg.vector_norm(f, dim=1), min=1e-30)
        return x, relres, k

    def _assemble_sparse_host(self, rho_e: np.ndarray, bcs: np.ndarray):
        """float64 SciPy BC-masked stiffness of ONE sample: (K_csr, f, mask),
        Dirichlet rows -> identity, loads zeroed there."""
        import scipy.sparse as sp

        ed = self.elem_dofs_np
        k_loc = self.k_loc.cpu().numpy().astype(np.float64)
        rows = np.repeat(ed, 8, axis=1).reshape(-1)
        cols = np.tile(ed, (1, 8)).reshape(-1)
        vals = (np.asarray(rho_e, np.float64)[:, None, None] * k_loc).reshape(-1)
        K = sp.coo_matrix((vals, (rows, cols)), shape=(self.neq, self.neq)).tocsr()
        f_t, mask_t = self._bc_data(torch.as_tensor(np.asarray(bcs, np.float32))[None])
        f = f_t[0].numpy().astype(np.float64)
        mask = mask_t[0].numpy()
        K = sp.diags((~mask).astype(np.float64)) @ K + sp.diags(mask.astype(np.float64))
        return K, f, mask

    def solve_host(self, rho_e: np.ndarray, bcs: np.ndarray) -> np.ndarray:
        """Exact float64 sparse-LU solve of one sample: rho_e [nels], bcs
        [nn, nn, 4]."""
        import scipy.sparse.linalg as spla

        K, f, _ = self._assemble_sparse_host(rho_e, bcs)
        return spla.spsolve(K.tocsc(), f)

    @torch.no_grad()
    def topopt_eval(self, x0_pred: torch.Tensor, batch: MechanicsBatch) -> dict:
        """Post-sampling metrics of predictions [B, P, P, 3] on ``batch``:
        rel_CE_error (compliance of the binarised design against the
        dataset's), vf_error, and the dataset's own residual as a sanity
        value. Returns per-sample tensors, the binarised rho images (for the
        host floating-material check), the solve's relres and iteration
        count, and its solutions."""
        bcs = batch.bcs
        vf = batch.conditioning[..., 0][:, 0, 0]
        rho_simp = batch.solution[:, :-1, :-1, 2]
        rho_simp_e = rho_simp.reshape(rho_simp.shape[0], -1)
        res_data, u_data, f, _ = self.residual_from_fields(batch.solution[..., :2], rho_simp_e,
                                                           bcs)
        compliance_data = (u_data.float() * f).sum(-1)

        rho_pred = x0_pred[..., 2]
        rho_bin = torch.where(rho_pred > 0.5, 1.0, 1e-3).float()
        rho_bin_e = rho_bin.reshape(rho_bin.shape[0], -1)
        u_sol, relres, iters = self.solve(rho_bin_e, bcs)
        compliance_true = (u_sol * f).sum(-1)
        return {
            "rel_CE_error_full_batch": (compliance_true - compliance_data) / compliance_data,
            "vf_error_full_batch": (rho_bin_e.mean(dim=1) - vf).abs() / vf,
            "data_residual_mean_abs": res_data.abs().mean(),
            "rho_binarized": rho_bin,
            "compliance_data_full_batch": compliance_data,
            "solve_relres_full_batch": relres,
            "solve_iterations": iters,
            "u_sol_full_batch": u_sol,
        }

    def topopt_eval_checked(self, topopt: dict, bcs: np.ndarray, tol: float = 1e-4) -> dict:
        """Host check of ``topopt_eval``'s solves: each solution's residual is
        evaluated again in float64 against a SciPy assembly, and the samples
        above ``tol`` get their compliance from an exact sparse-LU solve.
        Returns the dict (host numpy values) with rel_CE corrected and
        ``n_solve_fallback`` and ``solve_relres_f64_full_batch`` added.
        ``bcs``: [B, nn, nn, 4]."""
        import scipy.sparse.linalg as spla

        def host(v):
            return v.detach().cpu().numpy() if torch.is_tensor(v) else v

        out = {k: host(v) for k, v in topopt.items()}
        rel_ce = np.array(out["rel_CE_error_full_batch"], copy=True)
        comp_data = out["compliance_data_full_batch"]
        rho_bin = out["rho_binarized"]
        u_sol = np.asarray(out["u_sol_full_batch"], np.float64)
        bcs = host(bcs)
        n_fallback = 0
        relres64 = np.zeros(len(rel_ce))
        for i in range(len(rel_ce)):
            K, f, _ = self._assemble_sparse_host(rho_bin[i].reshape(-1), bcs[i])
            relres64[i] = np.linalg.norm(K @ u_sol[i] - f) / max(np.linalg.norm(f), 1e-30)
            if relres64[i] > tol:
                n_fallback += 1
                u = spla.spsolve(K.tocsc(), f)
                rel_ce[i] = (u @ f - comp_data[i]) / comp_data[i]
        out["rel_CE_error_full_batch"] = rel_ce
        out["solve_relres_f64_full_batch"] = relres64
        out["n_solve_fallback"] = n_fallback
        return out
