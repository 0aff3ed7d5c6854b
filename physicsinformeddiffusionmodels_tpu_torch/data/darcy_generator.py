"""Darcy-flow ground-truth generator (the port's copy of the JAX package's
NumPy/SciPy ``data/darcy_generator.py``).

Permeability fields are sampled from a Karhunen-Loeve expansion of a
Gaussian random field with exponential covariance; the Darcy operator is
assembled from the same finite-difference matrices the training residual
uses (the port's ``ops/fd.py``), with Neumann BC rows and one trapezoid-rule
integral-gauge row, and the overdetermined system is solved in the least
squares sense. Per-sample residuals are recorded as the dataset's quality
oracle. Several samples run in worker processes, with per-sample seeds.

    python -m physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator \\
        --n-samples K --out DIR [--seed S] [--workers W]

writes ``K_data.csv``, ``p_data.csv``, ``res_data.csv`` and ``seeds.csv``
(one flattened sample per row).
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg

from physicsinformeddiffusionmodels_tpu_torch.ops.fd import _derivative_matrix_np
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import (
    source_field,
    trapezoidal_weights,
)


@functools.lru_cache(maxsize=4)
def kle_eigenpairs(
    pixels_per_dim: int, q: int, corr_length: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Top-``q`` eigenpairs of the exponential covariance
    ``exp(-||x_i - x_j|| / l)`` on the boundary-inclusive grid
    (`darcy_data_generation.py:41-61`).

    The dense eigh at P=64 takes seconds, so results are memoized to the
    git-ignored ``data/.cache/torch/`` (worker processes load it from
    there).

    Returns (eigvals [q], eigvecs [P*P, q]) in descending eigenvalue order.
    """
    P = pixels_per_dim
    cache = (
        Path(__file__).resolve().parents[2]
        / "data" / ".cache" / "torch" / f"kle_P{P}_q{q}_l{corr_length:g}.npz"
    )
    if cache.exists():
        with np.load(cache) as z:
            return z["eigvals"], z["eigvecs"]
    x = np.linspace(0.0, 1.0, P)
    X, Y = np.meshgrid(x, x, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)  # [P*P, 2]
    dist = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    C = np.exp(-dist / corr_length)
    n = C.shape[0]
    eigvals, eigvecs = scipy.linalg.eigh(C, subset_by_index=[n - q, n - 1])
    # eigh returns ascending; flip to descending like the reference's sort
    eigvals, eigvecs = eigvals[::-1].copy(), eigvecs[:, ::-1].copy()
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, eigvals=eigvals, eigvecs=eigvecs)
    except OSError:
        pass
    return eigvals, eigvecs


def sample_log_k(
    pixels_per_dim: int, q: int, rng: np.random.Generator, corr_length: float = 0.1
) -> np.ndarray:
    """log-permeability KLE draw: sum_k sqrt(lambda_k) theta_k phi_k,
    theta ~ N(0, 1) (`darcy_data_generation.py:63-78`). Returns [P*P]."""
    eigvals, eigvecs = kle_eigenpairs(pixels_per_dim, q, corr_length)
    theta = rng.standard_normal(q)
    return eigvecs @ (np.sqrt(np.maximum(eigvals, 0.0)) * theta)


@functools.lru_cache(maxsize=4)
def _operators(pixels_per_dim: int, fd_acc: int, reverse_d1: bool):
    """Flattened-grid (row-major, index i*P+j) derivative operators as
    sparse CSR in float64, matching ``physics.darcy.DarcyResidual``'s
    conventions: spacing d0 = 1/(P-1) (pixels at boundary), d1 = -d0 when
    reverse_d1. The 1D stencil matrices have O(acc) nonzeros per row, so the
    kron-lifted 2D operators are very sparse."""
    P = pixels_per_dim
    d0 = 1.0 / (P - 1)
    d1 = -d0 if reverse_d1 else d0
    D0_1 = scipy.sparse.csr_matrix(_derivative_matrix_np(P, 1, fd_acc, False) / d0)
    D0_2 = scipy.sparse.csr_matrix(_derivative_matrix_np(P, 2, fd_acc, False) / d0**2)
    D1_1 = scipy.sparse.csr_matrix(_derivative_matrix_np(P, 1, fd_acc, False) / d1)
    D1_2 = scipy.sparse.csr_matrix(_derivative_matrix_np(P, 2, fd_acc, False) / d1**2)
    I = scipy.sparse.eye(P, format="csr")
    return (
        scipy.sparse.kron(D0_1, I, format="csr"),  # d/d0 on flattened field
        scipy.sparse.kron(D0_2, I, format="csr"),
        scipy.sparse.kron(I, D1_1, format="csr"),  # d/d1
        scipy.sparse.kron(I, D1_2, format="csr"),
    )


def _build_sparse_system(
    K_flat: np.ndarray,
    pixels_per_dim: int,
    fd_acc: int = 2,
    reverse_d1: bool = True,
) -> tuple[scipy.sparse.csr_matrix, np.ndarray]:
    """Assemble sparse (A, b) for the pressure p given a permeability field.

    Rows (matching the training residual + the reference's generator):
      * P*P PDE rows:  -K p_d00 - K_d0 p_d0 - K p_d11 - K_d1 p_d1 = f_s
        (`residuals_darcy.py:146-154`, `darcy_data_generation.py:135-147`)
      * 4P Neumann rows: +-dp/dn = 0 on the four edges
        (`darcy_data_generation.py:146-153`, signs as
        `residuals_darcy.py:169-183`)
      * 1 trapezoid integral-gauge row: sum w_ij p_ij = 0
        (`darcy_data_generation.py:99-121,157-158`)
    """
    P = pixels_per_dim
    K_flat = np.asarray(K_flat, np.float64).ravel()
    L0_1, L0_2, L1_1, L1_2 = _operators(P, fd_acc, reverse_d1)

    K_d0 = L0_1 @ K_flat
    K_d1 = L1_1 @ K_flat
    dK = scipy.sparse.diags(K_flat)
    A_pde = (
        -dK @ (L0_2 + L1_2)
        - scipy.sparse.diags(K_d0) @ L0_1
        - scipy.sparse.diags(K_d1) @ L1_1
    )
    b_pde = source_field(P).ravel().astype(np.float64)

    idx = np.arange(P * P).reshape(P, P)
    s1 = -1.0 if reverse_d1 else 1.0
    bc_rows = scipy.sparse.vstack(
        [
            -L0_1[idx[0, :]],  # top edge: -dp/d0
            L0_1[idx[-1, :]],  # bottom edge: +dp/d0
            -s1 * L1_1[idx[:, 0]],  # left edge
            s1 * L1_1[idx[:, -1]],  # right edge
        ]
    )
    integral_row = scipy.sparse.csr_matrix(trapezoidal_weights(P).ravel()[None, :])

    A = scipy.sparse.vstack([A_pde, bc_rows, integral_row], format="csr")
    b = np.concatenate([b_pde, np.zeros(4 * P + 1)])
    return A, b


def build_darcy_system(
    K_flat: np.ndarray,
    pixels_per_dim: int,
    fd_acc: int = 2,
    reverse_d1: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense (A, b) view of the Darcy system (see ``_build_sparse_system``
    for the row layout)."""
    A, b = _build_sparse_system(K_flat, pixels_per_dim, fd_acc, reverse_d1)
    return A.toarray(), b


def solve_darcy(
    K_flat: np.ndarray, pixels_per_dim: int, fd_acc: int = 2, reverse_d1: bool = True
) -> tuple[np.ndarray, float]:
    """Least-squares pressure solve; returns (p [P*P], mean |A p - b|)
    (`darcy_data_generation.py:161-163` solves the same overdetermined
    system with dense scipy lstsq, ~40 s/sample at P=64).

    The trapezoid gauge row is DENSE, so forming normal equations with it
    densifies A^T A (rank-1 update w w^T) and sparse LU degenerates to a
    ~10 s dense factorization. Instead the gauge is decoupled: the
    PDE+BC block A0 annihilates constants exactly (every FD stencil row
    sums to 0), so ||A0 p - b0||^2 is invariant along 1 and the full LS
    minimizer is obtained by (1) solving the BANDED normal equations of
    A0 with a one-node pin selecting a representative, then (2) shifting
    p by a multiple of 1 to zero the trapezoid integral — identical
    minimizer, ~100x faster (~0.5 s/sample). Dense lstsq guards
    pathological fields."""
    A, b = _build_sparse_system(K_flat, pixels_per_dim, fd_acc, reverse_d1)
    n = pixels_per_dim * pixels_per_dim
    A0, b0 = A[:-1], b[:-1]
    w = np.asarray(A[-1].todense()).ravel()  # trapezoid gauge weights
    try:
        S = (A0.T @ A0).tocsc()
        # pin node 0 at the problem's own scale: selects the y_0 = 0
        # representative of the constant-shift equivalence class without
        # perturbing the range component (removed by the shift below)
        pinw = float(S.diagonal().mean())
        pin = scipy.sparse.csc_matrix(([pinw], ([0], [0])), shape=S.shape)
        y = scipy.sparse.linalg.splu(S + pin).solve(A0.T @ b0)
        p = y - (w @ y) / (w @ np.ones(n)) * np.ones(n)
        if not np.isfinite(p).all():
            raise RuntimeError("non-finite normal-equation solution")
    except Exception:
        p, *_ = scipy.linalg.lstsq(A.toarray(), b, lapack_driver="gelsy")
    res = float(np.abs(A @ p - b).mean())
    return p, res


def _generate_one(args) -> tuple[np.ndarray, np.ndarray, float, int]:
    """One (K, p, res, seed) sample — module-level for ProcessPoolExecutor
    (process boundary as in `darcy_data_generation.py:123-131`)."""
    seed, P, q, corr_length, fd_acc = args
    rng = np.random.default_rng(seed)
    K = np.exp(sample_log_k(P, q, rng, corr_length))
    p, res = solve_darcy(K, P, fd_acc)
    return K.astype(np.float64), p, res, seed


def generate_dataset(
    n_samples: int,
    pixels_per_dim: int = 64,
    q: int = 64,
    corr_length: float = 0.1,
    fd_acc: int = 2,
    base_seed: int | None = None,
    out_dir: str | None = None,
    num_workers: int = 1,
):
    """Generate ``n_samples`` (K, p) pairs.

    Returns (K [N, P*P], p [N, P*P], res [N], seeds [N]); with ``out_dir``
    also writes the reference CSV layout ``K_data.csv / p_data.csv /
    res_data.csv / seeds.csv`` (one flattened sample per row,
    `darcy_data_generation.py:222-228`).
    """
    if base_seed is None:
        # process-unique base seed (reference: pid * time seeds,
        # `darcy_data_generation.py:127-131`)
        base_seed = (os.getpid() * int(time.time() * 1e3)) % (2**31 - 1)
    seeds = [int(base_seed) + i for i in range(n_samples)]
    assert len(set(seeds)) == n_samples, "duplicate seeds"

    tasks = [(s, pixels_per_dim, q, corr_length, fd_acc) for s in seeds]
    if num_workers > 1:
        kle_eigenpairs(pixels_per_dim, q, corr_length)  # cached before the workers start
        # spawn (not fork): the parent process may hold CUDA or OpenMP
        # threads, which do not survive fork
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as pool:
            results = list(pool.map(_generate_one, tasks))
    else:
        results = [_generate_one(t) for t in tasks]

    K = np.stack([r[0] for r in results])
    p = np.stack([r[1] for r in results])
    res = np.array([r[2] for r in results])
    out_seeds = np.array([r[3] for r in results])
    assert len(set(out_seeds.tolist())) == n_samples, "seed collision"

    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savetxt(out / "K_data.csv", K, delimiter=",")
        np.savetxt(out / "p_data.csv", p, delimiter=",")
        np.savetxt(out / "res_data.csv", res, delimiter=",")
        np.savetxt(out / "seeds.csv", out_seeds, delimiter=",", fmt="%d")
    return K, p, res, out_seeds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Generate Darcy (K, p) samples as CSV files.")
    ap.add_argument("--n-samples", type=int, default=10)
    ap.add_argument("--pixels-per-dim", type=int, default=64)
    ap.add_argument("--out", default="./data/darcy/train")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=None, help="base seed (default: process-unique)")
    ap.add_argument("--q", type=int, default=64)
    args = ap.parse_args(argv)
    t0 = time.time()
    K, _, res, _ = generate_dataset(args.n_samples, pixels_per_dim=args.pixels_per_dim,
                                    out_dir=args.out, num_workers=args.workers, q=args.q,
                                    base_seed=args.seed)
    print(f"Generated {len(K)} samples in {time.time() - t0:.1f}s -> {args.out}")
    print(f"mean lstsq residual: {res.mean():.2e}  max: {res.max():.2e}")


if __name__ == "__main__":
    main()
