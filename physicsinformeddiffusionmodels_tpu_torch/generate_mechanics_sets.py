"""Generate the mechanics study's four sets (port of
``scripts/generate_mechanics_sets.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets \\
        --root DIR [--n-train 3072] [--n-valid 64] [--n-test 128] [--n-iter 50] \\
        [--seed 0] [--pixels-per-dim 64] [--device {cuda,cpu,host}] [--batch 64] \\
        [--workers W]

Writes, as the JAX script lays them out:

    DIR/train/fields/<i>.npy               in-distribution families
    DIR/test/valid/fields/<i>.npy          in-distribution families
    DIR/test/test_level_1/fields/<i>.npy   in-distribution families
    DIR/test/test_level_2/fields/<i>.npy   the OOD families, vf in [0.25, 0.7]

each with a ``scenarios.csv`` (index, family, vf). One generator, seeded
with (seed, 0), draws every scenario in order, a batch at a time (the last
batch of a set draws a whole batch too), so a seed gives the JAX script's
files for the same path. ``--device cuda`` (the default, as JAX's default
is its device) or ``cpu`` optimises the designs of ``--batch`` scenarios at
once on that torch device (``data/mechanics_generator_gpu.py``); ``host``
optimises them one by one with the host SIMP, eight scenarios a batch as
the JAX script's host path draws them. The final solve of each sample is
exact (host sparse LU) whatever the path and ``--n-iter``. ``--workers``
runs the host's work, the SIMP (host path) or those final solves (device
path), in that many spawned processes; the draws stay in this process.
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
    IN_DIST_FAMILIES,
    OOD_FAMILIES,
    SCENARIO_FAMILIES,
    MechanicsFEM,
    fields_from_design,
    simp_topopt,
)

if TYPE_CHECKING:  # the host path's spawned workers import this module without torch
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
        GpuSimpGenerator)

# scenarios drawn a batch on the host path, as the JAX script's (min(--batch, 8))
HOST_BATCH = 8
IN_DIST_VF, OOD_VF = (0.3, 0.6), (0.25, 0.7)


@functools.cache
def _fem(pixels_per_dim: int) -> MechanicsFEM:
    return MechanicsFEM(pixels_per_dim)


def _simp(args) -> np.ndarray:
    """One SIMP design; module-level so that a spawned worker can run it."""
    pixels_per_dim, vf, f, fixed, penal, n_iter = args
    return simp_topopt(_fem(pixels_per_dim), vf, f, fixed, penal=penal, n_iter=n_iter)


def _fields(args) -> np.ndarray:
    """One sample's channels from its design (the exact host solve)."""
    pixels_per_dim, rho, fixed, f, penal = args
    return fields_from_design(_fem(pixels_per_dim), rho, fixed, f, penal=penal)


def generate_set(fem: MechanicsFEM, out_dir: str | Path, n_samples: int, families: tuple,
                 vf_range: tuple, rng: np.random.Generator, n_iter: int = 50,
                 penal: float = 3.0, pool: ProcessPoolExecutor | None = None,
                 gen: GpuSimpGenerator | None = None, batch: int = HOST_BATCH) -> None:
    """Write ``n_samples`` samples ``<i>.npy`` and ``scenarios.csv`` to
    ``out_dir``, the families taken round-robin, ``batch`` scenarios drawn a
    batch; the designs from ``gen`` (the device path) or else the host SIMP.
    With ``pool``, the host's work of a batch (the SIMP, or on the device
    path each sample's exact final solve) runs in its processes."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    meta, done, t0 = [], 0, time.time()
    while done < n_samples:
        nb = min(batch, n_samples - done)
        draws = []
        for b in range(batch):
            fam = families[(done + b) % len(families)]
            fixed, f = SCENARIO_FAMILIES[fam](fem, rng)
            draws.append((fam, fixed, f, rng.uniform(*vf_range)))
        run = pool.map if pool is not None else map
        if gen is not None:
            fixed, f, vf = (np.stack([d[i] for d in draws]) for i in (1, 2, 3))
            rho, relres = gen.optimize(gen.scenarios_from_host(fixed, f, vf))
            rhos = list(rho[:nb].cpu().numpy().astype(np.float64))
            print(f"  [{out.parent.name}/{out.name}] batch {done}-{done + nb}: device SIMP "
                  f"done, relres max {relres.max().item():.2e}", flush=True)
        else:
            rhos = list(run(_simp, [(fem.nels_per_side, float(vf), f, fixed, penal, n_iter)
                                    for _, fixed, f, vf in draws[:nb]]))
        jobs = [(fem.nels_per_side, rho, fixed, f, penal)
                for rho, (_, fixed, f, _) in zip(rhos, draws)]
        for b, sample in enumerate(run(_fields, jobs)):
            np.save(out / f"{done + b}.npy", sample)
            meta.append((done + b, draws[b][0], float(draws[b][3])))
        done += nb
    with open(out / "scenarios.csv", "w") as fh:
        fh.write("index,family,vf\n")
        for i, fam, v in meta:
            fh.write(f"{i},{fam},{v:.6f}\n")
    print(f"  {out}: {n_samples} samples in {time.time() - t0:.1f}s", flush=True)


def generate_sets(root: str | Path, n_train: int = 3072, n_valid: int = 64, n_test: int = 128,
                  n_iter: int = 50, seed: int = 0, pixels_per_dim: int = 64,
                  workers: int = 1, device: str = "cuda", batch: int = 64) -> None:
    """The train, valid, test_level_1 and test_level_2 sets under ``root``,
    on ``device`` ('cuda' or 'cpu': the batched SIMP; 'host': the host
    SIMP, ``min(batch, 8)`` scenarios a batch), the host's work in
    ``workers`` processes."""
    root = Path(root)
    fem = _fem(pixels_per_dim)
    rng = np.random.default_rng((seed, 0))
    sets = ((root / "train" / "fields", n_train, IN_DIST_FAMILIES, IN_DIST_VF),
            (root / "test" / "valid" / "fields", n_valid, IN_DIST_FAMILIES, IN_DIST_VF),
            (root / "test" / "test_level_1" / "fields", n_test, IN_DIST_FAMILIES, IN_DIST_VF),
            (root / "test" / "test_level_2" / "fields", n_test, OOD_FAMILIES, OOD_VF))
    gen, pool = None, None
    if workers > 1:
        pool = ProcessPoolExecutor(max_workers=workers,
                                   mp_context=multiprocessing.get_context("spawn"))
    if device == "host":
        batch = min(batch, HOST_BATCH)
    else:
        from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
            GpuSimpGenerator)

        gen = GpuSimpGenerator(pixels_per_dim, n_iter=n_iter, device=device)
    try:
        for out, n, families, vf_range in sets:
            generate_set(fem, out, n, families, vf_range, rng, n_iter=n_iter, pool=pool,
                         gen=gen, batch=batch)
    finally:
        if pool is not None:
            pool.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="./data/mechanics")
    ap.add_argument("--n-train", type=int, default=3072)
    ap.add_argument("--n-valid", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=128, help="per test level")
    ap.add_argument("--n-iter", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pixels-per-dim", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu", "host"],
                    help="cuda (default) or cpu: the batched SIMP on that torch device; "
                    "host: the host SIMP, eight scenarios a batch")
    ap.add_argument("--batch", type=int, default=64, help="scenarios a batch")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes for the host's work: the SIMP (host path) or the final "
                    "exact solves (device path)")
    a = ap.parse_args(argv)
    t0 = time.time()
    generate_sets(a.root, a.n_train, a.n_valid, a.n_test, a.n_iter, a.seed, a.pixels_per_dim,
                  a.workers, a.device, a.batch)
    print(f"All sets done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
