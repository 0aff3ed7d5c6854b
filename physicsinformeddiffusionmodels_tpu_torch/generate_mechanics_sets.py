"""Generate the mechanics study's four sets (port of
``scripts/generate_mechanics_sets.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets \\
        --root DIR [--n-train 3072] [--n-valid 64] [--n-test 128] [--n-iter 50] \\
        [--seed 0] [--pixels-per-dim 64] [--device {cuda,cpu,host}] [--batch 64] \\
        [--workers W] [--only {all,train,valid,test_level_1,test_level_2}] \\
        [--start-index I] [--in-dist-families cantilever,edge_cantilever,...]

Writes, as the JAX script lays them out:

    DIR/train/fields/<i>.npy               in-distribution families
    DIR/test/valid/fields/<i>.npy          in-distribution families
    DIR/test/test_level_1/fields/<i>.npy   in-distribution families
    DIR/test/test_level_2/fields/<i>.npy   the OOD families, vf in [0.25, 0.7]

``--only`` makes one of them. A set's scenarios (index, family, vf) go to
``scenarios_<start>.csv``, and ``merge_scenarios`` rebuilds
``scenarios.csv`` from every such shard file of the directory. One
generator, seeded with (seed, start index), draws every scenario in order,
a batch at a time (the last batch of a set draws a whole batch too), so a
seed gives the JAX script's files for the same path. ``--start-index``
(the train set only, as in JAX) names the files from that index and starts
the family round-robin there, so a set can be made in shards, some on the
card and some on the host, in one directory. ``--device cuda`` (the
default, as JAX's default is its device) or ``cpu`` optimises the designs
of ``--batch`` scenarios at once on that torch device
(``data/mechanics_generator_gpu.py``); ``host`` optimises them one by one
with the host SIMP, eight scenarios a batch as the JAX script's host path
draws them. The final solve of each sample is exact (host sparse LU)
whatever the path and ``--n-iter``. ``--workers`` runs the host's work, the
SIMP (host path) or those final solves (device path), in that many spawned
processes; the draws stay in this process.
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
SETS = ("train", "valid", "test_level_1", "test_level_2")


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
                 gen: GpuSimpGenerator | None = None, batch: int = HOST_BATCH,
                 start_index: int = 0) -> None:
    """Write ``n_samples`` samples ``<start_index + i>.npy`` to ``out_dir``,
    the families taken round-robin from ``start_index``, ``batch`` scenarios
    drawn a batch; the designs from ``gen`` (the device path) or else the
    host SIMP. Their scenarios go to ``scenarios_<start_index>.csv``, then
    ``merge_scenarios`` rebuilds ``scenarios.csv``. With ``pool``, the
    host's work of a batch (the SIMP, or on the device path each sample's
    exact final solve) runs in its processes."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    meta, done, t0 = [], 0, time.time()
    while done < n_samples:
        nb = min(batch, n_samples - done)
        draws = []
        for b in range(batch):
            fam = families[(start_index + done + b) % len(families)]
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
            idx = start_index + done + b
            np.save(out / f"{idx}.npy", sample)
            meta.append((idx, draws[b][0], float(draws[b][3])))
        done += nb
    # every shard, start 0 too, writes its own file: scenarios.csv is only
    # the merge's, so shards made at once never overwrite each other's rows
    with open(out / f"scenarios_{start_index}.csv", "w") as fh:
        fh.write("index,family,vf\n")
        for i, fam, v in meta:
            fh.write(f"{i},{fam},{v:.6f}\n")
    merge_scenarios(out)
    print(f"  {out}: {n_samples} samples in {time.time() - t0:.1f}s", flush=True)


def _shard_order(path: Path) -> tuple[float, int]:
    try:
        start = int(path.stem.split("_")[1])
    except (IndexError, ValueError):
        start = -1
    return path.stat().st_mtime, start


def merge_scenarios(out_dir: str | Path) -> None:
    """Rebuild ``scenarios.csv`` of ``out_dir`` from its
    ``scenarios_<start>.csv`` shards, rows keyed by sample index.

    The existing ``scenarios.csv`` is the base (a set made before shards
    keeps its rows); the shards are read oldest first by mtime (ties by
    start), so on an index held twice the newest shard wins and a stale
    shard of an earlier run cannot override a fresh one. Header, blank,
    truncated and non-integer lines are skipped (a shard cut mid-write
    loses only its cut rows). Nothing is written when there is no shard or
    no row; the shards are kept."""
    out = Path(out_dir)
    shards = sorted(out.glob("scenarios_*.csv"), key=_shard_order)
    if not shards:
        return
    main_csv = out / "scenarios.csv"
    rows = {}
    for path in ([main_csv] if main_csv.exists() else []) + shards:
        with open(path) as fh:
            for line in fh:
                parts = line.strip().split(",")
                if len(parts) != 3 or parts[0] == "index":
                    continue
                try:
                    rows[int(parts[0])] = (parts[1], parts[2])
                except ValueError:
                    continue
    if not rows:
        return
    with open(main_csv, "w") as fh:
        fh.write("index,family,vf\n")
        for i in sorted(rows):
            fam, v = rows[i]
            fh.write(f"{i},{fam},{v}\n")


def generate_sets(root: str | Path, n_train: int = 3072, n_valid: int = 64, n_test: int = 128,
                  n_iter: int = 50, seed: int = 0, pixels_per_dim: int = 64,
                  workers: int = 1, device: str = "cuda", batch: int = 64, only: str = "all",
                  start_index: int = 0,
                  in_dist_families: tuple[str, ...] = IN_DIST_FAMILIES) -> None:
    """The train, valid, test_level_1 and test_level_2 sets under ``root``
    (``only`` one of them, or 'all'), on ``device`` ('cuda' or 'cpu': the
    batched SIMP; 'host': the host SIMP, ``min(batch, 8)`` scenarios a
    batch), the host's work in ``workers`` processes. The train set's files
    start at ``start_index``; the draws are seeded with (seed,
    start_index); the in-distribution sets take ``in_dist_families``."""
    if only != "all" and only not in SETS:
        raise ValueError(f"only must be 'all' or one of {SETS}, got {only!r}")
    root = Path(root)
    fem = _fem(pixels_per_dim)
    rng = np.random.default_rng((seed, start_index))
    in_dist = tuple(in_dist_families)
    sets = (("train", root / "train" / "fields", n_train, in_dist, IN_DIST_VF, start_index),
            ("valid", root / "test" / "valid" / "fields", n_valid, in_dist, IN_DIST_VF, 0),
            ("test_level_1", root / "test" / "test_level_1" / "fields", n_test, in_dist,
             IN_DIST_VF, 0),
            ("test_level_2", root / "test" / "test_level_2" / "fields", n_test, OOD_FAMILIES,
             OOD_VF, 0))
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
        for name, out, n, families, vf_range, start in sets:
            if only in ("all", name):
                generate_set(fem, out, n, families, vf_range, rng, n_iter=n_iter, pool=pool,
                             gen=gen, batch=batch, start_index=start)
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
    ap.add_argument("--only", default="all", choices=("all",) + SETS)
    ap.add_argument("--start-index", type=int, default=0,
                    help="first output file index of this shard (train only)")
    ap.add_argument("--in-dist-families", default=",".join(IN_DIST_FAMILIES),
                    help="comma-separated train/valid/level-1 family mix")
    a = ap.parse_args(argv)
    t0 = time.time()
    generate_sets(a.root, a.n_train, a.n_valid, a.n_test, a.n_iter, a.seed, a.pixels_per_dim,
                  a.workers, a.device, a.batch, a.only, a.start_index,
                  tuple(a.in_dist_families.split(",")))
    print(f"All sets done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
