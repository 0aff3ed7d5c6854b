"""Generate one set of mechanics (SIMP topology-optimisation) samples (port
of ``scripts/generate_mechanics_data.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_data \\
        --n-samples 32 --out ./data/mechanics/train/fields [--nels-per-side 64] \\
        [--seed 0] [--n-iter 30] [--families cantilever] [--vf-range 0.3,0.6] \\
        [--start-index 0] [--device {cuda,cpu,host}] [--batch 64]

Writes ``<start_index + i>.npy`` for i < n_samples, so that shards made with
disjoint start indices fill one directory. ``--device cuda`` (the default)
or ``cpu`` optimises ``--batch`` designs at once on that torch device
(``data/mechanics_generator_gpu.py``, the JAX script's ``--tpu`` path);
``host`` runs the host SIMP one design at a time
(``data/mechanics_generator.py``, the JAX script's default). Each sample's
final solve is exact (host sparse LU) on every path. A seed gives the JAX
script's files on the same path. ``generate_mechanics_sets`` makes the
study's four sets at once.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import generate_dataset


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-samples", type=int, default=8)
    ap.add_argument("--nels-per-side", type=int, default=64)
    ap.add_argument("--out", default="./data/mechanics/train/fields")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-iter", type=int, default=30, help="SIMP iterations")
    ap.add_argument("--families", default="cantilever",
                    help="comma-separated scenario families (train/test_level_1: cantilever; "
                    "test_level_2: cantilever_multiload,bridge,double_clamp)")
    ap.add_argument("--vf-range", default="0.3,0.6",
                    help="volume-fraction range lo,hi (test_level_2 may shift it)")
    ap.add_argument("--start-index", type=int, default=0,
                    help="first output file index (for sharded generation)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu", "host"],
                    help="cuda (default) or cpu: the batched SIMP on that torch device; "
                    "host: the host SIMP")
    ap.add_argument("--batch", type=int, default=64,
                    help="designs a batch on the cuda and cpu paths")
    args = ap.parse_args(argv)

    lo, hi = (float(v) for v in args.vf_range.split(","))
    families = tuple(args.families.split(","))
    t0 = time.time()
    if args.device == "host":
        samples = generate_dataset(args.n_samples, nels_per_side=args.nels_per_side,
                                   seed=args.seed, n_iter=args.n_iter, families=families,
                                   vf_range=(lo, hi))
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        for i, s in enumerate(samples):
            np.save(out / f"{args.start_index + i}.npy", s)
    else:
        from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
            generate_dataset_gpu,
        )

        samples = generate_dataset_gpu(
            args.n_samples, nels_per_side=args.nels_per_side, seed=args.seed,
            out_dir=args.out, batch=args.batch, n_iter=args.n_iter, families=families,
            vf_range=(lo, hi), start_index=args.start_index, verbose=True,
            device=args.device)
    print(f"Generated {len(samples)} mechanics samples in {time.time() - t0:.1f}s "
          f"-> {args.out}")
    return samples


if __name__ == "__main__":
    main()
