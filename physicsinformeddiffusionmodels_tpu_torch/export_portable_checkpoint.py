"""Export a trained run as a small, portable eval checkpoint (port of
``scripts/export_portable_checkpoint.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.export_portable_checkpoint \\
        --model-dir trained_models/darcy --out results/darcy/portable [--step N]

Writes a run directory, ``config.json`` plus ``model/checkpoint_<step>.msgpack``,
that holds the EMA weights only (the raw weights when the run has no EMA),
cast to float16, and no optimizer state: ``sample_eval --model-dir <out>``
of either package loads it (float16 leaves come back as float32), but it
cannot resume training. A portable directory holds one checkpoint: stale
``checkpoint_*.msgpack`` files there are removed. The file is byte for byte
the JAX script's export of the same checkpoint: every floating leaf in
float16 (a bfloat16 leaf, which numpy does not count as floating, keeps its
dtype and bytes), scalars as 0-d arrays, dict keys sorted at every level.
Runs on the CPU, and on the machine that trained the run, which has no JAX.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import numpy as np

from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    RawArray,
    latest_checkpoint,
    msgpack_restore,
    msgpack_serialize,
)


def cast_tree_f16(tree):
    """Every floating leaf as float16, every other leaf as a numpy array (a
    ``RawArray`` as it is), as the JAX script's ``tree_map`` leaves them;
    the keys come out sorted (``msgpack_serialize`` writes them so)."""
    if isinstance(tree, dict):
        return {k: cast_tree_f16(v) for k, v in tree.items()}
    if isinstance(tree, RawArray):
        return tree
    x = np.asarray(tree)
    return x.astype(np.float16) if np.issubdtype(x.dtype, np.floating) else x


def export(model_dir: Path, out: Path, step: int | None) -> Path:
    """Export ``model_dir``'s checkpoint at ``step`` (None: the latest) to
    ``out``; returns the written checkpoint's path."""
    model_dir, out = Path(model_dir), Path(out)
    ckpt_dir = model_dir / "model"
    path = (ckpt_dir / f"checkpoint_{step}.msgpack" if step is not None
            else latest_checkpoint(ckpt_dir))
    if path is None or not Path(path).exists():
        sys.exit(f"no checkpoint under {ckpt_dir}")
    raw = msgpack_restore(Path(path).read_bytes(), keep_bfloat16=True)
    ema = raw.get("ema_params") or raw["params"]
    step_out = int(raw.get("step", 0))
    payload = {"step": step_out, "params": {}, "ema_params": cast_tree_f16(ema),
               "opt_state": {}}
    (out / "model").mkdir(parents=True, exist_ok=True)
    for stale in (out / "model").glob("checkpoint_*.msgpack"):
        stale.unlink()
    dst = out / "model" / f"checkpoint_{step_out}.msgpack"
    dst.write_bytes(msgpack_serialize(payload))
    shutil.copy2(model_dir / "config.json", out / "config.json")
    print(f"exported {path} (step {step_out}) -> {dst} "
          f"({dst.stat().st_size / 1e6:.1f} MB, float16 EMA-only)")
    return dst


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    return export(Path(args.model_dir), Path(args.out), args.step)


if __name__ == "__main__":
    main()
