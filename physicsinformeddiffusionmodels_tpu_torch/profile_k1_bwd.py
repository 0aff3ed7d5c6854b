"""Where K1's backward kv pass spends its time, on the card.

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_k1_bwd

Times ``lab_bwd_kv`` (``csrc/linear_attention_bwd.cu``, pass 3) as built,
and built with each of its per-tile trips through L2 taken out, one at a
time and then all together. Those builds compute wrong gradients: they only
show what each trip costs. Each variant is a one-line edit of the source,
built into a temporary directory:
  * ``dw_rmw``: the block's dW_qkv partial written on the range's last tile
    only, not read and rewritten on every tile;
  * ``w_restage``: W_q, W_k and W_v staged on the range's first tile only;
  * ``wt_restage``: the W^T slices of dxln staged on the first tile only;
  * ``m_restage``: the M^T slice of dP staged on the first tile only;
  * ``all``: the four together.
Prints the card's name and power limit, then the device ms of
``lab_bwd_kv`` per call (``torch.profiler``, 5 calls after one warm-up) at
B=64, fp32 and bf16 x, at (N, C) = (4096, 32) and (256, 128): one JSON line
per variant.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
from pathlib import Path

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import _build
from physicsinformeddiffusionmodels_tpu_torch.ops import linear_attention as la

SOURCE = "linear_attention_bwd.cu"
FIRST = "tile == plan.begin(r)"
VARIANTS = {
    "dw_rmw": [
        ("const bool first = tile == plan.begin(r);", "const bool first = true;"),
        ("          at[q] = make_float4(gq[0], gq[1], gq[2], gq[3]);",
         "          if (tile + 1 == plan.begin(r + 1))\n"
         "            at[q] = make_float4(gq[0], gq[1], gq[2], gq[3]);")],
    "w_restage": [
        ("w_qkv + sec * kH, n0, rows, C, true);",
         f"w_qkv + sec * kH, n0, rows, C, {FIRST} && sec == 0);")],
    "wt_restage": [
        ("        stage<kKC, kH>(u, kLdWt,",
         f"        if ({FIRST} && sec == 0) stage<kKC, kH>(u, kLdWt,")],
    "m_restage": [
        ("      stage<kH, kKC>(u, kLdMt,", f"      if ({FIRST}) stage<kH, kKC>(u, kLdMt,")],
}
VARIANTS["all"] = [edit for edits in VARIANTS.values() for edit in edits]
CALLS = [(4096, 32), (256, 128)]


def _load(name: str, csrc: Path, root: Path) -> None:
    """Build and load the library from a copy of ``csrc`` with the
    variant's edits."""
    src = root / name / "csrc"
    src.mkdir(parents=True)
    for f in csrc.iterdir():
        text = f.read_text()
        if f.name == SOURCE:
            for old, new in VARIANTS.get(name, []):
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} is not once in {SOURCE}")
                text = text.replace(old, new)
        (src / f.name).write_text(text)
    _build.CSRC, _build.BUILD_DIR = src, src.parent / "build"
    _build.build.cache_clear()
    _build.library.cache_clear()
    _build.library()


def _kv_ms(dtype: torch.dtype, n: int, c: int, gen: torch.Generator) -> float:
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    args = [randn(64, n, c).to(dtype), randn(c, scale=0.1, shift=1.0),
            randn(c, 768, scale=c**-0.5), randn(256, c, scale=100.0 * n / 16),
            randn(c, scale=0.1)]
    saved = la.launch_forward(*args)[1:]
    dy = randn(64, n, c).to(dtype)
    la.launch_backward(dy, *args[:4], *saved)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            la.launch_backward(dy, *args[:4], *saved)
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if "lab_bwd_kv" in e.key)
    return us / 5 / 1e3


def main() -> None:
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name in ["as built", *VARIANTS]:
                _load(name.replace(" ", "_"), csrc, Path(tmp))
                gen = torch.Generator().manual_seed(0)
                row = {f"{dtype} {call}": round(_kv_ms(dtype, *call, gen), 4)
                       for dtype in (torch.float32, torch.bfloat16) for call in CALLS}
                print(json.dumps({"variant": name, "lab_bwd_kv_ms": row}), flush=True)
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build.build.cache_clear()
        _build.library.cache_clear()


if __name__ == "__main__":
    main()
