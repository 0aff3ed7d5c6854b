"""Where K4 (the channel-major conv Block: 3x3 conv + GroupNorm + FiLM +
SiLU, forward and backward) spends its time, on the card.

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_k4

At B=64 and each distinct (P, Ci, Co) of the cm UNet's K4 calls, fp32 and
bf16 x, with FiLM: the device ms of a call (CUDA-graph replay) of

- the forward with grad off (sampling), and with grad on (training: the
  autograd node's forward, which keeps what its backward reads);
- the backward alone: forward and backward through autograd, less the
  grad-on forward;
- the port's default Block at the same shape (cuDNN's conv, then K2) the
  same three ways;

beside the bound of each pass (bytes at 3.35 TB/s or operations at the
card's fp32 / dense bf16 rate, whichever is larger), the time of each K4
kernel by name under ``torch.profiler`` (eager calls), the launch plan
(``ops/conv_block.py`` ``k4_plan``: blocks a row, pixels a block, channel
chunks, shared memory, workspace), how many of its clusters the card holds
at once, and the bytes a call moves through device memory by that plan.
Then the same pass totals (forward with grad off, backward) built with each
of ``VARIANTS``, one-line edits of the sources that the design tried and
dropped, each built into a temporary directory (the variant builds compute
the same function; only their speed differs).
Prints the card's name and power limit first, one JSON line per (dtype,
shape), then the times summed over one UNet pass's calls (18 in fp32, the
first 16 under bf16 + fp32 head), then one JSON line per variant. No
options.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

from physicsinformeddiffusionmodels_tpu_torch.models.unet import Block
from physicsinformeddiffusionmodels_tpu_torch.ops import _build
from physicsinformeddiffusionmodels_tpu_torch.ops import conv_block as cb
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact
from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

B = 64
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_BF16_FLOPS = 3.35e12, 67e12, 989e12
# one cm UNet(dim=32) pass at 64x64: (P, Ci, Co) -> K4 calls in fp32, and
# under bf16 + fp32 head (whose final Block's two calls are not K4)
CALLS = {(64, 32, 32): (8, 7), (32, 32, 64): (1, 1), (32, 64, 64): (3, 3),
         (32, 128, 32): (1, 1), (32, 32, 32): (3, 3), (64, 64, 32): (2, 1)}
PROFILED_CALLS = 5
_DZ_LOOP = "#pragma unroll {}\n    for (int n = n0 + V * lane; n < n1; n += V * d.tpc) {{"
# name -> ([(source, text replaced in every place, replacement)], {wrapper
# constant: value}): what the design tried and dropped
VARIANTS = {
    "one block an SM": ([
        ("conv_block.cu", "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
        ("conv_block_bwd.cu", "__launch_bounds__(kThreads, 2)\nk4_bwd_dx_kernel",
         "__launch_bounds__(kThreads, 1)\nk4_bwd_dx_kernel")], {}),
    "dW on 264 blocks": ([("conv_tile.cuh", "kDwBlocks = 132", "kDwBlocks = 264")],
                         {"_DW_BLOCKS": 264}),
    "staging batch of 4": ([("conv_tile.cuh", "template <int kBatch = 2>",
                             "template <int kBatch = 4>")], {}),
    "dz loop unrolled 8x": ([("conv_block_bwd.cu", _DZ_LOOP.format(2), _DZ_LOOP.format(8))], {}),
}


def work(p: int, ci: int, co: int, elt: int, backward: bool) -> tuple[float, float]:
    """Bytes and flops of one call at B, with FiLM (as ``chip_smoke.py``
    ``k4_work`` / ``k4_bwd_work`` count them): forward x read, out written,
    the weight read; backward x and dy read, dx written, the weight read and
    dW written; fp32 parameters and their gradients."""
    n = p * p
    conv = 2.0 * B * n * co * 9 * ci
    if backward:
        return (elt * (B * n * (2 * ci + co) + 2 * 9 * ci * co) + 4 * (5 * co + 4 * B * co),
                2 * conv + 25.0 * B * n * co)
    return elt * (B * n * (ci + co) + 9 * ci * co) + 4 * (3 * co + 2 * B * co), conv + 10.0 * B * n * co


def bound_ms(nbytes: float, flops: float, bf16: bool) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_us(run, calls: int) -> dict:
    """Device µs a call of each kernel that ``run()`` launches, by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            us[name[:80]] += (e.time_range.end - e.time_range.start) / calls
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def plan_info(p: int, ci: int, co: int, bf16: bool) -> dict:
    """The launch plan of both passes, the clusters of the forward's plan
    that the card holds at once, and the bytes each pass moves by the plan."""
    elt = 2 if bf16 else 4
    out = {}
    for backward in (False, True):
        plan = cb.k4_plan(B, p, ci, co, elt, backward)
        out["bwd" if backward else "fwd"] = {
            **plan._asdict(), "clusters_at_once": cb.max_clusters(plan, bf16, backward),
            "bytes_no_grad": cb.k4_bytes(plan, B, p, ci, co, elt, backward, save=False),
            "bytes_grad": cb.k4_bytes(plan, B, p, ci, co, elt, backward, save=True)}
    return out


def profile(dev: torch.device) -> list[dict]:
    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for (p, ci, co), calls in CALLS.items():
            def rnd(*shape, scale=1.0, shift=0.0):
                return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

            x = rnd(B, ci, p * p).to(dtype)
            w = rnd(co, ci, 3, 3, scale=(9 * ci) ** -0.5)
            params = [rnd(co, scale=0.1), rnd(co, scale=0.1, shift=1.0), rnd(co, scale=0.1)]
            film = [rnd(B, co, scale=0.1), rnd(B, co, scale=0.1)]
            dy = torch.randn(B, co, p * p, generator=gen).to(dev, dtype)
            leaves = [t.clone().requires_grad_(True) for t in (x, w, *params, *film)]

            def k4_no_grad():
                with torch.no_grad():
                    return cb.conv_gn_film_silu_cm(x, w, *params, *film, p)

            def k4_grad():
                return cb.conv_gn_film_silu_cm(*leaves, p)

            def k4_fwd_bwd():
                return torch.autograd.grad(k4_grad(), leaves, dy)

            block = Block(ci, co, dtype=None if not bf16 else dtype).to(dev)
            block.load_state_dict({"weight": w, "bias": params[0], "gn_scale": params[1],
                                   "gn_bias": params[2]})
            x_nhwc = x.transpose(1, 2).reshape(B, p, p, ci).contiguous().requires_grad_(True)
            dy_nhwc = dy.transpose(1, 2).reshape(B, p, p, co).contiguous()
            block_leaves = [x_nhwc, *block.parameters()]

            def block_no_grad():
                with torch.no_grad():
                    return block(x_nhwc, tuple(film))

            def block_fwd_bwd():
                return torch.autograd.grad(block(x_nhwc, tuple(film)), block_leaves, dy_nhwc)

            fwd_grad = graph_ms(k4_grad)
            default_grad = graph_ms(lambda: block(x_nhwc, tuple(film)))
            elt = 2 if bf16 else 4
            fb, fb_by = bound_ms(*work(p, ci, co, elt, False), bf16)
            bb, bb_by = bound_ms(*work(p, ci, co, elt, True), bf16)
            row = {
                "dtype": "bf16" if bf16 else "fp32", "p": p, "ci": ci, "co": co,
                "calls": calls[1] if bf16 else calls[0],
                "fwd_ms": graph_ms(k4_no_grad), "fwd_grad_ms": fwd_grad,
                "bwd_ms": graph_ms(k4_fwd_bwd, reps=5) - fwd_grad,
                "default_fwd_ms": graph_ms(block_no_grad), "default_fwd_grad_ms": default_grad,
                "default_bwd_ms": graph_ms(block_fwd_bwd, reps=5) - default_grad,
                "fwd_bound_ms": fb, "fwd_bound_by": fb_by,
                "bwd_bound_ms": bb, "bwd_bound_by": bb_by,
                "fwd_kernels_us": kernel_us(k4_no_grad, PROFILED_CALLS),
                "fwd_bwd_kernels_us": kernel_us(k4_fwd_bwd, PROFILED_CALLS),
                # None with a wrapper that has no launch plan (earlier kernels)
                "plan": plan_info(p, ci, co, bf16) if hasattr(cb, "k4_plan") else None,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, dy, leaves, block, x_nhwc, dy_nhwc, block_leaves
    return rows


def pass_ms(dev: torch.device) -> dict:
    """Device ms of one UNet pass's K4 calls (as ``profile``'s totals),
    forward with grad off and backward, fp32 and bf16."""
    gen = torch.Generator().manual_seed(0)
    totals = defaultdict(float)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for (p, ci, co), calls in CALLS.items():
            def rnd(*shape, scale=1.0, shift=0.0):
                return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

            args = [rnd(B, ci, p * p).to(dtype), rnd(co, ci, 3, 3, scale=(9 * ci) ** -0.5),
                    rnd(co, scale=0.1), rnd(co, scale=0.1, shift=1.0), rnd(co, scale=0.1),
                    rnd(B, co, scale=0.1), rnd(B, co, scale=0.1)]
            dy = torch.randn(B, co, p * p, generator=gen).to(dev, dtype)
            leaves = [t.requires_grad_(True) for t in args]
            with torch.no_grad():
                fwd = graph_ms(lambda: cb.conv_gn_film_silu_cm(*args, p))
            fwd_grad = graph_ms(lambda: cb.conv_gn_film_silu_cm(*leaves, p))
            both = graph_ms(lambda: torch.autograd.grad(cb.conv_gn_film_silu_cm(*leaves, p),
                                                        leaves, dy), reps=5)
            n = calls[1] if bf16 else calls[0]
            key = "bf16" if bf16 else "fp32"
            totals[f"{key} fwd_ms"] += n * fwd
            totals[f"{key} bwd_ms"] += n * (both - fwd_grad)
    return dict(totals)


def profile_variants(dev: torch.device) -> None:
    """pass_ms as built and with each of VARIANTS, one JSON line each."""
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, (edits, consts) in {"as built": ([], {}), **VARIANTS}.items():
                src = Path(tmp) / name.replace(" ", "_") / "csrc"
                src.mkdir(parents=True)
                for f in csrc.iterdir():
                    text = f.read_text()
                    for source, old, new in edits:
                        if f.name == source:
                            if old not in text:
                                raise RuntimeError(f"{name}: {old!r} is not in {source}")
                            text = text.replace(old, new)
                    (src / f.name).write_text(text)
                saved = {k: getattr(cb, k) for k in consts}
                for k, v in consts.items():
                    setattr(cb, k, v)
                _build.CSRC, _build.BUILD_DIR = src, src.parent / "build"
                _build.build.cache_clear()
                _build.library.cache_clear()
                cb._plan.cache_clear()
                try:
                    print(json.dumps({"variant": name, "ms_at_one_pass": pass_ms(dev)}),
                          flush=True)
                finally:
                    for k, v in saved.items():
                        setattr(cb, k, v)
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build.build.cache_clear()
        _build.library.cache_clear()
        cb._plan.cache_clear()


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_fp32_exact()
    dev = torch.device("cuda")
    rows = profile(dev)
    totals = defaultdict(float)
    for r in rows:
        for k in ("fwd_ms", "fwd_grad_ms", "bwd_ms", "default_fwd_ms", "default_fwd_grad_ms",
                  "default_bwd_ms", "fwd_bound_ms", "bwd_bound_ms"):
            totals[f"{r['dtype']} {k}"] += r["calls"] * r[k]
    print(json.dumps({"ms_at_one_pass": totals, "card": smi}), flush=True)
    profile_variants(dev)


if __name__ == "__main__":
    main()
