"""Where the device time of Darcy sampling goes, on the card.

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_sampling \\
        [--model-dir results/darcy_300k_fp32head/portable] [--no-samples 64]

Runs the main path's sampling (``sample_eval.sample_darcy``: every ancestral
step and the residual of the result) once to warm up, then once more under
``torch.profiler``, fp32, and prints per step: the wall time (host clock
around synchronised work), the device busy time and idle share of that
window, and the device time by kernel group (K1, K2, K4, convolutions,
matmuls, other) and by kernel name. The last line is the same as one JSON object.
Fails if the profiler saw no device work.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from physicsinformeddiffusionmodels_tpu_torch.sample_eval import load_run, sample_darcy
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("K1 linear attention bwd", ("lab_bwd",)),
    ("K2 group norm bwd", ("gn_bwd",)),
    ("K1 linear attention", ("lab_fwd",)),
    ("K2 group norm", ("gn_fwd_kernel",)),
    ("K4 conv block bwd", ("k4_bwd_dz_kernel", "k4_bwd_dw_kernel", "k4_bwd_dx_kernel")),
    ("K4 conv block", ("k4_fwd_kernel",)),
    ("convolutions", ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad", "wgrad",
                      "winograd", "fft")),
    ("matmuls", ("gemm", "cutlass", "cublas", "matmul")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def device_profile(run, steps: int) -> dict:
    """Run ``run()`` (which ends in device work) once under
    ``torch.profiler`` and split its device time into ``steps`` steps:
    wall and busy time, idle share, time by kernel group and by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the ranges that record_function annotations (such
    # as the optimizer's step) project onto the device timeline
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        by_group[_group(e.name)] += us
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    return {
        "device": torch.cuda.get_device_name(0), "steps": steps,
        "wall_ms_per_step": wall_ms / steps, "busy_ms_per_step": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "groups_ms_per_step": {g: us / 1e3 / steps for g, us in
                               sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {n[:120]: us / 1e3 / steps for n, us in
                                    sorted(by_name.items(), key=lambda kv: -kv[1])[:25]},
    }


def report(r: dict, what: str) -> None:
    """Print a profile: the summary line, the groups and kernels, then JSON."""
    print(f"{r['device']}: {what}, {r['steps']} steps: "
          f"{r['wall_ms_per_step']:.3f} ms/step wall, {r['busy_ms_per_step']:.3f} ms busy, "
          f"idle share {r['idle_share']:.3f}")
    for section in ("groups_ms_per_step", "top_kernels_ms_per_step"):
        for name, ms in r[section].items():
            print(f"  {ms:9.4f} ms/step  {name}")
    print(json.dumps(r))


def profile(model_dir: str, no_samples: int) -> dict:
    dev = torch.device("cuda")
    set_fp32_exact()
    cfg, model, _ = load_run(model_dir, compute_dtype="float32", device=dev)
    sample_darcy(cfg, model, no_samples, 0, dev)  # warm-up: kernel build, cuDNN choice
    torch.cuda.synchronize()
    r = device_profile(lambda: sample_darcy(cfg, model, no_samples, 1, dev), cfg.diff_steps)
    return {**r, "no_samples": no_samples}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="results/darcy_300k_fp32head/portable")
    ap.add_argument("--no-samples", type=int, default=64)
    args = ap.parse_args(argv)
    report(profile(args.model_dir, args.no_samples), f"{args.no_samples} samples")


if __name__ == "__main__":
    main()
