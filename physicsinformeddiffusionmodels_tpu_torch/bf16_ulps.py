"""Kernel and plain version on the same bf16 inputs, each held against a
float64 evaluation of those inputs, in bf16 ulps.

    python -m physicsinformeddiffusionmodels_tpu_torch.bf16_ulps [--seeds 5]

Two checks of ``chip_smoke.py`` failed once their inputs changed (PR 13):
phase 10's K3 bf16 check at (N, C) = (64, 256), B = 64 (allclose 1e-2
against the plain version), and phase 13a's bf16 rule on
``final_block.res_bias``. This script tells a fault of the kernel from a
limit tighter than the rounding: for each seed it measures how far the
kernel's result and the plain version's lie from float64, in units of the
bf16 spacing (ulp) at the float64 value, and whether the kernel lies more
than twice as far as the plain version (a fault).

  1. K3 (linear attention) forward on bf16 x, phase 10's input scales, at
     B = 64, (64, 256); float64 on the card.
  2. One bf16 + fp32-head training step of the committed 300k EMA weights at
     B = 8 (phase 13a) on the card, through the kernels and through the
     plain versions of K1 and K2 (every other operation the same), and on
     the CPU (plain versions: the other side of 13a's rule), each against the
     same step in float64 on the CPU (the UNet's
     parameters and activations, K1 and K2 in float64; the time-embedding
     MLP, the FiLM scale and shift and the finite-difference residual stay
     float32 in the port's code, a rounding 2^16 times finer than a bf16
     ulp). The batches: 64 fields of the port's Darcy generator (seed 1),
     drawn by ``np.random.default_rng(seed)`` as 13a draws them, seeds 13 on.
     Every parameter's gradient is measured; ``final_block.res_bias`` is
     printed in full, with 13a's rule (STEP_BF16_EACH) on it.

Each result is one JSON line; the last line is the verdict of both parts.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

RUN = Path(__file__).resolve().parent.parent / "results" / "darcy_300k_fp32head" / "portable"
# chip_smoke.py: K1_GAIN, and 13a's per-parameter rule (k x the card's own
# bf16 rounding + floor x the CPU gradient's norm)
K1_GAIN = 100.0
STEP_BF16_EACH = (6, 1e-3)
FAULT_RATIO = 2.0


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers (8 significant bits) at |ref|."""
    _, e = torch.frexp(ref.double().abs().clamp(min=2.0**-126))
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float64), e - 8)


def distance(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``got``'s distance from the float64 ``ref``: the largest error in bf16
    ulps at the tensor's largest |ref| (``ulps_at_max``), the largest and
    mean error in ulps at each entry's own |ref| (large where ref is near
    zero), the share of entries more than one own ulp off, and the L2
    distance relative to |ref|."""
    ref = ref.double()
    err = (got.double() - ref).abs()
    ulps = err / bf16_ulp(ref)
    return {"ulps_at_max": (err.max() / bf16_ulp(ref.abs().max())).item(),
            "max_abs_err": err.max().item(), "max_ulps": ulps.max().item(),
            "mean_ulps": ulps.mean().item(), "over_1_ulp": (ulps > 1).double().mean().item(),
            "rel_l2": (err.norm() / ref.norm().clamp(min=1e-300)).item()}


def verdict(kernel: dict, plain: dict) -> dict:
    """The kernel is at fault when it lies more than FAULT_RATIO times as far
    from float64 as the plain version (L2)."""
    ratio = kernel["rel_l2"] / max(plain["rel_l2"], 1e-300)
    return {"l2_ratio": ratio, "max_ulps_ratio": kernel["max_ulps"] / max(plain["max_ulps"], 1e-30),
            "fault": ratio > FAULT_RATIO}


def attention64(x, w_qkv, w_out, heads: int = 8, dim_head: int = 32):
    """LA(x) of ``ops/linear_attention.py``'s plain version, in float64."""
    x, w_qkv, w_out = x.double(), w_qkv.double(), w_out.double()
    b, n, _ = x.shape
    h = heads * dim_head
    q, k, v = (x @ w_qkv).split(h, dim=-1)
    q = q.reshape(b, n, heads, dim_head).softmax(dim=-1) * dim_head**-0.5
    k = k.reshape(b, n, heads, dim_head).softmax(dim=1)
    v = v.reshape(b, n, heads, dim_head) / n
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    return torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(b, n, h) @ w_out


def block64(x, gamma, w_qkv, w_out, b_out, heads=8, dim_head=32, eps=1e-5, channel_major=False):
    """K1 in float64: x + b_out + LA(LN_gamma(x))."""
    assert not channel_major
    x = x.double()
    mu, var = x.mean(dim=-1, keepdim=True), x.var(dim=-1, unbiased=False, keepdim=True)
    ln = (x - mu) / torch.sqrt(var + eps) * gamma.double()
    return attention64(ln, w_qkv, w_out, heads, dim_head) + b_out.double() + x


def group_norm64(x, gamma, beta, scale=None, shift=None, groups=8, eps=1e-5):
    """K2 in float64: GroupNorm -> affine -> FiLM -> SiLU."""
    shape, b, c = x.shape, x.shape[0], x.shape[-1]
    xg = x.double().reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, -1, c) * gamma.double() + beta.double()
    if scale is not None:
        y = y * (scale.double()[:, None, :] + 1.0) + shift.double()[:, None, :]
    return (y * torch.sigmoid(y)).reshape(shape)


@contextlib.contextmanager
def unet_kernels(block, group_norm):
    """The UNet's K1 and K2 calls through ``block`` and ``group_norm``."""
    from physicsinformeddiffusionmodels_tpu_torch.models import unet

    saved = unet.linear_attention_block, unet.group_norm_film_silu
    unet.linear_attention_block, unet.group_norm_film_silu = block, group_norm
    try:
        yield
    finally:
        unet.linear_attention_block, unet.group_norm_film_silu = saved


def k3_part(seeds, dev) -> list[dict]:
    from physicsinformeddiffusionmodels_tpu_torch.ops import linear_attention as la

    b, n, c = 64, 64, 256
    rows = []
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(b, n, c, generator=g).to(dev).bfloat16()
        w_qkv = (torch.randn(c, 768, generator=g) * c**-0.5).to(dev)
        w_out = (torch.randn(256, c, generator=g) * K1_GAIN * n * 256**-0.5).to(dev)
        kernel = la.linear_attention(x, w_qkv, w_out)
        plain = la.linear_attention_plain(x, w_qkv, w_out)
        ref = attention64(x, w_qkv, w_out)
        dk, dp = distance(kernel, ref), distance(plain, ref)
        rows.append({"part": "K3 bf16 (64, 256) B=64", "seed": seed, "kernel": dk, "plain": dp,
                     **verdict(dk, dp),
                     "phase10_check_passes": bool(torch.allclose(kernel.float(), plain.float(),
                                                                 atol=1e-2, rtol=1e-2)),
                     "kernel_vs_plain_max_abs": (kernel.float() - plain.float()).abs().max().item(),
                     "max_abs_output": ref.abs().max().item()})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _plain_block(plain):
    """K1's plain version with the wrapper's ``channel_major`` argument."""
    def block(x, *args, channel_major=False):
        assert not channel_major
        return plain(x, *args)

    return block


def _grads(loss_fn, model, batch, t, noise) -> dict:
    params = [(name, p) for name, p in model.named_parameters()]
    loss, _ = loss_fn(model, batch, t, noise)
    grads = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
    return {name: g.detach().cpu() for (name, _), g in zip(params, grads) if g is not None}


def step_part(seeds, dev, data_dir: Path) -> list[dict]:
    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
        group_norm_film_silu_plain)
    from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
        linear_attention_block_plain)
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    ds = load_darcy_dataset(data_dir)
    models = {(dtype, str(d)): sample_eval.load_run(RUN, compute_dtype=dtype, device=d)[1].train()
              for dtype in ("bfloat16", "float32") for d in (dev, "cpu")}
    cfg = sample_eval.load_run(RUN, device="cpu")[0]
    model64 = models["float32", "cpu"].double()
    sched = create_schedule(cfg.diff_steps)
    loss_fns = {str(d): train.build_darcy_loss_fn(sched, train.make_physics(cfg, d), cfg)
                for d in (dev, "cpu")}
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        idx, t = rng.integers(0, len(ds), 8), torch.from_numpy(rng.integers(0, cfg.diff_steps, 8))
        batch = torch.from_numpy(ds.stacked()[idx])
        noise = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
        on_dev = (batch.to(dev), t.to(dev), noise.to(dev))
        g_card = _grads(loss_fns[str(dev)], models["bfloat16", str(dev)], *on_dev)
        with unet_kernels(_plain_block(linear_attention_block_plain),
                          group_norm_film_silu_plain):
            g_plain = _grads(loss_fns[str(dev)], models["bfloat16", str(dev)], *on_dev)
        g_card32 = _grads(loss_fns[str(dev)], models["float32", str(dev)], *on_dev)
        g_cpu = _grads(loss_fns["cpu"], models["bfloat16", "cpu"], batch, t, noise)
        with unet_kernels(block64, group_norm64):
            g64 = _grads(loss_fns["cpu"], model64, batch.double(), t, noise.double())
        per_tensor = {}
        for name, ref in g64.items():
            dk, dp = distance(g_card[name], ref), distance(g_plain[name], ref)
            per_tensor[name] = (dk, dp, verdict(dk, dp))
        worst = max(per_tensor, key=lambda k: per_tensor[k][2]["l2_ratio"])
        name = "final_block.res_bias"
        dk, dp, v = per_tensor[name]
        dc = distance(g_cpu[name], g64[name])
        k, floor = STEP_BF16_EACH
        err = (g_card[name] - g_cpu[name]).norm().item()
        lim = k * (g_card[name] - g_card32[name]).norm().item() + floor * g_cpu[name].norm().item()
        rows.append({
            "part": "13a bf16 step, final_block.res_bias", "seed": seed, "kernel": dk,
            "plain": dp, **v, "cpu": dc, "card_over_cpu_l2": dk["rel_l2"] / dc["rel_l2"],
            "rule_13a": {"card_vs_cpu_l2": err, "limit": lim,
                                            "passes": err <= lim},
            "tensors": len(per_tensor),
            "tensors_kernel_over_2x_plain": sorted(n for n, r in per_tensor.items()
                                                   if r[2]["fault"]),
            "worst_tensor": {"name": worst, "l2_ratio": per_tensor[worst][2]["l2_ratio"],
                             "kernel": per_tensor[worst][0], "plain": per_tensor[worst][1]},
            "whole_gradient": verdict(
                distance(torch.cat([g_card[n].flatten() for n in g64]),
                         torch.cat([g.flatten() for g in g64.values()])),
                distance(torch.cat([g_plain[n].flatten() for n in g64]),
                         torch.cat([g.flatten() for g in g64.values()])))})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_ulps: needs a CUDA card", file=sys.stderr)
        return 2
    from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

    set_fp32_exact()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    k3 = k3_part(range(a.seeds), dev)
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([sys.executable, "-m",
                        "physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator",
                        "--n-samples", "64", "--out", f"{tmp}/train", "--seed", "1",
                        "--workers", "8"], check=True, capture_output=True)
        steps = step_part(range(13, 13 + a.seeds), dev, Path(tmp) / "train")
    print(json.dumps({"k3_faults": sum(r["fault"] for r in k3),
                      "k3_phase10_failures": sum(not r["phase10_check_passes"] for r in k3),
                      "res_bias_faults": sum(r["fault"] for r in steps),
                      "rule_13a_failures": sum(not r["rule_13a"]["passes"] for r in steps),
                      "seeds": a.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
