"""Device time of linear attention at the Darcy level-0 shape, on the card
(port of ``scripts/profile_attn.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_attn

B=64, 64x64, C=32, fp32 with TF32 off, with the JAX script's seeded
weights (normal x 0.05; LN scale 1, biases 0). Each form's device time per
call comes from replaying 20 calls captured in one CUDA graph:
  * pre-norm attention through K3: ``PreNormResidual(SpatialLinearAttention)``,
    LN (PyTorch) -> K3 -> + b_out + x;
  * the same through K3's plain PyTorch version;
  * K1, the fused pre-norm block (``LinearAttentionBlock``);
  * the level-0 stage, two resnet blocks of 3x3 conv + K2 (GroupNorm-SiLU,
    no FiLM) and then the attention, with K3 and with K1: forward, and
    forward + backward (the gradients of x, the conv kernel and the
    attention module's parameters);
and K3's kernel and plain version, forward and forward + backward, at every
(N, C) of one UNet(dim=32) forward's attention calls at B=64 (unit-scale
inputs). Prints a line per form; the last line is one JSON object.
"""

from __future__ import annotations

import json
import subprocess

import torch

from physicsinformeddiffusionmodels_tpu_torch.models.unet import (
    LinearAttentionBlock,
    PreNormResidual,
    SpatialLinearAttention,
    _conv,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention,
    linear_attention_plain,
)
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact
from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

B, P, C = 64, 64, 32
H = 8 * 32
# the distinct (N, C) of one UNet(dim=32) forward's attention calls at 64x64
SHAPES = [(4096, 32), (1024, 64), (256, 128), (64, 256), (64, 128), (256, 64), (1024, 32)]


def _weights(dev: torch.device) -> dict:
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return {"x": randn(B, P, P, C), "w": randn(C, C, 3, 3, scale=0.05),
            "bias": torch.zeros(C, device=dev), "gamma": torch.ones(C, device=dev),
            "beta": torch.zeros(C, device=dev), "w_qkv": randn(C, 3 * H, scale=0.05),
            "w_out": randn(H, C, scale=0.05), "b_out": torch.zeros(C, device=dev)}


def _forms(p: dict) -> dict:
    """The attention forms and the stage, as functions of an NHWC map, with
    the weights ``p``. The K3 and K1 forms are modules; the stage takes the
    conv kernel as its second argument."""
    k3 = PreNormResidual(C, SpatialLinearAttention(C)).to(p["x"].device)
    k3.load_state_dict({"ChannelLayerNorm_0.gamma": p["gamma"], "fn.w_qkv": p["w_qkv"],
                        "fn.w_out": p["w_out"], "fn.b_out": p["b_out"]})
    k1 = LinearAttentionBlock(C).to(p["x"].device)
    k1.load_state_dict({"ln_gamma": p["gamma"], "w_qkv": p["w_qkv"], "w_out": p["w_out"],
                        "b_out": p["b_out"]})

    def attn_plain(h):
        t = h.reshape(B, -1, C)
        mu = t.mean(dim=-1, keepdim=True)
        var = t.var(dim=-1, unbiased=False, keepdim=True)
        ln = (t - mu) / torch.sqrt(var + 1e-5) * p["gamma"]
        return (linear_attention_plain(ln, p["w_qkv"], p["w_out"]) + p["b_out"]).reshape(
            h.shape) + h

    def conv_gn(h, w):
        y = _conv(h, w, p["bias"], None, 1, 1)
        return group_norm_film_silu(y.reshape(B, -1, C), p["gamma"], p["beta"]).reshape(h.shape)

    def stage(attn):
        def f(h, w=p["w"]):
            a = conv_gn(conv_gn(h, w), w) + h
            return attn(conv_gn(conv_gn(a, w), w) + a)
        return f

    return {"k3": k3, "plain": attn_plain, "k1": k1,
            "stage_k3": stage(k3), "stage_k1": stage(k1), "stage_plain": stage(attn_plain)}


def _grad_inputs(dev: torch.device, p: dict) -> tuple:
    """x and the conv kernel as leaves that require grad, and the stage's
    output gradient."""
    x, w = (p[k].detach().clone().requires_grad_(True) for k in ("x", "w"))
    dy = torch.randn(p["x"].shape, generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    return x, w, dy


def _stage_grad(forms: dict, name: str, x, w, dy):
    """Forward + backward of one stage: the gradients of x, the conv kernel
    and the attention module's parameters."""
    leaves = [x, w, *forms[name[len("stage_"):]].parameters()]
    return torch.autograd.grad(forms[name](x, w), leaves, dy)


def stage_run(dev: torch.device) -> dict:
    """One eager forward of the level-0 stage through K3, then one eager
    forward + backward: the main path of K3, outside any graph capture.
    Returns the forward output beside the plain version's and K1's, and the
    gradients."""
    p = _weights(dev)
    forms = _forms(p)
    with torch.no_grad():
        out = {name: forms[name](p["x"]) for name in ("stage_k3", "stage_plain", "stage_k1")}
    out["grads_k3"] = _stage_grad(forms, "stage_k3", *_grad_inputs(dev, p))
    return out


def stage_times(dev: torch.device) -> dict:
    """Device ms per call of the level-0 stage with K3 and with K1, forward
    and forward + backward."""
    p = _weights(dev)
    forms = _forms(p)
    grad_inputs = _grad_inputs(dev, p)
    out = {}
    for name in ("stage_k3", "stage_k1"):
        with torch.no_grad():
            out[f"{name}_fwd_ms"] = graph_ms(lambda: forms[name](p["x"]))
        out[f"{name}_fwd_bwd_ms"] = graph_ms(lambda: _stage_grad(forms, name, *grad_inputs))
    return out


def attention_times(dev: torch.device) -> dict:
    """Device ms per call of the three pre-norm attention forms (forward)."""
    p = _weights(dev)
    forms = _forms(p)
    with torch.no_grad():
        return {f"attn_{k}_fwd_ms": graph_ms(lambda: forms[k](p["x"]))
                for k in ("k3", "plain", "k1")}


def shape_times(dev: torch.device) -> list[dict]:
    """K3 and its plain version at B=64 at every (N, C) of ``SHAPES``."""
    gen = torch.Generator().manual_seed(2)
    rows = []
    for n, c in SHAPES:
        args = [(torch.randn(*s, generator=gen) * sc).to(dev)
                for s, sc in (((B, n, c), 1.0), ((c, 3 * H), c**-0.5), ((H, c), H**-0.5))]
        dy = torch.randn(B, n, c, generator=gen).to(dev)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        row = {"n": n, "c": c}
        for name, fn in (("k3", linear_attention), ("plain", linear_attention_plain)):
            with torch.no_grad():
                row[f"{name}_fwd_ms"] = graph_ms(lambda: fn(*args))
            row[f"{name}_fwd_bwd_ms"] = graph_ms(
                lambda: torch.autograd.grad(fn(*leaves), leaves, dy), reps=5)
        rows.append(row)
        del args, leaves, dy
    return rows


def main() -> None:
    dev = torch.device("cuda")
    set_fp32_exact()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"device": smi, "batch": B, **attention_times(dev), **stage_times(dev)}
    for k, v in report.items():
        if k.endswith("_ms"):
            print(f"{k:28s} {v:9.3f}", flush=True)
    report["shapes"] = shape_times(dev)
    for row in report["shapes"]:
        print(json.dumps(row), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
