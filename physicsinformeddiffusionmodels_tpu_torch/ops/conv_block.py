"""3x3 conv -> GroupNorm -> FiLM -> SiLU, channel-major: kernel K4 (port of
``ops/pallas_conv.py``'s ``conv_gn_film_silu_cm``, its forward kernel
``_fwd_kernel`` and its backward kernel ``_bwd_kernel``).

``conv_gn_film_silu_cm`` launches the CUDA kernels for a CUDA tensor and
uses the plain PyTorch version, under plain autograd, for a CPU tensor.
Nothing else chooses between them: a CUDA tensor the kernels do not take
raises. On CUDA, when grad is enabled and an input requires it, the call
goes through an ``autograd.Function`` whose forward launches
``csrc/conv_block.cu`` (and saves the fp32 conv output z and the group
statistics it writes) and whose backward launches ``csrc/conv_block_bwd.cu``,
for fp32 and bf16 x alike. ``conv_gn_film_silu_cm.launches`` and
``.backward_launches`` count the calls that launched each,
``.bf16_launches`` and ``.bf16_backward_launches`` those of them on bf16 x.

The weight is the port's OIHW ``[Co, Ci, 3, 3]``; the kernels take the TPU
kernel's tap-major ``wflat`` ``[Co, 9 Ci]`` (``_flatten_w``: tap t = (dr +
1) * 3 + (dc + 1), column t * Ci + ci) in x's dtype, made here by a
differentiable cast and permute. So under bf16 compute dW leaves the kernel
in bf16, as the TPU kernel's VJP returns it (``dw.astype(wflat.dtype)``),
and autograd widens it through the cast to the fp32 parameter.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from physicsinformeddiffusionmodels_tpu_torch.ops import _build

# the TPU kernel's image bound (its tap views are static slices inside a
# 128-lane halo, ``pallas_conv._PADW``); the port keeps it
MAX_P = 127
# the CUDA tile reads 16 channels of one tap at a time, and the dz pass
# holds a group's channel sums in shared memory
_CHANNEL_MULTIPLE, _MAX_GROUP_CHANNELS = 16, 64


def flatten_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> tap-major [Co, 9 Ci] in ``dtype`` (differentiable)."""
    co, ci = weight.shape[:2]
    return weight.to(dtype).permute(0, 2, 3, 1).reshape(co, 9 * ci)


def conv_gn_film_silu_cm_plain(x_cm: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               gamma: torch.Tensor, beta: torch.Tensor,
                               scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                               p: int, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version (``conv_gn_film_silu_reference``): the conv of
    x and the weight rounded to x's dtype, multiplied and summed in fp32 (as
    the TPU kernel's ``_mmf`` does; the XLA reference also rounds the conv's
    output to x's dtype, a rounding this version, like the kernels, does not
    make), plus bias; two-pass GroupNorm, affine, FiLM and SiLU in fp32;
    returned in x's dtype.

    x_cm: [B, Ci, P*P] (a contiguous NCHW image); weight: [Co, Ci, 3, 3];
    bias, gamma, beta: [Co]; scale, shift: [B, Co] or None.
    """
    b, ci, n = x_cm.shape
    co = weight.shape[0]
    z = F.conv2d(x_cm.reshape(b, ci, p, p).float(), weight.to(x_cm.dtype).float(), padding=1)
    z = z.reshape(b, co, n) + bias.float()[:, None]
    zg = z.reshape(b, groups, co // groups, n)
    mean = zg.mean(dim=(2, 3), keepdim=True)
    var = ((zg - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    y = ((zg - mean) / torch.sqrt(var + eps)).reshape(b, co, n)
    y = y * gamma.float()[:, None] + beta.float()[:, None]
    if scale is not None:
        y = y * (scale.float()[:, :, None] + 1.0) + shift.float()[:, :, None]
    return (y * torch.sigmoid(y)).to(x_cm.dtype)


def _check(x, weight, bias, gamma, beta, scale, shift, p, groups) -> None:
    if x.ndim != 3 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(
            f"x_cm: expected a contiguous [B, Ci, P*P] float32/bfloat16 tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})")
    b, ci, n = x.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (ci, 3, 3) or weight.device != x.device:
        raise ValueError(f"weight: expected [Co, {ci}, 3, 3] on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    co = weight.shape[0]
    if (n != p * p or ci % _CHANNEL_MULTIPLE or co % _CHANNEL_MULTIPLE or co % groups
            or co // groups > _MAX_GROUP_CHANNELS or b * max(ci, co) * n >= 2**31):
        raise ValueError(
            f"unsupported shape: x {tuple(x.shape)}, P {p}, Co {co}, {groups} groups (the "
            f"kernels take N = P*P, Ci and Co multiples of {_CHANNEL_MULTIPLE} and at most "
            f"{_MAX_GROUP_CHANNELS} channels a group)")
    for name, t in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        _build.check_param(t, name, (co,), x.device)
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    if scale is not None:
        _build.check_param(scale, "scale", (b, co), x.device)
        _build.check_param(shift, "shift", (b, co), x.device)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _bf16(x) -> int:
    return int(x.dtype == torch.bfloat16)


def launch_forward(x, wflat, bias, gamma, beta, scale, shift, p: int, groups: int = 8,
                   eps: float = 1e-5):
    """Launch the forward kernels on checked CUDA tensors (``wflat`` [Co, 9
    Ci] in x's dtype, scale and shift fp32 [B, Co]). Returns (out, z, stats):
    the fp32 conv output plus bias [B, Co, P*P] and the (mean, rstd) of
    each (row, group) [B, G, 2], which the backward kernels read."""
    b, ci, n = x.shape
    co = wflat.shape[0]
    lib = _build.library()
    tiles = lib.pidm_conv_gn_film_silu_tiles(n)
    out = torch.empty((b, co, n), dtype=x.dtype, device=x.device)
    z = torch.empty((b, co, n), dtype=torch.float32, device=x.device)
    part = torch.empty((b, co, tiles, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    rc = lib.pidm_conv_gn_film_silu(
        x.data_ptr(), wflat.data_ptr(), bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), z.data_ptr(), part.data_ptr(),
        stats.data_ptr(), b, ci, co, p, groups, eps, _bf16(x), _stream(x))
    _build.check(rc, "conv_gn_film_silu_cm")
    conv_gn_film_silu_cm.launches += 1
    conv_gn_film_silu_cm.bf16_launches += _bf16(x)
    return out, z, stats


def launch_backward(dy, x, wflat, gamma, beta, scale, shift, z, stats, p: int,
                    groups: int = 8):
    """Launch the backward kernels with the forward's z and stats; dy and dx
    in x's dtype. Returns (dx, dwflat, dbias, dgamma, dbeta, dscale, dshift):
    dwflat in wflat's dtype (the kernels sum it in fp32), the rest fp32."""
    dy = dy.contiguous()
    b, ci, n = x.shape
    co = wflat.shape[0]
    lib = _build.library()
    # the flipped weights of the forward-form transposed conv (``_cb_bwd``):
    # wdx[ci, t Co + co] = wflat[co, t Ci + ci]
    wdx = wflat.reshape(co, 9, ci).permute(2, 1, 0).reshape(ci, 9 * co).contiguous()
    work = torch.empty(lib.pidm_conv_gn_film_silu_bwd_workspace(b, n, ci, co),
                       dtype=torch.float32, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dz = torch.empty_like(x), torch.empty((b, co, n), dtype=x.dtype, device=x.device)
    dw = torch.empty((co, 9 * ci), **f32)
    dbias, dgamma, dbeta = (torch.empty(co, **f32) for _ in range(3))
    dscale, dshift = torch.empty((b, co), **f32), torch.empty((b, co), **f32)
    rc = lib.pidm_conv_gn_film_silu_bwd(
        x.data_ptr(), wdx.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), dy.data_ptr(), z.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), dbias.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        dscale.data_ptr(), dshift.data_ptr(), dz.data_ptr(), work.data_ptr(), b, ci, co, p,
        groups, _bf16(x), _stream(x))
    _build.check(rc, "conv_gn_film_silu_cm backward")
    conv_gn_film_silu_cm.backward_launches += 1
    conv_gn_film_silu_cm.bf16_backward_launches += _bf16(x)
    return dx, dw.to(wflat.dtype), dbias, dgamma, dbeta, dscale, dshift


class _ConvGnFilmSilu(torch.autograd.Function):
    """The CUDA forward and backward kernels as one autograd node (fp32 or
    bf16 x and wflat, fp32 bias, GroupNorm parameters, scale and shift)."""

    @staticmethod
    def forward(ctx, x, wflat, bias, gamma, beta, scale, shift, p, groups, eps):
        out, z, stats = launch_forward(x, wflat, bias, gamma, beta, scale, shift, p, groups,
                                       eps)
        ctx.save_for_backward(x, wflat, gamma, beta, scale, shift, z, stats)
        ctx.p, ctx.groups = p, groups
        return out

    @staticmethod
    def backward(ctx, dy):
        return (*launch_backward(dy, *ctx.saved_tensors, ctx.p, ctx.groups), None, None, None)


def conv_gn_film_silu_cm(x_cm: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor,
                         scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                         p: int, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """The channel-major Block: conv3x3 (SAME, zero padding) + bias ->
    GroupNorm (``groups`` groups, biased variance) -> affine (gamma, beta)
    -> FiLM ``y * (scale + 1) + shift`` -> SiLU.

    x_cm: [B, Ci, P*P], row-major pixels (fp32 or bf16, contiguous); weight:
    [Co, Ci, 3, 3] (cast to x's dtype); bias, gamma, beta: [Co] fp32; scale,
    shift: [B, Co] fp32, or both None for no FiLM. Returns [B, Co, P*P] in
    x's dtype. Gradients: dx in x's dtype, the weight's through its cast to
    x's dtype, the rest fp32.
    """
    if p > MAX_P:
        raise ValueError(f"conv_gn_film_silu_cm supports p <= {MAX_P} (got p={p}), as the "
                         "TPU kernel does")
    if x_cm.device.type == "cpu":
        return conv_gn_film_silu_cm_plain(x_cm, weight, bias, gamma, beta, scale, shift, p,
                                          groups, eps)
    if x_cm.device.type != "cuda":
        raise ValueError(f"unsupported device {x_cm.device}")
    _check(x_cm, weight, bias, gamma, beta, scale, shift, p, groups)
    if scale is None:
        scale = shift = torch.zeros((x_cm.shape[0], weight.shape[0]), dtype=torch.float32,
                                    device=x_cm.device)
    args = (x_cm, flatten_weight(weight, x_cm.dtype), bias, gamma, beta, scale, shift)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_cm, weight, *args[2:])):
        return _ConvGnFilmSilu.apply(*args, p, groups, eps)
    return launch_forward(*args, p, groups, eps)[0]


conv_gn_film_silu_cm.launches = conv_gn_film_silu_cm.bf16_launches = 0
conv_gn_film_silu_cm.backward_launches = conv_gn_film_silu_cm.bf16_backward_launches = 0
