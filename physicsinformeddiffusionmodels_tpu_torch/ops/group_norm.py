"""GroupNorm -> FiLM -> SiLU: kernel K2 (port of ``ops/pallas_kernels.py``'s
forward kernel and its backward ``_gn_bwd``) and kernel K5, the lane-packed
bf16 forward of ``scripts/profile_gn.py``.

``group_norm_film_silu`` launches the CUDA kernels for a CUDA tensor and
uses the plain PyTorch version, under plain autograd, for a CPU tensor.
Nothing else chooses between them: a CUDA tensor the kernels do not take
raises. On CUDA, when grad is enabled and an input requires it, the call
goes through an ``autograd.Function`` whose forward launches
``csrc/group_norm.cu`` and whose backward launches
``csrc/group_norm_bwd.cu``, for fp32 and bf16 x alike.
``group_norm_film_silu.launches`` and ``.backward_launches`` count the calls
that launched each, ``.bf16_launches`` and ``.bf16_backward_launches`` those
of them on bf16 x.

``group_norm_film_silu_packed`` (K5, ``csrc/group_norm_packed.cu``) computes
the same function on bf16 x with the affine and FiLM folded into one scale
and shift per (row, channel) and the one-pass variance E[x^2] - mean^2. It
is forward only, as the TPU kernel is; no model calls it. Its launches are
counted in ``group_norm_film_silu_packed.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import _build

_STATS_CHUNK = 4096  # group elements per block of the statistics pass


def group_norm_film_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               scale: Optional[torch.Tensor] = None,
                               shift: Optional[torch.Tensor] = None,
                               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version, computed in float32 and returned in x's dtype.

    x: [B, ..., C]; gamma, beta: [C]; scale, shift: [B, C] or None.
    """
    shape = x.shape
    b, c = shape[0], shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, -1, c) * gamma.float() + beta.float()
    if scale is not None:
        y = y * (scale.float()[:, None, :] + 1.0) + shift.float()[:, None, :]
    return (y * torch.sigmoid(y)).to(x.dtype).reshape(shape)


def _check(x, gamma, beta, scale, shift, groups) -> None:
    if x.ndim < 2 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(
            f"x: expected a contiguous [B, ..., C] float32/bfloat16 tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    b, c = x.shape[0], x.shape[-1]
    if c % groups or c > 4096 or x.numel() >= 2**31:
        raise ValueError(f"unsupported shape {tuple(x.shape)} with {groups} groups")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    _build.check_param(gamma, "gamma", (c,), x.device)
    _build.check_param(beta, "beta", (c,), x.device)
    if scale is not None:
        _build.check_param(scale, "scale", (b, c), x.device)
        _build.check_param(shift, "shift", (b, c), x.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_forward(x, gamma, beta, scale, shift, groups: int = 8, eps: float = 1e-5):
    """Launch the forward kernel on checked CUDA tensors. Returns (out, the
    statistics partials [B, G, S, 2])."""
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // max(b * c, 1)
    s = max(1, min(64, -(-n * (c // groups) // _STATS_CHUNK)))
    out = torch.empty_like(x)
    partials = torch.empty((b, groups, s, 2), dtype=torch.float32, device=x.device)
    rc = _build.library().pidm_gn_film_silu(
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(scale),
        _ptr(shift), partials.data_ptr(), b, n, c, groups, s, eps,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "group_norm_film_silu")
    group_norm_film_silu.launches += 1
    group_norm_film_silu.bf16_launches += int(x.dtype == torch.bfloat16)
    return out, partials


def launch_backward(dy, x, gamma, beta, scale, shift, partials, groups: int = 8,
                    eps: float = 1e-5):
    """Launch the backward kernel with the forward's partials; dy and dx in
    x's dtype (fp32 or bf16). Returns (dx, dgamma, dbeta, dscale, dshift),
    the parameter gradients fp32; the last two are None without FiLM."""
    dy = dy.contiguous()
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c)
    lib = _build.library()
    work = torch.empty(lib.pidm_gn_film_silu_bwd_workspace(b, n, c), dtype=torch.float32,
                       device=x.device)
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    film = scale is not None
    dscale = torch.empty_like(scale) if film else None
    dshift = torch.empty_like(shift) if film else None
    rc = lib.pidm_gn_film_silu_bwd(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(scale),
        _ptr(shift), partials.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        _ptr(dscale), _ptr(dshift), work.data_ptr(), b, n, c, groups, partials.shape[2], eps,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "group_norm_film_silu backward")
    group_norm_film_silu.backward_launches += 1
    group_norm_film_silu.bf16_backward_launches += int(x.dtype == torch.bfloat16)
    return dx, dgamma, dbeta, dscale, dshift


class _GroupNormFilmSilu(torch.autograd.Function):
    """The CUDA forward and backward kernels as one autograd node (fp32 or
    bf16 x, fp32 parameters).
    The forward's statistics partials are saved, so the backward folds the
    same mean and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps):
        out, partials = launch_forward(x, gamma, beta, scale, shift, groups, eps)
        ctx.save_for_backward(x, gamma, beta, scale, shift, partials)
        ctx.groups, ctx.eps = groups, eps
        return out

    @staticmethod
    def backward(ctx, dy):
        return (*launch_backward(dy, *ctx.saved_tensors, ctx.groups, ctx.eps), None, None)


def group_norm_film_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm (``groups`` groups, biased variance) -> affine
    (gamma, beta) -> FiLM ``y * (scale + 1) + shift`` -> SiLU.

    x: [B, ..., C] (fp32 or bf16, contiguous); gamma, beta: [C] fp32;
    scale, shift: [B, C] fp32, or both None for no FiLM. Gradients: dx in
    x's dtype, the parameters' in fp32.
    """
    if x.device.type == "cpu":
        return group_norm_film_silu_plain(x, gamma, beta, scale, shift, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, gamma, beta, scale, shift, groups)
    args = (x, gamma, beta, scale, shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _GroupNormFilmSilu.apply(*args, groups, eps)
    return launch_forward(*args, groups, eps)[0]


group_norm_film_silu.launches = group_norm_film_silu.bf16_launches = 0
group_norm_film_silu.backward_launches = group_norm_film_silu.bf16_backward_launches = 0


# K5: the lane-packed bf16 forward of scripts/profile_gn.py

_PACKED_VEC = 8  # bf16 values in one 16-byte load of the kernel
_PACKED_SPLIT = 256 * 8  # vectors per block of the statistics pass


def _fold_film(gamma, beta, scale, shift):
    """The per-(row, channel) scale gamma (scale + 1) and shift beta (scale +
    1) + shift, in fp32 ([B, C] each), as ``gn_packed`` folds them."""
    sc1 = scale.float() + 1.0
    return gamma.float() * sc1, beta.float() * sc1 + shift.float()


def group_norm_film_silu_packed_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                      scale: torch.Tensor, shift: torch.Tensor,
                                      groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K5, ``gn_packed`` step by step in fp32: fold
    a and b, per (row, group) the mean and E[x^2] and inv = rsqrt(E[x^2] -
    mean^2 + eps), then SiLU of x (a inv) + (b - mean a inv), in x's dtype.

    x: [B, N, C]; gamma, beta: [C]; scale, shift: [B, C].
    """
    b, n, c = x.shape
    cg = c // groups
    a, bb = _fold_film(gamma, beta, scale, shift)
    xf = x.float()
    xg = xf.reshape(b, n, groups, cg)
    cnt = float(n * cg)
    mean = (xg.sum(dim=(1, 3)) / cnt).repeat_interleave(cg, dim=1)  # [B, C]
    ex2 = ((xg * xg).sum(dim=(1, 3)) / cnt).repeat_interleave(cg, dim=1)
    inv = torch.rsqrt(ex2 - mean * mean + eps)
    ai = a * inv
    y = xf * ai[:, None, :] + (bb - mean * ai)[:, None, :]
    return (y * torch.sigmoid(y)).to(x.dtype)


def _check_packed(x, gamma, beta, scale, shift, groups) -> None:
    if x.ndim != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(
            f"x: expected a contiguous, 16-byte aligned [B, N, C] bfloat16 tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})")
    b, _, c = x.shape
    if c % _PACKED_VEC or 128 % c or c % groups or x.numel() >= 2**31:
        raise ValueError(f"unsupported shape {tuple(x.shape)} with {groups} groups "
                         "(the kernel takes C in 8, 16, 32, 64, 128)")
    _build.check_param(gamma, "gamma", (c,), x.device)
    _build.check_param(beta, "beta", (c,), x.device)
    _build.check_param(scale, "scale", (b, c), x.device)
    _build.check_param(shift, "shift", (b, c), x.device)


def group_norm_film_silu_packed(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                scale: torch.Tensor, shift: torch.Tensor, groups: int = 8,
                                eps: float = 1e-5) -> torch.Tensor:
    """K5: GroupNorm -> affine -> FiLM -> SiLU of a bf16 x [B, N, C] with
    128 % C == 0 (and C % 8 == 0), the affine and FiLM folded into a =
    gamma (scale + 1) and b = beta (scale + 1) + shift in fp32 first.
    gamma, beta: [C] fp32; scale, shift: [B, C] fp32. Forward only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta, scale, shift)):
        raise NotImplementedError(
            "group_norm_film_silu_packed is forward only, as the TPU kernel it ports "
            "(scripts/profile_gn.py) has no VJP; train through group_norm_film_silu")
    if x.device.type == "cpu":
        return group_norm_film_silu_packed_plain(x, gamma, beta, scale, shift, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_packed(x, gamma, beta, scale, shift, groups)
    b, n, c = x.shape
    a, bb = _fold_film(gamma, beta, scale, shift)
    splits = max(1, min(64, -(-n * c // _PACKED_VEC // _PACKED_SPLIT)))
    out = torch.empty_like(x)
    partials = torch.empty((b, splits, groups, 2), dtype=torch.float32, device=x.device)
    rc = _build.library().pidm_gn_film_silu_packed(
        x.data_ptr(), out.data_ptr(), a.data_ptr(), bb.data_ptr(), partials.data_ptr(), b, n, c,
        groups, splits, eps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "group_norm_film_silu_packed")
    group_norm_film_silu_packed.launches += 1
    return out


group_norm_film_silu_packed.launches = 0
