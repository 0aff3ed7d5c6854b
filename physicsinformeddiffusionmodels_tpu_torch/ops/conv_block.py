"""3x3 conv -> GroupNorm -> FiLM -> SiLU, channel-major: kernel K4 (port of
``ops/pallas_conv.py``'s ``conv_gn_film_silu_cm``, its forward kernel
``_fwd_kernel`` and its backward kernel ``_bwd_kernel``).

``conv_gn_film_silu_cm`` launches the CUDA kernels for a CUDA tensor and
uses the plain PyTorch version, under plain autograd, for a CPU tensor.
Nothing else chooses between them: a CUDA tensor the kernels do not take
raises. On CUDA, when grad is enabled and an input requires it, the call
goes through an ``autograd.Function`` whose forward launches
``csrc/conv_block.cu`` (one launch, which then also keeps the fp32 conv
output z for the backward) and whose backward launches
``csrc/conv_block_bwd.cu`` (three), for fp32 and bf16 x alike. With grad
off no z is written.
``conv_gn_film_silu_cm.launches`` and ``.backward_launches`` count the calls
that launched each, ``.bf16_launches`` and ``.bf16_backward_launches`` those
of them on bf16 x. Both hold a batch row in one thread-block cluster;
``k4_plan`` lays a call out.

The weight is the port's OIHW ``[Co, Ci, 3, 3]``; the kernels take the TPU
kernel's tap-major ``wflat`` ``[Co, 9 Ci]`` (``_flatten_w``: tap t = (dr +
1) * 3 + (dc + 1), column t * Ci + ci) in x's dtype, made here by a
differentiable cast and permute (the fp32 kernels read its transpose). So
under bf16 compute dW leaves the kernel in bf16, as the TPU kernel's VJP
returns it (``dw.astype(wflat.dtype)``), and autograd widens it through the
cast to the fp32 parameter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from physicsinformeddiffusionmodels_tpu_torch.ops import _build

# the TPU kernel's image bound (its tap views are static slices inside a
# 128-lane halo, ``pallas_conv._PADW``); the port keeps it
MAX_P = 127
# the kernels' bf16 tile reads 16 channels of one tap at a time; the group
# bound is the wrapper's contract (the kernels themselves take any)
_CHANNEL_MULTIPLE, _MAX_GROUP_CHANNELS = 16, 64

# K4's launch plan on the H100 (csrc/conv_tile.cuh, which computes the same):
# a block is 8 warps, each a 32-channel x 64-pixel tile, over BM output
# channels (64 where Co allows, else 32) and 512 / (BM / 32) pixels of a
# batch row; a row's tiles are spread over one cluster of at most
# K4_CLUSTER_MAX blocks (more tiles: each block takes several and computes
# them twice). The input window is staged in chunks of 32 channels (bf16,
# pixel-major) or 8 (fp32, double-buffered).
K4_WARPS = 8
K4_SMEM_MAX = 232448  # 227 KB, the most shared memory a block may use
K4_CLUSTER_MAX = 8
_KC_TC, _KC_F = 32, 8
_XP, _WP = _KC_TC + 8, 9 * _KC_TC + 8  # staged pixel / weight row pitch (elements), bf16
# the dW kernel: tiles of 32 x 32 channels x 9 taps over chunks of pixels,
# about one block an SM (132) in all
_DW_CO, _DW_CI, _DW_PX_TC, _DW_PX_F, _DW_BLOCKS = 32, 32, 256, 128, 132


class K4Plan(NamedTuple):
    """How K4 lays a call out. Forward: ``k`` blocks a batch row (one
    cluster, B k blocks in all) share the row's ``tiles`` conv tiles of
    ``channels`` output channels x ``pixels`` pixels (rows of ``row_pitch``
    padded pixels); x is staged ``chunk`` channels at a time; ``smem`` bytes
    a block. Backward: ``k`` blocks a row of the dz kernel (one cluster),
    each a ``slice`` of the row's pixels in every channel, ``smem`` bytes a
    block; ``tiles``, ``channels``, ``pixels`` and ``dx_smem``: dx's conv
    over dz (Co in, Ci out); ``splits`` dW partials a dW tile, ``dw_smem``
    bytes a block of the dW kernel. ``workspace``: bytes that the wrapper
    allocates besides the outputs: the forward's fp32 z, kept for the
    backward when grad is on, or the backward's dz and fp32 scratch."""

    k: int
    tiles: int
    channels: int
    pixels: int
    row_pitch: int
    chunk: int
    smem: int
    slice: int
    splits: int
    dw_smem: int
    dx_smem: int
    workspace: int

    @property
    def resident(self) -> bool:
        """Forward: each block holds its one tile's z between its sums and its
        output (no tile is computed twice)."""
        return self.tiles <= self.k


class _Geom(NamedTuple):
    rp: int
    bm: int
    wn: int
    tpx: int
    pt: int
    ct: int
    tiles: int
    wr: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _window_rows(px: int, rp: int, p: int) -> int:
    """Rows (halo included) of the window that ``px`` consecutive padded
    pixels need (conv_tile.cuh ``window_rows``)."""
    return min((px - 1) // rp + 2, p) + 2


def _geom(p: int, cin: int, cout: int) -> _Geom:
    rp = _cdiv(p, 8) * 8
    bm = 64 if cout % 64 == 0 else 32
    wn = K4_WARPS // (bm // 32)
    tpx = wn * 64
    pt, ct = _cdiv(p * rp, tpx), _cdiv(cout, bm)
    return _Geom(rp, bm, wn, tpx, pt, ct, pt * ct, _window_rows(tpx, rp, p))


def _conv_smem(g: _Geom, tc: bool) -> int:
    if tc:
        return g.wr * (g.rp + 2) * _XP * 2 + g.bm * _WP * 2
    return 2 * _KC_F * g.wr * (g.rp + 8) * 4 + 2 * _KC_F * 9 * g.bm * 4


def _dw_smem(p: int, tc: bool) -> int:
    rp = _cdiv(p, 8) * 8
    px = _DW_PX_TC if tc else _DW_PX_F
    wr = _window_rows(px, rp, p)
    if tc:
        return wr * (rp + 2) * _XP * 2 + _DW_CO * (px + 8) * 2
    plane = wr * (rp + 8) + 4
    return max(2 * (_DW_CI * plane + _DW_CO * px) * 4, 3 * (_DW_CO // 8) * _DW_CI * 72 * 4)


def _dw_splits(b: int, p: int, ci: int, co: int, tc: bool) -> int:
    rp = _cdiv(p, 8) * 8
    chunks = b * _cdiv(p * rp, _DW_PX_TC if tc else _DW_PX_F)
    return min(_cdiv(_DW_BLOCKS, _cdiv(co, _DW_CO) * _cdiv(ci, _DW_CI)), chunks)


def _dz_plan(n: int, co: int) -> tuple[int, int]:
    """(blocks a row, pixels a block) of the backward's dz kernel
    (csrc/conv_block_bwd.cu ``dz_plan``): about 256 pixels a block, at most
    K4_CLUSTER_MAX blocks a row, slices a multiple of 4."""
    k = min(_cdiv(n, 256), K4_CLUSTER_MAX)
    return k, _cdiv(_cdiv(n, k), 4) * 4


def _bwd_floats(b: int, ci: int, co: int, k: int, splits: int) -> int:
    """Floats of the backward's fp32 scratch: each row's (S0, S1) per
    channel, each (row, cluster rank)'s dbias partials, the dW partials
    (csrc/conv_block_bwd.cu ``bwd_plan``)."""
    return 2 * b * co + b * k * co + splits * co * 9 * ci


def check_shape(b: int, p: int, ci: int, co: int, groups: int = 8) -> None:
    """Raise ValueError unless the kernels take x [b, ci, p*p] to co channels
    in ``groups`` groups."""
    if (not 1 <= p <= MAX_P or b < 1 or b > 65535 or ci < 1 or co < 1
            or ci % _CHANNEL_MULTIPLE or co % _CHANNEL_MULTIPLE or groups < 1 or co % groups
            or co // groups > _MAX_GROUP_CHANNELS or b * max(ci, co) * p * p >= 2**31):
        raise ValueError(
            f"unsupported shape: B {b}, P {p}, Ci {ci}, Co {co}, {groups} groups (the "
            f"kernels take P <= {MAX_P}, Ci and Co multiples of {_CHANNEL_MULTIPLE}, at most "
            f"{_MAX_GROUP_CHANNELS} channels a group and B max(Ci, Co) P^2 < 2^31)")


def k4_plan(b: int, p: int, ci: int, co: int, elt: int, backward: bool = False,
            groups: int = 8) -> K4Plan:
    """The launch plan of K4's forward (or its backward) on x [b, ci, p*p]
    of ``elt`` bytes an element (2: bf16, the tensor cores; 4: fp32) to
    ``co`` channels. The CUDA side recomputes it and refuses a launch whose
    plan differs."""
    check_shape(b, p, ci, co, groups)
    if elt not in (2, 4):
        raise ValueError(f"x must be fp32 or bf16 (elt 4 or 2), got elt {elt}")
    tc = elt == 2
    n = p * p
    chunk = _KC_TC if tc else _KC_F
    if not backward:
        g = _geom(p, ci, co)
        smem = max(_conv_smem(g, tc), g.bm * (g.tpx + 8) * 4) + 4 * (3 * co + 5 * groups)
        plan = K4Plan(min(g.tiles, K4_CLUSTER_MAX), g.tiles, g.bm, g.tpx, g.rp, chunk, smem, 0,
                      0, 0, 0, 4 * b * co * n)
    else:
        gx = _geom(p, co, ci)
        k, ts = _dz_plan(n, co)
        splits = _dw_splits(b, p, ci, co, tc)
        plan = K4Plan(k, gx.tiles, gx.bm, gx.tpx, gx.rp, chunk, 4 * (4 * co + 2 * groups), ts,
                      splits, _dw_smem(p, tc), _conv_smem(gx, tc),
                      elt * b * co * n + 4 * _bwd_floats(b, ci, co, k, splits))
    if max(plan.smem, plan.dw_smem, plan.dx_smem) > K4_SMEM_MAX:
        raise ValueError(f"K4 plan {plan} needs more than {K4_SMEM_MAX} bytes a block")
    return plan


@functools.cache
def _plan(b: int, p: int, ci: int, co: int, elt: int, backward: bool, groups: int) -> K4Plan:
    return k4_plan(b, p, ci, co, elt, backward, groups)


def max_clusters(plan: K4Plan, bf16: bool, backward: bool) -> int:
    """How many clusters of ``plan``'s cluster kernel the card holds at once
    (cudaOccupancyMaxActiveClusters; 0: it cannot schedule the plan)."""
    lib = _build.library()
    fits = (lib.pidm_conv_gn_film_silu_bwd_max_clusters if backward
            else lib.pidm_conv_gn_film_silu_max_clusters)(plan.k, plan.smem, int(bf16))
    if fits < 0:
        _build.check(-fits, "conv_gn_film_silu_cm: cudaOccupancyMaxActiveClusters")
    return fits


def k4_bytes(plan: K4Plan, b: int, p: int, ci: int, co: int, elt: int, backward: bool,
             save: bool) -> int:
    """Bytes a call moves through device memory by ``plan``: each input read
    once and each output written once (re-reads of a window's halo rows and
    of the weights, which every tile stages, and the dz kernel's second pass
    over its slice are counted as L2 hits), x read again where a forward row
    is not resident (its tiles computed twice), and the intermediates kept
    in device memory: the forward's fp32 z when ``save`` (grad on), read
    again by the backward; the backward's dz (written, then read by the dW
    and dx kernels), its dW partials (written and read) and its row sums."""
    n = p * p
    weights = elt * 9 * ci * co
    if not backward:
        x_in = (1 if plan.resident else 2) * elt * b * ci * n
        z = 4 * b * co * n if save else 0
        return x_in + weights + elt * b * co * n + 4 * (3 * co + 2 * b * co) + z
    # dz kernel: z and dy read, dz written
    nbytes = 4 * b * co * n + 2 * elt * b * co * n
    # dW and dx: x and dz read (each), dx written, the weights read, dW
    # partials written and read, dW written
    nbytes += elt * b * ci * n + 2 * elt * b * co * n + elt * b * ci * n + weights
    nbytes += 2 * 4 * plan.splits * co * 9 * ci + 4 * co * 9 * ci
    # the parameter sums, FiLM's and GroupNorm's parameters and gradients
    return nbytes + 4 * (2 * b * co + b * plan.k * co) + 4 * (5 * co + 4 * b * co)


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
    if n != p * p:
        raise ValueError(f"unsupported shape: x {tuple(x.shape)} is not [B, Ci, P*P], P {p}")
    check_shape(b, p, ci, co, groups)
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


def dx_weights(wflat: torch.Tensor, bf16: bool) -> torch.Tensor:
    """dx's weights in the route's layout: for bf16 x the tap-flipped
    ``wdx`` [Ci, 9 Co] (wdx[ci, t Co + co] = wflat[co, (8 - t) Ci + ci]: dx is
    the forward's conv over dz with the taps reversed, ``_cb_bwd``'s
    transposed conv), for fp32 x its transpose [9 Co, Ci] (the layout the
    fp32 tile reads, as the forward reads ``wflat``'s)."""
    co, ci = wflat.shape[0], wflat.shape[1] // 9
    wdx = wflat.reshape(co, 9, ci).flip(1).permute(2, 1, 0).reshape(ci, 9 * co)
    return wdx.contiguous() if bf16 else wdx.t().contiguous()


def backward_buffers(plan: K4Plan, b: int, p: int, ci: int, co: int,
                     dtype: torch.dtype) -> dict:
    """Shapes and dtypes of what the backward allocates besides its outputs:
    dz in x's dtype and the fp32 scratch (together ``plan.workspace`` bytes)."""
    return {"dz": ((b, co, p * p), dtype),
            "work": ((_bwd_floats(b, ci, co, plan.k, plan.splits),), torch.float32)}


def launch_forward(x, wflat, bias, gamma, beta, scale, shift, p: int, groups: int = 8,
                   eps: float = 1e-5, for_backward: bool = False):
    """Launch the forward kernel on checked CUDA tensors (``wflat`` [Co, 9
    Ci] in x's dtype, scale and shift fp32 [B, Co]). Returns (out, z, stats):
    z, the fp32 conv output plus bias [B, Co, P*P], only when
    ``for_backward`` (else None: no z is written), and the (mean, rstd) of
    each (row, group) [B, G, 2]; the backward reads both."""
    b, ci, n = x.shape
    co = wflat.shape[0]
    bf16 = x.dtype == torch.bfloat16
    plan = _plan(b, p, ci, co, x.element_size(), False, groups)
    out = torch.empty((b, co, n), dtype=x.dtype, device=x.device)
    z = torch.empty((b, co, n), dtype=torch.float32, device=x.device) if for_backward else None
    stats = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    w = wflat if bf16 else wflat.t().contiguous()
    rc = _build.library().pidm_conv_gn_film_silu(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), None if z is None else z.data_ptr(),
        stats.data_ptr(), b, ci, co, p, groups, eps, plan.k, plan.smem, int(bf16), _stream(x))
    _build.check(rc, "conv_gn_film_silu_cm")
    conv_gn_film_silu_cm.launches += 1
    conv_gn_film_silu_cm.bf16_launches += int(bf16)
    return out, z, stats


def launch_backward(dy, x, wflat, gamma, beta, scale, shift, z, stats, p: int,
                    groups: int = 8):
    """Launch the backward kernels with the forward's z and stats; dy and dx
    in x's dtype.
    Returns (dx, dwflat, dbias, dgamma, dbeta, dscale, dshift): dwflat in
    wflat's dtype (the kernels sum it in fp32), the rest fp32."""
    dy = dy.contiguous()
    b, ci, n = x.shape
    co = wflat.shape[0]
    bf16 = x.dtype == torch.bfloat16
    plan = _plan(b, p, ci, co, x.element_size(), True, groups)
    wdx = dx_weights(wflat, bf16)
    bufs = {k: torch.empty(shape, dtype=dt, device=x.device)
            for k, (shape, dt) in backward_buffers(plan, b, p, ci, co, x.dtype).items()}
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty((co, 9 * ci), **f32)
    dbias, dgamma, dbeta = (torch.empty(co, **f32) for _ in range(3))
    dscale, dshift = torch.empty((b, co), **f32), torch.empty((b, co), **f32)
    rc = _build.library().pidm_conv_gn_film_silu_bwd(
        x.data_ptr(), wdx.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), dy.data_ptr(), z.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        dw.data_ptr(),
        dbias.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dscale.data_ptr(),
        dshift.data_ptr(), bufs["dz"].data_ptr(), bufs["work"].data_ptr(), b, ci, co, p, groups,
        plan.k, plan.splits, plan.smem, plan.dw_smem, plan.dx_smem, int(bf16), _stream(x))
    _build.check(rc, "conv_gn_film_silu_cm backward")
    conv_gn_film_silu_cm.backward_launches += 1
    conv_gn_film_silu_cm.bf16_backward_launches += int(bf16)
    return dx, dw.to(wflat.dtype), dbias, dgamma, dbeta, dscale, dshift


class _ConvGnFilmSilu(torch.autograd.Function):
    """The CUDA forward and backward kernels as one autograd node (fp32 or
    bf16 x and wflat, fp32 bias, GroupNorm parameters, scale and shift)."""

    @staticmethod
    def forward(ctx, x, wflat, bias, gamma, beta, scale, shift, p, groups, eps):
        out, z, stats = launch_forward(x, wflat, bias, gamma, beta, scale, shift, p, groups,
                                       eps, for_backward=True)
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
