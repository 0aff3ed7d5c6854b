"""GroupNorm -> FiLM -> SiLU: kernel K2 (port of ``ops/pallas_kernels.py``'s
forward kernel and its backward ``_gn_bwd``) and kernel K5, the lane-packed
bf16 forward of ``scripts/profile_gn.py``.

``group_norm_film_silu`` launches the CUDA kernels for a CUDA tensor and
uses the plain PyTorch version, under plain autograd, for a CPU tensor.
Nothing else chooses between them: a CUDA tensor the kernels do not take
raises. On CUDA, when grad is enabled and an input requires it, the call
goes through an ``autograd.Function`` whose forward launches
``csrc/group_norm.cu`` (one launch) and whose backward launches
``csrc/group_norm_bwd.cu`` (two), for fp32 and bf16 x alike.
``group_norm_film_silu.launches`` and ``.backward_launches`` count the calls
that launched each, ``.bf16_launches`` and ``.bf16_backward_launches`` those
of them on bf16 x. Both kernels hold a batch row in one thread-block
cluster; ``k2_plan`` sizes it.

``group_norm_film_silu_packed`` (K5, ``csrc/group_norm_packed.cu``) computes
the same function on bf16 x with the affine and FiLM folded into one scale
and shift per (row, channel) and the one-pass variance E[x^2] - mean^2. It
is forward only, as the TPU kernel is; no model calls it. On the card it is
one launch of one cluster a batch row (``k5_plan``), the fold inside the
kernel. Its launches are counted in ``group_norm_film_silu_packed.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import _build

# K2's launch plan on the H100 (csrc/gn_cluster.cuh): one cluster of k
# blocks a batch row, each block a slice of the row's tokens in shared memory.
# The constants are those that measured fastest at the Darcy UNet's calls at
# B=64 (profile_k2.py): more blocks a row than the card holds at once cost a
# second wave of clusters, which a re-read from L2 costs less than.
K2_THREADS = 256
K2_SMEM_MAX = 232448  # 227 KB, the most shared memory a block may use
# bytes of x (and dy) a block holds at most: with its scratch, two blocks an
# SM; the backward on bf16 x (~80 registers a thread) half that, so that
# three fit an SM, with at most K2_BF16_BWD_CLUSTER blocks a row
K2_RESIDENT_MAX, K2_BF16_BWD_RESIDENT_MAX, K2_BF16_BWD_CLUSTER = 96 * 1024, 48 * 1024, 4
# a slice is not cut below this to cover the card: a smaller one pays more
# in its cluster barrier than it gains in parallel loads
K2_SLICE_MIN = 8 * 1024
K2_COVER = 128  # blocks a call should reach, about one for each of the H100's 132 SMs
K2_CLUSTER_PORTABLE, K2_CLUSTER_MAX = 8, 16


class K2Plan(NamedTuple):
    """How K2 lays a call out: ``k`` blocks a batch row (one cluster, B k in
    all); block q takes tokens [q ``tokens``, min(N, (q + 1) ``tokens``)),
    the first ``resident`` of them staged in ``smem`` bytes of shared memory
    (with its scratch), the rest re-read from global memory (L2) in each
    pass."""

    k: int
    tokens: int
    resident: int
    smem: int

    @property
    def reread(self) -> bool:
        return self.resident < self.tokens


def _aux_bytes(c: int, groups: int, elt: int, backward: bool) -> int:
    """Shared memory of a block besides its slices (csrc/gn_cluster.cuh
    ``aux_bytes``): per-(row lane, channel) scratch, channel and group
    partials."""
    rc = max(K2_THREADS * (16 // elt), c)
    return 4 * (2 * rc + 4 * c + 2 * groups if backward else rc + c + 4 * groups)


def _slice_bytes(tokens: int, c: int, elt: int) -> int:
    return -(-tokens * c * elt // 16) * 16


def k2_plan(b: int, n: int, c: int, elt: int, backward: bool = False, groups: int = 8,
            cluster_max: int = K2_CLUSTER_MAX) -> K2Plan:
    """The launch plan of K2's forward (or its backward, which holds x and
    dy) on a [b, n, c] x of ``elt`` bytes an element.

    k, a power of two, first grows until a block's slice fits its resident
    bytes (up to ``cluster_max``); then, up to the portable 8, while b k
    blocks do not reach K2_COVER and the halved slice stays at least
    K2_SLICE_MIN. What still does not fit is re-read."""
    if backward and elt == 2:
        cluster_max = min(cluster_max, K2_BF16_BWD_CLUSTER)
    fit = _fit(c, elt, backward, groups)
    tok_bytes = c * elt * (2 if backward else 1)
    k = 1
    while k < cluster_max and 2 * k <= n and -(-n // k) > fit:
        k *= 2
    while (k < min(K2_CLUSTER_PORTABLE, cluster_max) and 2 * k <= n and b * k < K2_COVER
           and -(-n // (2 * k)) * tok_bytes >= K2_SLICE_MIN):
        k *= 2
    return k2_plan_of(k, n, c, elt, backward, groups)


def _fit(c: int, elt: int, backward: bool, groups: int) -> int:
    """Tokens a block holds at most (x, and dy in the backward)."""
    resident_max = K2_BF16_BWD_RESIDENT_MAX if backward and elt == 2 else K2_RESIDENT_MAX
    aux = _aux_bytes(c, groups, elt, backward)
    return max(1, min(resident_max, K2_SMEM_MAX - aux) // (c * elt * (2 if backward else 1)))


def k2_plan_of(k: int, n: int, c: int, elt: int, backward: bool = False,
               groups: int = 8) -> K2Plan:
    """The plan with k blocks a row: each holds what fits of its slice."""
    tokens = -(-n // k)
    resident = min(tokens, _fit(c, elt, backward, groups))
    streams = 2 if backward else 1
    return K2Plan(k, tokens, resident,
                  streams * _slice_bytes(resident, c, elt) + _aux_bytes(c, groups, elt, backward))


def max_clusters(plan: K2Plan, bf16: bool, vec: bool, backward: bool) -> int:
    """How many clusters of ``plan`` the card holds at once
    (cudaOccupancyMaxActiveClusters; 0: it cannot schedule the plan)."""
    lib = _build.library()
    fits = (lib.pidm_gn_film_silu_bwd_max_clusters if backward
            else lib.pidm_gn_film_silu_max_clusters)(plan.k, plan.smem, int(vec), int(bf16))
    if fits < 0:
        _build.check(-fits, "group_norm_film_silu: cudaOccupancyMaxActiveClusters")
    return fits


@functools.cache
def _plan(b: int, n: int, c: int, groups: int, bf16: bool, vec: bool,
          backward: bool) -> K2Plan:
    """``k2_plan`` for the card: a non-portable cluster (k > 8) that the
    card cannot schedule steps down to 8."""
    plan = k2_plan(b, n, c, 2 if bf16 else 4, backward, groups)
    if plan.k > K2_CLUSTER_PORTABLE and max_clusters(plan, bf16, vec, backward) == 0:
        plan = k2_plan(b, n, c, 2 if bf16 else 4, backward, groups, K2_CLUSTER_PORTABLE)
    return plan


def _vec(c: int, elt: int, *tensors: torch.Tensor) -> bool:
    """Whether 16-byte vectors can read every row of these [B, N, C] tensors."""
    return c % (16 // elt) == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


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


def launch_forward(x, gamma, beta, scale, shift, groups: int = 8, eps: float = 1e-5,
                   plan: Optional[K2Plan] = None):
    """Launch the forward kernel on checked CUDA tensors (with ``plan``, or
    the card's plan for the shape). Returns (out, the statistics [B, G, 2]:
    each row's mean and rstd per group)."""
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // max(b * c, 1)
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    vec = _vec(c, x.element_size(), x, out)
    plan = plan or _plan(b, n, c, groups, bf16, vec, False)
    stats = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    rc = _build.library().pidm_gn_film_silu(
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(scale),
        _ptr(shift), stats.data_ptr(), b, n, c, groups, plan.k, plan.tokens, plan.resident,
        plan.smem, int(vec), eps, int(bf16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "group_norm_film_silu")
    group_norm_film_silu.launches += 1
    group_norm_film_silu.bf16_launches += int(bf16)
    return out, stats


def launch_backward(dy, x, gamma, beta, scale, shift, stats, groups: int = 8,
                    eps: float = 1e-5, plan: Optional[K2Plan] = None):
    """Launch the backward kernels with the forward's statistics (and
    ``plan``, as in launch_forward); dy and dx in x's dtype (fp32 or bf16).
    Returns (dx, dgamma, dbeta, dscale, dshift), the parameter gradients
    fp32; the last two are None without FiLM. ``eps`` is in the saved rstd
    already."""
    dy = dy.contiguous()
    b, c = x.shape[0], x.shape[-1]
    n = x.numel() // (b * c)
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty_like(x)
    vec = _vec(c, x.element_size(), x, dy, dx)
    plan = plan or _plan(b, n, c, groups, bf16, vec, True)
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    film = scale is not None
    dscale = torch.empty_like(scale) if film else None
    dshift = torch.empty_like(shift) if film else None
    rc = _build.library().pidm_gn_film_silu_bwd(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(scale),
        _ptr(shift), stats.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        _ptr(dscale), _ptr(dshift), sums.data_ptr(), b, n, c, groups, plan.k, plan.tokens,
        plan.resident, plan.smem, int(vec), int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "group_norm_film_silu backward")
    group_norm_film_silu.backward_launches += 1
    group_norm_film_silu.bf16_backward_launches += int(bf16)
    return dx, dgamma, dbeta, dscale, dshift


class _GroupNormFilmSilu(torch.autograd.Function):
    """The CUDA forward and backward kernels as one autograd node (fp32 or
    bf16 x, fp32 parameters).
    The forward's statistics are saved, so the backward reads the same mean
    and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps):
        out, stats = launch_forward(x, gamma, beta, scale, shift, groups, eps)
        ctx.save_for_backward(x, gamma, beta, scale, shift, stats)
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


# K5: the lane-packed bf16 forward of scripts/profile_gn.py. Its launch plan
# on the H100 (csrc/group_norm_packed.cu): one cluster of k blocks a batch
# row, each block's token slice copied into shared memory by bulk copies.
K5_VEC = 8  # bf16 values in one 16-byte vector of the kernel
# bytes of x a block holds at most (the kernel's mbarriers cover 256 KB)
K5_RESIDENT_MAX = 192 * 1024
K5_CHUNK_BYTES, K5_CHUNKS = 32 * 1024, 8  # one bulk copy and its mbarrier; mbarriers a block
# k grows past the fit while b k does not reach K5_COVER blocks (about one
# an SM) and a slice stays at least K5_SLICE_MIN bytes; at most the
# portable cluster of 8
K5_COVER, K5_SLICE_MIN, K5_CLUSTER_MAX = 128, 16 * 1024, 8


def _k5_aux(c: int, groups: int) -> int:
    """Shared memory of a K5 block besides its resident slice (the kernel's
    ``k5_aux_bytes``): the mbarriers, the warps' per-channel sums, the
    channel and group sums."""
    return 8 * K5_CHUNKS + 4 * (2 * 8 * c + 2 * c + 4 * groups)


def k5_plan(b: int, n: int, c: int, groups: int = 8, k: Optional[int] = None) -> K2Plan:
    """K5's launch plan on a bf16 [b, n, c] x (a K2Plan: k blocks a row,
    ``tokens`` a block, ``resident`` of them in ``smem`` bytes of shared
    memory, the rest re-read). Without ``k``: k, a power of two, grows
    until a block's slice fits K5_RESIDENT_MAX, then while b k < K5_COVER
    and the halved slice keeps K5_SLICE_MIN bytes, up to K5_CLUSTER_MAX. A
    row that still does not fit is the re-read mode."""
    tok_bytes = 2 * c
    if k is None:
        k = 1
        while k < K5_CLUSTER_MAX and 2 * k <= n and -(-n // k) * tok_bytes > K5_RESIDENT_MAX:
            k *= 2
        while (k < K5_CLUSTER_MAX and 2 * k <= n and b * k < K5_COVER
               and -(-n // (2 * k)) * tok_bytes >= K5_SLICE_MIN):
            k *= 2
    tokens = -(-n // k)
    resident = min(tokens, K5_RESIDENT_MAX // tok_bytes)
    return K2Plan(k, tokens, resident, _slice_bytes(resident, c, 2) + _k5_aux(c, groups))


def k5_max_clusters(plan: K2Plan) -> int:
    """How many clusters of K5's ``plan`` the card holds at once
    (cudaOccupancyMaxActiveClusters; 0: it cannot schedule the plan)."""
    fits = _build.library().pidm_gn_film_silu_packed_max_clusters(plan.k, plan.smem)
    if fits < 0:
        _build.check(-fits, "group_norm_film_silu_packed: cudaOccupancyMaxActiveClusters")
    return fits


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
    if c % K5_VEC or 128 % c or c % groups or x.numel() >= 2**31:
        raise ValueError(f"unsupported shape {tuple(x.shape)} with {groups} groups "
                         "(the kernel takes C in 8, 16, 32, 64, 128)")
    _build.check_param(gamma, "gamma", (c,), x.device)
    _build.check_param(beta, "beta", (c,), x.device)
    _build.check_param(scale, "scale", (b, c), x.device)
    _build.check_param(shift, "shift", (b, c), x.device)


def group_norm_film_silu_packed(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                scale: torch.Tensor, shift: torch.Tensor, groups: int = 8,
                                eps: float = 1e-5, plan: Optional[K2Plan] = None
                                ) -> torch.Tensor:
    """K5: GroupNorm -> affine -> FiLM -> SiLU of a bf16 x [B, N, C] with
    128 % C == 0 (and C % 8 == 0), the affine and FiLM folded into a =
    gamma (scale + 1) and b = beta (scale + 1) + shift in fp32. gamma,
    beta: [C] fp32; scale, shift: [B, C] fp32. Forward only. On the card
    one launch (``plan``, or ``k5_plan``'s for the shape) folds the FiLM
    itself."""
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
    plan = plan or _k5_plan(b, n, c, groups)
    out = torch.empty_like(x)
    rc = _build.library().pidm_gn_film_silu_packed(
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), b, n, c, groups, plan.k, plan.tokens, plan.resident, plan.smem, eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "group_norm_film_silu_packed")
    group_norm_film_silu_packed.launches += 1
    return out


_k5_plan = functools.cache(k5_plan)
group_norm_film_silu_packed.launches = 0
