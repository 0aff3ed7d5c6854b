"""Linear attention over tokens: the fused pre-norm block (kernel K1) and
the attention alone (kernel K3). Port of ``ops/pallas_attention.py``'s
``linear_attention_block`` and ``linear_attention`` with their custom VJPs.

Each wrapper launches the CUDA kernels for a CUDA tensor and uses its plain
PyTorch version, under plain autograd, for a CPU tensor. A CUDA tensor the
kernels do not take raises. On CUDA, when grad is enabled and an input
requires it, the call goes through an ``autograd.Function``: its forward
launches ``csrc/linear_attention.cu`` and saves the per-head context and
k-softmax statistics it writes, and its backward
``csrc/linear_attention_bwd.cu``, for fp32 and bf16 x alike (dx in x's
dtype, the parameter gradients in fp32): fp32 x multiplies in full fp32 on
the CUDA cores, bf16 x on the tensor cores in bf16 (``csrc/la_tile.cuh``),
each product's operands rounded to bf16 where the TPU kernel rounds them, as
the plain version does on bf16 x.
K3 is a mode of K1's kernels (no LN, no b_out, no residual).
``<wrapper>.launches`` and ``.backward_launches`` count the calls that
launched each; ``.bf16_backward_launches`` (both) and
``linear_attention_block.bf16_launches`` those of them on bf16 x.
"""

from __future__ import annotations

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import _build

# the kernels' fixed head layout: one warp per head
KERNEL_HEADS, KERNEL_DIM_HEAD = 8, 32
_STATS = KERNEL_DIM_HEAD * KERNEL_DIM_HEAD + 2 * KERNEL_DIM_HEAD  # ctx, m, z per (row, head)


def linear_attention_plain(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                           heads: int = 8, dim_head: int = 32) -> torch.Tensor:
    """Plain PyTorch version of K3, ``LA(x)``, computed in float32 and
    returned in x's dtype. x: [B, N, C]; w_qkv: [C, 3H]; w_out: [H, C] with
    H = heads * dim_head (``linear_attention_reference``)."""
    attention = _attention_bf16 if x.dtype == torch.bfloat16 else _attention
    return attention(x.float(), w_qkv, w_out, heads, dim_head).to(x.dtype)


def _attention(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, heads: int,
               dim_head: int) -> torch.Tensor:
    b, n, _ = x.shape
    h = heads * dim_head
    q, k, v = (x @ w_qkv.float()).split(h, dim=-1)
    q = q.reshape(b, n, heads, dim_head).softmax(dim=-1) * dim_head**-0.5
    k = k.reshape(b, n, heads, dim_head).softmax(dim=1)
    v = v.reshape(b, n, heads, dim_head) / n
    ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
    return torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(b, n, h) @ w_out.float()


def _r(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (and back to fp32), its gradient passed through."""
    return t + (t.bfloat16().float() - t).detach()


def _attention_bf16(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, heads: int,
                    dim_head: int) -> torch.Tensor:
    """``_attention`` on bf16 x: the products' operands rounded to bf16 and
    summed in fp32 where the TPU kernel's ``_mm``/``_dg`` round them
    (``_lab_fwd_kernel``, the output projection folded into M), but for M,
    kept in fp32: one row's M multiplies all of its N tokens, so a rounding
    of M that flips one way here and the other in the kernel, on fp32
    noise, would move a whole row's output by a bf16 step."""
    b, n, _ = x.shape
    h = heads * dim_head
    q, k, v = (_r(x) @ _r(w_qkv.float())).split(h, dim=-1)
    p = q.reshape(b, n, heads, dim_head).softmax(dim=-1)
    k = k.reshape(b, n, heads, dim_head)
    ek = torch.exp(k - k.amax(dim=1, keepdim=True).detach())  # a constant, as in the VJP
    ctx = torch.einsum("bnhd,bnhe->bhde", _r(ek), _r(v.reshape(b, n, heads, dim_head)))
    ctx = ctx / (ek.sum(dim=1)[..., None] * n)
    m = torch.einsum("bhde,hec->bhdc", _r(ctx), _r(w_out.float().reshape(heads, dim_head, -1)))
    m = (m * dim_head**-0.5).reshape(b, h, -1)
    return _r(p.reshape(b, n, h)) @ m


def linear_attention_block_plain(x: torch.Tensor, gamma: torch.Tensor, w_qkv: torch.Tensor,
                                 w_out: torch.Tensor, b_out: torch.Tensor, heads: int = 8,
                                 dim_head: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``x + b_out + LA(LN_gamma(x))``, computed in
    float32 and returned in x's dtype. x: [B, N, C]; gamma, b_out: [C];
    w_qkv: [C, 3H]; w_out: [H, C] with H = heads * dim_head."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    ln = (xf - mu) / torch.sqrt(var + eps) * gamma.float()
    attention = _attention_bf16 if x.dtype == torch.bfloat16 else _attention
    o = attention(ln, w_qkv, w_out, heads, dim_head)
    return (o + b_out.float() + xf).to(x.dtype)


def _check(x, w_qkv, w_out, heads, dim_head, gamma=None, b_out=None) -> None:
    if x.ndim != 3 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(
            f"x: expected a contiguous [B, N, C] float32/bfloat16 tensor, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    if (heads, dim_head) != (KERNEL_HEADS, KERNEL_DIM_HEAD):
        raise ValueError(f"the kernel takes {KERNEL_HEADS} heads of {KERNEL_DIM_HEAD} dims, "
                         f"got {heads} x {dim_head}")
    b, n, c = x.shape
    if not 0 < c <= 1024 or x.numel() >= 2**31 or n == 0:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    h = heads * dim_head
    _build.check_param(w_qkv, "w_qkv", (c, 3 * h), x.device)
    _build.check_param(w_out, "w_out", (h, c), x.device)
    if gamma is not None:  # K1's
        _build.check_param(gamma, "gamma", (c,), x.device)
        _build.check_param(b_out, "b_out", (c,), x.device)


def _saved(x):
    """Empty M [B, 256, C] and stats [B, 8, 1088], fp32: what the forward
    kernel writes for the backward kernel; and the forward's scratch."""
    b, n, c = x.shape
    m = torch.empty((b, KERNEL_HEADS * KERNEL_DIM_HEAD, c), dtype=torch.float32,
                    device=x.device)
    stats = torch.empty((b, KERNEL_HEADS, _STATS), dtype=torch.float32, device=x.device)
    work = torch.empty(_build.library().pidm_linear_attention_block_fwd_workspace(b, n, c),
                       dtype=torch.float32, device=x.device)
    return m, stats, work


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _bf16(x) -> int:
    return int(x.dtype == torch.bfloat16)


def launch_forward(x, gamma, w_qkv, w_out, b_out, eps: float = 1e-5):
    """Launch the forward kernel on checked CUDA tensors. Returns (out, M,
    stats): M and stats (per-head context and k-softmax statistics) are what
    the backward kernel reads."""
    b, n, c = x.shape
    out = torch.empty_like(x)
    m, stats, work = _saved(x)
    rc = _build.library().pidm_linear_attention_block(
        x.data_ptr(), out.data_ptr(), gamma.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), m.data_ptr(), stats.data_ptr(), work.data_ptr(), b, n, c, eps,
        _bf16(x), _stream(x),
    )
    _build.check(rc, "linear_attention_block")
    linear_attention_block.launches += 1
    linear_attention_block.bf16_launches += _bf16(x)
    return out, m, stats


def launch_backward(dy, x, gamma, w_qkv, w_out, m, stats, eps: float = 1e-5):
    """Launch the backward kernel with the forward's M and stats; dy and dx
    in x's dtype (fp32 or bf16). Returns (dx, dgamma, dw_qkv, dw_out,
    db_out)."""
    dy = dy.contiguous()
    b, n, c = x.shape
    lib = _build.library()
    work = torch.empty(lib.pidm_linear_attention_block_bwd_workspace(b, n, c),
                       dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma, db_out = torch.empty_like(gamma), torch.empty_like(gamma)
    dw_qkv, dw_out = torch.empty_like(w_qkv), torch.empty_like(w_out)
    rc = lib.pidm_linear_attention_block_bwd(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
        m.data_ptr(), stats.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dw_qkv.data_ptr(),
        dw_out.data_ptr(), db_out.data_ptr(), work.data_ptr(), b, n, c, eps, _bf16(x),
        _stream(x),
    )
    _build.check(rc, "linear_attention_block backward")
    linear_attention_block.backward_launches += 1
    linear_attention_block.bf16_backward_launches += _bf16(x)
    return dx, dgamma, dw_qkv, dw_out, db_out


class _LinearAttentionBlock(torch.autograd.Function):
    """The CUDA forward and backward kernels as one autograd node (fp32 or
    bf16 x, fp32 parameters)."""

    @staticmethod
    def forward(ctx, x, gamma, w_qkv, w_out, b_out, eps):
        out, m, stats = launch_forward(x, gamma, w_qkv, w_out, b_out, eps)
        ctx.save_for_backward(x, gamma, w_qkv, w_out, m, stats)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        return (*launch_backward(dy, *ctx.saved_tensors, ctx.eps), None)


def linear_attention_block(x: torch.Tensor, gamma: torch.Tensor, w_qkv: torch.Tensor,
                           w_out: torch.Tensor, b_out: torch.Tensor, heads: int = 8,
                           dim_head: int = 32, eps: float = 1e-5,
                           channel_major: bool = False) -> torch.Tensor:
    """Fused residual block ``x + b_out + LA(LN_gamma(x))``.

    x: [B, N, C] (fp32 or bf16, contiguous), or [B, C, N] with
    ``channel_major``; gamma, b_out: [C] fp32; w_qkv: [C, 3H] fp32; w_out:
    [H, C] fp32, H = heads * dim_head. The kernels take 8 heads of 32 dims
    and C <= 1024, token-major: a channel-major x is transposed into a
    contiguous copy, and the result comes back as a [B, C, N] view of the
    token-major output.
    """
    if channel_major:
        out = linear_attention_block(x.transpose(1, 2).contiguous(), gamma, w_qkv, w_out,
                                     b_out, heads, dim_head, eps)
        return out.transpose(1, 2)
    if x.device.type == "cpu":
        return linear_attention_block_plain(x, gamma, w_qkv, w_out, b_out, heads, dim_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w_qkv, w_out, heads, dim_head, gamma, b_out)
    args = (x, gamma, w_qkv, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _LinearAttentionBlock.apply(*args, eps)
    return launch_forward(*args, eps)[0]


linear_attention_block.launches = linear_attention_block.bf16_launches = 0
linear_attention_block.backward_launches = linear_attention_block.bf16_backward_launches = 0


def launch_attention_forward(x, w_qkv, w_out):
    """Launch K3's forward kernel on checked CUDA tensors. Returns (out, M,
    stats), as ``launch_forward`` does."""
    b, n, c = x.shape
    out = torch.empty_like(x)
    m, stats, work = _saved(x)
    rc = _build.library().pidm_linear_attention(
        x.data_ptr(), out.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), m.data_ptr(),
        stats.data_ptr(), work.data_ptr(), b, n, c, _bf16(x), _stream(x),
    )
    _build.check(rc, "linear_attention")
    linear_attention.launches += 1
    return out, m, stats


def launch_attention_backward(dy, x, w_qkv, w_out, m, stats):
    """Launch K3's backward kernel with the forward's M and stats; dy and dx
    in x's dtype. Returns (dx, dw_qkv, dw_out)."""
    dy = dy.contiguous()
    b, n, c = x.shape
    lib = _build.library()
    work = torch.empty(lib.pidm_linear_attention_block_bwd_workspace(b, n, c),
                       dtype=torch.float32, device=x.device)
    dx, dw_qkv, dw_out = torch.empty_like(x), torch.empty_like(w_qkv), torch.empty_like(w_out)
    rc = lib.pidm_linear_attention_bwd(
        x.data_ptr(), dy.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), m.data_ptr(),
        stats.data_ptr(), dx.data_ptr(), dw_qkv.data_ptr(), dw_out.data_ptr(), work.data_ptr(),
        b, n, c, _bf16(x), _stream(x),
    )
    _build.check(rc, "linear_attention backward")
    linear_attention.backward_launches += 1
    linear_attention.bf16_backward_launches += _bf16(x)
    return dx, dw_qkv, dw_out


class _LinearAttention(torch.autograd.Function):
    """K3's CUDA forward and backward kernels as one autograd node (fp32 or
    bf16 x)."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out):
        out, m, stats = launch_attention_forward(x, w_qkv, w_out)
        ctx.save_for_backward(x, w_qkv, w_out, m, stats)
        return out

    @staticmethod
    def backward(ctx, dy):
        return launch_attention_backward(dy, *ctx.saved_tensors)


def linear_attention(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
                     heads: int = 8, dim_head: int = 32) -> torch.Tensor:
    """Linear attention ``LA(x)``, no LN, no output bias, no residual.

    x: [B, N, C] (fp32 or bf16, contiguous); w_qkv: [C, 3H] fp32; w_out:
    [H, C] fp32, H = heads * dim_head. The kernels take 8 heads of 32 dims
    and C <= 1024.
    """
    if x.device.type == "cpu":
        return linear_attention_plain(x, w_qkv, w_out, heads, dim_head)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w_qkv, w_out, heads, dim_head)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_qkv, w_out)):
        return _LinearAttention.apply(x, w_qkv, w_out)
    return launch_attention_forward(x, w_qkv, w_out)[0]


linear_attention.launches = 0
linear_attention.backward_launches = linear_attention.bf16_backward_launches = 0
