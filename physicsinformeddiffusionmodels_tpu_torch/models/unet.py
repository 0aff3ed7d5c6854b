"""The attention U-Net denoiser in PyTorch (port of ``models/unet.py``).

Activations are NHWC ([B, H, W, C]) at the public boundary and inside, as in
the JAX model, so that the two fused kernels see the token-major [B, N, C]
layout with no copies: a convolution takes a channels-last view
(``permute(0, 3, 1, 2)``), and its channels-last output permutes back to a
contiguous NHWC tensor.

Modules are named after the Flax parameter tree (``ResnetBlock_0``,
``LinearAttentionBlock_3``, ``mid_spatial_attn``, ...), so ``convert.py``
maps a Flax checkpoint onto the state dict by name. The 3x3, 7x7, strided
and transposed convolutions are ``torch.nn.functional`` convolutions, as
they are XLA convolutions outside any Pallas kernel in the JAX package; the
GroupNorm-FiLM-SiLU after every 3x3 conv (K2) and the linear-attention
block (K1) are the CUDA kernels of ``ops/``. ``SpatialLinearAttention``
(the attention alone, K3) is here too; no UNet configuration builds it.

``UNet(cm_conv_stages=True)`` runs every level stage narrower than 128
channels channel-major, [B, C, H*W], as the JAX model does (``_use_cm``):
each ``Block`` there is kernel K4 (``ops/conv_block.py``: the conv, the
GroupNorm, FiLM and SiLU in one), each ``LinearAttentionBlock`` K1 in its
channel-major mode, and the layout changes at the stage's entry and exit
(``channel_major`` / ``from_channel_major``) and at the final block when
there is no fp32 head. The parameters are the same in both layouts, so the
flag may also be switched on a built model.

The port builds the Darcy study's ``UNet(dim=32, channels=2)`` and the
mechanics study's ``UNet(dim=128, channels=10, out_dim=3,
sigmoid_last_channel=True)``, whose last output channel (the density) goes
through a sigmoid in the head's dtype. An input with a frame axis, [B, F,
H, W, C], runs its frames as consecutive images of one batch; the frame
attention at F > 1 (``UNet(multi_frame=True)``, the Flax tree initialised
at F > 1) is full attention along F with RoPE and a relative position
bias, plain PyTorch. ``padding_mode='circular'`` (a run with periodic boundaries) wraps
every spatial padding of the init conv, the Blocks, Downsample and
Upsample (a circular pre-pad, a VALID transposed conv, then the crop), as
JAX's ``_pad2d`` does; the conditioning branch's 3x3 conv stays
zero-padded, and the channel-major stages run only with zero padding.
``self_condition`` concatenates ``x_self_cond`` (zeros when None) before x
on the channel axis, so the init conv takes 2 x ``channels`` inputs. The
residual-gradient conditioning modules (``emb_conv_0``, ``emb_conv_1``,
``combine_conv``) are built in every UNet unless ``cond_path=False``, so
that every checkpoint loads; only a call with ``cond`` runs them
(``UNet.forward``, and ``apply_with_guidance`` for classifier-free
guidance). As in JAX, ``init_dim`` sets the width of the init conv, of the
init frame attention and of the conditioning modules (the first level then
maps ``init_dim`` to ``dim``), and ``use_sparse_linear_attn=False`` builds
no ``LinearAttentionBlock``: such a UNet launches no K1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from physicsinformeddiffusionmodels_tpu_torch.ops.conv_block import MAX_P, conv_gn_film_silu_cm
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention,
    linear_attention_block,
)
from physicsinformeddiffusionmodels_tpu_torch.parallel.collectives import (
    enter_partial,
    gather,
    shard,
)
from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import Mesh, cols, whole
from physicsinformeddiffusionmodels_tpu_torch.parallel.seq_attention import (
    sequence_sharded_linear_attention_block,
)


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if t is None or dtype is None else t.to(dtype)


# cuDNN 9 (H100) runs some float32 convolutions with more input channels
# than this as FFT tiles: the mechanics head's 3x3 256 -> 128 at 64x64 takes
# 110 ms at B=6 and 4.4 at B=8, against 0.6 as two 128-channel halves
# (``profile_conv``). On the card a float32 convolution sums slices of at
# most this many input channels.
FP32_CONV_SLICE = 128


def _pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Wrap-pad the H and W axes of an NHWC tensor by ``pad`` each side."""
    if pad == 0:
        return x
    x = torch.cat([x[:, -pad:], x, x[:, :pad]], dim=1)
    return torch.cat([x[:, :, -pad:], x, x[:, :, :pad]], dim=2)


def _conv(x: torch.Tensor, weight, bias, dtype, stride=1, padding=0, transpose=False,
          circular=False):
    """Convolution of an NHWC tensor with an OIHW (or IOHW when transposed)
    weight, computed in ``dtype`` (None: the input's); ``circular`` pads by
    wrapping, then convolves VALID."""
    if circular:
        x, padding = _pad2d(x, padding), 0
    dt = dtype or x.dtype
    xc, w, b = x.permute(0, 3, 1, 2).to(dt), weight.to(dt), _cast(bias, dt)
    if transpose:
        y = F.conv_transpose2d(xc, w, b, stride=stride, padding=padding)
    elif dt == torch.float32 and xc.is_cuda and w.shape[1] > FP32_CONV_SLICE:
        s = FP32_CONV_SLICE
        y = F.conv2d(xc[:, :s], w[:, :s], b, stride=stride, padding=padding)
        for i in range(s, w.shape[1], s):
            y = y + F.conv2d(xc[:, i:i + s], w[:, i:i + s], None, stride=stride, padding=padding)
    else:
        y = F.conv2d(xc, w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    dt = dtype or x.dtype
    bias = whole(layer, "bias") if layer.bias is not None else None
    return F.linear(x.to(dt), whole(layer, "weight").to(dt), _cast(bias, dt))


def _lecun(*shape: int) -> nn.Parameter:
    """A Flax ``lecun_normal``-scaled parameter; fan-in is every dim but the last."""
    return nn.Parameter(torch.randn(*shape) / math.sqrt(math.prod(shape[:-1])))


def channel_major(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> contiguous [B, C, H*W]."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c).transpose(1, 2).contiguous()


def from_channel_major(x_cm: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, C, H*W] -> [B, H, W, C], a view where the strides allow (a
    convolution's NCHW view of it is then the contiguous x_cm)."""
    b, c, _ = x_cm.shape
    return x_cm.transpose(1, 2).reshape(b, h, w, c)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                          * (-math.log(10000.0) / (half - 1)))
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last axis with scale, no bias, biased variance."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        mean = x.mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.gamma


class Conv2dPadded(nn.Module):
    """k x k convolution padded by ``pad`` with zeros (Flax 'SAME' for k=3/7
    s=1 and k=4 s=2) or, with ``padding_mode='circular'``, by wrapping."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, pad: int = 0,
                 dtype=None, padding_mode: str = "zeros"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride, pad)
        self.dtype = dtype
        self.circular = padding_mode == "circular"

    def forward(self, x, tp: Optional[Mesh] = None):
        """``tp``: column-parallel, the rank's output channels of the whole x."""
        c = self.Conv_0
        w, b = ((whole(c, "weight"), whole(c, "bias")) if tp is None
                else (cols(c, "weight", 0, tp), cols(c, "bias", 0, tp)))
        return _conv(x, w, b, self.dtype, c.stride, c.padding[0], circular=self.circular)


class Downsample(nn.Module):
    """k=4 s=2 p=1 strided conv."""

    def __init__(self, dim: int, dtype=None, padding_mode: str = "zeros"):
        super().__init__()
        self.Conv2dPadded_0 = Conv2dPadded(dim, dim, 4, 2, 1, dtype, padding_mode)

    def forward(self, x, tp: Optional[Mesh] = None):
        return self.Conv2dPadded_0(x, tp)


class Upsample(nn.Module):
    """ConvTranspose k=4 s=2 p=1: doubles the resolution. Circular: a wrap
    pad of 1, a VALID transposed conv, then a crop of 3 each side."""

    def __init__(self, dim: int, dtype=None, padding_mode: str = "zeros"):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(dim, dim, 4, 2, 1)
        self.dtype = dtype
        self.circular = padding_mode == "circular"

    def forward(self, x, tp: Optional[Mesh] = None):
        """``tp``: column-parallel, the rank's output channels of the whole x."""
        c = self.ConvTranspose_0
        w, b = ((whole(c, "weight"), whole(c, "bias")) if tp is None
                else (cols(c, "weight", 1, tp), cols(c, "bias", 0, tp)))
        if not self.circular:
            return _conv(x, w, b, self.dtype, 2, 1, transpose=True)
        xp = _pad2d(x, 1)
        y = _conv(xp, w, b, self.dtype, 2, 0, transpose=True)
        crop = (y.shape[1] - 2 * (xp.shape[1] - 2)) // 2
        return y[:, crop:-crop, crop:-crop].contiguous()


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> (FiLM) -> SiLU: a cuDNN conv (zero- or
    wrap-padded) then kernel K2 on NHWC x, or with ``cm=P`` all four in
    kernel K4 on channel-major x [B, C, P*P] (zero padding only)."""

    def __init__(self, cin: int, cout: int, groups: int = 8, dtype=None,
                 padding_mode: str = "zeros"):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, 3, 3) / math.sqrt(9 * cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.gn_scale = nn.Parameter(torch.ones(cout))
        self.gn_bias = nn.Parameter(torch.zeros(cout))
        self.groups = groups
        self.dtype = dtype
        self.circular = padding_mode == "circular"

    def forward(self, x, scale_shift=None, cm: int = 0, tp: Optional[Mesh] = None,
                frames: int = 1):
        """``tp``: column-parallel, the rank's C/tp output channels of the
        whole x, K2 on its groups // tp groups, ``scale_shift`` the rank's.
        ``frames`` > 1: x holds a batch row's frames as consecutive images
        ([B F, H, W, C]); the conv runs per frame and K2's statistics span
        the row's frames, as JAX's Block folds frames into the batch for the
        conv only."""
        scale, shift = scale_shift if scale_shift is not None else (None, None)
        names = ("weight", "bias", "gn_scale", "gn_bias")
        if tp is not None:
            w, b, g, beta = (cols(self, n, 0, tp) for n in names)
            h = _conv(x, w, b, self.dtype, 1, 1, circular=self.circular)
            return group_norm_film_silu(h, g, beta, scale, shift, groups=self.groups // tp.tp)
        w, b, g, beta = (whole(self, n) for n in names)
        if cm:
            if self.circular:
                raise ValueError("the channel-major Block (K4) pads with zeros only")
            return conv_gn_film_silu_cm(x.to(self.dtype or x.dtype), w, b, g, beta, scale,
                                        shift, cm, self.groups)
        h = _conv(x, w, b, self.dtype, 1, 1, circular=self.circular)
        if frames > 1:
            return group_norm_film_silu(h.reshape(h.shape[0] // frames, -1, h.shape[-1]), g,
                                        beta, scale, shift, groups=self.groups).reshape(h.shape)
        return group_norm_film_silu(h, g, beta, scale, shift, groups=self.groups)


class ResnetBlock(nn.Module):
    """Two blocks, the first FiLM-conditioned on the time embedding, plus a
    1x1 residual projection when the width changes; ``cm=P`` runs
    channel-major on [B, C, P*P]."""

    def __init__(self, cin: int, cout: int, time_dim: Optional[int] = None, groups: int = 8,
                 dtype=None, padding_mode: str = "zeros"):
        super().__init__()
        if time_dim is not None:
            self.Dense_0 = nn.Linear(time_dim, 2 * cout)
        self.Block_0 = Block(cin, cout, groups, dtype, padding_mode)
        self.Block_1 = Block(cout, cout, groups, dtype, padding_mode)
        if cin != cout:
            self.res_kernel = _lecun(cin, cout)
            self.res_bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x, time_emb=None, cm: int = 0, tp: Optional[Mesh] = None,
                frames: int = 1):
        """``tp``: column-parallel: x is the whole input, whose gradient the
        tp ranks' shares make up (``enter_partial``, or a ``gather`` with
        ``partial``); returns the rank's C/tp output channels. ``frames``:
        as in ``Block``."""
        scale_shift = None
        if time_emb is not None:
            emb = _dense(F.silu(time_emb), self.Dense_0, self.dtype).float()
            scale_shift = tuple(e.contiguous() for e in emb.chunk(2, dim=-1))
            if tp is not None:
                scale_shift = tuple(shard(e, -1, tp.tp_group) for e in scale_shift)
        if tp is None:
            h = self.Block_1(self.Block_0(x, scale_shift, cm, frames=frames), cm=cm,
                             frames=frames)
        else:
            h = self.Block_0(x, scale_shift, tp=tp)
            h = self.Block_1(gather(h, -1, tp.tp_group, partial=True), tp=tp)
        if not hasattr(self, "res_kernel"):
            return h + (x if tp is None else x.narrow(-1, tp.tp_rank * h.shape[-1], h.shape[-1]))
        dt = self.dtype or x.dtype
        if tp is not None:
            kernel, bias = cols(self, "res_kernel", 1, tp), cols(self, "res_bias", 0, tp)
        else:
            kernel, bias = whole(self, "res_kernel"), whole(self, "res_bias")
        if cm:
            return h + (torch.einsum("bcn,cd->bdn", x.to(dt), kernel.to(dt))
                        + bias.to(dt)[:, None])
        return h + (x.to(dt) @ kernel.to(dt) + bias.to(dt))


class SpatialLinearAttention(nn.Module):
    """Linear attention over the pixel tokens of a [..., H, W, C] map plus an
    output bias: kernel K3. No UNet configuration builds it (the UNet uses
    the fused ``LinearAttentionBlock``); ``PreNormResidual`` around it is
    the unfused form of that block."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=None):
        super().__init__()
        hidden = heads * dim_head
        self.w_qkv = _lecun(dim, 3 * hidden)
        self.w_out = _lecun(hidden, dim)
        self.b_out = nn.Parameter(torch.zeros(dim))
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype

    def forward(self, x):
        *lead, h, w, c = x.shape
        dt = self.dtype or x.dtype
        tokens = x.reshape(-1, h * w, c).to(dt).contiguous()
        out = linear_attention(tokens, self.w_qkv, self.w_out, self.heads, self.dim_head)
        return out.reshape(*lead, h, w, -1) + self.b_out.to(dt)


class LinearAttentionBlock(nn.Module):
    """x + b_out + LA(LN_gamma(x)) over the pixel tokens: kernel K1; ``cm``
    takes and returns channel-major [B, C, N].

    With ``sp_mesh`` (tp > 1 dividing the tokens) the block runs
    sequence-parallel instead: each tp rank takes its contiguous tokens,
    the attention's statistics cross ranks, and every rank gets the whole
    output (``parallel.seq_attention``, plain PyTorch as in JAX)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=None,
                 sp_mesh: Optional[Mesh] = None):
        super().__init__()
        hidden = heads * dim_head
        self.ln_gamma = nn.Parameter(torch.ones(dim))
        self.w_qkv = _lecun(dim, 3 * hidden)
        self.w_out = _lecun(hidden, dim)
        self.b_out = nn.Parameter(torch.zeros(dim))
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.sp_mesh = sp_mesh

    def forward(self, x, cm: bool = False, tp: Optional[Mesh] = None):
        """``tp``: x is the rank's channels of a wide stage; the block runs
        on the gathered x (its LN needs every channel) and returns the
        rank's channels."""
        gamma, w_qkv, w_out, b_out = (whole(self, n)
                                      for n in ("ln_gamma", "w_qkv", "w_out", "b_out"))
        dt = self.dtype or x.dtype
        if cm:
            return linear_attention_block(x.to(dt), gamma, w_qkv, w_out, b_out, self.heads,
                                          self.dim_head, channel_major=True)
        if tp is not None:
            x = gather(x, -1, tp.tp_group, partial=False)
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c).to(dt)
        sp = self.sp_mesh
        if sp is not None and sp.tp > 1 and (h * w) % sp.tp == 0:
            out = sequence_sharded_linear_attention_block(
                shard(tokens, 1, sp.tp_group), gamma, w_qkv, w_out, b_out, sp.tp_group,
                self.heads, self.dim_head, gather_output=True)
        else:
            out = linear_attention_block(tokens, gamma, w_qkv, w_out, b_out, self.heads,
                                         self.dim_head)
        out = out.reshape(b, h, w, c)
        return out if tp is None else shard(out, -1, tp.tp_group)


def _rope_rotate(x: torch.Tensor, positions: torch.Tensor, dim_head: int) -> torch.Tensor:
    """Rotary position embedding on the last axis (JAX's ``_rope_rotate``,
    the rotate-half convention), in float32."""
    half = dim_head // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32, device=x.device)
                               / half))
    angles = positions[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot, x[..., 2 * half:]], dim=-1) if dim_head > 2 * half else rot


class Embed(nn.Module):
    """A lookup table, Flax ``nn.Embed``'s ``embedding`` [num, features]."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num, features) / math.sqrt(features))


class RelativePositionBias(nn.Module):
    """T5-bucketed relative position bias [heads, n, n] (JAX's
    ``RelativePositionBias``)."""

    def __init__(self, heads: int = 8, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.Embed_0 = Embed(num_buckets, heads)
        self.num_buckets, self.max_distance = num_buckets, max_distance

    def forward(self, n: int) -> torch.Tensor:
        table = self.Embed_0.embedding
        pos = torch.arange(n, device=table.device)
        neg = pos[:, None] - pos[None, :]  # -(k - q)
        nb = self.num_buckets // 2
        max_exact = nb // 2
        num = neg.abs()
        large = max_exact + (torch.log(num.float() / max_exact + 1e-9)
                             / math.log(self.max_distance / max_exact)
                             * (nb - max_exact)).long()
        buckets = (neg < 0).long() * nb + torch.where(num < max_exact, num,
                                                      large.clamp(max=nb - 1))
        return table[buckets].permute(2, 0, 1)


class Attention(nn.Module):
    """Full multi-head softmax attention over the token axis of [b, n, C],
    with RoPE on q and k (``use_rope``) and an additive [heads, n, n] bias."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=None,
                 use_rope: bool = False):
        super().__init__()
        hidden = heads * dim_head
        self.Dense_0 = nn.Linear(dim, 3 * hidden, bias=False)
        self.Dense_1 = nn.Linear(hidden, dim, bias=False)
        self.heads, self.dim_head, self.dtype, self.use_rope = heads, dim_head, dtype, use_rope

    def forward(self, x, pos_bias: Optional[torch.Tensor] = None):
        b, n, _ = x.shape
        qkv = _dense(x, self.Dense_0, self.dtype).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))  # [b, heads, n, d]
        if self.use_rope:
            pos = torch.arange(n, dtype=torch.float32, device=x.device)
            q, k = _rope_rotate(q, pos, self.dim_head), _rope_rotate(k, pos, self.dim_head)
        sim = (q * self.dim_head**-0.5) @ k.transpose(-1, -2)
        if pos_bias is not None:
            sim = sim + pos_bias
        attn = (sim - sim.amax(dim=-1, keepdim=True)).softmax(dim=-1)
        out = (attn @ v.to(attn.dtype)).transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return _dense(out, self.Dense_1, self.dtype)


class FrameAttention(nn.Module):
    """Attention along the frame axis, per pixel. Its parameters follow
    the F that the Flax tree was initialised at: at F == 1 (``multi_frame``
    False) ``to_qkv_kernel`` and ``to_out_kernel``, and softmax over one key
    is 1, so the block is the per-token map x (W_v W_out); at F > 1
    ``RelativePositionBias_0`` (32 buckets, max distance 32) and
    ``Attention_0`` (full attention with RoPE), plain PyTorch as JAX's is
    plain XLA."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dtype=None,
                 multi_frame: bool = False):
        super().__init__()
        self.hidden = heads * dim_head
        self.multi_frame = multi_frame
        if multi_frame:
            self.RelativePositionBias_0 = RelativePositionBias(heads, max_distance=32)
            self.Attention_0 = Attention(dim, heads, dim_head, dtype, use_rope=True)
        else:
            self.to_qkv_kernel = _lecun(dim, 3 * self.hidden)
            self.to_out_kernel = _lecun(self.hidden, dim)
        self.dtype = dtype

    def forward(self, x, frames: int = 1):
        """x: [B F, H, W, C], each batch row's ``frames`` frames consecutive."""
        if self.multi_frame != (frames > 1):
            raise ValueError(f"this FrameAttention holds the parameters of "
                             f"{'F > 1' if self.multi_frame else 'F == 1'} and got F={frames} "
                             "(UNet(multi_frame=...) follows the Flax tree)")
        if frames > 1:
            bf, h, w, c = x.shape
            tokens = x.reshape(bf // frames, frames, h * w, c).transpose(1, 2)
            out = self.Attention_0(tokens.reshape(-1, frames, c),
                                   pos_bias=self.RelativePositionBias_0(frames))
            return (out.reshape(bf // frames, h * w, frames, -1).transpose(1, 2)
                    .reshape(bf, h, w, -1))
        dt = self.dtype or x.dtype
        w_qkv, w_out = whole(self, "to_qkv_kernel"), whole(self, "to_out_kernel")
        w_eff = (w_qkv[:, 2 * self.hidden:] @ w_out).to(dt)
        return x.to(dt) @ w_eff


def _no_attention(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """A level stage's attention in a UNet built without it."""
    return x


class PreNormResidual(nn.Module):
    """x + fn(LayerNorm(x))."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.ChannelLayerNorm_0 = ChannelLayerNorm(dim)
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(self.ChannelLayerNorm_0(x), **kwargs) + x


class UNet(nn.Module):
    """Physics-informed diffusion denoiser; Darcy is ``UNet(dim=32, channels=2)``,
    mechanics ``UNet(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True)``.

    ``dtype`` is the compute dtype (None: float32); parameters stay float32.
    ``fp32_head`` runs the final block and 1x1 conv in float32 under a
    bf16 ``dtype``. ``cm_conv_stages`` runs the level stages narrower than
    128 channels channel-major through K4; ``padding_mode`` ('zeros' or
    'circular') and ``self_condition`` as in the module docstring.

    ``tp_mesh`` (a mesh with tp > 1; JAX's ``_tp_constrain``) splits the
    wide stages over the tp ranks: at a level or mid stage of C >=
    ``tp_min_width`` channels, with C and ``resnet_groups`` divisible by tp
    (and not channel-major), what passes between its modules is the rank's
    C/tp channels. Each ResnetBlock, and the Downsample or Upsample after
    it, is column-parallel (the gathered input, the rank's output-channel
    weights; K2 on groups // tp groups); a LinearAttentionBlock gathers x,
    runs K1 alike on every rank and keeps its channels; the skip
    concatenation gathers both halves first. Everything else runs alike on
    every rank. ``sp_mesh`` runs the LinearAttentionBlocks
    sequence-parallel. The parameters themselves are split by
    ``parallel.mesh.shard_params``; a module gathers what it needs whole.
    ``multi_frame`` builds the frame attention's F > 1 parameters (JAX's
    tree at F > 1) in place of its F == 1 ones; on frames there are no
    channel-major or tp-split stages, as in JAX. ``init_dim`` (default
    ``dim``), ``use_sparse_linear_attn`` and ``cond_path`` as in the module
    docstring; without the cond path a ``cond`` argument is ignored, as JAX's
    UNet ignores it.
    """

    def __init__(self, dim: int, channels: int = 2, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), attn_heads: int = 8,
                 attn_dim_head: int = 32, init_kernel_size: int = 7, resnet_groups: int = 8,
                 frame_attention: bool = True, dtype: Optional[torch.dtype] = None,
                 fp32_head: bool = False, cm_conv_stages: bool = False,
                 sigmoid_last_channel: bool = False, padding_mode: str = "zeros",
                 self_condition: bool = False, tp_mesh: Optional[Mesh] = None,
                 tp_min_width: int = 128, sp_mesh: Optional[Mesh] = None,
                 multi_frame: bool = False, init_dim: Optional[int] = None,
                 use_sparse_linear_attn: bool = True, cond_path: bool = True):
        super().__init__()
        if padding_mode not in ("zeros", "circular"):
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        dt, g, pm = dtype, resnet_groups, padding_mode
        heads = (attn_heads, attn_dim_head)
        time_dim = dim * 4
        self.dim = dim
        init_dim = init_dim or dim
        self.frame_attention = frame_attention
        self.cond_path = cond_path
        self.fp32_head = fp32_head
        self.cm_conv_stages = cm_conv_stages
        self.sigmoid_last_channel = sigmoid_last_channel
        self.padding_mode = padding_mode
        self.self_condition = self_condition
        self.dtype = dtype
        self.resnet_groups = resnet_groups
        self.tp_mesh, self.tp_min_width = tp_mesh, tp_min_width

        self.init_conv = Conv2dPadded(channels * (2 if self_condition else 1), init_dim,
                                      init_kernel_size, 1, init_kernel_size // 2, dt, pm)
        if frame_attention:
            self.init_frame_attn = PreNormResidual(init_dim, FrameAttention(
                init_dim, *heads, dt, multi_frame))
        if cond_path:
            self.emb_conv_0 = nn.Conv2d(channels, init_dim, 1)
            self.emb_conv_1 = Conv2dPadded(init_dim, init_dim, 3, 1, 1, dt)
            self.combine_conv = nn.Conv2d(2 * init_dim, init_dim, 1)
        self.time_pos_emb = SinusoidalPosEmb(dim)
        self.time_mlp_0 = nn.Linear(dim, time_dim)
        self.time_mlp_1 = nn.Linear(time_dim, time_dim)

        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        counts = {"ResnetBlock": 0, "LinearAttentionBlock": 0, "Downsample": 0, "Upsample": 0}

        def add(kind: str, module: nn.Module) -> nn.Module:
            self.add_module(f"{kind}_{counts[kind]}", module)
            counts[kind] += 1
            return module

        def attention(width: int):
            if not use_sparse_linear_attn:
                return _no_attention
            return add("LinearAttentionBlock", LinearAttentionBlock(width, *heads, dt, sp_mesh))

        self.downs = []
        for i, (din, dout) in enumerate(in_out):
            self.downs.append((
                dout,
                add("ResnetBlock", ResnetBlock(din, dout, time_dim, g, dt, pm)),
                add("ResnetBlock", ResnetBlock(dout, dout, time_dim, g, dt, pm)),
                attention(dout),
                add("Downsample", Downsample(dout, dt, pm)) if i < len(in_out) - 1 else None,
            ))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, g, dt, pm)
        self.mid_spatial_attn = PreNormResidual(mid, Attention(mid, *heads, dt))
        if frame_attention:
            self.mid_frame_attn = PreNormResidual(mid, FrameAttention(mid, *heads, dt,
                                                                      multi_frame))
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, g, dt, pm)
        self.ups = []
        for i, (din, dout) in enumerate(reversed(in_out)):
            self.ups.append((
                din,
                add("ResnetBlock", ResnetBlock(2 * dout, din, time_dim, g, dt, pm)),
                add("ResnetBlock", ResnetBlock(din, din, time_dim, g, dt, pm)),
                attention(din),
                add("Upsample", Upsample(din, dt, pm)) if i < len(in_out) - 1 else None,
            ))
        head_dt = None if fp32_head else dt
        self.final_block = ResnetBlock(2 * init_dim, dim, None, g, head_dt, pm)
        self.final_conv = nn.Conv2d(dim, out_dim or channels, 1)
        self.head_dtype = head_dt

    def _use_cm(self, width: int, x: torch.Tensor, frames: int = 1) -> bool:
        """Whether a stage of ``width`` channels on NHWC ``x`` runs
        channel-major (JAX's ``_use_cm``: never with circular padding, nor
        on frames)."""
        return (self.cm_conv_stages and width < 128 and x.ndim == 4 and frames == 1
                and self.padding_mode == "zeros"
                and x.shape[1] == x.shape[2] and x.shape[2] <= MAX_P)

    def forward(self, x: torch.Tensor, time: torch.Tensor, cond: Optional[torch.Tensor] = None,
                null_mask: Optional[torch.Tensor] = None,
                x_self_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, channels], or [B, F, H, W, channels] with a frame
        axis (F == 1 runs as [B, H, W, channels] and keeps its frame axis; F
        > 1 needs ``multi_frame``, and cond, null_mask and x_self_cond
        then take the frame axis too); time: [B] (or scalar) integer timesteps;
        cond: an optional [B, H, W, channels] conditioning image (the
        residual gradient), which replaces the stem's output by
        ``combine_conv([x, emb(cond)])``; null_mask: an optional [B] bool
        tensor, True where a sample's cond is zeroed (classifier-free
        guidance training). A masked sample still goes through the
        conditioning branch, with a zero cond; only cond=None bypasses it.
        x_self_cond: with ``self_condition``, the [B, H, W, channels] image
        put before x on the channel axis (zeros when None); ignored
        otherwise, as in JAX.

        Frames (JAX's ``UNet.__call__``): each batch row's F frames run as
        consecutive images of one batch ([B F, H, W, C]) through the convs,
        the linear and the spatial attention; the Blocks' GroupNorm spans a
        row's frames, the time embedding is the row's, and the frame
        attention mixes the frames of each pixel."""
        frames, squeeze = 1, False
        if x.ndim == 5:
            if x.shape[1] == 1:
                x, squeeze = x[:, 0], True
                x_self_cond = None if x_self_cond is None else x_self_cond[:, 0]
                cond = None if cond is None else cond[:, 0]
            else:
                frames = x.shape[1]
        time = torch.broadcast_to(torch.atleast_1d(time), (x.shape[0],))
        if frames > 1:
            x = x.flatten(0, 1)
            x_self_cond = None if x_self_cond is None else x_self_cond.flatten(0, 1)
            cond = None if cond is None else cond.flatten(0, 1)
            null_mask = None if null_mask is None else null_mask.repeat_interleave(frames)
        out = self._forward(x, time, cond, null_mask, x_self_cond, frames)
        if frames > 1:
            return out.unflatten(0, (-1, frames))
        return out[:, None] if squeeze else out

    def _forward(self, x, time, cond, null_mask, x_self_cond, frames: int):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond.to(x.dtype), x], dim=-1)
        x = self.init_conv(x)
        if self.frame_attention:
            x = self.init_frame_attn(x, frames=frames)
        if cond is not None and self.cond_path:
            if null_mask is not None:
                cond = torch.where(null_mask.reshape(-1, 1, 1, 1), 0.0, cond)
            c = self.emb_conv_0
            emb = F.gelu(_conv(cond, whole(c, "weight"), whole(c, "bias"), self.dtype))
            emb = self.emb_conv_1(emb)
            c = self.combine_conv
            x = _conv(torch.cat([x, emb.to(x.dtype)], dim=-1), whole(c, "weight"),
                      whole(c, "bias"), self.dtype)
        r = x
        t = _dense(self.time_pos_emb(time), self.time_mlp_0, self.dtype)
        t = _dense(F.gelu(t), self.time_mlp_1, self.dtype)

        tp = self.tp_mesh if self.tp_mesh is not None and self.tp_mesh.tp > 1 else None

        def wide(width: int) -> bool:
            """A stage split over tp (JAX ``_tp_constrain``'s condition:
            never on frames)."""
            return (tp is not None and width >= self.tp_min_width and width % tp.tp == 0
                    and self.resnet_groups % tp.tp == 0 and frames == 1)

        def whole_act(a, split: bool):
            """An activation whole, for work every rank does alike."""
            return gather(a, -1, tp.tp_group, partial=False) if split else a

        def cols_input(a, split: bool):
            """An activation whole, for column-parallel work."""
            return (gather(a, -1, tp.tp_group, partial=True) if split
                    else enter_partial(a, tp.tp_group))

        def wide_stage(a, res0, res1, attn):
            a = res0(a, t, tp=tp)
            return attn(res1(gather(a, -1, tp.tp_group, partial=True), t, tp=tp), tp=tp)

        split = False  # whether x holds the rank's channels only
        skips = []  # (layout "cm" or "nat", tensor, split)
        for width, res0, res1, attn, down in self.downs:
            if self._use_cm(width, x, frames):
                x, split = whole_act(x, split), False
                h, w = x.shape[1:3]
                xc = attn(res1(res0(channel_major(x), t, cm=h), t, cm=h), cm=True)
                skips.append(("cm", xc, False))
                x = from_channel_major(xc, h, w)
            elif wide(width):
                x, split = wide_stage(cols_input(x, split), res0, res1, attn), True
                skips.append(("nat", x, True))
            else:
                x = res1(res0(whole_act(x, split), t, frames=frames), t, frames=frames)
                x, split = attn(x), False
                skips.append(("nat", x, False))
            if down is not None:
                x = down(gather(x, -1, tp.tp_group, partial=True), tp) if split else down(x)

        mid = self.downs[-1][0]
        if wide(mid):
            x = whole_act(self.mid_block1(cols_input(x, split), t, tp=tp), True)
        else:
            x = self.mid_block1(whole_act(x, split), t, frames=frames)
        b, h, w, c = x.shape
        x = self.mid_spatial_attn(x.reshape(b, h * w, c)).reshape(b, h, w, c)
        if self.frame_attention:
            x = self.mid_frame_attn(x, frames=frames)
        if wide(mid):
            x, split = self.mid_block2(enter_partial(x, tp.tp_group), t, tp=tp), True
        else:
            x, split = self.mid_block2(x, t, frames=frames), False

        for width, res0, res1, attn, up in self.ups:
            kind, skip, skip_split = skips.pop()
            if kind == "cm" and self._use_cm(width, x, frames):
                x = whole_act(x, split)
                h, w = x.shape[1:3]
                xc = torch.cat([channel_major(x), skip], dim=1)
                xc = attn(res1(res0(xc, t, cm=h), t, cm=h), cm=True)
                x, split = from_channel_major(xc, h, w), False
            else:
                if kind == "cm":
                    skip = from_channel_major(skip, *x.shape[1:3])
                if wide(width):
                    x = torch.cat([cols_input(x, split), cols_input(skip, skip_split)], dim=-1)
                    x, split = wide_stage(x, res0, res1, attn), True
                else:
                    x = torch.cat([whole_act(x, split), whole_act(skip, skip_split)], dim=-1)
                    x = res1(res0(x, t, frames=frames), t, frames=frames)
                    x, split = attn(x), False
            if up is not None:
                x = up(gather(x, -1, tp.tp_group, partial=True), tp) if split else up(x)

        x = whole_act(x, split)
        if self._use_cm(self.dim, x, frames) and not self.fp32_head:
            h, w = x.shape[1:3]
            xc = torch.cat([channel_major(x), channel_major(r)], dim=1)
            x = from_channel_major(self.final_block(xc, cm=h), h, w)
        else:
            x = torch.cat([x, r], dim=-1)
            if self.fp32_head:
                x = x.float()
            x = self.final_block(x, frames=frames)
        c = self.final_conv
        x = _conv(x, whole(c, "weight"), whole(c, "bias"), self.head_dtype)
        if self.sigmoid_last_channel:
            x = torch.cat([x[..., :-1], torch.sigmoid(x[..., -1:])], dim=-1)
        return x


def apply_with_guidance(model: UNet, x: torch.Tensor, time: torch.Tensor, cond: torch.Tensor,
                        guidance_scale: float = 3.0) -> torch.Tensor:
    """Two-pass classifier-free guidance, null + scale * (cond - null), the
    null pass with a zero cond; one conditioned pass at scale 1."""
    logits = model(x, time, cond=cond)
    if guidance_scale == 1.0:
        return logits
    null_logits = model(x, time, cond=torch.zeros_like(cond))
    return null_logits + (logits - null_logits) * guidance_scale


def build_model(cfg, compute_dtype: Optional[str] = None, mesh: Optional[Mesh] = None) -> UNet:
    """The study's UNet for a ``RunConfig`` (Darcy or mechanics).
    ``compute_dtype`` overrides ``cfg.compute_dtype``. On a ``mesh`` with tp
    > 1, ``cfg.tp_shard_activations`` splits the wide stages and
    ``cfg.seq_parallel_attn`` runs the linear attention sequence-parallel
    over tp, as JAX's ``build_model``; the parameters are split by
    ``parallel.mesh.shard_params``."""
    name = compute_dtype or cfg.compute_dtype
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute dtype {name!r}")
    dtype = torch.bfloat16 if name == "bfloat16" else None
    tp_on = mesh is not None and mesh.tp > 1
    return UNet(dim=cfg.unet_dim, channels=cfg.model_channels, out_dim=cfg.output_channels,
                frame_attention=cfg.frame_attention, dtype=dtype,
                fp32_head=cfg.fp32_head and dtype is not None,
                sigmoid_last_channel=cfg.sigmoid_last_channel,
                padding_mode="circular" if cfg.bcs == "periodic" else "zeros",
                self_condition=cfg.self_condition,
                tp_mesh=mesh if tp_on and cfg.tp_shard_activations else None,
                sp_mesh=mesh if tp_on and cfg.seq_parallel_attn else None)
