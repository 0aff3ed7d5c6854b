"""Linear attention with the tokens split over a group of ranks (port of
``parallel/seq_attention.py``).

Linear attention is exactly sequence-parallel: its only couplings across
tokens are the k-softmax statistics and the context,

    m   = max_n k[n]                          (all_max, zero gradient)
    Z   = sum_n exp(k[n] - m)                 (all_sum)
    ctx = sum_n exp(k[n] - m) / Z . v[n] / N  (all_sum of the ranks' partials)

after which each rank finishes its own tokens (the q softmax is per
token). As in the JAX package this is plain PyTorch, no kernel. A rank
passes its own tokens [B, N/s, C]; the weights are the same on every rank,
and each rank's weight gradient comes out whole (their shares are summed).
"""

from __future__ import annotations

import torch

from physicsinformeddiffusionmodels_tpu_torch.parallel.collectives import (
    all_max,
    all_sum,
    enter_partial,
    gather,
)


def _attend(x: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor, group, n_total: int,
            heads: int, dim_head: int) -> torch.Tensor:
    """LA of the rank's tokens x [B, n, C] (in x's dtype): [B, n, C_out]."""
    b, n, _ = x.shape
    q, k, v = (x @ w_qkv).split(heads * dim_head, dim=-1)
    k = k.reshape(b, n, heads, dim_head)
    v = v.reshape(b, n, heads, dim_head)
    m = all_max(k.amax(dim=1), group)                       # [B, heads, dh]
    ek = torch.exp(k - m[:, None])
    z = all_sum(ek.sum(dim=1), group)
    ctx = all_sum(torch.einsum("bnhd,bnhe->bhde", ek, v / n_total), group) / z[..., None]
    q = q.reshape(b, n, heads, dim_head).softmax(dim=-1) * dim_head**-0.5
    return torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(b, n, heads * dim_head) @ w_out


def sequence_sharded_linear_attention(x: torch.Tensor, w_qkv: torch.Tensor,
                                      w_out: torch.Tensor, group, heads: int = 8,
                                      dim_head: int = 32) -> torch.Tensor:
    """LA(x) of the rank's tokens x [B, N/s, C] of a sequence split in rank
    order over ``group`` (s ranks); w_qkv: [C, 3H]; w_out: [H, C]. Returns
    the rank's [B, N/s, C] of ``ops.linear_attention.linear_attention_plain``
    on the whole sequence."""
    n_total = x.shape[1] * torch.distributed.get_world_size(group)
    return _attend(x, enter_partial(w_qkv, group), enter_partial(w_out, group), group,
                   n_total, heads, dim_head)


def sequence_sharded_linear_attention_block(
        x: torch.Tensor, gamma: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
        b_out: torch.Tensor, group, heads: int = 8, dim_head: int = 32, eps: float = 1e-5,
        gather_output: bool = False) -> torch.Tensor:
    """``x + b_out + LA(LN_gamma(x))`` of the rank's tokens x [B, N/s, C]:
    LN, the bias and the residual are per token, only the attention's
    statistics cross ranks. The LN and the sums run in fp32, the products in
    x's dtype (the weights are cast to it), as JAX's. With ``gather_output``
    the result is every rank's tokens, [B, N, C], whose downstream work
    every rank then does alike."""
    n_total = x.shape[1] * torch.distributed.get_world_size(group)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    ln = ((xf - mu) / torch.sqrt(var + eps) * enter_partial(gamma.float(), group)).to(x.dtype)
    out = _attend(ln, enter_partial(w_qkv.to(x.dtype), group),
                  enter_partial(w_out.to(x.dtype), group), group, n_total, heads, dim_head)
    y = (out.float() + enter_partial(b_out.float(), group) + xf).to(x.dtype)
    return gather(y, 1, group, partial=False) if gather_output else y
