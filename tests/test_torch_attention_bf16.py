"""K1 and K3 on bf16 input: the port's plain versions, forward and autograd,
against the JAX package's Pallas kernels and their custom VJPs on the same
bf16 input, run in interpret mode as the JAX package's own tests run them.

On bf16 x the TPU kernels multiply bf16 operands with fp32 sums (``_mm`` and
``_dg``, ``ops/pallas_attention.py``). The port's plain versions round the
same operands but M (``_attention_bf16``), and its CUDA kernels, which
multiply bf16 x on the tensor cores, are held to them on the card
(``tests/test_torch_cuda.py``). Here that rounding is held to JAX's:

  * each output and gradient lies within twice JAX's own bf16 rounding, the
    largest |JAX bf16 - JAX fp32| on the same input (the rule of
    ``test_torch_bf16.py``): both sides round, but not all in the same
    places (the TPU's K3 projects ctx^T q through W_out in a second product,
    where the port folds W_out into M as K1 does, and keeps M in fp32), and
    they sum in other orders;
  * each gradient lies nearer JAX's bf16 gradient than JAX's fp32 one does,
    by NEARER at least: a plain version that does not round (fp32
    arithmetic on the bf16 input) sits at that distance, a ratio of 1.

XLA:CPU does not run the Pallas K1 on bf16 in interpret mode ("Unsupported
element type for DotThunk::Execute: BF16 x BF16 = F32"), so K1's JAX side is
x + b_out + K3(LN_gamma(x) rounded to bf16), the TPU K1's own first rounding,
with the Pallas K3 in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.ops import pallas_attention as pa
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention_block_plain,
    linear_attention_plain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADS, DH = 8, 32
H = HEADS * DH
# W_out and the v columns of W_qkv each scaled by sqrt(GAIN * N): the
# attention term is O(1) beside x and every gradient well above rounding
GAIN = 100.0
# the port's bf16 gradients lie at most this share of JAX's bf16-to-fp32
# distance from JAX's bf16 gradients
NEARER = 0.9


def _k3_jax(x, w_qkv, w_out):
    yt = pa._linear_attention_pallas(jnp.swapaxes(x, -1, -2), jnp.swapaxes(w_qkv, 0, 1),
                                     jnp.swapaxes(w_out, 0, 1), HEADS, DH, True)
    return jnp.swapaxes(yt, -1, -2)


def _k1_jax(x, w_qkv, w_out, gamma, b_out, eps=1e-5):
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = ((xf - mu) ** 2).mean(-1, keepdims=True)
    ln = ((xf - mu) * jax.lax.rsqrt(var + eps) * gamma).astype(x.dtype)
    return (xf + b_out + _k3_jax(ln, w_qkv, w_out).astype(jnp.float32)).astype(x.dtype)


def _k1_port(x, w_qkv, w_out, gamma, b_out):
    return linear_attention_block_plain(x, gamma, w_qkv, w_out, b_out, HEADS, DH)


def _k3_port(x, w_qkv, w_out, *_):
    return linear_attention_plain(x, w_qkv, w_out, HEADS, DH)


def _inputs(b, n, c, seed):
    """x (bf16-representable), W_qkv, W_out, gamma, b_out."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    w_qkv = (rng.standard_normal((c, 3 * H)) / np.sqrt(c)).astype(np.float32)
    w_qkv[:, 2 * H:] *= np.float32(np.sqrt(GAIN * n))
    w_out = (rng.standard_normal((H, c)) * np.sqrt(GAIN * n / H)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w_qkv, w_out, gamma, b_out


def _max(a) -> float:
    return float(np.abs(np.asarray(a, np.float32)).max())


@pytest.mark.parametrize("kind", ["k1", "k3"])
@pytest.mark.parametrize("b,n,c", [(2, 256, 32), (2, 128, 64), (2, 64, 128)])
def test_bf16_plain_attention_rounds_as_the_tpu_kernel(kind, b, n, c):
    jax_fn, port_fn = {"k1": (_k1_jax, _k1_port), "k3": (_k3_jax, _k3_port)}[kind]
    x, *params = _inputs(b, n, c, seed=n + c)
    n_args = 5 if kind == "k1" else 3
    params = params[:n_args - 1]

    def jax_loss(xx, *p):
        return jnp.sum(jnp.sin(jax_fn(xx, *p).astype(jnp.float32)))

    jax_params = [jnp.asarray(p) for p in params]
    jax_out, jax_grads = {}, {}
    for dtype in (jnp.bfloat16, jnp.float32):
        xx = jnp.asarray(x, dtype)
        jax_out[dtype] = np.asarray(jax_fn(xx, *jax_params).astype(jnp.float32))
        jax_grads[dtype] = [np.asarray(g, np.float32) for g in
                            jax.grad(jax_loss, argnums=tuple(range(n_args)))(xx, *jax_params)]
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(True)]
    leaves += [torch.from_numpy(p).requires_grad_(True) for p in params]
    out = port_fn(*leaves)
    assert out.dtype == torch.bfloat16
    torch.sin(out.float()).sum().backward()

    ref, ref32 = jax_out[jnp.bfloat16], jax_out[jnp.float32]
    assert _max(ref - x) >= 1.0  # the attention term is O(1)
    gap, rounding = _max(out.detach().float().numpy() - ref), _max(ref - ref32)
    assert gap <= 2 * rounding, (kind, "out", gap, rounding)
    for i, leaf in enumerate(leaves):
        got = leaf.grad.float().numpy()
        g16, g32 = jax_grads[jnp.bfloat16][i], jax_grads[jnp.float32][i]
        gap, rounding = _max(got - g16), _max(g16 - g32)
        assert rounding > 0 and gap <= NEARER * rounding, (kind, i, gap, rounding)
