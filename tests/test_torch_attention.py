"""K3, the unfused linear attention: the port's plain version and its autograd
against the JAX Pallas kernel and its custom VJP (run in interpret mode, as
the JAX package's own tests run them), the wrapper's CPU routing, and
``SpatialLinearAttention`` carried over from Flax. The CUDA kernels are held
against the plain version in test_torch_cuda.py, on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models import unet as junet
from physicsinformeddiffusionmodels_tpu.ops import pallas_attention as pa
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import (
    PreNormResidual,
    SpatialLinearAttention,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention,
    linear_attention_plain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADS, DH = 8, 32
H = HEADS * DH
# v is divided by N and the k softmax averages it over the tokens, so with
# unit-scale weights LA(x) is 1e-5..1e-3; W_out scaled by LA_GAIN * N makes
# it O(1), so the forward comparison sees the attention
LA_GAIN = 100.0
# gradients: W_out and the v columns of W_qkv scaled by sqrt(GRAD_GAIN * N)
# each, so every gradient, and each q/k/v part of dW_qkv, reaches GRAD_MIN_MAX
# (100x the tolerance) and a VJP off by 1% on any of them fails
GRAD_GAIN, GRAD_TOL = 10.0, 5e-4
GRAD_MIN_MAX = 100 * GRAD_TOL


def _inputs(b, n, c, seed, w_out_gain=1.0, v_gain=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w_qkv = (rng.standard_normal((c, 3 * H)) / np.sqrt(c)).astype(np.float32)
    w_qkv[:, 2 * H:] *= np.float32(v_gain)
    w_out = (rng.standard_normal((H, c)) * w_out_gain / np.sqrt(H)).astype(np.float32)
    return x, w_qkv, w_out


def _pallas(x, w_qkv, w_out):
    yt = pa._linear_attention_pallas(jnp.swapaxes(x, -1, -2), jnp.swapaxes(w_qkv, 0, 1),
                                     jnp.swapaxes(w_out, 0, 1), HEADS, DH, True)
    return jnp.swapaxes(yt, -1, -2)


def _t(a):
    return torch.from_numpy(np.array(a))


# the cases of the JAX package's tests/test_pallas_attention.py (1024: more
# tokens than one tile at the older tile cap)
@pytest.mark.parametrize("n,c", [(256, 32), (128, 64), (384, 32), (1024, 32)])
def test_linear_attention_plain_matches_pallas_interpret(n, c):
    x, w_qkv, w_out = _inputs(2, n, c, seed=n + c, w_out_gain=LA_GAIN * n)
    ref = np.asarray(_pallas(x, w_qkv, w_out))
    assert np.abs(ref).max() >= 1.0
    got = linear_attention_plain(_t(x), _t(w_qkv), _t(w_out), HEADS, DH).numpy()
    # fp32 both; the Pallas body streams the token softmax over tiles and
    # sums in another order (the JAX package's own kernel tolerance)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,n,c", [(3, 256, 32), (2, 128, 64)])
def test_linear_attention_plain_gradients_match_pallas_interpret(b, n, c):
    gain = np.sqrt(GRAD_GAIN * n)
    args = _inputs(b, n, c, seed=7 + n, w_out_gain=gain, v_gain=gain)

    def loss(x, w_qkv, w_out):
        return jnp.sum(jnp.sin(_pallas(x, w_qkv, w_out)))

    ref = [np.asarray(r) for r in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, args))]
    names = ("dx", "dw_qkv", "dw_out")
    parts = dict(zip(names, ref))
    parts.update({f"dw_{p}": ref[1][:, i * H:(i + 1) * H] for i, p in enumerate("qkv")})
    for name, r in parts.items():
        assert np.abs(r).max() >= GRAD_MIN_MAX, f"{name}: max |g| {np.abs(r).max():.3e}"
    leaves = [_t(a).requires_grad_(True) for a in args]
    torch.sin(linear_attention_plain(*leaves, HEADS, DH)).sum().backward()
    # the JAX package's own tolerance for its Pallas VJP against autodiff
    for name, leaf, r in zip(names, leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_linear_attention_wrapper_uses_the_plain_version_for_cpu_tensors():
    x, w_qkv, w_out = map(_t, _inputs(2, 64, 32, seed=3, w_out_gain=LA_GAIN * 64))
    before = (linear_attention.launches, linear_attention.backward_launches)
    np.testing.assert_array_equal(linear_attention(x, w_qkv, w_out).numpy(),
                                  linear_attention_plain(x, w_qkv, w_out).numpy())
    out = linear_attention(x.bfloat16(), w_qkv, w_out)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               linear_attention_plain(x.bfloat16().float(), w_qkv, w_out).numpy(),
                               atol=0.05, rtol=0.02)
    assert (linear_attention.launches, linear_attention.backward_launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        linear_attention(torch.empty((1, 16, 32), device="meta"), w_qkv, w_out)


def test_prenorm_spatial_linear_attention_carried_over_from_flax():
    """``PreNormResidual(C, SpatialLinearAttention(C))``, the unfused form of
    the UNet's attention block, with the weights of a Flax one."""
    c, p = 32, 16
    flax_model = junet.PreNormResidual(c, junet.SpatialLinearAttention(c))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, p, p, c)).astype(np.float32)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), x)
    # every leaf drawn (a zero-initialised b_out would hide a dropped bias);
    # W_out at LA_GAIN * N so the attention term is O(1) beside x
    gains = {"w_out": LA_GAIN * p * p / np.sqrt(H), "w_qkv": c**-0.5, "b_out": 0.1,
             "gamma": 0.1}

    def draw(path, leaf):
        name = path[-1].key
        a = rng.standard_normal(leaf.shape) * gains[name]
        return (a + 1.0 if name == "gamma" else a).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    ref = np.asarray(flax_model.apply(params, x))
    assert np.abs(ref - x).max() >= 1.0
    model = PreNormResidual(c, SpatialLinearAttention(c))
    model.load_state_dict(torch_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # fp32 both; the same arithmetic in another order
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_profile_attn_forms_agree_on_the_cpu(monkeypatch):
    """The profiler's K3 and K1 forms compute the same function (LN scale 1,
    b_out 0), here through the plain versions at a small size."""
    from physicsinformeddiffusionmodels_tpu_torch import profile_attn

    monkeypatch.setattr(profile_attn, "B", 2)
    monkeypatch.setattr(profile_attn, "P", 8)
    p = profile_attn._weights(torch.device("cpu"))
    p["w_out"] = p["w_out"] * LA_GAIN * 64  # the attention term O(1) beside x
    forms = profile_attn._forms(p)
    x = p["x"]
    ref = forms["k1"](x)
    assert (ref - x).abs().max().item() >= 1.0
    for name in ("k3", "plain"):
        torch.testing.assert_close(forms[name](x), ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(forms["stage_k3"](x), forms["stage_k1"](x), atol=1e-4, rtol=1e-4)
