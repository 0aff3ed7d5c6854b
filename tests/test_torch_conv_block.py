"""K4, the channel-major conv block, on the CPU: the port's plain version
and its autograd against the JAX package's ``conv_gn_film_silu_cm`` run in
Pallas interpret mode (as ``tests/test_pallas_conv.py`` runs it), with the
port's OIHW weight made from the same HWIO array; and the wrapper's rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.ops import pallas_conv as pc
from physicsinformeddiffusionmodels_tpu_torch.ops.conv_block import (
    conv_gn_film_silu_cm,
    conv_gn_film_silu_cm_plain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# JAX's own kernel-against-reference tolerances (tests/test_pallas_conv.py)
FWD_TOL, GRAD_TOL = 2e-5, 5e-4
NAMES = ("dx", "dw", "dbias", "dgamma", "dbeta", "dscale", "dshift")


def _inputs(p, ci, co, film, b=2, seed=0):
    """x [B, Ci, P*P], the HWIO weight, bias, gamma, beta, scale, shift."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, p * p)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(co)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(co)).astype(np.float32)
    scale = (0.1 * rng.standard_normal((b, co))).astype(np.float32) if film else None
    shift = (0.1 * rng.standard_normal((b, co))).astype(np.float32) if film else None
    return x, w, bias, gamma, beta, scale, shift


def _port_args(args):
    """The same arrays as torch tensors, the weight as OIHW [Co, Ci, 3, 3]."""
    x, w, *rest = args
    oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    return [torch.from_numpy(x), torch.from_numpy(oihw),
            *(None if a is None else torch.from_numpy(a) for a in rest)]


def _jax(args, p):
    x, w, bias, gamma, beta, scale, shift = (None if a is None else jnp.asarray(a) for a in args)
    return pc.conv_gn_film_silu_cm(x, w, bias, gamma, beta, scale, shift, p, groups=8,
                                   interpret=True)


@pytest.mark.parametrize("p,ci,co,film", [
    (16, 32, 32, True),
    (16, 32, 32, False),
    (16, 64, 32, True),   # the up path's concatenated input: Ci != Co
    (8, 32, 64, True),    # Co > Ci, one tile of the TPU kernel
])
def test_plain_forward_matches_pallas_interpret(p, ci, co, film):
    args = _inputs(p, ci, co, film)
    ref = np.asarray(_jax(args, p))
    got = conv_gn_film_silu_cm(*_port_args(args), p)
    assert got.shape == ref.shape == (2, co, p * p)
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("p,ci,co,film", [
    (16, 32, 32, True),
    (16, 64, 32, True),
    (8, 32, 64, False),
])
def test_plain_gradients_match_pallas_interpret(p, ci, co, film):
    """The seven gradients of <y, dy> (dscale and dshift with FiLM), the
    port's autograd through the plain version against JAX's custom VJP
    (the backward kernel, interpreted). dy is scaled so that every gradient
    reaches 100x the tolerance: a dropped term cannot pass inside it."""
    args = _inputs(p, ci, co, film, seed=5)
    rng = np.random.default_rng(6)
    dy = (10.0 * rng.standard_normal((2, co, p * p))).astype(np.float32)
    used = [i for i, a in enumerate(args) if a is not None]

    def f(*a):
        full = list(args)
        for i, v in zip(used, a):
            full[i] = v
        return _jax(full, p)

    _, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in used))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    ref[1] = ref[1].transpose(3, 2, 0, 1)  # HWIO -> OIHW

    leaves = [t if t is None else t.requires_grad_(True) for t in _port_args(args)]
    y = conv_gn_film_silu_cm(*leaves, p)
    got = torch.autograd.grad(y, [t for t in leaves if t is not None], torch.from_numpy(dy))
    assert len(got) == len(ref) == len(used)
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        assert np.abs(r).max() >= 100 * GRAD_TOL, f"{name}: max |g| {np.abs(r).max():.3e}"
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def _counts():
    f = conv_gn_film_silu_cm
    return f.launches, f.bf16_launches, f.backward_launches, f.bf16_backward_launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_tensor_uses_the_plain_version_and_counts_nothing(dtype):
    a = _port_args(_inputs(8, 16, 16, True))
    a[0] = a[0].to(dtype).requires_grad_(True)
    before = _counts()
    y = conv_gn_film_silu_cm(*a, 8)
    assert y.dtype == dtype
    assert torch.equal(y, conv_gn_film_silu_cm_plain(*a, 8))
    y.float().square().sum().backward()
    assert a[0].grad.dtype == dtype and torch.isfinite(a[0].grad).all()
    assert _counts() == before


def test_image_wider_than_127_raises():
    a = _port_args(_inputs(8, 16, 16, True))
    x = torch.zeros(1, 16, 128 * 128)
    with pytest.raises(ValueError, match="p <= 127"):
        conv_gn_film_silu_cm(x, *a[1:], 128)


def test_wrapper_refuses_other_devices():
    a = _port_args(_inputs(8, 16, 16, True))
    meta = torch.empty((2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_gn_film_silu_cm(meta, *a[1:], 8)
