"""``ops/gradients.py`` (numeric and ``torch.func`` jacobians and Hessians,
the finite-difference image jacobian) and ``models/blocks.py``
``SignalEmbedding`` (CNN and GRU, Flax weights carried over) of the port
against the JAX package's on the same inputs: the cases of JAX's
``tests/test_gradients_blocks.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models.blocks import SignalEmbedding as FlaxSignalEmbedding
from physicsinformeddiffusionmodels_tpu.ops import gradients as jg
from physicsinformeddiffusionmodels_tpu.ops.fd import StencilGradients as JaxStencilGradients
from physicsinformeddiffusionmodels_tpu_torch.models.blocks import (
    SignalEmbedding,
    state_dict_from_flax,
)
from physicsinformeddiffusionmodels_tpu_torch.ops import gradients as tg
from physicsinformeddiffusionmodels_tpu_torch.ops.fd import StencilGradients
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# float32 on both sides. Autodiff and the stencils: the same products in
# another order. A central difference divides a float32 rounding of f by
# 2 eps (eps 1e-3: ~1e-4); a forward-difference Hessian by eps^2 (eps 1e-2:
# ~1e-3 of |f| ~ 1), so the numeric ones are held to those
AD_RTOL, JAC_NUM_ATOL, HESS_NUM_ATOL = 1e-6, 5e-4, 5e-3


def _quadratic_jax(x):
    return jnp.stack([x[..., 0] ** 2 + x[..., 1] * x[..., 2], x[..., 2] ** 2])


def _quadratic(x):
    return torch.stack([x[..., 0] ** 2 + x[..., 1] * x[..., 2], x[..., 2] ** 2])


def _scalar_jax(x):
    return (x[..., 0] ** 2 * x[..., 1] + x[..., 1] ** 3).sum()


def _scalar(x):
    return (x[..., 0] ** 2 * x[..., 1] + x[..., 1] ** 3).sum()


X = np.array([0.7, -0.3, 1.2], np.float32)


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_jacobians_match_jax(mode):
    ja = tg.jacobian_autodiff(_quadratic, torch.from_numpy(X), mode=mode).numpy()
    np.testing.assert_allclose(ja, np.asarray(jg.jacobian_autodiff(_quadratic_jax, X, mode=mode)),
                               rtol=AD_RTOL, atol=0)
    jn = tg.jacobian_numeric(_quadratic, torch.from_numpy(X), eps=1e-3).numpy()
    ref = np.asarray(jg.jacobian_numeric(_quadratic_jax, jnp.asarray(X), eps=1e-3))
    assert jn.shape == ref.shape == (2, 3)
    np.testing.assert_allclose(jn, ref, atol=JAC_NUM_ATOL, rtol=0)
    np.testing.assert_allclose(jn, ja, atol=1e-3, rtol=0)  # JAX's own check


def test_hessians_match_jax():
    x = np.array([0.5, -1.1, 0.2], np.float32)
    ha = tg.hessian_autodiff(_scalar, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ha, np.asarray(jg.hessian_autodiff(_scalar_jax, x)),
                               rtol=AD_RTOL, atol=1e-7)
    hn = tg.hessian_numeric(_scalar, torch.from_numpy(x), eps=1e-2).numpy()
    ref = np.asarray(jg.hessian_numeric(_scalar_jax, jnp.asarray(x), eps=1e-2))
    assert hn.shape == ref.shape == (3, 3)
    np.testing.assert_allclose(hn, ref, atol=HESS_NUM_ATOL, rtol=0)
    np.testing.assert_allclose(hn, ha, atol=1e-1, rtol=0)  # JAX's own check


def test_batched_jacobians_match_jax():
    xs = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    j = tg.jacobian_autodiff(_quadratic, torch.from_numpy(xs), mode="rev", batched=True)
    assert j.shape == (4, 2, 3)
    np.testing.assert_allclose(j.numpy(), np.asarray(jg.jacobian_autodiff(
        _quadratic_jax, xs, mode="rev", batched=True)), rtol=AD_RTOL, atol=0)
    h = tg.hessian_autodiff(lambda x: (x**2).sum(), torch.from_numpy(xs), batched=True)
    assert h.shape == (4, 3, 3)
    np.testing.assert_allclose(h.numpy(), np.asarray(jg.hessian_autodiff(
        lambda x: (x**2).sum(), xs, batched=True)), rtol=AD_RTOL, atol=0)


def test_image_jacobian_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 1, 8, 8)).astype(np.float32)
    ref = np.asarray(jg.image_jacobian(
        JaxStencilGradients(h=8, w=8, d0=1.0 / 7, d1=1.0 / 7, fd_acc=2), jnp.asarray(x)))
    got = tg.image_jacobian(StencilGradients(8, 8, 1.0 / 7, 1.0 / 7, fd_acc=2),
                            torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 1, 2, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("arch", ["CNN", "GRU"])
def test_signal_embedding_matches_flax(arch):
    """JAX's case (B=2, L=32), with random weights and biases carried over."""
    x = np.random.default_rng(2).standard_normal((2, 32)).astype(np.float32)
    flax_model = FlaxSignalEmbedding(arch=arch)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), x)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(  # fan-in scaled, as Flax's initialisers
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10.0)
                   ).astype(np.float32), shapes)
    ref = np.asarray(flax_model.apply(params, x))
    model = SignalEmbedding(arch=arch)
    sd = state_dict_from_flax(params)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 128) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)
    # the CNN's mean over the positions, where more than one remains
    if arch == "CNN":
        x64 = np.random.default_rng(4).standard_normal((2, 64)).astype(np.float32)
        ref64 = np.asarray(flax_model.apply(params, x64))
        with torch.no_grad():
            np.testing.assert_allclose(model(torch.from_numpy(x64)).numpy(), ref64,
                                       atol=1e-5 * max(1.0, np.abs(ref64).max()), rtol=0)
