"""Schedule tables, FD operators and the Darcy residual of the port against
the JAX package, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.data.darcy_generator import generate_dataset
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as jsched
from physicsinformeddiffusionmodels_tpu.ops import fd as jfd
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as tsched
from physicsinformeddiffusionmodels_tpu_torch.ops import fd as tfd
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import (
    DarcyResidual,
    source_field,
    trapezoidal_weights,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TABLES = [
    "betas", "alphas", "alphas_prod", "alphas_bar_sqrt", "one_minus_alphas_bar_sqrt",
    "alphas_prod_prev", "posterior_mean_coef1", "posterior_mean_coef2", "posterior_variance",
]


@pytest.mark.parametrize("steps", [100, 10])
def test_schedule_tables_equal_jax(steps):
    # both build in float64 with numpy and cast: the float32 tables are identical
    ours = tsched.create_schedule(steps)
    ref = jsched.create_schedule(steps)
    for name in TABLES:
        got = getattr(ours, name)
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(tsched.make_beta_schedule("cosine", steps),
                                  jsched.make_beta_schedule("cosine", steps))


def test_q_sample_and_posterior_mean_match_jax():
    rng = np.random.default_rng(0)
    x0, xt, noise = (rng.standard_normal((3, 8, 8, 2)).astype(np.float32) for _ in range(3))
    t = np.array([0, 41, 99])
    ours, ref = tsched.create_schedule(100), jsched.create_schedule(100)
    tt = torch.from_numpy(t)
    # elementwise float32 arithmetic in the same order: equal to 1 ulp
    np.testing.assert_allclose(
        tsched.q_sample(ours, torch.from_numpy(x0), tt, torch.from_numpy(noise)).numpy(),
        np.asarray(jsched.q_sample(ref, x0, jnp.asarray(t), noise)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tsched.posterior_mean(ours, torch.from_numpy(x0), torch.from_numpy(xt), tt).numpy(),
        np.asarray(jsched.posterior_mean(ref, x0, xt, jnp.asarray(t))), rtol=1e-6, atol=1e-7)
    # a Python-int timestep gives the same values as the per-sample gather
    same_t = torch.full((3,), 41)
    np.testing.assert_array_equal(
        tsched.posterior_mean(ours, torch.from_numpy(x0), torch.from_numpy(xt), 41).numpy(),
        tsched.posterior_mean(ours, torch.from_numpy(x0), torch.from_numpy(xt), same_t).numpy())


@pytest.mark.parametrize("n,deriv,acc,periodic", [
    (64, 1, 2, False), (64, 2, 2, False), (16, 1, 4, False), (16, 2, 6, False),
    (16, 1, 2, True), (16, 2, 4, True),
])
def test_derivative_matrices_equal_jax(n, deriv, acc, periodic):
    got = tfd.derivative_matrix(n, -0.5, deriv, acc, periodic).numpy()
    ref = np.asarray(jfd.derivative_matrix(n, -0.5, deriv, acc, periodic))
    np.testing.assert_array_equal(got, ref)


def test_source_and_quadrature_equal_jax():
    from physicsinformeddiffusionmodels_tpu.physics import darcy as jd

    np.testing.assert_array_equal(source_field(64), jd.source_field(64))
    np.testing.assert_array_equal(trapezoidal_weights(64), jd.trapezoidal_weights(64))


def _residual_pair(x, **kw):
    P = x.shape[1]
    got = DarcyResidual(pixels_per_dim=P, **kw).residual(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxDarcy(pixels_per_dim=P, **kw).residual(jnp.asarray(x)))
    return got, ref


@pytest.fixture(scope="module")
def generated_fields():
    P = 32
    K, p, res, _ = generate_dataset(n_samples=2, pixels_per_dim=P, q=32, base_seed=7)
    x = np.stack([p.reshape(-1, P, P), K.reshape(-1, P, P)], axis=-1).astype(np.float32)
    return x, res


def test_residual_on_generated_fields_matches_jax(generated_fields):
    x, res = generated_fields
    got, ref = _residual_pair(x)
    assert got.shape == (2, 32 * 32, 3)
    # fp32 banded-matrix contractions in another summation order; the
    # residual of a solved field is a cancellation of O(|K p''|) ~ 1e2
    # terms, so compare at fp32 resolution of those terms
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    # and the fields are near-solutions: a small mean |residual|
    assert np.abs(got).mean() < 5 * res.max() + 1e-2


@pytest.mark.parametrize("reverse_d1,fd_acc", [(True, 2), (False, 4)])
def test_residual_on_random_fields_matches_jax(reverse_d1, fd_acc):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 64, 64, 2)).astype(np.float32)
    got, ref = _residual_pair(x, reverse_d1=reverse_d1, fd_acc=fd_acc)
    # random fields have |p''| ~ 1/d0^2 ~ 4e3: fp32 relative error 1e-6 of that
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=2e-6 * scale, rtol=0)
    np.testing.assert_array_equal(got[:, :, 1:] == 0, ref[:, :, 1:] == 0)
