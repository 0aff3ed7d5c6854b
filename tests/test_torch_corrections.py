"""The sampler's inference-time operations against the JAX package, on the
same numpy inputs: the CoCoGen residual correction (``_jacobian_max``,
``residual_correction``) and dynamic thresholding. ``p_sample_loop`` with
them is held against JAX's in test_torch_sampling.py."""

import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.data.darcy_generator import generate_dataset
from physicsinformeddiffusionmodels_tpu.diffusion import sampling as jsampling
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import dynamic_threshold
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fields():
    """Two generated Darcy fields at 64x64, with noise on p so that the
    correction has a residual to reduce."""
    P = 64
    K, p, _, _ = generate_dataset(n_samples=2, pixels_per_dim=P, q=16, base_seed=3)
    x = np.stack([p.reshape(-1, P, P), K.reshape(-1, P, P)], axis=-1).astype(np.float32)
    x[..., 0] += 0.01 * np.random.default_rng(4).standard_normal((2, P, P)).astype(np.float32)
    return x


def test_jacobian_max_matches_jax(fields):
    K = fields[..., 1]
    ref = np.asarray(JaxDarcy(pixels_per_dim=64)._jacobian_max(K))
    got = DarcyResidual(pixels_per_dim=64)._jacobian_max(torch.from_numpy(K)).numpy()
    assert got.shape == (2,)
    # the same entries, each one or two fp32 products of K and a stencil weight
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_residual_correction_matches_jax(fields, n_steps):
    xr, rr = JaxDarcy(pixels_per_dim=64).residual_correction(fields, n_steps)
    physics = DarcyResidual(pixels_per_dim=64)
    x, r = physics.residual_correction(torch.from_numpy(fields), n_steps)
    # the step is eps * d(sum r^2)/dp: float32 FD sums in another order, on
    # a field of O(1); the residual amplifies field noise by ~1/d0^2 ~ 4e3,
    # so it is held relative to its largest entry
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=1e-5, rtol=0)
    rr = np.asarray(rr)
    np.testing.assert_allclose(r.numpy(), rr, atol=1e-5 * np.abs(rr).max(), rtol=0)
    # the step moved p and lowered sum r^2; K is kept
    assert np.abs(x.numpy() - fields).max() > 0
    assert (r.square().sum() < physics.residual(torch.from_numpy(fields)).square().sum()).item()
    np.testing.assert_array_equal(x[..., 1].numpy(), fields[..., 1])


def test_dynamic_threshold_matches_jax():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 16, 16, 2)) * np.array([0.5, 2.0, 4.0])[:, None, None, None]
         ).astype(np.float32)
    ref = np.asarray(jsampling.dynamic_threshold(x))
    got = dynamic_threshold(torch.from_numpy(x)).numpy()
    # sample 0's 90% quantile of |x| is below 1, so s = 1 and it is only
    # clipped; samples 1 and 2 are clipped to [-s, s] and scaled by 1/s
    np.testing.assert_array_equal(got[0], np.clip(x[0], -1.0, 1.0))
    assert np.abs(got[1:]).max() == 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
