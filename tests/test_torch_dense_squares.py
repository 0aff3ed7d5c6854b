"""The two pieces of the mechanics slice ported last, against the JAX
package at a small grid: ``MechanicsResidual.assemble_dense`` (the dense,
Dirichlet-masked global stiffness) and ``data/datasets.py``'s
``SquareImagesDataset``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.data import datasets as jds
from physicsinformeddiffusionmodels_tpu.physics import mechanics as jm
from physicsinformeddiffusionmodels_tpu_torch.data import datasets as tds
from physicsinformeddiffusionmodels_tpu_torch.physics import mechanics as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("p", [4, 8])
def test_assemble_dense_matches_jax(p):
    J, T = jm.MechanicsResidual(p), tm.MechanicsResidual(p)
    rng = np.random.default_rng(p)
    rho = rng.uniform(0.01, 1.0, (2, T.nels)).astype(np.float32)
    mask = rng.random((2, T.neq)) < 0.2
    got = T.assemble_dense(torch.from_numpy(rho), torch.from_numpy(mask)).numpy()
    ref = np.asarray(J.assemble_dense(jnp.asarray(rho), jnp.asarray(mask)))
    assert got.shape == ref.shape == (2, T.neq, T.neq)
    # float32 sums of at most four element entries a dof pair, in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # the masked dofs' rows are the identity's; the rest applies the matrix-free K u
    u = rng.standard_normal((2, T.neq)).astype(np.float32)
    ku = T._Ku(torch.from_numpy(rho), torch.from_numpy(u)).numpy()
    dense_ku = np.einsum("bij,bj->bi", got, u)
    np.testing.assert_allclose(dense_ku[~mask], ku[~mask], rtol=0,
                               atol=1e-5 * np.abs(ku).max())
    np.testing.assert_array_equal(dense_ku[mask], u[mask])


def test_square_images_dataset_matches_jax():
    got, ref = tds.SquareImagesDataset(5, 16, 3, seed=4), jds.SquareImagesDataset(5, 16, 3, seed=4)
    assert len(got) == len(ref) == 5
    np.testing.assert_array_equal(got.stacked(), ref.stacked())
    np.testing.assert_array_equal(got[2], ref[2])
    assert got.stacked().dtype == np.float32 and got.stacked().sum() == 5 * 3 * 4 * 4
    np.testing.assert_array_equal(tds.sample_images_with_squares(3, 8, 1),
                                  jds.sample_images_with_squares(3, 8, 1))
