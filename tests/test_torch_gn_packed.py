"""K5's plain version (the lane-packed bf16 GroupNorm-FiLM-SiLU of
``scripts/profile_gn.py``) against the JAX package's ``_reference_impl``,
the oracle that script checks its kernel against ("packed max err vs XLA"),
on the CPU.

The inputs are made with numpy as the script makes them, at small B and N:
x standard normal (shifted, so that the one-pass variance has a mean to
cancel), gamma and beta, scale and shift, all rounded to bf16. The script
itself is not imported: it runs its benchmark when imported.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.ops.pallas_kernels import _reference_impl
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
    group_norm_film_silu_packed,
    group_norm_film_silu_packed_plain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

G = 8
# bf16 keeps 8 significant bits: one ulp of the largest output is at most
# 2^-7 of it. The two sides round in different places (JAX's reference takes
# the mean, the variance and x-hat in bf16; K5 keeps its statistics and the
# folded scale in fp32), so they may differ by a few ulps
TOL = 4 * 2.0**-7


def _inputs(b, n, c, seed):
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()

    return (bf16(rng.standard_normal((b, n, c)) * 2.0 + 0.5),
            bf16(1.0 + 0.1 * rng.standard_normal(c)), bf16(0.1 * rng.standard_normal(c)),
            bf16(0.1 * rng.standard_normal((b, c))), bf16(0.1 * rng.standard_normal((b, c))))


@pytest.mark.parametrize("c", [32, 64, 128])
def test_packed_plain_matches_jax_reference(c):
    x, *params = _inputs(2, 64, c, seed=c)
    got = group_norm_film_silu_packed(x, *(p.float() for p in params), groups=G)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ref = _reference_impl(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, *params)),
                          G, 1e-5)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    scale = ref.abs().max().item()
    err = (got.float() - ref).abs().max().item()
    assert scale > 1.0 and err <= TOL * scale, f"max |diff| {err:.3e}, max |out| {scale:.3e}"
    # the wrapper takes the plain version for a CPU tensor; it is forward only
    torch.testing.assert_close(got, group_norm_film_silu_packed_plain(
        x, *(p.float() for p in params), groups=G), atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="forward only"):
        group_norm_film_silu_packed(x.requires_grad_(True), *(p.float() for p in params))


@pytest.mark.parametrize("b,n,c", [(64, 4096, 32), (64, 1024, 64), (64, 256, 128), (4, 100, 32),
                                   (4, 64, 8), (4, 65536, 32), (1, 1, 8), (2, 33, 16)])
def test_k5_plan(b, n, c):
    """K5's launch plan (csrc/group_norm_packed.cu): one cluster of k blocks
    a batch row covering the row, within the card's shared memory and the
    kernel's mbarriers; a row past the cluster's shared memory is the
    re-read mode. At the three shapes of chip_smoke.py phase 14 a row fits
    two blocks (the plan measured fastest at the level-0 shape)."""
    from physicsinformeddiffusionmodels_tpu_torch.ops import group_norm as gn

    plan = gn.k5_plan(b, n, c)
    assert plan.k in (1, 2, 4, 8) and plan.tokens == -(-n // plan.k)
    assert plan.resident * 2 * c <= min(gn.K5_RESIDENT_MAX, gn.K5_CHUNKS * gn.K5_CHUNK_BYTES)
    assert plan.smem == -(-plan.resident * 2 * c // 16) * 16 + gn._k5_aux(c, 8) <= gn.K2_SMEM_MAX
    assert plan.reread == (n * 2 * c > gn.K5_CLUSTER_MAX * gn.K5_RESIDENT_MAX)
    if b == 64:
        assert plan.k == 2 and not plan.reread
    # a plan of any other cluster size covers the row too
    for k in (1, 2, 4, 8):
        other = gn.k5_plan(b, n, c, k=k)
        assert other.k == k and other.tokens == -(-n // k)
