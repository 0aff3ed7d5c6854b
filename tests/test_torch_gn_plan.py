"""K2's launch plan (``ops/group_norm.py`` ``k2_plan``), on the CPU: how a
call's batch rows are laid over thread-block clusters on the H100. The
kernels that take the plan run only on the card (tests/test_torch_cuda.py);
this checks its arithmetic at every shape the port calls K2 with."""

import pytest

from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
    K2_BF16_BWD_CLUSTER,
    K2_BF16_BWD_RESIDENT_MAX,
    K2_CLUSTER_MAX,
    K2_CLUSTER_PORTABLE,
    K2_RESIDENT_MAX,
    K2_SMEM_MAX,
    _aux_bytes,
    _slice_bytes,
    k2_plan,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the (N, C) of each K2 call of one UNet(dim=32) forward at 64x64 (as
# chip_smoke.py's K2_CALLS), of UNet(dim=128) of the mechanics study, and
# ragged token counts
DARCY = [(4096, 32), (1024, 64), (256, 128), (64, 256), (64, 128), (256, 64), (1024, 32)]
MECHANICS = [(4096, 128), (1024, 256), (256, 512), (64, 1024)]
RAGGED = [(100, 32), (33, 64), (5, 32), (4097, 32), (1, 8)]
CASES = ([(b, n, c) for b in (4, 64) for n, c in DARCY + RAGGED]
         + [(6, n, c) for n, c in MECHANICS])


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("elt", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c", CASES)
def test_plan_covers_each_row_once_and_fits_a_block(b, n, c, elt, backward):
    plan = k2_plan(b, n, c, elt, backward)
    assert 1 <= plan.k <= K2_CLUSTER_MAX and plan.k & (plan.k - 1) == 0
    # block q takes [q tokens, min(N, (q + 1) tokens)): every token once
    spans = [range(q * plan.tokens, min(n, (q + 1) * plan.tokens)) for q in range(plan.k)]
    assert [t for s in spans for t in s] == list(range(n))
    # no block left empty but by the rounding of the last ones
    assert (plan.k - 1) * plan.tokens < n
    assert plan.smem <= K2_SMEM_MAX
    # resident or re-read, as the bytes say: the whole slice is held when
    # it fits, else as many tokens as fit
    streams = 2 if backward else 1
    slice_of = lambda t: streams * _slice_bytes(t, c, elt)  # noqa: E731
    aux = _aux_bytes(c, 8, elt, backward)
    assert plan.smem == slice_of(plan.resident) + aux
    assert 1 <= plan.resident <= plan.tokens
    bf16_bwd = backward and elt == 2
    room = min(K2_BF16_BWD_RESIDENT_MAX if bf16_bwd else K2_RESIDENT_MAX, K2_SMEM_MAX - aux)
    assert slice_of(plan.resident) <= room + streams * 16
    assert plan.reread == (plan.tokens * c * elt * streams > room)
    if plan.reread:
        assert plan.k == (K2_BF16_BWD_CLUSTER if bf16_bwd else K2_CLUSTER_MAX)
        assert (plan.resident + 1) * c * elt * streams > room


def test_plan_at_the_darcy_level_0_and_the_smallest_rows():
    # B=64 at level 0 (a row of 4096 x 32): the fp32 forward and backward
    # hold it whole in 8 and 16 blocks, the bf16 forward in 4; the bf16
    # backward spreads it over 4 blocks and re-reads what passes 48 KB
    assert k2_plan(64, 4096, 32, 4)[:3] == (8, 512, 512)
    assert k2_plan(64, 4096, 32, 4, backward=True)[:3] == (16, 256, 256)
    assert k2_plan(64, 4096, 32, 2)[:3] == (4, 1024, 1024)
    bwd = k2_plan(64, 4096, 32, 2, backward=True)
    assert bwd[:3] == (4, 1024, 384) and bwd.reread
    # a row of 64 x 128 bf16 (16 KB) is cut in two, no finer than 8 KB a
    # block, and 64 rows then make 128 blocks
    assert k2_plan(64, 64, 128, 2).k == 2
    assert k2_plan(64, 64, 128, 2, backward=True).k == 2
    # at B=4 a row of 1024 x 32 still takes a cluster of 8
    assert k2_plan(4, 1024, 32, 4).k == 8


def test_plan_steps_down_to_a_portable_cluster():
    plan = k2_plan(6, 4096, 128, 4, backward=True)
    assert plan.k == 16 and plan.reread
    portable = k2_plan(6, 4096, 128, 4, backward=True, cluster_max=K2_CLUSTER_PORTABLE)
    assert portable.k == K2_CLUSTER_PORTABLE and portable.tokens == 512
    assert portable.resident == plan.resident and portable.smem == plan.smem


def test_mechanics_level_0_in_fp32_is_re_read_and_bf16_resident():
    assert k2_plan(6, 4096, 128, 4).reread
    assert not k2_plan(6, 4096, 128, 2).reread
