"""K4's launch plan (``ops/conv_block.py`` ``k4_plan``), on the CPU: its
arithmetic at every (P, Ci, Co) of the cm UNet's K4 calls and at ragged
images, and the shapes it refuses. The CUDA side recomputes the same plan
and refuses a launch that differs (checked on the card by
``tests/test_torch_cuda.py``)."""

import pytest
import torch

from physicsinformeddiffusionmodels_tpu_torch.ops import conv_block as cb

# (P, Ci, Co) of one cm UNet(dim=32) pass at 64x64 (chip_smoke.py K4_CALLS)
PATH_SHAPES = [(64, 32, 32), (32, 32, 64), (32, 64, 64), (32, 128, 32), (32, 32, 32),
               (64, 64, 32)]
# images whose P*P is not a multiple of a tile, P not a multiple of 8, and
# the largest P the kernels take
RAGGED = [(24, 64, 32), (7, 16, 16), (127, 32, 32), (127, 48, 64)]
SHAPES = PATH_SHAPES + RAGGED


def _tiles(plan, p, co):
    """(first padded pixel, last padded pixel + 1, first channel) of each
    conv tile of a row, in the kernels' order (channel tiles fastest)."""
    ct = -(-co // plan.channels)
    return [((t // ct) * plan.pixels, min((t // ct + 1) * plan.pixels, p * plan.row_pitch),
             (t % ct) * plan.channels) for t in range(plan.tiles)]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [4, 64])
@pytest.mark.parametrize("p,ci,co", SHAPES)
def test_plan_covers_every_pixel_and_channel_once(p, ci, co, b, elt, backward):
    """The forward's conv tiles (the backward's: dx's conv over dz, Co in and
    Ci out) cover each pixel of each output channel once."""
    plan = cb.k4_plan(b, p, ci, co, elt, backward)
    if backward:
        ci, co = co, ci
    assert plan.row_pitch % 8 == 0 and p <= plan.row_pitch < p + 8
    assert plan.channels in (32, 64) and plan.chunk == (32 if elt == 2 else 8)
    # 8 warps of 32 channels x 64 pixels
    assert plan.channels * plan.pixels == 8 * 32 * 64
    # each real pixel of each channel lies in exactly one tile
    covered = torch.zeros(co, p * p, dtype=torch.int32)
    for t0, t1, c0 in _tiles(plan, p, co):
        assert t0 < t1
        gp = torch.arange(t0, t1)
        row, col = gp // plan.row_pitch, gp % plan.row_pitch
        real = (row * p + col)[col < p]
        covered[c0:c0 + plan.channels, real] += 1
    assert torch.equal(covered, torch.ones_like(covered))
    # a row on one cluster of at most 8 blocks: the forward's tiles, one a
    # block when they fit (the row's z stays on chip), else several in turn;
    # the backward's dz slices, each block one slice of every channel
    assert 1 <= plan.k <= cb.K4_CLUSTER_MAX <= 16
    if not backward:
        assert plan.k == min(plan.tiles, cb.K4_CLUSTER_MAX) and plan.slice == 0
        assert plan.resident == (plan.tiles <= cb.K4_CLUSTER_MAX)
    else:
        n = p * p
        assert plan.slice % 4 == 0 and (plan.k - 1) * plan.slice < n <= plan.k * plan.slice
    for smem in (plan.smem, plan.dw_smem, plan.dx_smem):
        assert 0 <= smem <= cb.K4_SMEM_MAX == 232448
    assert plan.smem > 0
    if backward:
        chunks = b * -(-p * plan.row_pitch // (256 if elt == 2 else 128))
        assert 1 <= plan.splits <= chunks and plan.dw_smem > 0 and plan.dx_smem > 0
    else:
        assert plan.splits == plan.dw_smem == plan.dx_smem == 0


@pytest.mark.parametrize("p,ci,co", PATH_SHAPES)
def test_the_path_keeps_every_row_on_chip(p, ci, co):
    """At the path's shapes each forward block holds one tile (no second
    conv), and the level-0 row spans the portable cluster of 8; the dz
    kernel gives a block about 256 pixels of every channel."""
    for elt in (2, 4):
        plan = cb.k4_plan(64, p, ci, co, elt)
        assert plan.resident and plan.k == plan.tiles
        assert plan.k == (8 if p == 64 else 4 if co == 64 else 2)
        bwd = cb.k4_plan(64, p, ci, co, elt, backward=True)
        assert (bwd.k, bwd.slice) == ((8, 512) if p == 64 else (4, 256))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [4, 64])
@pytest.mark.parametrize("p,ci,co", SHAPES)
def test_workspace_is_what_the_wrapper_allocates(p, ci, co, b, dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    fwd = cb.k4_plan(b, p, ci, co, elt)
    # with grad the forward keeps z, [B, Co, P*P] fp32, for the backward
    assert fwd.workspace == 4 * b * co * p * p
    bwd = cb.k4_plan(b, p, ci, co, elt, backward=True)
    bufs = cb.backward_buffers(bwd, b, p, ci, co, dtype)
    nbytes = sum(torch.empty((), dtype=dt).element_size() * int(torch.Size(shape).numel())
                 for shape, dt in bufs.values())
    assert bwd.workspace == nbytes
    # dz in x's type, and the fp32 scratch: rows' (S0, S1), the dbias
    # partials of each (row, rank), the dW partials of each split
    assert bufs["dz"] == ((b, co, p * p), dtype)
    assert bufs["work"][0] == (2 * b * co + b * bwd.k * co + bwd.splits * co * 9 * ci,)
    # fewer dW partials than one a row and 1024 pixels
    assert bwd.splits <= max(b * -(-p * p // 1024), 132)


@pytest.mark.parametrize("b,p,ci,co,groups", [
    (4, 128, 32, 32, 8),    # P above the TPU kernel's bound
    (4, 0, 32, 32, 8),
    (4, 32, 24, 32, 8),     # Ci not a multiple of 16
    (4, 32, 32, 40, 8),     # Co not a multiple of 16
    (4, 32, 32, 48, 5),     # Co not a multiple of the groups
    (4, 32, 32, 1024, 8),   # 128 channels a group
    (0, 32, 32, 32, 8),
    (70000, 8, 16, 16, 8),  # more rows than a grid's y
    (2048, 127, 512, 64, 8),  # B max(Ci, Co) P^2 >= 2^31
])
def test_plan_refuses_what_the_kernels_do_not_take(b, p, ci, co, groups):
    with pytest.raises(ValueError):
        cb.k4_plan(b, p, ci, co, 4, groups=groups)


def test_plan_refuses_other_dtypes():
    with pytest.raises(ValueError):
        cb.k4_plan(4, 32, 32, 32, 8)


@pytest.mark.parametrize("bf16", [False, True])
def test_dx_weights_flip_the_taps(bf16):
    """dx's weights: wdx[ci, t Co + co] = wflat[co, (8 - t) Ci + ci], so
    that dx is the forward's conv over dz with the taps reversed; fp32 gets
    the transpose."""
    co, ci = 32, 16
    wflat = torch.randn(co, 9 * ci)
    wdx = cb.dx_weights(wflat, bf16)
    if not bf16:
        wdx = wdx.t()
    for t in range(9):
        assert torch.equal(wdx[:, t * co:(t + 1) * co], wflat[:, (8 - t) * ci:(9 - t) * ci].t())


def test_dx_as_a_flipped_conv_equals_the_transposed_conv():
    """The identity the dx kernel rests on, in plain PyTorch: the conv of dz
    with the tap-flipped, transposed weights is conv_transpose2d."""
    gen = torch.Generator().manual_seed(0)
    co, ci, p = 16, 32, 9
    w = torch.randn(co, ci, 3, 3, generator=gen, dtype=torch.float64)
    dz = torch.randn(2, co, p, p, generator=gen, dtype=torch.float64)
    wdx = cb.dx_weights(cb.flatten_weight(w, torch.float64), True)
    w_dx = wdx.reshape(ci, 3, 3, co).permute(0, 3, 1, 2)  # OIHW for the conv over dz
    got = torch.nn.functional.conv2d(dz, w_dx, padding=1)
    want = torch.nn.functional.conv_transpose2d(dz, w, padding=1)
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("p,ci,co", PATH_SHAPES)
def test_bytes_by_the_plan(p, ci, co):
    """The bytes a call moves by the plan: at least what the bound counts
    (x read and out written once), at most twice that in the forward."""
    for elt in (2, 4):
        plan = cb.k4_plan(64, p, ci, co, elt)
        least = elt * 64 * p * p * (ci + co)
        assert least <= cb.k4_bytes(plan, 64, p, ci, co, elt, False, save=False) <= 2 * least
        saved = cb.k4_bytes(plan, 64, p, ci, co, elt, False, save=True)
        assert saved - cb.k4_bytes(plan, 64, p, ci, co, elt, False, save=False) == (
            4 * 64 * co * p * p)
        bwd = cb.k4_plan(64, p, ci, co, elt, backward=True)
        assert cb.k4_bytes(bwd, 64, p, ci, co, elt, True, save=True) >= elt * 64 * p * p * (
            2 * ci + co)
