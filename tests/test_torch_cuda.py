"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu_torch.ops.conv_block import (
    conv_gn_film_silu_cm,
    conv_gn_film_silu_cm_plain,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
    group_norm_film_silu,
    group_norm_film_silu_packed,
    group_norm_film_silu_packed_plain,
    group_norm_film_silu_plain,
    k5_plan,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention,
    linear_attention_block,
    linear_attention_block_plain,
    linear_attention_plain,
)

H = 256
# v is divided by N and the k softmax averages it over the tokens, so with
# unit-scale weights the attention term is 1e-5..1e-3, below the tolerance
# beside x; W_out scaled by LA_GAIN * N makes it O(1), so a broken attention
# fails the comparison
LA_GAIN = 100.0
# The distinct (N, C) shapes at which the Darcy UNet calls both kernels.
PATH_SHAPES = [(4096, 32), (1024, 64), (256, 128), (64, 256), (64, 128), (256, 64),
               (1024, 32)]


def _lab_inputs(b, n, c, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    w_qkv = (rng.standard_normal((c, 3 * H)) / np.sqrt(c)).astype(np.float32)
    w_out = (rng.standard_normal((H, c)) * LA_GAIN * n / np.sqrt(H)).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, w_qkv, w_out, b_out


def _gn_inputs(b, n, c, film, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    scale = (0.1 * rng.standard_normal((b, c))).astype(np.float32) if film else None
    shift = (0.1 * rng.standard_normal((b, c))).astype(np.float32) if film else None
    return x, gamma, beta, scale, shift


def _t(a, device):
    return None if a is None else torch.from_numpy(a).to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' matmuls and convolutions in full fp32, as the
    # sampling path runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_lab_forward(cuda, n, c, b=4):
    args = [_t(a, cuda) for a in _lab_inputs(b, n, c)]
    before = linear_attention_block.launches
    got = linear_attention_block(*args)
    torch.cuda.synchronize()
    assert linear_attention_block.launches == before + 1
    ref = linear_attention_block_plain(*args)
    # the attention term, which the kernel computes, is far above the tolerance
    assert (ref - args[0] - args[4]).abs().max().item() >= 1.0
    # fp32 on both sides, different summation order
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32), (33, 64)])
def test_linear_attention_kernel_matches_plain(cuda, n, c):
    _check_lab_forward(cuda, n, c)


# one-line breaks of K1's forward (file, text replaced, replacement), each
# of which the comparison above must catch
K1_MUTANTS = {
    "attention dropped": ("linear_attention.cu", "block ? acc + bo[k]", "block ? 0.f * acc + bo[k]"),
    "k softmax uniform": ("linear_attention.cu",
                          "const float e = t < rows ? expf(kv[t * kLdKV + tid] - mx) : 0.f;",
                          "const float e = t < rows ? 1.f : 0.f;"),
    "context transposed": ("linear_attention.cu", "fmaf(ctx_s[dd][e],", "fmaf(ctx_s[e][dd],"),
    "q softmax unnormalised": ("la_tile.cuh", "v[i][j] = v[i][j] / s;", "v[i][j] = v[i][j];"),
    # the merge of a row's token ranges: an earlier range's context not
    # rescaled to the new running max
    "merge drops the rescale of an earlier range": (
        "linear_attention.cu", "c4[k] = c4[k] * a + p[", "c4[k] = c4[k] + p["),
}


@contextlib.contextmanager
def _patched_kernels(monkeypatch, tmp_path, filename, old, new):
    """Build and load the library from a copy of ``csrc/`` in which ``old``
    (once in ``filename``) is replaced by ``new``."""
    from physicsinformeddiffusionmodels_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        text = f.read_text()
        if f.name == filename:
            assert text.count(old) == 1
            text = text.replace(old, new)
        (src / f.name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build.cache_clear()
    _build.library.cache_clear()
    try:
        yield
    finally:  # the next launch loads the library of the real sources again
        _build.build.cache_clear()
        _build.library.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(K1_MUTANTS))
def test_linear_attention_comparison_fails_a_broken_kernel(cuda, monkeypatch, tmp_path, mutant):
    with _patched_kernels(monkeypatch, tmp_path, *K1_MUTANTS[mutant]):
        args = [_t(a, cuda) for a in _lab_inputs(4, 4096, 32)]
        got = linear_attention_block(*args)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(got, linear_attention_block_plain(*args),
                                       atol=1e-4, rtol=1e-4)


def _check_gn_forward(cuda, n, c, film, b=4):
    args = [_t(a, cuda) for a in _gn_inputs(b, n, c, film)]
    before = group_norm_film_silu.launches
    got = group_norm_film_silu(*args)
    torch.cuda.synchronize()
    assert group_norm_film_silu.launches == before + 1
    torch.testing.assert_close(got, group_norm_film_silu_plain(*args), atol=1e-5, rtol=1e-5)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32)])
def test_group_norm_kernel_matches_plain(cuda, n, c, film):
    _check_gn_forward(cuda, n, c, film)


# one-line breaks of K2's forward (file, text replaced, replacement), each
# of which the comparison above must catch at B=4, (1024, 32), where a row
# spans a cluster of 8 blocks (ops/group_norm.py k2_plan)
K2_MUTANTS = {
    "merge skips a rank's partial": (
        "group_norm.cu", "for (int p = 0; p < k; ++p) {", "for (int p = 1; p < k; ++p) {"),
    "rstd of the block's own slice, no merge": (
        "group_norm.cu", "gstat[2 * g + 1] = rsqrtf(m2_a / n_a + eps);",
        "gstat[2 * g + 1] = rsqrtf(gpart[2 * g + 1] / cnt + eps);"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(K2_MUTANTS))
def test_group_norm_comparison_fails_a_broken_kernel(cuda, monkeypatch, tmp_path, mutant):
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import k2_plan

    assert k2_plan(4, 1024, 32, 4).k > 1
    with _patched_kernels(monkeypatch, tmp_path, *K2_MUTANTS[mutant]):
        with pytest.raises(AssertionError):
            _check_gn_forward(cuda, 1024, 32, film=True)


# K2 at more rows than the card holds clusters at once (several waves of
# clusters): each call's output and gradients bit for bit those of the
# first (fixed-order sums, no atomics)
REPEAT_SHAPE, REPEATS = (256, 4096, 32), 20


def _check_gn_repeats(device):
    b, n, c = REPEAT_SHAPE
    args = [_t(a, device) for a in _gn_inputs(b, n, c, True)]
    leaves = [a.requires_grad_(True) for a in args]
    dy = torch.randn(b, n, c, generator=torch.Generator().manual_seed(5)).to(device)
    first = None
    for i in range(REPEATS):
        out = group_norm_film_silu(*leaves)
        got = [out.detach(), *torch.autograd.grad(out, leaves, dy)]
        if first is None:
            first = got
            torch.testing.assert_close(
                got[0], group_norm_film_silu_plain(*[a.detach() for a in args]),
                atol=1e-5, rtol=1e-5)
        for name, g, f in zip(("out", "dx", "dgamma", "dbeta", "dscale", "dshift"), got, first):
            assert torch.equal(g, f), f"call {i}: {name} differs from the first call's"


@pytest.mark.cuda
def test_group_norm_kernels_repeat_bit_for_bit(cuda):
    _check_gn_repeats(cuda)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_bad_arguments(cuda):
    x, gamma, w_qkv, w_out, b_out = [_t(a, cuda) for a in _lab_inputs(2, 64, 32)]
    with pytest.raises(ValueError):
        linear_attention_block(x.transpose(0, 1), gamma, w_qkv, w_out, b_out)
    with pytest.raises(ValueError):
        linear_attention_block(x, gamma.double(), w_qkv, w_out, b_out)
    with pytest.raises(ValueError):
        linear_attention_block(x, gamma, w_qkv, w_out, b_out, heads=4, dim_head=64)
    with pytest.raises(ValueError):
        group_norm_film_silu(x.half(), gamma, b_out)
    with pytest.raises(ValueError):
        group_norm_film_silu(x, gamma, b_out, scale=gamma[None])


# fp32 on both sides, sums in another order (split token reductions, tiled
# products): each gradient within 1e-4 of the largest entry of its tensor
GRAD_TOL = 1e-4


def _grads(fn, args, dy):
    """Gradients of <fn(*args), dy> with respect to every tensor argument."""
    leaves = [None if a is None else a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, [a for a in leaves if a is not None], dy)


def _assert_grads_close(got, ref, names):
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape, name
        scale = r.abs().max().item()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= GRAD_TOL * scale, (
            f"{name}: max |diff| {err:.3e} > {GRAD_TOL} x max |g| {scale:.3e}")


def _check_lab_backward(cuda, n, c, b=4):
    args = [_t(a, cuda) for a in _lab_inputs(b, n, c)]
    dy = torch.randn(b, n, c, generator=torch.Generator().manual_seed(n + c)).to(cuda)
    _, ref = _grads(linear_attention_block_plain, args, dy)
    fwd, bwd = linear_attention_block.launches, linear_attention_block.backward_launches
    _, got = _grads(linear_attention_block, args, dy)
    torch.cuda.synchronize()
    assert (linear_attention_block.launches, linear_attention_block.backward_launches) == (
        fwd + 1, bwd + 1)
    _assert_grads_close(got, ref, ("dx", "dgamma", "dw_qkv", "dw_out", "db_out"))


def _check_gn_backward(cuda, n, c, film, b=4):
    args = [_t(a, cuda) for a in _gn_inputs(b, n, c, film)]
    dy = torch.randn(b, n, c, generator=torch.Generator().manual_seed(n + c)).to(cuda)
    _, ref = _grads(group_norm_film_silu_plain, args, dy)
    fwd, bwd = group_norm_film_silu.launches, group_norm_film_silu.backward_launches
    _, got = _grads(group_norm_film_silu, args, dy)
    torch.cuda.synchronize()
    assert (group_norm_film_silu.launches, group_norm_film_silu.backward_launches) == (
        fwd + 1, bwd + 1)
    _assert_grads_close(got, ref, ("dx", "dgamma", "dbeta", "dscale", "dshift"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32), (33, 64)])
def test_linear_attention_backward_matches_plain(cuda, n, c):
    _check_lab_backward(cuda, n, c)


@pytest.mark.cuda
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32)])
def test_group_norm_backward_matches_plain(cuda, n, c, film):
    _check_gn_backward(cuda, n, c, film)


# one-line breaks of the backward kernels, each of which the gradient
# comparison above must catch: file -> {name: (text replaced, replacement)}
BWD_MUTANTS = {
    "linear_attention_bwd.cu": {
        "row term dropped": ("kp * (dk[i][j] - rowv[jd])", "kp * dk[i][j]"),
        # dK' = vn dctx (not dctx^T)
        "dctx transposed": ("warp_gemm<kTc, false, false, kSplitB>(dk,",
                            "warp_gemm<kTc, false, true, kSplitB>(dk,"),
        # the ordered reduce of dW_qkv's partials starts at the second block
        "dW_qkv reduce skips a block's partial": (
            "src = dw_part + i, dst = dw_qkv + (long long)c * kQKV + j, stride = e_w, n = n_blk;",
            "src = dw_part + e_w + i, dst = dw_qkv + (long long)c * kQKV + j, stride = e_w, "
            "n = n_blk - 1;"),
    },
    "group_norm_bwd.cu": {
        "t2 dropped": ("(t1[v] + xhat * t2[v])", "(t1[v])"),
        "SiLU derivative dropped": ("return sig * (1.f + z * (1.f - sig));", "return 1.f;"),
        # the row's S0, S1 summed from the second block of its cluster on
        "S0/S1 merge skips a rank": ("for (int p = 0; p < k; ++p) {",
                                     "for (int p = 1; p < k; ++p) {"),
        # dgamma and dbeta leave out the first batch row
        "parameter pass skips a row": ("for (int b = r; b < B; b += kRowLanes) {",
                                       "for (int b = r + (r == 0); b < B; b += kRowLanes) {"),
    },
}


@pytest.mark.cuda
@pytest.mark.parametrize("filename,mutant", [(f, m) for f in BWD_MUTANTS for m in BWD_MUTANTS[f]])
def test_backward_comparison_fails_a_broken_kernel(cuda, monkeypatch, tmp_path, filename, mutant):
    with _patched_kernels(monkeypatch, tmp_path, filename, *BWD_MUTANTS[filename][mutant]):
        with pytest.raises(AssertionError):
            if filename == "linear_attention_bwd.cu":
                _check_lab_backward(cuda, 1024, 32)
            else:
                _check_gn_backward(cuda, 1024, 32, film=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16_fp32_head"])
def test_kernels_keep_the_unet_in_the_autograd_graph(cuda, dtype):
    """Every K1 and K2 parameter of UNet(dim=32) gets a non-zero gradient
    from a training loss on the card (the kernels once returned outputs
    with no grad_fn, which cut these parameters off), in fp32 and in the
    study's bf16 recipe, where the kernels' backward takes bf16."""
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import LossWeights, pidm_loss
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
    from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual

    torch.manual_seed(0)
    model = UNet(dim=32, channels=2, dtype=dtype, fp32_head=dtype is not None).to(cuda)
    x0 = torch.randn(2, 64, 64, 2, device=cuda)
    t = torch.tensor([3, 70], device=cuda)
    noise = torch.randn(2, 64, 64, 2, device=cuda)
    counts = [(linear_attention_block, "backward_launches"),
              (linear_attention_block, "bf16_backward_launches"),
              (group_norm_film_silu, "backward_launches"),
              (group_norm_film_silu, "bf16_backward_launches")]
    before = [getattr(f, k) for f, k in counts]
    loss, _ = pidm_loss(create_schedule(100), x0, t, noise, denoise_fn=model,
                        physics_fn=DarcyResidual(64, device=cuda),
                        weights=LossWeights(1.0, 1e-3))
    loss.backward()
    torch.cuda.synchronize()
    # in bf16 every K1 and K2 backward takes bf16 but the fp32 head's two K2
    assert [getattr(f, k) - b for (f, k), b in zip(counts, before)] == (
        [8, 0, 38, 0] if dtype is None else [8, 8, 38, 36])
    names = [n for n, _ in model.named_parameters()
             if n.split(".")[-1] in ("ln_gamma", "w_qkv", "w_out", "b_out", "gn_scale", "gn_bias")]
    assert len(names) == 8 * 4 + 38 * 2
    for name, p in model.named_parameters():
        if name in names:
            assert p.grad is not None and p.grad.abs().max().item() > 0, name


# K3, the linear attention alone (a mode of K1's kernels)


def _la_inputs(b, n, c, seed=1):
    """x, W_qkv and W_out as K1's inputs draw them (W_out at LA_GAIN * N)."""
    x, _, w_qkv, w_out, _ = _lab_inputs(b, n, c, seed)
    return x, w_qkv, w_out


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32), (33, 64)])
def test_linear_attention_k3_kernel_matches_plain(cuda, n, c):
    args = [_t(a, cuda) for a in _la_inputs(4, n, c)]
    before = linear_attention.launches
    got = linear_attention(*args)
    torch.cuda.synchronize()
    assert linear_attention.launches == before + 1
    ref = linear_attention_plain(*args)
    # the attention term is the whole output, O(1); fp32, another summation order
    assert ref.abs().max().item() >= 1.0
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    got_bf16 = linear_attention(args[0].bfloat16(), *args[1:])
    assert got_bf16.dtype == torch.bfloat16
    # bf16: the output's rounding
    torch.testing.assert_close(got_bf16, linear_attention_plain(args[0].bfloat16(), *args[1:]),
                               atol=1e-2, rtol=1e-2)


def _check_la_backward(cuda, n, c, b=4):
    args = [_t(a, cuda) for a in _la_inputs(b, n, c)]
    dy = torch.randn(b, n, c, generator=torch.Generator().manual_seed(n + c)).to(cuda)
    _, ref = _grads(linear_attention_plain, args, dy)
    fwd, bwd = linear_attention.launches, linear_attention.backward_launches
    _, got = _grads(linear_attention, args, dy)
    torch.cuda.synchronize()
    assert (linear_attention.launches, linear_attention.backward_launches) == (fwd + 1, bwd + 1)
    _assert_grads_close(got, ref, ("dx", "dw_qkv", "dw_out"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32), (33, 64)])
def test_linear_attention_k3_backward_matches_plain(cuda, n, c):
    _check_la_backward(cuda, n, c)


def _check_composition(cuda, n, c, b=4):
    """K1(x) = x + b_out + K3(LN_gamma(x)), the LN computed by torch: the two
    kernels held against each other."""
    x, gamma, w_qkv, w_out, b_out = [_t(a, cuda) for a in _lab_inputs(b, n, c)]
    k1 = linear_attention_block(x, gamma, w_qkv, w_out, b_out)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    ln = ((x - mu) / torch.sqrt(var + 1e-5) * gamma).contiguous()
    k3 = x + b_out + linear_attention(ln, w_qkv, w_out)
    torch.cuda.synchronize()
    scale = (k1 - x).abs().max().item()
    err = (k1 - k3).abs().max().item()
    assert scale >= 1.0 and err <= 1e-4 * scale, f"max |diff| {err:.3e}, max |K1 - x| {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32)])
def test_k1_equals_x_plus_bias_plus_k3_of_layer_norm(cuda, n, c):
    _check_composition(cuda, n, c)


# one-line breaks of K3's mode, each of which a check above must catch:
# name -> (file, text replaced, replacement, the check that must fail)
K3_MUTANTS = {
    "K3 adds the residual": (
        "linear_attention.cu", "(block ? acc + bo[k] + xv[k] : acc);",
        "(acc + to_f32(x[((long long)b * N + n0 + t) * C + c0 + c]));", "forward"),
    # K3 normalises its tokens (without a gamma)
    "K3 applies the LN": (
        "la_tile.cuh", "    if (block && t < rows) {", "    if (t < rows) {", "composition"),
    "K3 backward drops the row term": (
        "linear_attention_bwd.cu", "kp * (dk[i][j] - rowv[jd])", "kp * dk[i][j]", "backward"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(K3_MUTANTS))
def test_k3_checks_fail_a_broken_kernel(cuda, monkeypatch, tmp_path, mutant):
    filename, old, new, check = K3_MUTANTS[mutant]
    with _patched_kernels(monkeypatch, tmp_path, filename, old, new):
        with pytest.raises(AssertionError):
            if check == "forward":
                test_linear_attention_k3_kernel_matches_plain(cuda, 1024, 32)
            elif check == "composition":
                _check_composition(cuda, 1024, 32)
            else:
                _check_la_backward(cuda, 1024, 32)


# K1 and K2 at the mechanics study's (N, C): UNet(dim=128, channels=10)
# runs the attention block down (4096, 128) ... (64, 1024) and up (64, 512)
# ... (1024, 128), at C = 128 to 1024, where the kernels tile C through
# shared memory; K2 normalises every conv output at the same (N, C)
MECHANICS_SHAPES = [(4096, 128), (1024, 256), (256, 512), (64, 1024), (64, 512), (256, 256),
                    (1024, 128)]


@pytest.mark.cuda
def test_mechanics_shapes_are_the_unets_calls(cuda):
    """MECHANICS_SHAPES are the distinct (N, C) of the mechanics UNet's K1
    and K2 calls in one forward, recorded by hooks (bf16 + fp32 head: all
    on bf16 x but the head's two K2 calls)."""
    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import (
        Block, LinearAttentionBlock, build_model)

    torch.manual_seed(0)
    model = build_model(RunConfig(gov_eqs="mechanics", fp32_head=True)).to(cuda)
    k1, k2 = [], []
    for m in model.modules():
        if isinstance(m, LinearAttentionBlock):
            m.register_forward_hook(lambda mod, a, y: k1.append((y.shape[1] * y.shape[2],
                                                                 y.shape[3], y.dtype)))
        elif isinstance(m, Block):
            m.register_forward_hook(lambda mod, a, y: k2.append((y.shape[1] * y.shape[2],
                                                                 y.shape[3], y.dtype)))
    with torch.no_grad():
        model(torch.randn(1, 64, 64, 10, device=cuda), torch.tensor([3], device=cuda))
    assert len(k1) == 8 and len(k2) == 38
    assert list(dict.fromkeys(c[:2] for c in k1)) == MECHANICS_SHAPES
    assert list(dict.fromkeys(c[:2] for c in k2)) == MECHANICS_SHAPES
    assert [c[2] for c in k1] == [torch.bfloat16] * 8
    assert [c[2] for c in k2] == [torch.bfloat16] * 36 + [torch.float32] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", MECHANICS_SHAPES)
def test_linear_attention_kernels_at_the_mechanics_shapes(cuda, n, c):
    args = _check_lab_forward(cuda, n, c, b=6)
    got_bf16 = linear_attention_block(args[0].bfloat16(), *args[1:])
    assert got_bf16.dtype == torch.bfloat16
    # bf16: the output's rounding
    torch.testing.assert_close(got_bf16, linear_attention_block_plain(args[0].bfloat16(),
                                                                      *args[1:]),
                               atol=1e-2, rtol=1e-2)
    del args, got_bf16
    _check_lab_backward(cuda, n, c, b=6)
    _check_bf16_lab_backward(cuda, n, c, b=6)


# K2 at the same (N, C) and B=6: clusters of up to 16 blocks, and at
# (4096, 128) in fp32 a row (2 MB) larger than its cluster's shared memory,
# so each block re-reads part of its slice
@pytest.mark.cuda
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("n,c", MECHANICS_SHAPES)
def test_group_norm_kernels_at_the_mechanics_shapes(cuda, n, c, film):
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import k2_plan

    assert k2_plan(6, 4096, 128, 4).reread and k2_plan(6, 4096, 128, 4, backward=True).reread
    args = _check_gn_forward(cuda, n, c, film=film, b=6)
    got_bf16 = group_norm_film_silu(args[0].bfloat16(), *args[1:])
    assert got_bf16.dtype == torch.bfloat16
    # bf16: the output's rounding
    torch.testing.assert_close(got_bf16, group_norm_film_silu_plain(args[0].bfloat16(), *args[1:]),
                               atol=1e-2, rtol=1e-2)
    del args, got_bf16
    _check_gn_backward(cuda, n, c, film=film, b=6)
    _check_bf16_gn_backward(cuda, n, c, film, b=6)


@pytest.mark.cuda
def test_batched_pcg_on_the_card_matches_the_cpu_and_the_host_solve(cuda):
    """The mechanics evaluation's Jacobi-PCG (one CUDA graph of
    ``check_every`` iterations between host reads) on generator designs at
    64x64: ten iterations equal the CPU's to float32 rounding, and the
    converged solve's compliance is within 1e-4 of the float64 sparse-LU
    solve's."""
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
        MechanicsFEM, generate_sample)
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import (
        MechanicsResidual, split_mechanics_batch)

    fem, rng = MechanicsFEM(64), np.random.default_rng(0)
    data = np.stack([generate_sample(fem, rng, n_iter=3, family=f)
                     for f in ("edge_cantilever", "bridge")])
    mb = split_mechanics_batch(torch.from_numpy(data))
    rho = mb.solution[:, :-1, :-1, 2].reshape(2, -1)
    card, cpu = MechanicsResidual(64, device=cuda), MechanicsResidual(64)
    u, rel, k = card.solve(rho.to(cuda), mb.bcs.to(cuda), maxiter=10, check_every=4)
    u_cpu, rel_cpu, k_cpu = cpu.solve(rho, mb.bcs, maxiter=10, check_every=4)
    assert int(k) == int(k_cpu) == 10
    torch.testing.assert_close(u.cpu(), u_cpu, rtol=0, atol=1e-5 * u_cpu.abs().max().item())
    u, rel, k = card.solve(rho.to(cuda), mb.bcs.to(cuda))
    assert 0 < int(k) < 3000 and (rel < 1e-2).all()
    f, _ = cpu._bc_data(mb.bcs)
    for i in range(2):
        exact = cpu.solve_host(rho[i].numpy(), mb.bcs[i].numpy()) @ f[i].double().numpy()
        got = u[i].double().cpu().numpy() @ f[i].double().numpy()
        assert abs(got - exact) <= 1e-4 * abs(exact), (got, exact)


# K2 where 16-byte vectors do not fit: C not a multiple of a vector's
# elements (the scalar edge: C = 6, and C = 20 in bf16), and x at an address
# that is not 16-byte aligned; N ragged, groups of 3 and 5 channels
@pytest.mark.cuda
@pytest.mark.parametrize("n,c,groups,offset", [(33, 20, 4, 0), (100, 6, 2, 0), (77, 32, 8, 1)])
def test_group_norm_kernels_without_16_byte_vectors(cuda, n, c, groups, offset):
    _check_gn_grouped(cuda, 3, n, c, groups, offset)


# K2 under tensor parallelism: a column-parallel Block normalises its rank's
# C / tp channels in 8 / tp groups; the Darcy and mechanics UNets' wide
# stages at tp = 2 (4 groups) and tp = 4 (2 groups)
@pytest.mark.cuda
@pytest.mark.parametrize("n,c,groups", [(1024, 32, 4), (256, 64, 4), (4096, 64, 4),
                                        (1024, 128, 4), (256, 256, 4), (64, 512, 4),
                                        (4096, 32, 2), (64, 256, 2)])
def test_group_norm_kernels_at_tensor_parallel_groups(cuda, n, c, groups):
    _check_gn_grouped(cuda, 6, n, c, groups, 0)


def _check_gn_grouped(cuda, b, n, c, groups, offset):
    """K2's forward and backward, fp32 and bf16, with ``groups`` groups,
    against autograd through the plain version; x ``offset`` elements past
    a 16-byte boundary."""
    x, gamma, beta, scale, shift = [_t(a, cuda) for a in _gn_inputs(b, n, c, True)]
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        buf[offset:].copy_(x.flatten())
        xd = buf[offset:].view(x.shape).requires_grad_(True)
        assert (xd.data_ptr() % 16 != 0) == bool(offset)
        args = [xd] + [a.detach().clone().requires_grad_(True) for a in (gamma, beta, scale, shift)]
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(n)).to(cuda, dtype)
        out = group_norm_film_silu(*args, groups=groups)
        got = torch.autograd.grad(out, args, dy)
        ref_out = group_norm_film_silu_plain(*args, groups=groups)
        ref = torch.autograd.grad(ref_out, args, dy)
        fp32 = dtype == torch.float32
        tol = 1e-5 if fp32 else 1e-2
        torch.testing.assert_close(out, ref_out, atol=tol, rtol=tol)
        for i, (g, r) in enumerate(zip(got, ref)):
            t = GRAD_TOL if fp32 else (BF16_DX_TOL if i == 0 else BF16_PARAM_TOL)
            scale_, err = r.float().abs().max().item(), (g.float() - r.float()).abs().max().item()
            assert g.dtype == r.dtype and err <= t * scale_, (dtype, i, err, scale_)


# C not a multiple of the kernels' 32-channel slices: a partial last slice,
# and rows of M that are not 16-byte aligned (C = 20)
@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(100, 48), (33, 20)])
def test_linear_attention_kernels_at_a_ragged_channel_count(cuda, n, c):
    _check_lab_forward(cuda, n, c)
    _check_lab_backward(cuda, n, c)
    _check_bf16_lab_backward(cuda, n, c)
    _check_la_backward(cuda, n, c)


@pytest.mark.cuda
def test_fp32_k1_kernels_run_no_tensor_core_instruction(cuda):
    """K1's and K3's kernels multiply fp32 x in full fp32 (the sampling path
    is held to 1e-4): none of their fp32 instantiations holds a tensor-core
    instruction (HMMA) in the built library; the bf16 ones with a product
    do (bf16 mma.sync)."""
    import re
    import shutil
    import subprocess

    from physicsinformeddiffusionmodels_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.build()[0])], capture_output=True,
                          text=True, check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            hmma[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            hmma[name] += 1
    k1 = {n: count for n, count in hmma.items() if "lab_" in n}
    fp32 = [count for n, count in k1.items() if "nv_bfloat16" not in n]
    bf16 = [count for n, count in k1.items() if "nv_bfloat16" in n]
    assert len(fp32) >= 7 and len(bf16) == 5, sorted(k1)
    assert not any(fp32) and all(bf16), k1


# bf16 input to the backward kernels (K1, K2, K3), and K5

# bf16 backward kernel vs autograd through the plain version on the same bf16
# input: dx is written in bf16 (one rounding of the output), the parameter
# gradients stay fp32 (the same sums in another order)
BF16_DX_TOL, BF16_PARAM_TOL = 2e-2, 1e-3


def _bf16_dy(shape, device, seed):
    """A bf16 dy in the first half of a buffer twice its size, so that a
    kernel that reads it as fp32 reads garbage inside the allocation (and
    fails the comparison) rather than past its end."""
    n = int(np.prod(shape))
    buf = torch.empty(2 * n, dtype=torch.bfloat16, device=device)
    buf.normal_(generator=torch.Generator(device=device).manual_seed(seed))
    return buf[:n].view(shape)


def _check_bf16_backward(fn, plain, args, names, counter):
    """The gradients of <fn(*args), dy> with x (args[0]) and dy in bf16,
    through the kernel and through autograd on the plain version."""
    args = [args[0].bfloat16(), *args[1:]]
    dy = _bf16_dy(args[0].shape, args[0].device, seed=sum(args[0].shape))
    _, ref = _grads(plain, args, dy)
    before = (counter.backward_launches, counter.bf16_backward_launches)
    out, got = _grads(fn, args, dy)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and (
        counter.backward_launches, counter.bf16_backward_launches) == (before[0] + 1, before[1] + 1)
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        tol = BF16_DX_TOL if name == "dx" else BF16_PARAM_TOL
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * scale, (
            f"{name}: max |diff| {err:.3e} > {tol} x max |g| {scale:.3e}")


def _check_bf16_lab_backward(cuda, n, c, b=4):
    _check_bf16_backward(linear_attention_block, linear_attention_block_plain,
                         [_t(a, cuda) for a in _lab_inputs(b, n, c)],
                         ("dx", "dgamma", "dw_qkv", "dw_out", "db_out"), linear_attention_block)


def _check_bf16_la_backward(cuda, n, c, b=4):
    _check_bf16_backward(linear_attention, linear_attention_plain,
                         [_t(a, cuda) for a in _la_inputs(b, n, c)], ("dx", "dw_qkv", "dw_out"),
                         linear_attention)


def _check_bf16_gn_backward(cuda, n, c, film, b=4):
    _check_bf16_backward(group_norm_film_silu, group_norm_film_silu_plain,
                         [_t(a, cuda) for a in _gn_inputs(b, n, c, film)],
                         ("dx", "dgamma", "dbeta", "dscale", "dshift"), group_norm_film_silu)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", PATH_SHAPES + [(100, 32), (33, 64)])
def test_bf16_backward_kernels_match_autograd(cuda, n, c):
    _check_bf16_lab_backward(cuda, n, c)
    _check_bf16_la_backward(cuda, n, c)
    for film in (True, False):
        _check_bf16_gn_backward(cuda, n, c, film)


# one break of each kernel's bf16 path, which its check must catch:
# name -> (file, text replaced, replacement)
BF16_MUTANTS = {
    # K1/K3: dy read as fp32 in dP = dy M^T
    "K1/K3 bwd read bf16 dy as fp32": (
        "linear_attention_bwd.cu",
        "stage<kT, kKC>(dys, kLdX, dyb + (long long)n0 * C + c0, C, rows, C - c0);",
        "stage<kT, kKC>(dys, kLdX, reinterpret_cast<const float*>(dyb) + (long long)n0 * C + c0, "
        "C, rows, C - c0);"),
    # K1's bf16 forward rounds exp(k - m) against the running max of its
    # tiles, not the row's max (lab_fwd_kmax unused): the context it saves
    # drifts from the plain version's, and the gradients with it
    "K1 bf16 fwd rounds against running maxima": (
        "linear_attention.cu", "  if constexpr (kTc)  // bf16: the row's max (launch 0)",
        "  if constexpr (false)  // bf16: the row's max (launch 0)"),
    "K2 bwd read bf16 dy as fp32": (
        "group_norm_bwd.cu", "load_vec<T, V>(fd, sm ? dys + o : dyr + o);",
        "load_vec<float, V>(fd, reinterpret_cast<const float*>(sm ? dys + o : dyr + o));"),
    "K5 variance without mean^2": (
        "group_norm_packed.cu", "rsqrtf(t2 / cnt - mean * mean + eps)", "rsqrtf(t2 / cnt + eps)"),
    # the last block's sums of a row left out of the cluster's total
    "K5 cluster partial dropped": (
        "group_norm_packed.cu", "for (int p = 0; p < k; ++p)", "for (int p = 0; p < k - 1; ++p)"),
    # the FiLM scale left out of the folded multiplier
    "K5 FiLM fold without scale": (
        "group_norm_packed.cu", "a[j] = gamma[c0 + j] * sc1;", "a[j] = gamma[c0 + j];"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(BF16_MUTANTS))
def test_bf16_checks_fail_a_broken_kernel(cuda, monkeypatch, tmp_path, mutant):
    filename, old, new = BF16_MUTANTS[mutant]
    checks = {"linear_attention_bwd.cu": [lambda: _check_bf16_lab_backward(cuda, 1024, 32),
                                          lambda: _check_bf16_la_backward(cuda, 1024, 32)],
              "linear_attention.cu": [lambda: _check_bf16_lab_backward(cuda, 1024, 64)],
              "group_norm_bwd.cu": [lambda: _check_bf16_gn_backward(cuda, 1024, 32, True)],
              "group_norm_packed.cu": [lambda: _check_k5(cuda, 1024, 32)]}[filename]
    with _patched_kernels(monkeypatch, tmp_path, filename, old, new):
        for check in checks:
            with pytest.raises(AssertionError):
                check()


def _check_k5(cuda, n, c, b=4):
    """K5 against its plain version and against K2's forward on the same
    bf16 input: within K5_TOL of the largest output."""
    x, gamma, beta, scale, shift = [_t(a, cuda) for a in _gn_inputs(b, n, c, film=True)]
    x = x.bfloat16()
    before = group_norm_film_silu_packed.launches
    got = group_norm_film_silu_packed(x, gamma, beta, scale, shift)
    torch.cuda.synchronize()
    assert group_norm_film_silu_packed.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    # the cluster adds its blocks' sums in rank order: a call repeats bit for bit
    assert torch.equal(got, group_norm_film_silu_packed(x, gamma, beta, scale, shift))
    for ref in (group_norm_film_silu_packed_plain(x, gamma, beta, scale, shift),
                group_norm_film_silu(x, gamma, beta, scale, shift)):
        scale_ = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= K5_TOL * scale_, (
            f"max |diff| {err:.3e} > {K5_TOL} x {scale_:.3e}")


# bf16 outputs: a rounding, and the one-pass variance against K2's shifted sums
K5_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(64, 4096, 32), (64, 1024, 64), (64, 256, 128), (4, 4096, 32),
                                   (4, 1024, 64), (4, 256, 128), (4, 100, 32), (4, 64, 8),
                                   (4, 65536, 32)])
def test_packed_kernel_matches_plain_and_k2(cuda, b, n, c):
    """The three K5_SHAPES of chip_smoke.py at B=64 and B=4, a ragged N,
    C=8, and a row past a cluster's shared memory (the re-read plan)."""
    assert k5_plan(b, n, c).reread == (n == 65536)
    _check_k5(cuda, n, c, b)


@pytest.mark.cuda
def test_packed_kernel_raises_on_what_it_does_not_take(cuda):
    x, gamma, beta, scale, shift = [_t(a, cuda) for a in _gn_inputs(2, 64, 32, film=True)]
    with pytest.raises(ValueError):
        group_norm_film_silu_packed(x, gamma, beta, scale, shift)  # fp32 x
    x48 = torch.zeros(2, 64, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # 128 % 48 != 0
        group_norm_film_silu_packed(x48, gamma, beta, scale, shift)
    with pytest.raises(NotImplementedError, match="forward only"):
        group_norm_film_silu_packed(x.bfloat16().requires_grad_(True), gamma, beta, scale, shift)


# K4, the channel-major conv block (3x3 conv + GroupNorm + FiLM + SiLU)

# (P, Ci, Co): the level-0 Block of the cm UNet, and a ragged image (P*P =
# 576 pixels, not a multiple of the kernels' 128-pixel tile) with Ci != Co
K4_SHAPES = [(64, 32, 32), (24, 64, 32)]
# kernel vs plain version, as a share of the largest output: fp32, the same
# products summed in another order; bf16, the output's rounding
K4_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _k4_inputs(b, p, ci, co, film, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, p * p)).astype(np.float32)
    w = (rng.standard_normal((co, ci, 3, 3)) / np.sqrt(9 * ci)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(co)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(co)).astype(np.float32)
    scale = (0.1 * rng.standard_normal((b, co))).astype(np.float32) if film else None
    shift = (0.1 * rng.standard_normal((b, co))).astype(np.float32) if film else None
    return x, w, bias, gamma, beta, scale, shift


def _k4_args(cuda, b, p, ci, co, film, dtype):
    args = [_t(a, cuda) for a in _k4_inputs(b, p, ci, co, film)]
    return [args[0].to(dtype), *args[1:]]


def _check_k4(cuda, p, ci, co, film, dtype, b=4):
    args = _k4_args(cuda, b, p, ci, co, film, dtype)
    before = (conv_gn_film_silu_cm.launches, conv_gn_film_silu_cm.bf16_launches)
    got = conv_gn_film_silu_cm(*args, p)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert (conv_gn_film_silu_cm.launches, conv_gn_film_silu_cm.bf16_launches) == (
        before[0] + 1, before[1] + bf16)
    assert got.dtype == dtype and got.shape == (b, co, p * p)
    ref = conv_gn_film_silu_cm_plain(*args, p)
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got).all() and err <= K4_TOL[dtype] * scale, (
        f"max |diff| {err:.3e} > {K4_TOL[dtype]} x max |out| {scale:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("p,ci,co", K4_SHAPES)
def test_conv_block_kernel_matches_plain(cuda, p, ci, co, film, dtype):
    _check_k4(cuda, p, ci, co, film, dtype)


K4_GRADS = ("dx", "dw", "dbias", "dgamma", "dbeta", "dscale", "dshift")


def _check_k4_backward(cuda, p, ci, co, dtype, b=4):
    """The seven gradients of <K4(*args), dy> through the kernels against
    autograd through the plain version: fp32 each within GRAD_TOL of its
    max; bf16 dx and dW (rounded to bf16, as the TPU kernel's VJP returns
    it) within BF16_DX_TOL, the fp32 parameter gradients within
    BF16_PARAM_TOL."""
    args = _k4_args(cuda, b, p, ci, co, True, dtype)
    dy = torch.randn(b, co, p * p, generator=torch.Generator().manual_seed(p + ci)).to(cuda)
    dy = dy.to(dtype)
    _, ref = _grads(lambda *a: conv_gn_film_silu_cm_plain(*a, p), args, dy)
    counts = ("launches", "bf16_launches", "backward_launches", "bf16_backward_launches")
    before = [getattr(conv_gn_film_silu_cm, k) for k in counts]
    _, got = _grads(lambda *a: conv_gn_film_silu_cm(*a, p), args, dy)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert [getattr(conv_gn_film_silu_cm, k) - v for k, v in zip(counts, before)] == [
        1, bf16, 1, bf16]
    for name, g, r in zip(K4_GRADS, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if dtype == torch.float32:
            tol = GRAD_TOL
        else:
            tol = BF16_DX_TOL if name in ("dx", "dw") else BF16_PARAM_TOL
        if dtype == torch.bfloat16 and name == "dw":
            assert torch.equal(g, g.bfloat16().float()), "dW is not rounded to bf16"
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * scale, (
            f"{name}: max |diff| {err:.3e} > {tol} x max |g| {scale:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("p,ci,co", K4_SHAPES)
def test_conv_block_backward_matches_plain(cuda, p, ci, co, dtype):
    _check_k4_backward(cuda, p, ci, co, dtype)


# one-line breaks of K4, each of which a check above must catch, at the
# ragged shape (24, 64, 32), where a row spans a cluster of 2 blocks, or at
# (13, 16, 48), whose odd P has a column of padding in every row of the
# staged window: name -> (file, text replaced, replacement, the check, the
# dtypes it breaks, the shape). The conv's column masks are the staged
# window's zero border, which the forward's conv and dx's conv over dz
# share: the same break is caught by the forward's check and the
# backward's.
_BF16_RIGHT_MASK = ("conv_tile.cuh", "const bool ok1 = ok && col + 1 < P;", "const bool ok1 = ok;")
_FP32_RIGHT_MASK = ("conv_tile.cuh", "const bool ok = row_ok && col0 + e >= 0 && col0 + e < P;",
                    "const bool ok = row_ok && col0 + e >= 0 && col0 + e < P + 1;")
K4_MUTANTS = {
    "forward drops the right column mask (bf16 window)": (
        *_BF16_RIGHT_MASK, "forward", ("bf16",), (13, 16, 48)),
    "forward drops the right column mask (fp32 window)": (
        *_FP32_RIGHT_MASK, "forward", ("fp32",), (13, 16, 48)),
    "dx drops the column mask on dz (bf16 window)": (
        *_BF16_RIGHT_MASK, "backward", ("bf16",), (13, 16, 48)),
    "dx drops the column mask on dz (fp32 window)": (
        *_FP32_RIGHT_MASK, "backward", ("fp32",), (13, 16, 48)),
    "dscale left at zero": (
        "conv_block_bwd.cu", "dscale[bc] = fmaf(gamma[c], r1[c], beta[c] * r0[c]);",
        "dscale[bc] = 0.f;", "backward", ("fp32", "bf16"), (24, 64, 32)),
    # the row's statistics merged from the second block of its cluster on
    "merge skips a rank's partial": (
        "conv_block.cu", "pn[p] = p < k ? rp[3 * gi] : 0.f,",
        "pn[p] = p < k && p > 0 ? rp[3 * gi] : 0.f,", "forward", ("fp32", "bf16"), (24, 64, 32)),
    # the window's first row (the halo above the block's rows) left zero
    "halo row of the staged window left unloaded (bf16)": (
        "conv_tile.cuh", "const bool ok = it < total && row >= 0 && row < P && col < P && c < cin;",
        "const bool ok = it < total && rr > 0 && row >= 0 && row < P && col < P && c < cin;",
        "forward", ("bf16",), (24, 64, 32)),
    "halo row of the staged window left unloaded (fp32)": (
        "conv_tile.cuh", "const bool row_ok = row >= 0 && row < P && c0 + c < cin;",
        "const bool row_ok = rr > 0 && row >= 0 && row < P && c0 + c < cin;", "forward",
        ("fp32",), (24, 64, 32)),
    "last dW partial dropped": (
        "conv_block_bwd.cu", "for (int sp = l; sp < splits; sp += 4) s += part[sp * e_dw + e];",
        "for (int sp = l; sp < splits - 1; sp += 4) s += part[sp * e_dw + e];", "backward",
        ("fp32", "bf16"), (24, 64, 32)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(K4_MUTANTS))
def test_conv_block_checks_fail_a_broken_kernel(cuda, monkeypatch, tmp_path, mutant):
    from physicsinformeddiffusionmodels_tpu_torch.ops.conv_block import k4_plan

    assert k4_plan(4, 24, 64, 32, 4).k == 2
    filename, old, new, check, dtypes, (p, ci, co) = K4_MUTANTS[mutant]
    with _patched_kernels(monkeypatch, tmp_path, filename, old, new):
        for dtype in dtypes:
            dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
            with pytest.raises(AssertionError):
                if check == "forward":
                    _check_k4(cuda, p, ci, co, True, dtype)
                else:
                    _check_k4_backward(cuda, p, ci, co, dtype)


# shapes off the UNet's path that the kernels take: an image whose tiles
# outnumber a cluster (each block computes its tiles twice), P not a
# multiple of 4 or 8, Co a multiple of 16 but not of 32, Ci = 16
K4_OFF_PATH_SHAPES = [(100, 32, 32), (13, 16, 48), (7, 16, 16), (30, 48, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("p,ci,co", K4_OFF_PATH_SHAPES)
def test_conv_block_kernels_off_the_path(cuda, p, ci, co, dtype):
    from physicsinformeddiffusionmodels_tpu_torch.ops.conv_block import k4_plan

    if p == 100:
        assert not k4_plan(2, p, ci, co, 4).resident
    _check_k4(cuda, p, ci, co, True, dtype, b=2)
    _check_k4_backward(cuda, p, ci, co, dtype, b=2)


def _k4_outputs(cuda, args, p, dy):
    """out and the seven gradients of <K4(*args), dy>, through the kernels."""
    out, grads = _grads(lambda *a: conv_gn_film_silu_cm(*a, p), args, dy)
    return [out.detach(), *grads]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv_block_kernels_repeat_bit_for_bit(cuda, dtype):
    """At the level-0 shape, B=64 (a row on a cluster of 8, several waves of
    clusters): a second and third call give the first's out and gradients
    bit for bit (fixed-order sums, no atomics)."""
    b, p, ci, co = 64, 64, 32, 32
    args = _k4_args(cuda, b, p, ci, co, True, dtype)
    dy = torch.randn(b, co, p * p, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    first = _k4_outputs(cuda, args, p, dy)
    for call in (1, 2):
        for name, g, f in zip(("out",) + K4_GRADS, _k4_outputs(cuda, args, p, dy), first):
            assert torch.equal(g, f), f"call {call}: {name} differs from the first call's"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("p,ci,co", K4_SHAPES)
def test_conv_block_grad_off_and_grad_on_forwards_agree(cuda, p, ci, co, dtype):
    """The forward with grad off (no z written) and the autograd node's
    forward (fp32: z kept for the backward) give the same out bit for bit."""
    args = _k4_args(cuda, 4, p, ci, co, True, dtype)
    with torch.no_grad():
        off = conv_gn_film_silu_cm(*args, p)
    before = conv_gn_film_silu_cm.launches
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    on = conv_gn_film_silu_cm(*leaves, p)
    assert on.grad_fn is not None and conv_gn_film_silu_cm.launches == before + 1
    assert torch.equal(on.detach(), off)


@pytest.mark.cuda
def test_conv_block_plan_matches_the_library(cuda):
    """The CUDA side's backward workspace is the wrapper's plan's, and the
    card holds at least one cluster of each path plan."""
    from physicsinformeddiffusionmodels_tpu_torch.ops import _build
    from physicsinformeddiffusionmodels_tpu_torch.ops import conv_block as cb

    lib = _build.library()
    for p, ci, co in K4_SHAPES + K4_OFF_PATH_SHAPES + [(32, 128, 32), (32, 64, 64)]:
        for b in (4, 64):
            for bf16 in (False, True):
                elt = 2 if bf16 else 4
                plan = cb.k4_plan(b, p, ci, co, elt, backward=True)
                floats = lib.pidm_conv_gn_film_silu_bwd_workspace(b, p, ci, co, 8, int(bf16))
                assert cb.backward_buffers(plan, b, p, ci, co, torch.float32)["work"][0] == (
                    floats,)
                assert cb.max_clusters(plan, bf16, True) >= 1
                assert cb.max_clusters(cb.k4_plan(b, p, ci, co, elt), bf16, False) >= 1


@pytest.mark.cuda
def test_k4_kernels_multiply_bf16_on_the_tensor_cores_and_fp32_in_fp32(cuda):
    """K4's bf16 kernels that multiply (the forward's conv, dW, dx) hold
    tensor-core instructions (HMMA, from mma.sync); its fp32 ones hold none
    (FFMA in full fp32, TF32 off), nor does the elementwise dz kernel."""
    import re
    import shutil
    import subprocess

    from physicsinformeddiffusionmodels_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.build()[0])], capture_output=True,
                          text=True, check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            hmma[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            hmma[name] += 1
    k4 = {n: count for n, count in hmma.items() if "k4_" in n and "k4_bwd_dz" not in n}
    fp32 = [count for n, count in k4.items() if "nv_bfloat16" not in n]
    bf16 = [count for n, count in k4.items() if "nv_bfloat16" in n]
    dz = [count for n, count in hmma.items() if "k4_bwd_dz" in n]
    assert len(fp32) == 3 and len(bf16) == 3 and len(dz) == 4, sorted(hmma)
    assert not any(fp32) and all(bf16) and not any(dz), k4


@pytest.mark.cuda
def test_conv_block_wrapper_raises_on_what_it_does_not_take(cuda):
    x, w, bias, gamma, beta, scale, shift = _k4_args(cuda, 2, 8, 32, 32, True, torch.float32)
    with pytest.raises(ValueError):  # Ci not a multiple of 16
        conv_gn_film_silu_cm(x[:, :8].contiguous(), w[:, :8].contiguous(), bias, gamma, beta,
                             scale, shift, 8)
    with pytest.raises(ValueError):  # N != P * P
        conv_gn_film_silu_cm(x, w, bias, gamma, beta, scale, shift, 7)
    with pytest.raises(ValueError):  # not contiguous
        conv_gn_film_silu_cm(x.transpose(1, 2).contiguous().transpose(1, 2), w, bias, gamma,
                             beta, scale, shift, 8)
    with pytest.raises(ValueError):  # fp64 parameters
        conv_gn_film_silu_cm(x, w, bias.double(), gamma, beta, scale, shift, 8)
    with pytest.raises(ValueError, match="p <= 127"):
        conv_gn_film_silu_cm(x, w, bias, gamma, beta, scale, shift, 128)


def _small_training(cuda, guided, dtype):
    """A small UNet's state, loss and data on the card (fp32 or bf16 compute)."""
    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        create_train_state, make_optimizer)

    torch.manual_seed(0)
    model = UNet(dim=32, channels=2, dim_mults=(1, 2), dtype=dtype).to(cuda)
    cfg = RunConfig(pixels_per_dim=16, residual_grad_guidance=guided, compute_dtype="float32")
    loss_fn = train.build_darcy_loss_fn(create_schedule(100), train.make_physics(cfg, cuda), cfg)
    data = torch.randn(16, 16, 16, 2, generator=torch.Generator().manual_seed(1)).to(cuda)
    state = create_train_state(model, make_optimizer(model, 1e-3, 1.0, "cosine", total_steps=20))
    return cfg, state, loss_fn, data


@pytest.mark.cuda
@pytest.mark.parametrize("guided,dtype", [(False, None), (False, torch.bfloat16),
                                          (True, None)], ids=["fp32", "bf16", "guided"])
def test_graphed_steps_equal_eager_steps_bit_for_bit(cuda, guided, dtype):
    """12 steps replayed from ``GraphedTrainStep`` against 12 eager steps on
    the same draws, under a cosine lr and across ema_start: the same
    weights, EMA, Adam state and counters, bit for bit (deterministic cuDNN)."""
    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        GraphedTrainStep, resident_train_step)

    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for graph in (False, True):
            cfg, state, loss_fn, data = _small_training(cuda, guided, dtype)
            graphed = GraphedTrainStep(state, loss_fn, ema_start=5) if graph else None
            gen = torch.Generator(device=cuda)
            for _ in range(12):
                aux = resident_train_step(state, loss_fn, data, 4, 100, 7, gen, ema_start=5,
                                          null_cond_prob=train.null_cond_prob(cfg),
                                          graphed=graphed)
            torch.cuda.synchronize()
            runs.append((state, aux.loss.clone(), graphed))
    (eager, loss_e, _), (replay, loss_g, graphed) = runs
    assert graphed.captures == 2 and torch.equal(loss_e, loss_g)
    for a, b in ((eager.model, replay.model), (eager.ema, replay.ema)):
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    for sa, sb in zip(eager.optimizer.adam.state.values(), replay.optimizer.adam.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert (eager.step, eager.optimizer.count) == (replay.step, replay.optimizer.count) == (12, 12)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_step_as_one_process(cuda, tmp_path):
    """Two data-parallel ranks on cuda:0 over gloo (NCCL refuses two ranks on
    one device), a B=8 step of a small UNet through K1 and K2 on each, against
    the one-process step on the same card (``torch_ranks.cuda_dp_step``)."""
    from torch_ranks import cuda_dp_step, spawn

    spawn(cuda_dp_step, 2, tmp_path)
    out = dict(np.load(tmp_path / "cuda_dp.npz"))
    assert out["loss_rel"] <= 1e-5 and out["worst_grad"] <= 1e-3
    assert out["k1_launches"] == 2 * 4 and out["k2_launches"] == 2 * 22  # fwd + bwd a call


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises(cuda):
    """A loss that reads a value back to the host cannot be captured: the
    capture raises, and nothing falls back to an eager step."""
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import GraphedTrainStep

    _, state, loss_fn, data = _small_training(cuda, False, None)

    def syncing(model, *args):
        loss, aux = loss_fn(model, *args)
        if loss.item() > 0:  # a host sync: illegal while capturing
            return loss, aux
        return loss, aux

    graphed = GraphedTrainStep(state, syncing)
    t = torch.zeros(4, dtype=torch.long, device=cuda)
    with pytest.raises(RuntimeError):
        graphed(data[:4], t, torch.randn_like(data[:4]))
    assert state.step == 0 and state.optimizer.count == 0


# the toy study, the batched SIMP and the UNet's circular padding and
# self-conditioning: the card (kernels, cuDNN, cuBLAS) against the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("estimation", ["mean", "sample"])
@pytest.mark.parametrize("pred_mode", ["x0", "eps", "mu"])
def test_toy_loss_on_the_card_matches_the_cpu(cuda, pred_mode, estimation):
    """The toy model's forward, then one fp32 loss and its gradients at the
    driver's B = 128 (all four loss terms on): the loss to 1e-5 relative,
    each gradient to 1e-3 of its max."""
    from physicsinformeddiffusionmodels_tpu_torch import train_toy
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.models.toy import ConditionalModel

    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((128, 2)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 128))
    noise = torch.from_numpy(rng.standard_normal((128, 2)).astype(np.float32))
    config = {**train_toy.default_config(), "c_ineq": 0.1, "lambda_opt": 0.01,
              "model_pred_mode": pred_mode, "x0_estimation": estimation}
    loss_fn = train_toy.build_loss_fn(create_schedule(100), config)
    out = {}
    for dev in ("cpu", cuda):
        model = ConditionalModel(seed=1).to(dev)
        y = model(x0.to(dev), t.to(dev))
        loss, _ = loss_fn(model, x0.to(dev), t.to(dev), noise.to(dev))
        out[str(dev)] = y.detach().cpu(), loss.item(), [
            g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))]
    (y_cpu, loss_cpu, g_cpu), (y, loss, grads) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(y, y_cpu, rtol=0, atol=1e-5 * y_cpu.abs().max().item())
    assert abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu), (loss, loss_cpu)
    for g, gc in zip(grads, g_cpu):
        assert (g - gc).abs().max().item() <= 1e-3 * gc.abs().max().item()


@pytest.mark.cuda
def test_toy_sampling_on_the_card_matches_the_cpu(cuda):
    """A 10-step pass of 256 points in each prediction mode, the draws given:
    the card's samples within 1e-4 of the largest CPU one."""
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import p_sample_loop
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.models.toy import ConditionalModel

    gen = torch.Generator().manual_seed(4)
    x_init, noise = torch.randn(256, 2, generator=gen), torch.randn(10, 256, 2, generator=gen)
    for mode in ("x0", "eps", "mu"):
        res = {}
        for dev in ("cpu", cuda):
            with torch.no_grad():
                res[str(dev)] = p_sample_loop(
                    create_schedule(10), ConditionalModel(seed=2).to(dev), x_init.to(dev),
                    noise.to(dev), pred_mode=mode).x.cpu()
        ref = res["cpu"]
        torch.testing.assert_close(res[str(cuda)], ref, rtol=0,
                                   atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
def test_batched_simp_on_the_card_matches_the_cpu(cuda):
    """Three SIMP iterations of three P = 16 load cases: the card's designs
    within 2e-4 of the CPU's (float32 CG sums in another order), each at its
    volume fraction, the final relres under 1e-4 on both."""
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
        SCENARIO_FAMILIES, MechanicsFEM)
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
        GpuSimpGenerator)

    fem, rng = MechanicsFEM(16), np.random.default_rng(21)
    fixed, f = np.zeros((3, fem.neq), bool), np.zeros((3, fem.neq))
    for b, fam in enumerate(["cantilever", "bridge", "double_clamp"]):
        fixed[b], f[b] = SCENARIO_FAMILIES[fam](fem, rng)
    vf = np.array([0.4, 0.5, 0.35])
    out = {}
    for dev in ("cpu", cuda):
        gen = GpuSimpGenerator(16, n_iter=3, device=dev)
        rho, rel = gen.optimize(gen.scenarios_from_host(fixed, f, vf))
        out[str(dev)] = rho.cpu(), rel.cpu()
    (rho_cpu, rel_cpu), (rho, rel) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(rho, rho_cpu, rtol=0, atol=2e-4)
    np.testing.assert_allclose(rho.mean(dim=1).numpy(), vf, atol=2e-3)
    assert (rel < 1e-4).all() and (rel_cpu < 1e-4).all()


@pytest.mark.cuda
@pytest.mark.parametrize("self_condition", [False, True], ids=["circular", "circular_selfcond"])
def test_unet_options_on_the_card_match_the_cpu(cuda, self_condition):
    """A circular UNet(dim=32) at 64x64, with and without self-conditioning:
    the forward within 5e-4 (the transplant tolerance) and one step's
    gradients within 1e-3 of each max, card vs CPU, with K1 (8) and K2 (38)
    launched in the card's forward."""
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet

    torch.manual_seed(0)
    ref_model = UNet(dim=32, channels=2, padding_mode="circular", self_condition=self_condition)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))
    t = torch.tensor([3, 70])
    dy = torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        model = UNet(dim=32, channels=2, padding_mode="circular",
                     self_condition=self_condition).to(dev)
        model.load_state_dict(ref_model.state_dict())
        before = (linear_attention_block.launches, group_norm_film_silu.launches)
        y = model(x.to(dev), t.to(dev), x_self_cond=sc.to(dev) if self_condition else None)
        launched = (linear_attention_block.launches - before[0],
                    group_norm_film_silu.launches - before[1])
        params = [p for p in model.parameters() if p.requires_grad]
        grads = torch.autograd.grad((y * dy.to(dev)).sum(), params, allow_unused=True)
        out[str(dev)] = y.detach().cpu(), [None if g is None else g.cpu() for g in grads], launched
    (y_cpu, g_cpu, l_cpu), (y, grads, launched) = out["cpu"], out[str(cuda)]
    assert launched == (8, 38) and l_cpu == (0, 0)
    assert (y - y_cpu).abs().max().item() <= 5e-4
    for g, gc in zip(grads, g_cpu):
        assert (g is None) == (gc is None)
        if g is not None:
            assert (g - gc).abs().max().item() <= 1e-3 * gc.abs().max().item()


# the inverse of each layout transform of models/reference_port.py (by name)
_REFERENCE_LAYOUT = {
    "_linear": lambda a: a.T,
    "_conv3d": lambda a: a.transpose(3, 2, 0, 1)[:, :, None],
    "_conv2d": lambda a: a.transpose(3, 2, 0, 1),
    "_pointwise3d": lambda a: a.T[:, :, None, None, None],
    "_pointwise2d": lambda a: a.T[:, :, None, None],
    "_conv_transpose3d": lambda a: a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1][:, :, None],
    "_gamma": lambda a: a.reshape(1, -1, 1, 1, 1),
    "_copy": lambda a: a,
}


@pytest.mark.cuda
def test_reference_imported_unet_forward_on_the_card(cuda):
    """A seeded UNet(dim=32, frame_attention=False) rewritten into the
    reference Unet3D's layout (with a dead-module tensor) and imported by
    ``import_reference_state_dict``: its forward on the card is the source
    model's bit for bit (cuDNN deterministic), within 5e-4 of the CPU's,
    with K1 (8) and K2 (38) launched."""
    from physicsinformeddiffusionmodels_tpu_torch.models.reference_port import (
        import_reference_state_dict, reference_key_map)
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
    from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
        flax_params_from_torch)

    torch.manual_seed(3)
    source = UNet(dim=32, channels=2, frame_attention=False)
    key_map, sd = reference_key_map(32), {"sign_emb_CNN.0.weight": torch.ones(32, 1, 3)}

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    for path, a in leaves(flax_params_from_torch(source.state_dict())["params"]):
        tkey, transform = key_map[path]
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(_REFERENCE_LAYOUT[transform.__name__](a)))
    model = UNet(dim=32, channels=2, frame_attention=False)
    _, unused = import_reference_state_dict(sd, model, key_map)
    assert unused == ["sign_emb_CNN.0.weight"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 2)).astype(np.float32))
    t = torch.tensor([0, 9, 50, 99])
    with torch.no_grad():
        y_cpu = model(x, t)
        model, source = model.to(cuda), source.to(cuda)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                        allow_tf32=False):
            before = (linear_attention_block.launches, group_norm_film_silu.launches)
            y = model(x.to(cuda), t.to(cuda))
            launched = (linear_attention_block.launches - before[0],
                        group_norm_film_silu.launches - before[1])
            y_source = source(x.to(cuda), t.to(cuda))
    assert launched == (8, 38)
    assert torch.equal(y, y_source)
    assert (y.cpu() - y_cpu).abs().max().item() <= 5e-4


@pytest.mark.cuda
def test_unet_without_linear_attention_on_the_card(cuda):
    """UNet(dim=32, init_dim=48, use_sparse_linear_attn=False,
    cond_path=False): the forward within 5e-4 and each gradient within 1e-3
    of its max, card vs CPU, with no K1 and 38 K2 launched, forward and
    backward."""
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet

    torch.manual_seed(0)
    ref_model = UNet(dim=32, channels=2, init_dim=48, use_sparse_linear_attn=False,
                     cond_path=False)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 64, 64, 2)).astype(np.float32))
    t = torch.tensor([3, 70])
    out = {}
    for dev in ("cpu", cuda):
        model = UNet(dim=32, channels=2, init_dim=48, use_sparse_linear_attn=False,
                     cond_path=False).to(dev)
        model.load_state_dict(ref_model.state_dict())
        counters = (linear_attention_block, group_norm_film_silu)
        before = [(f.launches, f.backward_launches) for f in counters]
        y = model(x.to(dev), t.to(dev))
        grads = torch.autograd.grad((y * dy.to(dev)).sum(), list(model.parameters()))
        launched = [(f.launches - b[0], f.backward_launches - b[1])
                    for f, b in zip(counters, before)]
        out[str(dev)] = y.detach().cpu(), [g.cpu() for g in grads], launched
    (y_cpu, g_cpu, l_cpu), (y, grads, launched) = out["cpu"], out[str(cuda)]
    assert launched == [(0, 0), (38, 38)] and l_cpu == [(0, 0), (0, 0)]
    assert (y - y_cpu).abs().max().item() <= 5e-4
    for g, gc in zip(grads, g_cpu):
        assert (g - gc).abs().max().item() <= 1e-3 * gc.abs().max().item()
