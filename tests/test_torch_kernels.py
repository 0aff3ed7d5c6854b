"""The two fused kernels' plain versions against the JAX Pallas bodies (run in
interpret mode, as the JAX package's own tests run them), and the wrappers'
CPU routing and argument checks. The CUDA kernels themselves are held
against the plain versions in test_torch_cuda.py, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.ops import pallas_attention as pa
from physicsinformeddiffusionmodels_tpu.ops import pallas_kernels as pk
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
    group_norm_film_silu,
    group_norm_film_silu_plain,
)
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention_block,
    linear_attention_block_plain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADS, DH = 8, 32
H = HEADS * DH
# v is divided by N and the k softmax averages it over the tokens, so with
# unit-scale weights the attention term is 1e-5..1e-3, below the tolerance
# beside x; W_out scaled by LA_GAIN * N makes it O(1), so a broken attention
# fails the comparison
LA_GAIN = 100.0


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


def _t(a, device="cpu"):
    return None if a is None else torch.from_numpy(a).to(device)


@pytest.mark.parametrize("n,c", [(256, 32), (128, 64), (1024, 32)])
def test_linear_attention_plain_matches_pallas_interpret(n, c):
    x, gamma, w_qkv, w_out, b_out = _lab_inputs(2, n, c)
    ref = pa._linear_attention_block_pallas(
        jnp.swapaxes(x, -1, -2), gamma.reshape(c, 1), jnp.swapaxes(w_qkv, 0, 1), w_out,
        b_out.reshape(c, 1), HEADS, DH, 1e-5, True)
    ref = np.swapaxes(np.asarray(ref), -1, -2)
    # the attention term is what the comparison holds, so it must be far
    # above the tolerance
    assert np.abs(ref - x - b_out).max() >= 1.0
    got = linear_attention_block_plain(*map(_t, (x, gamma, w_qkv, w_out, b_out)), HEADS, DH)
    # fp32 both; the Pallas body streams the token softmax over tiles and
    # sums in another order (the JAX package's own kernel tolerance)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("n,c", [(64, 32), (256, 64)])
def test_group_norm_plain_matches_pallas_interpret(film, n, c):
    x, gamma, beta, scale, shift = _gn_inputs(3, n, c, film)
    zeros = np.zeros((3, c), np.float32)
    ref = pk._gn_film_silu_pallas(
        x, gamma, beta, zeros if scale is None else scale, zeros if shift is None else shift,
        8, 1e-5, True)
    got = group_norm_film_silu_plain(*map(_t, (x, gamma, beta, scale, shift)), groups=8)
    # fp32: the Pallas body takes E[x^2] - E[x]^2, the plain version the
    # centred second moment
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_wrappers_use_the_plain_versions_for_cpu_tensors():
    x, gamma, w_qkv, w_out, b_out = map(_t, _lab_inputs(2, 64, 32))
    before = linear_attention_block.launches
    np.testing.assert_array_equal(
        linear_attention_block(x, gamma, w_qkv, w_out, b_out).numpy(),
        linear_attention_block_plain(x, gamma, w_qkv, w_out, b_out).numpy())
    assert linear_attention_block.launches == before

    args = list(map(_t, _gn_inputs(2, 64, 32, True)))
    before = group_norm_film_silu.launches
    np.testing.assert_array_equal(group_norm_film_silu(*args).numpy(),
                                  group_norm_film_silu_plain(*args).numpy())
    assert group_norm_film_silu.launches == before


def test_plain_versions_keep_bfloat16_inputs_in_bfloat16():
    x, gamma, w_qkv, w_out, b_out = map(_t, _lab_inputs(1, 64, 32))
    xb = x.bfloat16()
    out = linear_attention_block(xb, gamma, w_qkv, w_out, b_out)
    assert out.dtype == torch.bfloat16
    ref = linear_attention_block_plain(xb.float(), gamma, w_qkv, w_out, b_out)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.05, rtol=0.02)
    args = list(map(_t, _gn_inputs(1, 64, 32, True)))
    y = group_norm_film_silu(args[0].bfloat16(), *args[1:])
    assert y.dtype == torch.bfloat16


def test_wrappers_refuse_other_devices():
    x, gamma, w_qkv, w_out, b_out = _lab_inputs(1, 16, 32)
    meta = torch.empty((1, 16, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        linear_attention_block(meta, *map(_t, (gamma, w_qkv, w_out, b_out)))
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_film_silu(meta, _t(gamma), _t(b_out))


def test_build_names_the_library_after_its_sources(monkeypatch, tmp_path):
    from physicsinformeddiffusionmodels_tpu_torch.ops import _build

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libpidm_kernels_")
    assert sorted(p.name for p in _build._sources()) == [
        "conv_block.cu", "conv_block_bwd.cu", "group_norm.cu", "group_norm_bwd.cu",
        "group_norm_packed.cu", "linear_attention.cu", "linear_attention_bwd.cu"]
    # a changed source gives another library name, so a stale build is never loaded
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    assert _build.library_path() == path
    (src / "group_norm.cu").write_text("// changed\n")
    assert _build.library_path() != path
    # and so does a changed header
    changed = _build.library_path()
    (src / "conv_tile.cuh").write_text("// changed\n")
    assert _build.library_path() not in (path, changed)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from physicsinformeddiffusionmodels_tpu_torch.ops import _build

    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
