"""The port's msgpack reader and config against the JAX package's files."""

import json
from pathlib import Path

import numpy as np
import pytest
from flax import serialization

from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    msgpack_restore,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "results/darcy_300k_fp32head/portable/model/checkpoint_300000.msgpack"


def _assert_trees_identical(a, b, path="") -> int:
    """Same structure, same Python values, arrays equal bit for bit; returns
    the number of array leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        return sum(_assert_trees_identical(a[k], b[k], f"{path}/{k}") for k in b)
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
        return 1
    assert type(a) is type(b) and a == b, path
    return 0


def test_reader_matches_flax_bit_for_bit():
    data = CKPT.read_bytes()
    n = _assert_trees_identical(msgpack_restore(data), serialization.msgpack_restore(data))
    assert n == 271  # the ema_params leaves; params and opt_state are empty


def test_reader_scalars_and_containers():
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129, -(2**40)],
        "floats": [0.5, -1.25e300],
        "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "ü" * 200],
        "bytes": b"\x00\x01" * 40,
        "npscalar": np.float32(3.5),
        "arrays": {
            "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "f16": np.array([1.5, -2.0], np.float16),
            "i64": np.array([[-(2**40)]], np.int64),
            "empty": np.zeros((0, 4), np.float32),
        },
        "big_map": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    _assert_trees_identical(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_rejects_truncated_data():
    data = CKPT.read_bytes()[:1000]
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data)


def test_load_checkpoint_casts_float16_to_float32():
    raw = load_checkpoint(CKPT)
    assert raw["step"] == 300000
    leaf = raw["ema_params"]["params"]["init_conv"]["Conv_0"]["kernel"]
    ref = serialization.msgpack_restore(CKPT.read_bytes())
    ref_leaf = ref["ema_params"]["params"]["init_conv"]["Conv_0"]["kernel"]
    assert ref_leaf.dtype == np.float16 and leaf.dtype == np.float32
    np.testing.assert_array_equal(leaf, ref_leaf.astype(np.float32))
    assert latest_checkpoint(CKPT.parent) == CKPT


@pytest.mark.parametrize("config_path", sorted(ROOT.glob("results/*/portable/config.json")),
                         ids=lambda p: p.parent.parent.name)
def test_portable_configs_load_unchanged(config_path):
    ours = RunConfig.load(config_path)
    ref = JaxRunConfig.load(config_path)
    assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert (ours.output_channels, ours.model_channels) == (ref.output_channels, ref.model_channels)


def test_use_double_is_refused():
    with pytest.raises(ValueError, match="use_double"):
        RunConfig(use_double=True)
