"""The port's reference-checkpoint import (``models/reference_port.py`` and
the ``import_reference_checkpoint`` CLI) against the JAX package's on the
CPU: the key map path for path, the import of a seeded state dict in the
reference layout bit for bit (the JAX import's tree carried across with
``torch_state_dict_from_flax``), the forward against Flax's, the errors,
the ``.pt`` loader, and the CLI against ``scripts/import_reference_checkpoint.py``
on the same files.

The reference's own ``Unet3D`` is not in the repo: the state dicts are
built from the map's reference keys, each tensor in the reference layout
(the inverse of the map's transform applied to the Flax leaf's shape),
plus tensors of the reference's dead modules. JAX's import reads only the
shapes and dtypes of its template's leaves, so the templates are zeros of
``jax.eval_shape(model.init, ...)`` (an eager ``model.init`` takes about a
minute on one CPU).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models import reference_port as jax_port
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.training.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch import import_reference_checkpoint, sample_eval
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.reference_port import (
    import_reference_state_dict,
    reference_key_map,
    state_dict_from_torch_file,
)
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    flax_params_from_torch,
    load_checkpoint,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
P = 16
# fp32 on both sides, summed in another order: within FWD_TOL of the max
FWD_TOL = 1e-5
# the reference layout of each transform's Flax leaf shape
REF_SHAPE = {
    "_linear": lambda s: (s[1], s[0]),
    "_conv3d": lambda s: (s[3], s[2], 1, s[0], s[1]),
    "_conv2d": lambda s: (s[3], s[2], s[0], s[1]),
    "_pointwise3d": lambda s: (s[1], s[0], 1, 1, 1),
    "_pointwise2d": lambda s: (s[1], s[0], 1, 1),
    "_conv_transpose3d": lambda s: (s[2], s[3], 1, s[0], s[1]),
    "_gamma": lambda s: (1, s[0], 1, 1, 1),
    "_copy": lambda s: tuple(s),
}
# tensors of modules the reference builds but never runs
DEAD = {"init_temporal_attn.fn.to_qkv.weight": (96, 32),
        "mid_temporal_attn.fn.to_out.weight": (32, 96),
        "time_rel_pos_bias.relative_attention_bias.weight": (32, 8),
        "sign_emb_CNN.0.weight": (8, 1, 3),
        "downs.0.2.fn.fn.to_q.weight": (256, 32, 1, 1),
        "rotary_emb.inv_freq": (16,)}

MAP_CASES = {
    "darcy": dict(dim=32, channels=2),
    "mechanics": dict(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True),
    "init_dim": dict(dim=16, channels=2, init_dim=24),
    "no_linear_attn": dict(dim=16, channels=2, use_sparse_linear_attn=False),
    "no_cond_path": dict(dim=16, channels=2, cond_path=False),
}
MAP_KEYS = ("dim", "init_dim", "use_sparse_linear_attn", "cond_path")


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _template(flax_model, *args):
    """Zeros of the shapes and dtypes of ``flax_model.init(*args)``."""
    shapes = jax.eval_shape(flax_model.init, *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _map_kw(kw):
    return {k: v for k, v in kw.items() if k in MAP_KEYS}


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_key_map_matches_jax(case):
    """The same Flax paths, reference keys and transform names as JAX's
    map, which covers every path of the port's UNet built with the options
    (a map entry the model lacks is never consulted: ``_reference_state_dict``)."""
    kw = MAP_CASES[case]
    got, ref = reference_key_map(**_map_kw(kw)), jax_port.reference_key_map(**_map_kw(kw))
    assert list(got) == list(ref)
    for path, (tkey, fn) in ref.items():
        assert got[path][0] == tkey and got[path][1].__name__ == fn.__name__, path
    template = flax_params_from_torch(UNet(**kw, frame_attention=False).state_dict())["params"]
    assert {p for p, _ in _leaves(template)} == set(got)


def _reference_state_dict(flax_params, key_map, seed):
    """A seeded state dict in the reference layout for each leaf of the Flax
    tree, plus dead-module tensors. Only the tree's leaves are looked up: at
    init_dim == 2 * dim the last decoder level's first ResnetBlock takes
    2 * dim channels and gives init_dim, so it has no res conv, in the
    reference as in Flax, while both maps list one."""
    rng = np.random.default_rng(seed)
    sd = {}
    for path, leaf in _leaves(flax_params):
        tkey, fn = key_map[path]
        shape = REF_SHAPE[fn.__name__](leaf.shape)
        sd[tkey] = (rng.standard_normal(shape) / np.sqrt(max(2, np.prod(shape[1:])))
                    ).astype(np.float32)
    for k, shape in DEAD.items():
        sd[k] = rng.standard_normal(shape).astype(np.float32)
    return sd


IMPORT_CASES = {
    "darcy": dict(dim=16, channels=2),
    "mechanics": dict(dim=8, channels=10, out_dim=3, sigmoid_last_channel=True),
    "options": dict(dim=8, channels=2, init_dim=16, use_sparse_linear_attn=False,
                    cond_path=False),
}


@pytest.mark.parametrize("case", list(IMPORT_CASES))
def test_import_matches_jax_bit_for_bit(case):
    """JAX's import of a reference-layout dict, carried across with
    ``torch_state_dict_from_flax``, equals the port's import bit for bit;
    ``unused`` is the same list (the dead modules); the port's forward is
    within FWD_TOL of Flax's on the imported weights."""
    kw = IMPORT_CASES[case]
    channels = kw["channels"]
    flax_model = FlaxUNet(**kw, frame_attention=False)
    x = np.random.default_rng(1).standard_normal((2, P, P, channels)).astype(np.float32)
    t = np.array([3, 71], np.int32)
    template = _template(flax_model, jax.random.key(0), jnp.asarray(x), jnp.asarray(t))
    key_map = jax_port.reference_key_map(**_map_kw(kw))
    sd = _reference_state_dict(template["params"], key_map, seed=2)
    jax_params, jax_unused = jax_port.import_reference_state_dict(sd, template, key_map)

    model = UNet(**kw, frame_attention=False)
    got, unused = import_reference_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, model, reference_key_map(**_map_kw(kw)))
    want = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    assert unused == jax_unused == sorted(DEAD)
    assert got.keys() == want.keys() == model.state_dict().keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(model.state_dict()[k], v), k
    ref = np.asarray(jax.jit(flax_model.apply)(jax_params, x, t))
    with torch.no_grad():
        y = model(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(y, ref, atol=FWD_TOL * np.abs(ref).max(), rtol=0)


def _darcy_sd(dim=8, seed=3):
    model = UNet(dim=dim, channels=2, frame_attention=False)
    key_map = reference_key_map(dim)
    return model, key_map, _reference_state_dict(
        flax_params_from_torch(model.state_dict())["params"], key_map, seed)


def test_import_errors():
    """JAX's three errors: a missing reference key, a shape mismatch, and a
    model with the frame attention (with the hint)."""
    model, key_map, sd = _darcy_sd()
    missing = dict(sd)
    del missing["mid_block1.block1.proj.bias"]
    with pytest.raises(KeyError, match="missing mid_block1.block1.proj.bias"):
        import_reference_state_dict(missing, model, key_map)
    wrong = dict(sd, **{"final_conv.1.bias": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        import_reference_state_dict(wrong, model, key_map)
    with pytest.raises(KeyError, match=r"FrameAttention.*frame_attention=False"):
        import_reference_state_dict(sd, UNet(dim=8, channels=2), key_map)


@pytest.mark.parametrize("wrapped", [True, False], ids=["wrapped", "bare"])
def test_state_dict_from_torch_file(tmp_path, wrapped):
    """A ``.pt`` of ``{'model': sd}`` or of a bare sd loads as numpy arrays
    equal to the tensors, and imports as the in-memory dict does."""
    model, key_map, sd = _darcy_sd()
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = tmp_path / "checkpoint_100.pt"
    torch.save({"model": tensors} if wrapped else tensors, path)
    loaded = state_dict_from_torch_file(path)
    assert loaded.keys() == sd.keys()
    assert all(isinstance(v, np.ndarray) and np.array_equal(v, sd[k]) for k, v in loaded.items())
    a, _ = import_reference_state_dict(loaded, model, key_map)
    b, _ = import_reference_state_dict(sd, model, key_map)
    assert all(torch.equal(a[k], b[k]) for k in a)


class _ShapeInitUNet:
    """The Flax UNet with ``init`` giving ``_template``'s zeros: what JAX's
    import reads of its template (shapes and dtypes) is unchanged."""

    def __init__(self, **kw):
        self.model = FlaxUNet(**kw)

    def init(self, *args):
        return _template(self.model, *args)


def _jax_cli(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_import_reference_checkpoint", ROOT / "scripts" / "import_reference_checkpoint.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(cli, "UNet", _ShapeInitUNet)
    return cli


@pytest.mark.parametrize("gov_eqs", ["darcy", "mechanics"])
def test_import_cli_matches_the_jax_script(tmp_path, monkeypatch, gov_eqs):
    """The port's CLI and JAX's script on the same ``.pt`` and
    ``model.yaml``: equal config.json files and equal decoded checkpoints,
    leaf for leaf and dtype for dtype (both slots filled, no optimizer
    state); ``sample_eval.load_run`` of the port loads the run."""
    dim = 8
    yaml = tmp_path / "model.yaml"
    yaml.write_text("c_data: 1.0\nc_residual: 0.001\ndiff_steps: 100\nx0_estimation: mean\n"
                    f"correction_mode: None\ngov_eqs: {gov_eqs}\nfd_acc: 2\n"
                    f"unet_dim: {dim}\npixels_per_dim: {P}\n")
    channels, out_dim = (2, 2) if gov_eqs == "darcy" else (10, 3)
    model = UNet(dim=dim, channels=channels, out_dim=out_dim, frame_attention=False,
                 sigmoid_last_channel=gov_eqs == "mechanics")
    key_map = reference_key_map(dim)
    sd = _reference_state_dict(flax_params_from_torch(model.state_dict())["params"], key_map, 4)
    pt = tmp_path / "checkpoint_12345.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, pt)
    args = ["--checkpoint", str(pt), "--model-yaml", str(yaml)]
    _jax_cli(monkeypatch).main(args + ["--out", str(tmp_path / "jax")])
    import_reference_checkpoint.main(args + ["--out", str(tmp_path / "port")])

    for name in ("config.json", "model/config.json"):
        got = json.loads((tmp_path / "port" / name).read_text())
        assert got == json.loads((tmp_path / "jax" / name).read_text())
        assert got["frame_attention"] is False and got["gov_eqs"] == gov_eqs
    path = "model/checkpoint_12345.msgpack"
    got = load_checkpoint(tmp_path / "port" / path)
    want = jax_load_checkpoint(tmp_path / "jax" / path)
    assert got["step"] == want["step"] == 12345 and got["opt_state"] == want["opt_state"] == {}
    for slot in ("params", "ema_params"):
        a, b = list(_leaves(got[slot])), list(_leaves(want[slot]))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, u), (_, v) in zip(a, b):
            assert u.dtype == np.asarray(v).dtype and np.array_equal(u, np.asarray(v)), (slot, p)
    cfg, loaded, step = sample_eval.load_run(tmp_path / "port", device="cpu")
    assert step == 12345 and not loaded.frame_attention
    assert loaded.sigmoid_last_channel == (gov_eqs == "mechanics")
    for k, v in torch_state_dict_from_flax(want["params"]).items():
        assert torch.equal(loaded.state_dict()[k], v), k
