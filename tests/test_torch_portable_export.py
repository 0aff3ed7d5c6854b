"""The port's portable-checkpoint export (``export_portable_checkpoint``)
on the CPU: the JAX package's three ``tests/test_portable_checkpoint.py``
cases on the port, then byte equality with the JAX script's ``export`` of
the same input, for a checkpoint the port wrote, one the JAX package wrote
(with a bfloat16, an int and a float64 leaf) and the committed
``results/darcy_300k_fp32head/portable``; ``sample_eval --model-dir`` of the
port reads the export.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu.training.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch import export_portable_checkpoint, sample_eval
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    load_checkpoint,
    msgpack_restore,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
export = export_portable_checkpoint.export


def _jax_export():
    spec = importlib.util.spec_from_file_location(
        "jax_export_portable_checkpoint", ROOT / "scripts" / "export_portable_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.export


def _dense_run(tmp_path, with_ema=True):
    """A run of a ``dense`` layer written by the port: raw weights, EMA
    weights (or none) and Adam's state after one step."""
    torch.manual_seed(0)
    model = torch.nn.ModuleDict({"dense": torch.nn.Linear(3, 4)})
    ema = torch.nn.ModuleDict({"dense": torch.nn.Linear(3, 4)})
    opt = make_optimizer(model)
    sum(p.sum() for p in model.parameters()).backward()
    opt.step()
    run = tmp_path / "run"
    save_checkpoint(run / "model", 1234, model=model, ema=ema if with_ema else None,
                    optimizer=opt, config=RunConfig(gov_eqs="darcy"))
    RunConfig(gov_eqs="darcy").save(run / "config.json")
    return run, model, ema


def test_export_is_f16_ema_only_and_smaller(tmp_path):
    run, _, ema = _dense_run(tmp_path)
    out = tmp_path / "portable"
    dst = export(run, out, step=None)
    assert dst.name == "checkpoint_1234.msgpack"
    assert (out / "config.json").exists()
    raw = msgpack_restore(dst.read_bytes())
    assert raw["params"] == {} and raw["opt_state"] == {}
    leaf = raw["ema_params"]["params"]["dense"]["kernel"]
    assert leaf.dtype == np.float16
    np.testing.assert_allclose(leaf, ema.dense.weight.detach().numpy().T, rtol=1e-3)
    assert dst.stat().st_size < (run / "model" / "checkpoint_1234.msgpack").stat().st_size


def test_export_falls_back_to_raw_params(tmp_path):
    run, model, _ = _dense_run(tmp_path, with_ema=False)
    out = tmp_path / "portable"
    export(run, out, step=None)
    raw = msgpack_restore((out / "model" / "checkpoint_1234.msgpack").read_bytes())
    leaf = raw["ema_params"]["params"]["dense"]["bias"]
    assert leaf.dtype == np.float16
    np.testing.assert_allclose(leaf, model.dense.bias.detach().numpy(), rtol=1e-3)


def _unet_run(tmp_path):
    """A tiny Darcy run written by the port: UNet(dim=8) at 16x16, raw and
    EMA weights apart, Adam's state after one step."""
    cfg = RunConfig(name="tiny", unet_dim=8, pixels_per_dim=16, diff_steps=4,
                    compute_dtype="float32")
    torch.manual_seed(1)
    model, ema = UNet(dim=8, channels=2), UNet(dim=8, channels=2)
    opt = make_optimizer(model)
    sum(p.sum() for p in model.parameters()).backward()
    opt.step()
    run = tmp_path / "tiny"
    save_checkpoint(run / "model", 5, model=model, ema=ema, optimizer=opt)
    save_checkpoint(run / "model", 9, model=model, ema=ema, optimizer=opt)
    cfg.save(run / "config.json")
    return run, ema


def test_load_run_restores_f16_to_f32(tmp_path):
    """``load_checkpoint`` widens the export's leaves to float32, and
    ``sample_eval`` loads and samples the portable run: its weights are the
    EMA's rounded to float16. A second export to the same directory leaves
    one checkpoint there."""
    run, ema = _unet_run(tmp_path)
    out = tmp_path / "portable"
    export(run, out, step=5)
    assert export(run, out, step=None).name == "checkpoint_9.msgpack"
    assert [p.name for p in (out / "model").glob("checkpoint_*")] == ["checkpoint_9.msgpack"]
    raw = load_checkpoint(out / "model" / "checkpoint_9.msgpack")
    leaf = raw["ema_params"]["params"]["final_conv"]["kernel"]
    assert leaf.dtype == np.float32
    cfg, model, step = sample_eval.load_run(out, device="cpu")
    assert cfg.unet_dim == 8 and step == 9
    for k, v in ema.state_dict().items():
        assert torch.equal(model.state_dict()[k], v.half().float()), k
    sample_eval.main(["--model-dir", str(out), "--no-samples", "1", "--device", "cpu",
                      "--compute-dtype", "float32", "--out", str(tmp_path / "eval")])
    assert (tmp_path / "eval" / "validation" / "sample_statistics.csv").exists()


def _jax_run(tmp_path):
    """A run written by the JAX package whose EMA tree holds a float32, a
    bfloat16, an int32 and a float64 leaf, the keys out of order."""
    rng = np.random.default_rng(2)
    params = {"b": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)}}
    ema = {"z_dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                       "bias": jnp.asarray(rng.standard_normal(4), jnp.bfloat16)},
           "a_count": np.asarray(7, np.int32), "m_scale": np.float64(0.1)}
    run = tmp_path / "jax_run"
    jax_save_checkpoint(run / "model", 300, params=params, ema_params=ema,
                        opt_state={"count": np.asarray(42, np.int32)})
    JaxRunConfig(gov_eqs="darcy").save(run / "config.json")
    return run


@pytest.mark.parametrize("source", ["port", "jax", "committed"])
def test_export_is_byte_equal_to_the_jax_script(tmp_path, source):
    """The port's export and the JAX script's of the same input write the
    same bytes, checkpoint and config.json alike."""
    run = {"port": lambda: _unet_run(tmp_path)[0], "jax": lambda: _jax_run(tmp_path),
           "committed": lambda: ROOT / "results" / "darcy_300k_fp32head" / "portable"}[source]()
    got, want = export(run, tmp_path / "port", None), _jax_export()(run, tmp_path / "jax", None)
    assert got.name == want.name
    assert got.read_bytes() == want.read_bytes()
    assert (tmp_path / "port" / "config.json").read_bytes() == \
        (tmp_path / "jax" / "config.json").read_bytes()
    if source == "jax":  # the bfloat16 leaf kept its dtype, as in JAX's export
        raw = msgpack_restore(got.read_bytes(), keep_bfloat16=True)
        assert raw["ema_params"]["z_dense"]["bias"].dtype == "bfloat16"
        assert raw["ema_params"]["z_dense"]["kernel"].dtype == np.float16
    if source == "committed":
        cfg, model, step = sample_eval.load_run(tmp_path / "port", device="cpu")
        assert step == 300000
        raw = load_checkpoint(got)
        for k, v in torch_state_dict_from_flax(raw["ema_params"]).items():
            assert torch.equal(model.state_dict()[k], v), k


def test_export_without_a_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_portable_checkpoint.main(["--model-dir", str(tmp_path), "--out",
                                         str(tmp_path / "out")])
