"""``RunConfig.from_model_yaml``, ``RunConfig.save`` and ``train
--model-yaml`` of the port against the JAX package's ``RunConfig`` on the
same reference-format ``model.yaml``: the cases of JAX's
``tests/test_schedule.py::test_config_from_model_yaml``, held field for
field."""

import dataclasses

import pytest

from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu_torch import train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_YAML = ("c_data: 1\nc_residual: 0.001\nc_ineq: 0\nlambda_opt: 0\n"
              "diff_steps: 100\nx0_estimation: 'sample'\nddim_steps: 3\n"
              "residual_grad_guidance: False\ncorrection_mode: xt\n"
              "M_correction: 2\nN_correction: 1\ngov_eqs: darcy\nfd_acc: 2\n")


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_model_yaml_matches_jax_field_for_field(tmp_path):
    y = tmp_path / "model.yaml"
    y.write_text(MODEL_YAML)
    cfg, ref = RunConfig.from_model_yaml(y, name="t"), JaxRunConfig.from_model_yaml(y, name="t")
    assert _fields(cfg) == _fields(ref)
    assert cfg.ddim_steps == 3 and cfg.use_ddim_x0
    assert cfg.train_batch_size == 16  # sample-estimation halves the batch
    assert cfg.correction_mode == "xt" and cfg.N_correction == 1
    # a correction mode that YAML reads as a bool or a number stays a string
    y.write_text("correction_mode: none\nM_correction: 0\n")
    assert _fields(RunConfig.from_model_yaml(y)) == _fields(JaxRunConfig.from_model_yaml(y))


def test_model_yaml_refuses_unknown_keys(tmp_path):
    y = tmp_path / "model.yaml"
    y.write_text("not_a_key: 1\n")
    with pytest.raises(ValueError, match="not_a_key"):
        RunConfig.from_model_yaml(y)
    with pytest.raises(ValueError):
        JaxRunConfig.from_model_yaml(y)


def test_save_writes_what_jax_loads(tmp_path):
    cfg = RunConfig(name="saved", gov_eqs="mechanics", mesh_tp=2, compute_dtype="float32")
    cfg.save(tmp_path / "config.json")
    assert _fields(JaxRunConfig.load(tmp_path / "config.json")) == _fields(cfg)
    assert _fields(RunConfig.load(tmp_path / "config.json")) == _fields(cfg)


def test_train_model_yaml_flag(tmp_path):
    """``train --model-yaml`` configures the run from the file, the other
    flags on top, as the JAX ``train.py``'s ``RunConfig.from_model_yaml(path,
    **flags)``."""
    y = tmp_path / "model.yaml"
    y.write_text(MODEL_YAML)
    cfg = train.config_from_args(train.parse_args(
        ["--model-yaml", str(y), "--name", "t", "--iterations", "7", "--c-residual", "0.01"]))
    ref = JaxRunConfig.from_model_yaml(y, gov_eqs="darcy", name="t", train_iterations=7,
                                       c_residual=0.01)
    assert _fields(cfg) == _fields(ref)
    assert cfg.x0_estimation == "sample" and cfg.c_residual == 0.01
