"""The port's entry points: import independence from JAX, device selection,
and the ``sample_eval`` CLI's outputs in the JAX ``sample_eval.py`` format."""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu.training.checkpoint import save_checkpoint
from physicsinformeddiffusionmodels_tpu_torch import sample_eval
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import resolve_device
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_CHECK = """
import importlib, json, pkgutil, sys
banned = ("jax", "jaxlib", "flax", "optax", "msgpack", "matplotlib",
          "physicsinformeddiffusionmodels_tpu")
for name in banned:  # an import of any of them now raises ImportError
    sys.modules[name] = None
import physicsinformeddiffusionmodels_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
sample_eval.parse_args(["--model-dir", "m", "--no-samples", "2", "--device", "cpu",
                        "--guidance-scale", "3"])
train.parse_args(["--iterations", "2", "--device", "cpu", "--x0-estimation", "sample",
                  "--residual-grad-guidance", "--chunk-steps", "20", "--mesh-dp", "2",
                  "--mesh-tp", "2", "--mesh-slices", "2", "--tp-shard-activations",
                  "--seq-parallel-attn"])
from physicsinformeddiffusionmodels_tpu_torch import train_mechanics
train_mechanics.parse_args(["--iterations", "2", "--device", "cpu", "--chunk-steps", "20"])
from physicsinformeddiffusionmodels_tpu_torch import train_toy
train_toy.parse_args(["--device", "cpu", "--epochs", "1", "--pred-mode", "mu"])
print(json.dumps({"modules": names,
                  "banned": sorted(k for k in sys.modules
                                   if k.split(".")[0] in banned and sys.modules[k] is not None)}))
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("models.unet", "train", "data.datasets", "data.darcy_generator",
                 "training.trainer", "diffusion.losses", "profile_attn", "profile_gn",
                 "utils.timing", "utils.viz", "ops.conv_block", "diffusion.sampling",
                 "diffusion.schedule", "physics.darcy", "sample_eval", "config",
                 "profile_training", "profile_k4", "physics.mechanics", "physics.fem_grid",
                 "ops.reshape", "ops.connected_components", "data.mechanics_generator",
                 "generate_mechanics_sets", "train_mechanics", "profile_sampling",
                 "physics.toy", "models.toy", "train_toy", "data.mechanics_generator_gpu",
                 "parallel", "parallel.mesh", "parallel.collectives", "parallel.seq_attention",
                 "ops.gradients", "models.blocks", "models.reference_port",
                 "import_reference_checkpoint", "export_portable_checkpoint",
                 "generate_mechanics_data"):
        assert f"physicsinformeddiffusionmodels_tpu_torch.{name}" in report["modules"]
    assert len(report["modules"]) >= 40
    assert report["banned"] == []


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_eval.main(["--model-dir", str(tmp_path), "--no-samples", "1"])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A small Darcy run directory written by the JAX package: config.json
    and a float32 msgpack checkpoint of random weights."""
    run = tmp_path_factory.mktemp("tiny_run")
    cfg = JaxRunConfig(name="tiny", unet_dim=8, pixels_per_dim=16, diff_steps=4,
                       compute_dtype="float32")
    shapes = jax.eval_shape(FlaxUNet(dim=8, channels=2).init, jax.random.key(0),
                            np.zeros((1, 16, 16, 2), np.float32), np.zeros((1,), np.int32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes)
    save_checkpoint(run / "model", 7, params=params, ema_params=params)
    cfg.save(run / "config.json")
    return run


def test_cli_writes_jax_format_statistics(tiny_run, tmp_path):
    out = tmp_path / "eval"
    sample_eval.main(["--model-dir", str(tiny_run), "--no-samples", "2", "--device", "cpu",
                      "--seed", "3", "--out", str(out)])
    with open(out / "validation" / "sample_statistics.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Sample Index", "Residuals (abs)"]
    assert [r[0] for r in rows[1:]] == ["0", "1", "Mean"]
    res = np.array([float(r[1]) for r in rows[1:3]])
    assert float(rows[3][1]) == pytest.approx(res.mean(), rel=1e-6)

    # the per-sample CSVs hold the fields those residuals were computed on
    fields = np.stack([
        np.stack([np.loadtxt(out / "validation" / f"sample_{s}" / f"sample_{c}.csv",
                             delimiter=",") for c in range(2)], axis=-1)
        for s in range(2)
    ]).astype(np.float32)
    assert fields.shape == (2, 16, 16, 2)
    ref = np.abs(np.asarray(JaxDarcy(pixels_per_dim=16).residual(fields))).mean(axis=(1, 2))
    np.testing.assert_allclose(res, ref, rtol=1e-4)

    settings = json.loads((out / "eval_settings.json").read_text())
    assert settings["checkpoint_step"] == 7 and settings["device"] == "cpu"
    # every key of the JAX sample_eval.py's file, beside the port's own
    assert {"argv", "model_dir", "checkpoint_step", "no_samples", "test_batches", "seed",
            "correction_mode", "M_correction", "N_correction", "guidance_scale",
            "use_dynamic_threshold", "compute_dtype", "platform", "device_kind",
            "n_devices"} <= set(settings)
    assert settings["argv"][:2] == ["--model-dir", str(tiny_run)]
    assert (settings["platform"], settings["device_kind"]) == ("cpu", "cpu")
    assert not (out / "eval_settings.json.pending").exists()


def test_cli_runs_corrected_thresholded_sampling_and_writes_gifs(tiny_run, tmp_path):
    args = ["--model-dir", str(tiny_run), "--no-samples", "2", "--device", "cpu", "--seed", "3"]
    sample_eval.main([*args, "--out", str(tmp_path / "plain")])
    out = tmp_path / "corrected"
    sample_eval.main([*args, "--out", str(out), "--correction-mode", "x0", "--n-correction",
                      "2", "--m-correction", "1", "--dynamic-threshold", "on", "--create-gif"])
    settings = json.loads((out / "eval_settings.json").read_text())
    assert (settings["correction_mode"], settings["N_correction"], settings["M_correction"],
            settings["use_dynamic_threshold"]) == ("x0", 2, 1, True)

    def sample(run):
        return np.loadtxt(run / "validation" / "sample_0" / "sample_0.csv", delimiter=",")

    # the same seed and draws: the corrections and the threshold changed the samples
    assert np.isfinite(sample(out)).all()
    assert np.abs(sample(out) - sample(tmp_path / "plain")).max() > 0
    for s in range(2):
        for c in range(2):
            assert (out / "validation" / f"sample_{s}_{c}.png").stat().st_size > 0
            assert (out / "validation" / f"sample_{s}" / f"sample_{c}.gif").stat().st_size > 0


def test_profile_helpers_group_kernels_and_merge_busy_intervals():
    from physicsinformeddiffusionmodels_tpu_torch.profile_sampling import _busy_us, _group

    assert _busy_us([(0.0, 10.0), (5.0, 12.0), (20.0, 25.0)]) == 17.0
    assert _busy_us([]) == 0.0
    assert _group("void (anonymous namespace)::lab_fwd_chunk_kernel<float, false>(float const*)") \
        == "K1 linear attention"
    assert _group("void (anonymous namespace)::gn_fwd_kernel<float, 4>(float const*)") \
        == "K2 group norm"
    assert _group("void (anonymous namespace)::lab_bwd_reduce_kernel<true>(float const*)") \
        == "K1 linear attention bwd"
    assert _group("void (anonymous namespace)::gn_bwd_kernel<__nv_bfloat16, 8>(float const*)") \
        == "K2 group norm bwd"
    assert _group("sm80_xmma_fprop_implicit_gemm_f32f32") == "convolutions"
    assert _group("ampere_sgemm_128x64_nn") == "matmuls"
    assert _group("elementwise_kernel") == "other"
