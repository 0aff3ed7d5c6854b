"""The port's entry points on a mesh of CPU ranks: the training CLI under
``torchrun`` (two gloo ranks, ``--mesh-dp 2``) against the same run on one
rank, and ``sample_eval``'s mechanics sweep split over two data ranks
against the one-rank sweep; files written once, by rank 0. And the errors:
mesh flags without a process group, torchrun's environment missing."""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator import generate_dataset
from physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets import generate_sets
from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import init_distributed
from torch_ranks import mech_sweep, spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
P = 16
LEVEL_CSVS = ("residuals", "rel_CE_error", "rel_vf_error", "fm_error", "sample_statistics")


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_torchrun_cli_on_two_cpu_ranks_gives_the_one_rank_run(tmp_path):
    for split, n, seed in (("train", 4, 1), ("valid", 2, 100)):
        generate_dataset(n, pixels_per_dim=P, q=16, base_seed=seed, out_dir=tmp_path / split)
    args = ["--iterations", "1", "--batch-size", "2", "--pixels-per-dim", str(P),
            "--data-dir", str(tmp_path / "train"), "--valid-data-dir", str(tmp_path / "valid"),
            "--sample-freq", "2", "--test-eval-freq", "1", "--log-freq", "1",
            "--no-samples", "2", "--device", "cpu", "--compute-dtype", "float32",
            "--name", "tiny"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env = {k: v for k, v in env.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "physicsinformeddiffusionmodels_tpu_torch.train", *args, "--mesh-dp", "2",
         "--output-dir", str(tmp_path / "ranks")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("Number of trainable parameters") == 1  # rank 0 alone prints
    train.main([*args, "--output-dir", str(tmp_path / "one")])
    ranks, one = (tmp_path / d / "tiny" for d in ("ranks", "one"))
    got, want = _rows(ranks / "metrics.csv"), _rows(one / "metrics.csv")
    assert [r["step"] for r in got] == [r["step"] for r in want]  # each row once
    for g, w in zip(got, want):
        for k, v in w.items():
            if k != "time" and v:
                np.testing.assert_allclose(float(g[k]), float(v), rtol=1e-5, err_msg=k)
    a, b = (load_checkpoint(latest_checkpoint(d / "model")) for d in (ranks, one))
    assert a["step"] == b["step"] == 1
    # Adam moves every entry by about lr = 1e-4 a step whatever the size of
    # its gradient, so an entry whose gradient sits at the rounding of a sum
    # taken in another order may move another way: all but a thousandth of
    # the entries within 5e-6 (5% of a step, the three-step parity test's
    # tolerance), every entry within the two steps taken
    diffs = np.concatenate([np.abs(_flat(a[part])[k] - v).ravel()
                            for part in ("params", "ema_params")
                            for k, v in _flat(b[part]).items()])
    assert np.mean(diffs > 5e-6) < 1e-3 and diffs.max() <= 2e-4, (
        np.mean(diffs > 5e-6), diffs.max())
    assert sorted(p.name for p in (ranks / "training" / "step_1").iterdir()) == sorted(
        p.name for p in (one / "training" / "step_1").iterdir())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_mechanics_sweep_split_over_two_ranks_gives_the_one_rank_sweep(tmp_path):
    generate_sets(tmp_path / "sets", n_train=2, n_valid=2, n_test=3, n_iter=1, seed=2,
                  pixels_per_dim=P, device="host")
    cfg = RunConfig(gov_eqs="mechanics", unet_dim=8, pixels_per_dim=P, train_batch_size=2,
                    compute_dtype="float32", name="tiny", diff_steps=20)
    torch.manual_seed(0)
    model = build_model(cfg)
    save_checkpoint(tmp_path / "run" / "model", 0, model=model, ema=model, config=cfg)
    (tmp_path / "run" / "config.json").write_text(cfg.to_json())
    one = sample_eval.evaluate(tmp_path / "run", 2, "float32", "cpu", seed=0,
                               out=tmp_path / "sweep_one", test_data_root=tmp_path / "sets")
    # three conditions a level in batches of 2: the first splits over the
    # ranks, the second (one condition) runs alike on both
    spawn(mech_sweep, 2, tmp_path)
    settings = json.loads((tmp_path / "sweep_ranks" / "eval_settings.json").read_text())
    assert settings["n_devices"] == 2
    for level, summary in one["levels"].items():
        assert summary["n"] == 3
        for name in LEVEL_CSVS:
            got, want = (np.genfromtxt(tmp_path / d / level / f"{name}.csv", delimiter=",",
                                       skip_header=name == "sample_statistics")
                         for d in ("sweep_ranks", "sweep_one"))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{level} {name}")
        assert (settings["levels"][level]["n_solve_fallback"]
                == summary["n_solve_fallback"])
        # the fields, O(1), after 20 fp32 steps of a UNet whose CPU kernels
        # sum in an order that depends on the batch size
        for s in range(2):
            for c in range(3):
                got, want = (np.loadtxt(tmp_path / d / level / f"sample_{s}" / f"sample_{c}.csv",
                                        delimiter=",") for d in ("sweep_ranks", "sweep_one"))
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_a_rank_needs_torchruns_environment_and_a_mesh_needs_a_process_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed("cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        sample_eval.evaluate(ROOT / "results" / "darcy_300k_fp32head" / "portable", 2,
                             device="cpu", mesh_flags={"mesh_dp": 2})
