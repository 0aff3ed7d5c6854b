"""The port's mechanics entry points on the CPU at a small width: the
training driver (``train_mechanics``, and ``train --gov-eqs mechanics``) on
sets from the port's generator, with its sample pass, checkpoints in Flax's
bytes and a resume; ``sample_eval``'s mechanics sweep with the JAX driver's
CSVs; and (``slow``) the committed 131.7M-parameter checkpoint's forward
against Flax's."""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import sample_eval as jax_sample_eval
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.physics.mechanics import MechanicsResidual as JaxMech
from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train, train_mechanics
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.datasets import NpyFieldDataset
from physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets import generate_sets
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
P, DIM = 16, 8
# the JAX sample_eval.py's per-level files and its statistics header
LEVEL_CSVS = ("residuals", "rel_CE_error", "rel_vf_error", "fm_error", "sample_statistics")
STATS_HEADER = ["Sample Index", "Residuals (abs)", "rel_CE_error", "rel_vf_error", "fm"]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("mech_sets")
    generate_sets(root, n_train=4, n_valid=2, n_test=3, n_iter=1, seed=2, pixels_per_dim=P,
                  device="host")
    return root


def _args(sets, out, iterations, *extra):
    return ["--iterations", str(iterations), "--batch-size", "2", "--unet-dim", str(DIM),
            "--pixels-per-dim", str(P), "--data-dir", str(sets / "train" / "fields"),
            "--valid-data-dir", str(sets / "test" / "valid" / "fields"),
            "--output-dir", str(out), "--name", "tiny", "--sample-freq", "2",
            "--test-eval-freq", "1", "--log-freq", "1", "--no-samples", "2",
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def run(sets, tmp_path_factory):
    """Two steps and a sample pass of the bf16 + fp32-head recipe, then a
    resume to step 3 (the last step samples again and saves)."""
    out = tmp_path_factory.mktemp("mech_out")
    state = train_mechanics.main(_args(sets, out, 2, "--fp32-head"))
    assert state.step == 3
    saved = sorted(p.name for p in (out / "tiny" / "model").glob("*.msgpack"))
    state = train_mechanics.main(_args(sets, out, 3, "--fp32-head", "--resume"))
    assert state.step == 4
    return out / "tiny", saved


def test_driver_trains_samples_saves_and_resumes(run):
    run_dir, saved_first = run
    assert saved_first == ["checkpoint_2.msgpack"]
    saved = json.loads((run_dir / "config.json").read_text())
    assert (saved["gov_eqs"], saved["unet_dim"], saved["compute_dtype"], saved["fp32_head"],
            saved["c_ineq"], saved["lambda_opt"]) == ("mechanics", DIM, "bfloat16", True,
                                                      1e-3, 1e-6)
    with open(run_dir / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == train_mechanics.COLUMNS
    assert [int(r["step"]) for r in rows if r["loss"]] == [0, 1, 2, 3]
    sampled = [r for r in rows if r["rel_CE_error"]]
    assert [int(r["step"]) for r in sampled] == [2, 3]
    for r in sampled:
        vals = [float(r[k]) for k in ("residual_mean_abs_samples", "rel_CE_error",
                                      "rel_vf_error", "fm_error", "n_solve_fallback")]
        assert np.isfinite(vals).all()
    fields = np.loadtxt(run_dir / "training" / "step_3" / "sample_1" / "sample_2.csv",
                        delimiter=",")
    assert fields.shape == (P + 1, P + 1) and np.isfinite(fields).all()

    # the final checkpoint holds Adam's state; JAX's sample_eval reads the run
    # and the EMA weights fit the Flax mechanics UNet's tree
    raw = load_checkpoint(run_dir / "model" / "checkpoint_3.msgpack")
    assert raw["opt_state"] and int(raw["step"]) == 3
    jcfg, jraw = jax_sample_eval.load_run(str(run_dir), None)
    assert (jcfg.gov_eqs, jcfg.unet_dim) == ("mechanics", DIM)
    template = jax.eval_shape(
        FlaxUNet(dim=DIM, channels=10, out_dim=3, sigmoid_last_channel=True).init,
        jax.random.key(0), np.zeros((1, P, P, 10)), np.zeros((1,), np.int32))
    serialization.from_state_dict(template, jraw["ema_params"])


def test_train_cli_dispatches_mechanics(monkeypatch):
    cfg = train.config_from_args(train.parse_args(["--gov-eqs", "mechanics"]))
    assert (cfg.c_ineq, cfg.lambda_opt, cfg.data_dir, cfg.train_batch_size, cfg.unet_dim) == (
        1e-3, 1e-6, "./data/mechanics/train/fields", 6, 128)
    cfg = train.config_from_args(train.parse_args(["--gov-eqs", "mechanics", "--data-dir", "d"]))
    assert cfg.data_dir == "d"
    seen = []
    monkeypatch.setattr(train_mechanics, "run_mechanics", lambda c, d: seen.append((c, d)))
    train.main(["--gov-eqs", "mechanics", "--iterations", "5", "--device", "cpu"])
    assert seen[0][0].gov_eqs == "mechanics" and seen[0][0].train_iterations == 5
    assert seen[0][1] == "cpu"


def test_sample_eval_sweeps_both_levels_with_jax_csvs(run, sets, tmp_path):
    run_dir, _ = run
    out = tmp_path / "eval"
    sample_eval.main(["--model-dir", str(run_dir), "--no-samples", "2", "--device", "cpu",
                      "--seed", "1", "--out", str(out), "--test-batches", "1",
                      "--test-data-root", str(sets)])
    settings = json.loads((out / "eval_settings.json").read_text())
    assert settings["test_batches"] == 1 and settings["checkpoint_step"] == 3
    assert not (out / "eval_settings.json.pending").exists()
    jmech = JaxMech(P)
    for level in ("test_level_1", "test_level_2"):
        ldir = out / level
        assert all((ldir / f"{name}.csv").exists() for name in LEVEL_CSVS)
        with open(ldir / "sample_statistics.csv", newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == STATS_HEADER and [r[0] for r in rows[1:]] == ["0", "1", "Mean"]
        res = np.loadtxt(ldir / "residuals.csv", delimiter=",")
        assert res.shape == (2,) and float(rows[3][1]) == pytest.approx(res.mean(), rel=1e-6)
        for name in LEVEL_CSVS[1:4]:
            assert np.isfinite(np.loadtxt(ldir / f"{name}.csv", delimiter=",")).all()
        # the residuals were computed on the written fields, as JAX computes them
        finals = np.stack([np.stack([np.loadtxt(ldir / f"sample_{s}" / f"sample_{c}.csv",
                                                delimiter=",") for c in range(3)], axis=-1)
                           for s in range(2)]).astype(np.float32)
        bcs = NpyFieldDataset(sets / "test" / level / "fields").stacked()[:2, ..., 6:10]
        ref, _, _, _ = jmech.residual_from_fields(finals[..., :2],
                                                  finals[:, :-1, :-1, 2].reshape(2, -1), bcs)
        np.testing.assert_allclose(res, np.abs(np.asarray(ref)).mean(axis=1), rtol=1e-4)
    with pytest.raises(FileNotFoundError, match="test_level"):
        sample_eval.main(["--model-dir", str(run_dir), "--device", "cpu", "--out",
                          str(tmp_path / "none"), "--test-data-root", str(tmp_path)])


@pytest.mark.slow
def test_committed_checkpoint_forward_matches_flax():
    run_dir = ROOT / "results" / "mech_600k_full" / "portable"
    cfg = RunConfig.load(run_dir / "config.json")
    params = load_checkpoint(run_dir / "model" / "checkpoint_600000.msgpack")["ema_params"]
    model = build_model(cfg, "float32")
    model.load_state_dict(torch_state_dict_from_flax(params))
    assert sum(p.numel() for p in model.parameters()) == 131_706_499
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 64, 10)).astype(np.float32)
    t = np.array([37], np.int32)
    flax_model = FlaxUNet(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True)
    ref = np.asarray(jax.jit(flax_model.apply)(params, x, t))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    # README "Parity": the transplant tolerance of the JAX package's own tests
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=0)
