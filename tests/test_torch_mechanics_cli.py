"""The port's mechanics entry points on the CPU at a small width: the
training driver (``train_mechanics``, and ``train --gov-eqs mechanics``) on
sets from the port's generator, with its sample pass, checkpoints in Flax's
bytes and a resume; ``sample_eval``'s mechanics sweep with the JAX driver's
CSVs; and (``slow``) the committed 131.7M-parameter checkpoint's forward
against Flax's, and its 100-step sampling and topopt scoring against JAX's."""

import csv
import json
import os
import resource
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import sample_eval as jax_sample_eval
import train_mechanics as jax_tm
from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu.diffusion import create_schedule as jax_schedule
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.ops.connected_components import (
    floating_material as jax_floating_material)
from physicsinformeddiffusionmodels_tpu.physics.mechanics import MechanicsResidual as JaxMech
from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train, train_mechanics
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.datasets import NpyFieldDataset
from physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets import generate_sets
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from test_torch_sampling import _jax_draws
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


# the trained model's sweep, port against JAX (both fp32 on the CPU): the
# largest |difference| of the final 65x65 states and of each sample's
# rel_CE and vf error, about twice what the test's first run measured
# (PERF.md section 7): the states drift from 4.8e-7 at the first step to
# 1.4e-6 / 2.4e-6 (levels 1 / 2) at the last; the binarised designs were
# equal, so rel_CE differed only by the fp32 data compliance (9.7e-8 at
# most) and the vf error by the fp32 mean of the design (1.08e-5 at most)
FINAL_ATOL, REL_CE_ATOL, VF_ATOL = 5e-6, 2e-7, 2e-5


@pytest.mark.slow
def test_trained_mechanics_sweep_rel_ce_matches_jax(tmp_path):
    """The committed 600k mechanics checkpoint (131.7M parameters, fp32 on
    both sides) samples 4 test_level_1 and 4 test_level_2 fields (the
    port's host SIMP at P=64, the sets' 50 iterations; a batch of 4 a
    level) in JAX's ``make_mech_sample_fn`` (100 ancestral steps from a
    key) and in the port's ``sample_mechanics`` (the same x_init and
    per-step noise, JAX's draws from that key, passed in as numpy arrays).
    Each side scores its own final states as its ``sample_eval`` does:
    ``topopt_eval`` (rel_CE from the PCG, checked on the host in float64),
    the vf error and the floating-material flag. The final states agree
    within FINAL_ATOL, each sample's rel_CE within REL_CE_ATOL and its vf
    error within VF_ATOL (absolute; about twice the differences of the
    first run, whose states drifted step by step to 2.4e-6 over the 100
    steps); the fm flags are equal. About 6 min and 3 GiB on 8 CPU
    threads.
    Prints the per-sample numbers, the drift, the wall time and the peak
    memory."""
    t_start = time.perf_counter()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    root = tmp_path / "sets"
    for level in ("test_level_1", "test_level_2"):
        generate_sets(root, n_test=4, seed=0, device="host", workers=4, only=level)
    run_dir = ROOT / "results" / "mech_600k_full" / "portable"
    params = load_checkpoint(run_dir / "model" / "checkpoint_600000.msgpack")["ema_params"]
    cfg = RunConfig.load(run_dir / "config.json")
    model = build_model(cfg, "float32")
    model.load_state_dict(torch_state_dict_from_flax(params))
    model.eval()
    jcfg = JaxRunConfig.load(run_dir / "config.json")
    flax_model = FlaxUNet(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True)
    jmech, mech = JaxMech(64), MechanicsResidual(64)
    sample_fn = jax_tm.make_mech_sample_fn(flax_model, jax_schedule(cfg.diff_steps), jmech,
                                           jcfg, save_history=True)
    report = {}
    for k, level in enumerate(("test_level_1", "test_level_2")):
        batch = NpyFieldDataset(root / "test" / level / "fields").stacked()
        key = jax.random.key(100 + k)
        final_j, _, _, _, topopt_j, hist_j = sample_fn(params, batch, key)
        checked_j = jmech.topopt_eval_checked(topopt_j, batch[..., 6:10])
        fm_j = jax_floating_material(np.asarray(checked_j["rho_binarized"]))
        x_init, noise = _jax_draws(key, (len(batch), 65, 65, 3), cfg.diff_steps)
        b = torch.from_numpy(batch)
        with torch.no_grad():
            sample = train_mechanics.sample_mechanics(cfg, model, b, torch.from_numpy(x_init),
                                         torch.from_numpy(noise), mech, save_history=True)
        checked, fm = train_mechanics.topopt_metrics(mech, sample, b)
        drift = np.abs(sample.history.numpy() - np.asarray(hist_j)).reshape(
            cfg.diff_steps, -1).max(axis=1)
        rep = {
            "final_max_abs_diff": float(np.abs(sample.final.numpy()
                                               - np.asarray(final_j)).max()),
            "drift_at_steps_0_24_49_74_99": [float(drift[i]) for i in (0, 24, 49, 74, 99)],
            "rel_CE_port": [float(v) for v in checked["rel_CE_error_full_batch"]],
            "rel_CE_jax": [float(v) for v in checked_j["rel_CE_error_full_batch"]],
            "vf_err_port": [float(v) for v in np.asarray(checked["vf_error_full_batch"])],
            "vf_err_jax": [float(v) for v in np.asarray(checked_j["vf_error_full_batch"])],
            "fm_port": [int(v) for v in fm], "fm_jax": [int(v) for v in fm_j],
            "rho_binarized_pixels_differing": int(
                (np.asarray(checked["rho_binarized"]) != np.asarray(checked_j["rho_binarized"]))
                .sum()),
            "fallbacks_port_jax": [checked["n_solve_fallback"], checked_j["n_solve_fallback"]],
        }
        report[level] = rep
    report["seconds"] = time.perf_counter() - t_start
    report["peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(report, indent=1))
    for level in ("test_level_1", "test_level_2"):
        rep = report[level]
        assert rep["final_max_abs_diff"] <= FINAL_ATOL, (level, rep)
        np.testing.assert_allclose(rep["rel_CE_port"], rep["rel_CE_jax"], rtol=0,
                                   atol=REL_CE_ATOL, err_msg=level)
        np.testing.assert_allclose(rep["vf_err_port"], rep["vf_err_jax"], rtol=0,
                                   atol=VF_ATOL, err_msg=level)
        assert rep["fm_port"] == rep["fm_jax"], level
