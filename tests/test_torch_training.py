"""The port's trainer, checkpoints, metrics log and training driver against the
JAX package: three optimizer steps from the same weights with the same
batches, t and noise; save/restore/continue; port checkpoints read by Flax
and by both ``sample_eval``s."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import sample_eval as jax_sample_eval
from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator import generate_dataset
from physicsinformeddiffusionmodels_tpu_torch.diffusion import losses as tl
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training import checkpoint as tck
from physicsinformeddiffusionmodels_tpu_torch.training.metrics import MetricsLogger
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    resident_train_step,
    train_step,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# MULTS keeps the JAX compiles short; sample_eval builds the config's (1, 2, 4, 8)
P, DIM, MULTS, CFG_MULTS = 16, 8, (1, 2), (1, 2, 4, 8)
WEIGHTS = dict(c_data=1.0, c_residual=1e-3)


def _flax_params(flax_model, seed):
    """Random parameters of the Flax tree's shapes (biases and norms drawn
    too, so a bias that is dropped or not trained shows)."""
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), np.zeros((1, P, P, 2)),
                            np.zeros((1,), np.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(params, groups: int = 8, mults=MULTS) -> UNet:
    model = UNet(dim=DIM, channels=2, dim_mults=mults, resnet_groups=groups)
    model.load_state_dict(torch_state_dict_from_flax(params))
    return model


def _port_loss_fn():
    sched, physics = ts.create_schedule(100), DarcyResidual(P)

    def loss_fn(model, batch, t, noise):
        return tl.pidm_loss(sched, batch, t, noise, denoise_fn=model, physics_fn=physics,
                            weights=tl.LossWeights(**WEIGHTS))

    return loss_fn


def test_three_train_steps_match_jax():
    # 4 groups of 2 channels at width 8: with one channel per group the conv
    # bias before the GroupNorm has a zero gradient, whose rounding noise
    # Adam would blow up to steps of random sign in either framework.
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=4)
    params = _flax_params(flax_model, seed=11)
    rng = np.random.default_rng(12)
    steps = [(rng.standard_normal((2, P, P, 2)).astype(np.float32), rng.integers(0, 100, 2),
              rng.standard_normal((2, P, P, 2)).astype(np.float32)) for _ in range(3)]
    sched, physics = js.create_schedule(100), JaxDarcy(P)

    def jax_loss(p, batch, key, step):
        x0, t, noise = batch
        return jl.pidm_loss(sched, x0, t, key, denoise_fn=lambda a, b: flax_model.apply(p, a, b),
                            physics_fn=physics, weights=jl.LossWeights(**WEIGHTS), noise=noise)

    tx = jt.make_optimizer(1e-4, 1.0)
    # ema_start=1: steps 0 and 1 copy the weights, step 2 interpolates
    step_fn = jt.make_train_step(jax_loss, tx, ema_mu=0.99, ema_start=1, donate=False)
    jstate = jt.create_train_state(params, tx)
    model = _port_model(params, groups=4)
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0))
    loss_fn = _port_loss_fn()
    for x0, t, noise in steps:
        jstate, jaux = step_fn(jstate, (x0, t, noise), jax.random.key(0))
        aux = train_step(state, loss_fn, torch.from_numpy(x0), torch.from_numpy(t),
                         torch.from_numpy(noise), ema_mu=0.99, ema_start=1)
        np.testing.assert_allclose(aux.loss.item(), float(jaux.loss), rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    # fp32 gradients of two frameworks differ in their last bits; Adam maps
    # each to a step of about lr = 1e-4, so 5e-6 is 5% of one step
    for name, mine, ref in (("params", state.model, jstate.params),
                            ("ema", state.ema, jstate.ema_params)):
        ref_sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        for k, v in mine.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=5e-6, rtol=0,
                                       err_msg=f"{name} {k}")
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, torch_state_dict_from_flax(params)[k])]
    assert len(moved) > 60  # the steps trained the network, kernels' parameters included


def test_cosine_learning_rate_matches_optax():
    import optax

    model = torch.nn.Linear(2, 2)
    opt = make_optimizer(model, 1e-4, 1.0, "cosine", total_steps=100, final_frac=0.1)
    ref = optax.cosine_decay_schedule(1e-4, 100, alpha=0.1)
    for count in (0, 1, 37, 99, 100, 250):
        np.testing.assert_allclose(opt.lr_at(count), float(ref(count)), rtol=1e-6)
    with pytest.raises(ValueError, match="total_steps"):
        make_optimizer(model, schedule="cosine")


def _resident_run(state, data, start, stop, gen):
    loss_fn = _port_loss_fn()
    for _ in range(start, stop):
        resident_train_step(state, loss_fn, data, 2, 100, seed=3, generator=gen, ema_start=1)


def test_resume_continues_bit_for_bit(tmp_path):
    """Save after step 1 (label 1), restore into a fresh state, run to 3:
    the same weights, EMA and Adam moments as an uninterrupted run (EMA
    updates from step 2 on)."""
    params = _flax_params(FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS), seed=13)
    data = torch.from_numpy(np.random.default_rng(14).standard_normal((6, P, P, 2))
                            .astype(np.float32))
    gen = torch.Generator()

    def fresh():
        model = _port_model(params)
        return create_train_state(model, make_optimizer(model, 1e-4, 1.0))

    ref = fresh()
    _resident_run(ref, data, 0, 4, gen)
    part = fresh()
    _resident_run(part, data, 0, 2, gen)
    tck.save_checkpoint(tmp_path, 1, model=part.model, ema=part.ema, optimizer=part.optimizer)
    resumed, start = tck.restore_train_state(tmp_path, fresh())
    assert start == resumed.step == 2
    _resident_run(resumed, data, 2, 4, gen)
    for a, b in ((ref.model, resumed.model), (ref.ema, resumed.ema)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    for sa, sb in zip(ref.optimizer.state_dict()["state"].values(),
                      resumed.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_msgpack_writer_matches_flax_bytes():
    rng = np.random.default_rng(15)
    tree = {"step": 300000, "neg": -70000, "small": 5, "f": 0.5, "s": "x" * 40, "empty": {},
            "none": None, "flag": True,
            "params": {"a": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": np.arange(70000, dtype=np.int32), "h": np.float16(2.5),
                       "nested": {str(i): np.float32(i) * np.ones(i + 1, np.float32)
                                  for i in range(20)}}}
    data = tck.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = tck.msgpack_restore(data)
    np.testing.assert_array_equal(back["params"]["b"], tree["params"]["b"])


def test_port_checkpoint_serves_flax_and_both_sample_evals(tmp_path):
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=CFG_MULTS)
    params = _flax_params(flax_model, seed=16)
    model = _port_model(params, mults=CFG_MULTS)
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0))
    x = np.random.default_rng(17).standard_normal((2, P, P, 2)).astype(np.float32)
    tt = np.array([5, 60])
    train_step(state, _port_loss_fn(), torch.from_numpy(x), torch.from_numpy(tt),
               torch.from_numpy(x[::-1].copy()))
    cfg = RunConfig(unet_dim=DIM, pixels_per_dim=P, compute_dtype="float32")
    run = tmp_path / "run"
    (run / "model").mkdir(parents=True)
    (run / "config.json").write_text(cfg.to_json())
    path = tck.save_checkpoint(run / "model", 0, model=state.model, ema=state.ema,
                               optimizer=state.optimizer)

    raw = serialization.msgpack_restore(path.read_bytes())
    template = jax.eval_shape(flax_model.init, jax.random.key(0), x, tt)
    restored = serialization.from_state_dict(template, raw["ema_params"])  # same tree
    with torch.no_grad():
        mine = state.ema(torch.from_numpy(x), torch.from_numpy(tt)).numpy()
    ref = np.asarray(jax.jit(flax_model.apply)(restored, x, tt))
    # README "Parity": the transplant tolerance of the JAX package's tests
    np.testing.assert_allclose(mine, ref, atol=5e-4, rtol=0)

    jcfg, jraw = jax_sample_eval.load_run(str(run), None)
    assert jcfg.unet_dim == DIM and int(jraw["step"]) == 0
    serialization.from_state_dict(template, jraw["ema_params"] or jraw["params"])
    _, loaded, step = sample_eval.load_run(run, device="cpu")
    assert step == 0
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(torch.from_numpy(x), torch.from_numpy(tt)).numpy(),
                                      mine)


def test_metrics_log_keeps_earlier_rows_across_a_resume(tmp_path):
    log = MetricsLogger(tmp_path)
    log.log({"loss": torch.tensor(1.5)}, step=0)
    log.log({"loss_test": 2.0}, step=0)
    log.flush(["step", "time", "loss", "loss_test"])
    log = MetricsLogger(tmp_path)  # a resumed run opens the same file
    log.log({"loss": 0.5}, step=1)
    log.close()
    with open(tmp_path / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["0", "0", "1"]
    assert [r["loss"] for r in rows] == ["1.5", "", "0.5"]
    with pytest.raises(ValueError, match="columns"):
        log.log({"other": 1.0}, step=2)
        log.flush()


@pytest.mark.parametrize("kw,item", [
    (dict(mesh_tp=2), "torchrun"),
])
def test_driver_refuses_unported_options(kw, item):
    """A mesh of more than one rank with no process group raises, naming
    the launcher, before anything is built or run."""
    cfg = RunConfig(**{"compute_dtype": "float32", **kw})
    with pytest.raises(RuntimeError, match=item):
        train.join_run(cfg, "cpu")


def test_cli_compute_dtype_defaults_to_the_config():
    """As in the JAX driver: no --compute-dtype means the config's (bf16)."""
    cfg = train.config_from_args(train.parse_args([]))
    assert cfg.compute_dtype == RunConfig().compute_dtype == "bfloat16"
    assert not cfg.fp32_head
    cfg = train.config_from_args(train.parse_args(["--compute-dtype", "float32"]))
    assert cfg.compute_dtype == "float32"
    assert train.config_from_args(train.parse_args(["--fp32-head"])).fp32_head


@pytest.mark.parametrize("dtype_args", [["--compute-dtype", "float32"],
                                        ["--compute-dtype", "bfloat16", "--fp32-head"]],
                         ids=["float32", "bfloat16_fp32_head"])
def test_driver_trains_samples_saves_and_resumes_on_the_cpu(tmp_path, dtype_args):
    for split, n, seed in (("train", 4, 1), ("valid", 2, 100)):
        generate_dataset(n, pixels_per_dim=P, q=16, base_seed=seed, out_dir=tmp_path / split)
    args = ["--pixels-per-dim", str(P), "--data-dir", str(tmp_path / "train"),
            "--valid-data-dir", str(tmp_path / "valid"), "--output-dir", str(tmp_path / "out"),
            "--batch-size", "2", "--sample-freq", "2", "--test-eval-freq", "1",
            "--log-freq", "1", "--no-samples", "2", "--device", "cpu", "--name", "tiny",
            *dtype_args]
    cfg = train.config_from_args(train.parse_args(["--iterations", "2", *args]))
    cfg.unet_dim = DIM
    state = train.run_darcy(cfg, "cpu")
    assert state.step == 3
    run = tmp_path / "out" / "tiny"
    assert sorted(p.name for p in (run / "model").glob("*.msgpack")) == ["checkpoint_2.msgpack"]
    assert (run / "training" / "step_2" / "sample_statistics.csv").exists()
    saved = json.loads((run / "config.json").read_text())
    assert (saved["compute_dtype"], saved["fp32_head"]) == (
        (dtype_args[1], "--fp32-head" in dtype_args))
    # JAX's sample_eval reads the run: its config, and the EMA weights into
    # the Flax tree of the config's UNet
    jcfg, jraw = jax_sample_eval.load_run(str(run), None)
    assert (jcfg.compute_dtype, jcfg.fp32_head) == (saved["compute_dtype"], saved["fp32_head"])
    template = jax.eval_shape(FlaxUNet(dim=DIM, channels=2).init, jax.random.key(0),
                              np.zeros((1, P, P, 2)), np.zeros((1,), np.int32))
    serialization.from_state_dict(template, jraw["ema_params"])
    cfg.train_iterations, cfg.resume = 3, True
    state = train.run_darcy(cfg, "cpu")
    assert state.step == 4
    with open(run / "metrics.csv", newline="") as f:
        steps = [int(r["step"]) for r in csv.DictReader(f) if r["loss"]]
    assert steps == [0, 1, 2, 3]
