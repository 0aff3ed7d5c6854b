"""The toy study's port against the JAX package on the CPU: the constraint
terms, the samplers and the registry; the conditional MLP on carried Flax
weights; ``pidm_loss`` in the three prediction modes with the model's own
x0 estimate and with the DDIM chain; the sampler's step and loop in the
three modes; three training steps; checkpoints written by either package
and read by the other; and the driver's files.

Randomness is injected: the timesteps, the noise and the sampling draws are
made here (or replayed from JAX's keys) and given to both sides.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_toy as jax_train_toy
from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import sampling as jsamp
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.toy import ConditionalModel as FlaxToy
from physicsinformeddiffusionmodels_tpu.physics import toy as jtoy
from physicsinformeddiffusionmodels_tpu.training import checkpoint as jck
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch import train_toy
from physicsinformeddiffusionmodels_tpu_torch.diffusion import losses as tl
from physicsinformeddiffusionmodels_tpu_torch.diffusion import sampling as tsamp
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.toy import ConditionalModel
from physicsinformeddiffusionmodels_tpu_torch.physics import toy as ttoy
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    flax_params_from_torch,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.utils import viz
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, T, SHORT_T = 16, 100, 10
# every term of the loss on, so that each is compared
WEIGHTS = dict(c_data=1.0, c_residual=0.005, c_ineq=0.1, lambda_opt=0.01)
MODES = ("x0", "eps", "mu")


def _flax_params(seed=0, n_steps=T):
    model = FlaxToy(dim=2, n_steps=n_steps)
    return model, model.init(jax.random.key(seed), jnp.zeros((1, 2)), jnp.zeros((1,), jnp.int32))


def _port_model(params, n_steps=T) -> ConditionalModel:
    model = ConditionalModel(dim=2, n_steps=n_steps)
    sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert sd.keys() == model.state_dict().keys()  # nothing missing, nothing unexpected
    model.load_state_dict(sd)
    return model


def _points(seed, n=B):
    return np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32)


def test_toy_terms_samplers_and_registry_match_jax():
    x = _points(0, 64) * 1.3
    xt = torch.from_numpy(x)
    for mode in ("leq", "geq"):
        np.testing.assert_allclose(ttoy.density_inequality(xt, 1.2, mode).numpy(),
                                   np.asarray(jtoy.density_inequality(x, 1.2, mode)), rtol=1e-6)
    for got, ref in zip(ttoy.toy_physics(xt, 0.8), jtoy.toy_physics(x, 0.8)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ttoy.hypersphere_residual(xt).numpy(),
                               np.asarray(jtoy.hypersphere_residual(x)), rtol=1e-6, atol=1e-7)
    # the NumPy samplers give JAX's arrays for a seed
    assert ttoy.TOY_DISTRIBUTIONS.keys() == jtoy.TOY_DISTRIBUTIONS.keys()
    for name, sampler in ttoy.TOY_DISTRIBUTIONS.items():
        np.testing.assert_array_equal(sampler(np.random.default_rng(5), 50),
                                      jtoy.TOY_DISTRIBUTIONS[name](np.random.default_rng(5), 50))
    np.testing.assert_array_equal(ttoy.sample_hypersphere(np.random.default_rng(42), 100, 3),
                                  jtoy.sample_hypersphere(np.random.default_rng(42), 100, 3))
    # the registry: the default spec, a spec with kwargs, an unknown name,
    # and a constraint a user registers
    for spec in (None, {"name": "hypersphere", "kwargs": {"threshold": 0.5}}):
        got, ref = ttoy.build_toy_constraint(spec)(xt), jtoy.build_toy_constraint(spec)(x)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError, match="unknown toy constraint"):
        ttoy.build_toy_constraint({"name": "nope", "kwargs": {}})

    @ttoy.register_toy_constraint("test_ring")
    def _ring(radius: float = 1.0):
        return lambda x0: tl.PhysicsTerms(residual=(x0**2).sum(dim=1) - radius**2)

    terms = ttoy.build_toy_constraint({"name": "test_ring", "kwargs": {"radius": 2.0}})(xt)
    np.testing.assert_allclose(terms.residual.numpy(), (x**2).sum(1) - 4.0, rtol=1e-6)
    assert terms.inequality is None


def test_conditional_model_forward_matches_flax():
    flax_model, params = _flax_params(1)
    model = _port_model(params)
    x = _points(2)
    t = np.random.default_rng(3).integers(0, T, B).astype(np.int32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
        got_scalar = model(torch.from_numpy(x), 7).numpy()
    np.testing.assert_allclose(got, np.asarray(flax_model.apply(params, x, t)), atol=1e-6)
    np.testing.assert_allclose(got_scalar, np.asarray(flax_model.apply(params, x, 7)), atol=1e-6)
    # the port's own initial weights: Flax's initialisers (zero biases, gates
    # in [0, 1), kernels truncated at two standard deviations), from a seed
    fresh = ConditionalModel(seed=4).state_dict()
    assert fresh.keys() == model.state_dict().keys()
    gate = fresh["ConditionalDense_0.Embed_0.embedding"]
    assert gate.min() >= 0 and gate.max() < 1 and gate.shape == (T, 128)
    assert not fresh["Dense_0.bias"].any()
    w = fresh["ConditionalDense_1.Dense_0.weight"]
    std = (1 / 128) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std and 0.8 < w.std().item() / (0.87962566 * std) < 1.2
    assert torch.equal(ConditionalModel(seed=4).state_dict()["Dense_0.weight"],
                       fresh["Dense_0.weight"])


def _losses(pred_mode, estimation, params, flax_model, x0, t, noise):
    """(JAX loss, JAX gradients in the port's layout), (port loss, port
    gradients) of one minibatch."""
    jsched = js.create_schedule(T)
    physics = jtoy.build_toy_constraint(None)

    def jax_loss(p):
        def denoise(x, tt):
            return flax_model.apply(p, x, tt)

        sampler = None
        if estimation == "sample":
            def sampler(x_t, tt, k):
                return jsamp.ddim_sample_x0(jsched, denoise, x_t, tt, k, ddim_steps=0,
                                            pred_mode=pred_mode)
        return jl.pidm_loss(jsched, x0, t, jax.random.key(0), denoise_fn=denoise,
                            physics_fn=physics, weights=jl.LossWeights(**WEIGHTS),
                            pred_mode=pred_mode, x0_sampler=sampler, ll_clamp=jl.TOY_LL_CLAMP,
                            noise=noise)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    jgrads = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    config = {**train_toy.default_config(), **WEIGHTS, "model_pred_mode": pred_mode,
              "x0_estimation": estimation}
    model = _port_model(params)
    loss, _ = train_toy.build_loss_fn(create_schedule(T), config)(
        model, torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise))
    loss.backward()
    return (float(jloss), jgrads), (loss.item(), {n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("estimation", ["mean", "sample"])
@pytest.mark.parametrize("pred_mode", MODES)
def test_pidm_loss_matches_jax(pred_mode, estimation):
    """The toy loss (TOY_LL_CLAMP, all four terms) with the model's own x0
    estimate or the DDIM chain advancing its own state: the loss to 1e-5
    relative, each parameter's gradient to 1e-4 of its max. The timesteps
    are antithetic and include t = 0 (the mu mode's NLL branch and the
    clamp)."""
    flax_model, params = _flax_params(5)
    rng = np.random.default_rng(6)
    x0 = jtoy.sample_hypersphere(rng, B).astype(np.float32)
    half = rng.integers(0, T, B // 2 + 1)
    half[0] = 0
    t = np.concatenate([half, T - half - 1])[:B].astype(np.int32)
    noise = rng.standard_normal((B, 2)).astype(np.float32)
    (jloss, jgrads), (loss, grads) = _losses(pred_mode, estimation, params, flax_model, x0, t,
                                             noise)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name, g in grads.items():
        ref = jgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0,
                                   err_msg=name)


def test_antithetic_timesteps_pair_up():
    t = tl.antithetic_timesteps(torch.Generator().manual_seed(0), 9, T)
    assert t.shape == (9,) and torch.equal(t[5:], T - 1 - t[:4])


@pytest.mark.parametrize("suppress_noise", [True, False], ids=["suppress", "noise"])
@pytest.mark.parametrize("threshold", [False, True], ids=["plain", "threshold"])
@pytest.mark.parametrize("pred_mode", MODES)
def test_p_sample_step_matches_jax(pred_mode, threshold, suppress_noise):
    """One ancestral step at t = 37 and at t = 0 with JAX's own draw z; the
    x0 correction (a rescale onto the circle) recomputes the mean."""
    flax_model, params = _flax_params(7)
    model = _port_model(params)
    jsched, sched = js.create_schedule(T), create_schedule(T)
    x = _points(8) * 2.5  # some samples beyond the threshold's quantile
    key = jax.random.key(9)
    z = np.array(jax.random.normal(key, x.shape, jnp.float32))

    def jax_fix(a):
        return a / jnp.linalg.norm(a, axis=1, keepdims=True)

    def fix(a):
        return a / torch.linalg.vector_norm(a, dim=1, keepdim=True)

    for t in (37, 0):
        for corr in (False, True):
            ref = jsamp.p_sample_step(
                jsched, lambda a, b: flax_model.apply(params, a, b), x, t, key,
                pred_mode=pred_mode, suppress_noise=suppress_noise,
                use_dynamic_threshold=threshold, x0_correction_fn=jax_fix if corr else None)
            with torch.no_grad():
                got = tsamp.p_sample_step(
                    sched, model, torch.from_numpy(x), t, torch.from_numpy(z),
                    pred_mode=pred_mode, suppress_noise=suppress_noise,
                    use_dynamic_threshold=threshold, x0_correction_fn=fix if corr else None)
            for g, r in zip(got, ref[:2]):
                r = np.asarray(r)
                np.testing.assert_allclose(g.numpy(), r, atol=1e-6 * np.abs(r).max(), rtol=0,
                                           err_msg=f"t={t} correction={corr}")


@pytest.mark.parametrize("suppress_noise", [True, False], ids=["suppress", "noise"])
@pytest.mark.parametrize("pred_mode", MODES)
def test_p_sample_loop_matches_jax(pred_mode, suppress_noise):
    """A 10-step schedule with JAX's draws replayed (one split for x_init,
    one a step, the t = 0 draw used only when the noise is not suppressed);
    the history too."""
    flax_model, params = _flax_params(10, SHORT_T)
    model = _port_model(params, SHORT_T)
    key = jax.random.key(11)
    ref = jax.jit(lambda k: jsamp.p_sample_loop(
        js.create_schedule(SHORT_T), lambda a, b: flax_model.apply(params, a, b), (B, 2), k,
        pred_mode=pred_mode, suppress_noise=suppress_noise, save_history=True))(key)
    key, init_key = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_key, (B, 2)))
    noise = []
    for _ in range(SHORT_T):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.normal(sub, (B, 2))))
    with torch.no_grad():
        got = tsamp.p_sample_loop(create_schedule(SHORT_T), model, torch.from_numpy(x_init),
                                  torch.from_numpy(np.stack(noise)), pred_mode=pred_mode,
                                  suppress_noise=suppress_noise, save_history=True)
    # random weights in the eps and mu modes drive the states to O(100):
    # each array is held to 1e-5 of its largest entry
    for name in ("x", "history", "x0_history"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, atol=1e-5 * np.abs(r).max(),
                                   rtol=0, err_msg=name)
    # a generator draws no noise for t = 0 while it is suppressed
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    with torch.no_grad():
        tsamp.p_sample_loop(create_schedule(SHORT_T), model, torch.from_numpy(x_init), g1,
                            pred_mode=pred_mode, suppress_noise=suppress_noise)
    torch.randn((SHORT_T - int(suppress_noise), B, 2), generator=g2)
    assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))


@pytest.mark.parametrize("pred_mode,estimation", [("x0", "sample"), ("eps", "mean"),
                                                  ("mu", "sample")])
def test_three_train_steps_match_jax(pred_mode, estimation):
    """Three steps of the toy driver's optimizer (Adam at 5e-4, clip 1.0, no
    EMA: ema_start 10^9) from the same weights on the same batches, t and
    noise as JAX's ``make_train_step``."""
    flax_model, params = _flax_params(12)
    jsched = js.create_schedule(T)
    physics = jtoy.build_toy_constraint(None)
    rng = np.random.default_rng(13)
    steps = [(jtoy.sample_hypersphere(rng, B).astype(np.float32),
              rng.integers(0, T, B).astype(np.int32),
              rng.standard_normal((B, 2)).astype(np.float32)) for _ in range(3)]

    def jax_loss(p, batch, key, step):
        x0, t, noise = batch

        def denoise(x, tt):
            return flax_model.apply(p, x, tt)

        sampler = None
        if estimation == "sample":
            def sampler(x_t, tt, k):
                return jsamp.ddim_sample_x0(jsched, denoise, x_t, tt, k, pred_mode=pred_mode)
        return jl.pidm_loss(jsched, x0, t, key, denoise_fn=denoise, physics_fn=physics,
                            weights=jl.LossWeights(**WEIGHTS), pred_mode=pred_mode,
                            x0_sampler=sampler, ll_clamp=jl.TOY_LL_CLAMP, noise=noise)

    tx = jt.make_optimizer(5e-4, grad_clip=1.0)
    step_fn = jt.make_train_step(jax_loss, tx, ema_start=10**9, donate=False)
    jstate = jt.create_train_state(params, tx)
    model = _port_model(params)
    state = create_train_state(model, make_optimizer(model, 5e-4, 1.0))
    config = {**train_toy.default_config(), **WEIGHTS, "model_pred_mode": pred_mode,
              "x0_estimation": estimation}
    loss_fn = train_toy.build_loss_fn(create_schedule(T), config)
    for x0, t, noise in steps:
        jstate, jaux = step_fn(jstate, (x0, t, noise), jax.random.key(0))
        aux = train_step(state, loss_fn, torch.from_numpy(x0), torch.from_numpy(t).long(),
                         torch.from_numpy(noise), ema_start=train_toy.EMA_START)
        np.testing.assert_allclose(aux.loss.item(), float(jaux.loss), rtol=1e-5)
    # Adam maps each gradient to a step of about lr = 5e-4: 2.5e-5 is 5% of one
    for name, mine, ref in (("params", state.model, jstate.params),
                            ("ema", state.ema, jstate.ema_params)):
        ref_sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        for k, v in mine.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=2.5e-5, rtol=0,
                                       err_msg=f"{name} {k}")
    assert not torch.equal(state.model.Dense_0.weight, _port_model(params).Dense_0.weight)


def _register_ring_both():
    """The same user constraint under one name in both registries."""
    @jtoy.register_toy_constraint("test_scaled_ring")
    def _jax_ring(radius: float = 1.0):
        return lambda x0: jl.PhysicsTerms(residual=jnp.sum(x0**2, axis=1) - radius**2)

    @ttoy.register_toy_constraint("test_scaled_ring")
    def _ring(radius: float = 1.0):
        return lambda x0: tl.PhysicsTerms(residual=(x0**2).sum(dim=1) - radius**2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_toy_checkpoint_round_trip_between_packages(tmp_path, writer):
    """A toy run saved by one package with a custom constraint spec, loaded
    by the other's ``load_toy_run``: the weights bit for bit, the constraint
    rebuilt from its spec, the forward equal, and sampling on the restored
    model (as tests/test_toy_persistence.py does within JAX)."""
    _register_ring_both()
    config = {**jax_train_toy.default_config(), "train_num_steps": 1,
              "constraint_spec": {"name": "test_scaled_ring", "kwargs": {"radius": 2.0}}}
    flax_model, params = _flax_params(14)
    out = tmp_path / "toy_run"
    if writer == "port":
        model = _port_model(params)
        state = create_train_state(model, make_optimizer(model, 5e-4, 1.0))
        loss_fn = train_toy.build_loss_fn(create_schedule(T), config)
        x0 = torch.from_numpy(_points(15))
        train_step(state, loss_fn, x0, torch.arange(B) % T, torch.randn(B, 2),
                   ema_start=train_toy.EMA_START)
        save_checkpoint(out / "model", 1, model=state.model, ema=state.ema,
                        optimizer=state.optimizer, config=config)
        saved = flax_params_from_torch(state.model.state_dict())
        _, jparams, _, jconfig, jphysics = jax_train_toy.load_toy_run(out)
        for a, b in zip(jax.tree_util.tree_leaves(saved), jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert jconfig["constraint_spec"] == config["constraint_spec"]
        x = _points(16)
        np.testing.assert_allclose(np.asarray(jphysics(x).residual), (x**2).sum(1) - 4.0,
                                   rtol=1e-6)
        result = jsamp.p_sample_loop(js.create_schedule(T),
                                     lambda a, b: flax_model.apply(jparams, a, b), (8, 2),
                                     jax.random.key(3), pred_mode=jconfig["model_pred_mode"])
        assert np.isfinite(np.asarray(result.x)).all()
        with torch.no_grad():
            ref = state.model(torch.from_numpy(x), 5).numpy()
        np.testing.assert_allclose(np.asarray(flax_model.apply(jparams, x, 5)), ref, atol=1e-6)
        return
    tx = jt.make_optimizer(5e-4, grad_clip=1.0)
    jstate = jt.create_train_state(params, tx)
    step_fn = jt.make_train_step(jax_train_toy.build_loss_fn(flax_model, js.create_schedule(T),
                                                             config), tx, ema_start=10**9)
    jstate, _ = step_fn(jstate, jnp.asarray(_points(15)), jax.random.key(1))
    jck.save_checkpoint(out / "model", 1, params=jstate.params, ema_params=jstate.ema_params,
                        opt_state=jstate.opt_state, config=config)
    model, sched, tconfig, physics = train_toy.load_toy_run(out, device="cpu")
    ref_sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref_sd[k]), k
    assert tconfig["constraint_spec"] == config["constraint_spec"]
    x = _points(16)
    np.testing.assert_allclose(physics(torch.from_numpy(x)).residual.numpy(),
                               (x**2).sum(1) - 4.0, rtol=1e-6)
    with torch.no_grad():
        got = model(torch.from_numpy(x), 5).numpy()
        result = tsamp.p_sample_loop(sched, model, torch.randn(8, 2),
                                     torch.Generator().manual_seed(3),
                                     pred_mode=tconfig["model_pred_mode"])
    np.testing.assert_allclose(got, np.asarray(flax_model.apply(jstate.params, x, 5)), atol=1e-6)
    assert torch.isfinite(result.x).all()


def test_train_toy_cli_writes_jax_files(tmp_path):
    """``--device cpu --epochs 1`` at full width (10^4 points, B=128, a
    1000-sample pass at epoch 0): the JAX driver's metrics columns and
    config, its sample CSV, and a checkpoint JAX's ``load_toy_run`` reads."""
    result = train_toy.main(["--device", "cpu", "--epochs", "1", "--name", "cli",
                             "--pred-mode", "eps", "--output-dir", str(tmp_path)])
    run = tmp_path / "cli"
    assert result.steps == 2 * (10**4 // 128) and result.samples == 1000
    assert np.isfinite(result.residual)
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["step", "time", "loss", "loss_data", "loss_residual",
                             "loss_inequality", "loss_optimization", "residual_samples"]
    assert [r["step"] for r in rows] == ["0", "0", "1"]
    assert rows[1]["residual_samples"] and not rows[0]["residual_samples"]
    assert all(np.isfinite(float(r["loss"])) for r in (rows[0], rows[2]))
    sample = np.loadtxt(run / "csv" / "step_0_sample.csv", delimiter=",")
    assert sample.shape == (1000, 2) and np.isfinite(sample).all()
    config = json.loads((run / "config.json").read_text())
    expected = {**jax_train_toy.default_config(), "name": "cli", "model_pred_mode": "eps",
                "train_num_steps": 1, "use_ddim_x0": True}
    assert config == expected
    assert sorted(p.name for p in (run / "model").iterdir()) == ["checkpoint_1.msgpack",
                                                                 "config.json"]
    assert not list(run.glob("*.png")) and not list(run.glob("*.gif"))
    flax_model, jparams, _, jconfig, _ = jax_train_toy.load_toy_run(run)
    assert jconfig == expected
    x = _points(17)
    with torch.no_grad():
        got = result.state.model(torch.from_numpy(x), 3).numpy()
    np.testing.assert_allclose(np.asarray(flax_model.apply(jparams, x, 3)), got, atol=1e-6)


def test_scatter_writers(tmp_path):
    """The toy's panels and trajectory GIF (only with ``--create-gif``)."""
    history = np.random.default_rng(18).standard_normal((4, 20, 2))
    viz.save_scatter_panels(history, [0, 1, 3], tmp_path / "p" / "step_0.png", 3)
    viz.scatter_history_to_gif(history, tmp_path / "g" / "step_0.gif", (-3, 3), (-3, 3))
    assert (tmp_path / "p" / "step_0.png").stat().st_size > 0
    assert (tmp_path / "g" / "step_0.gif").stat().st_size > 0
