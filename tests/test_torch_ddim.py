"""The port's DDIM x0 sample-estimation (x0_estimation='sample') against the
JAX package: the time ladders, the chain with and without eta noise, and
the Darcy training loss built on it, with its input gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jax_train
from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import sampling as jsamp
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu_torch import train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.diffusion import sampling as tsamp
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, DIM, MULTS = 16, 8, (1, 2)
# the chain's output and the gradients: within TOL x each tensor's largest
# entry (fp32; the two frameworks sum the convolutions in another order)
TOL = 1e-4
LOSS_RTOL = 1e-5


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("ddim_steps", [0, 1, 2, 5])
def test_time_ladders_equal_jax(ddim_steps):
    t = np.concatenate([np.arange(100), [0, 1, 2, 3]])
    cur, nxt = tsamp.ddim_time_ladders(torch.from_numpy(t), ddim_steps)
    jcur, jnxt = jsamp.ddim_time_ladders(jnp.asarray(t), ddim_steps)
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert cur.shape == (ddim_steps + 2, t.size)
    assert (cur[0].numpy() == t).all() and (nxt[-1].numpy() == -1).all()


def _denoisers():
    """The same smooth, time-dependent x0 predictor in both frameworks."""
    w = np.linspace(0.5, 1.5, 100).astype(np.float32)

    def jax_fn(x, t):
        return jnp.tanh(x) * jnp.asarray(w)[t].reshape(-1, 1, 1, 1) + 0.1 * x

    wt = torch.from_numpy(w)

    def torch_fn(x, t):
        return torch.tanh(x) * wt[t].reshape(-1, 1, 1, 1) + 0.1 * x

    return jax_fn, torch_fn


@pytest.mark.parametrize("ddim_steps,eta,pred_mode", [
    (0, 0.0, "x0"), (2, 0.0, "x0"), (2, 0.5, "x0"), (2, 0.0, "eps"), (1, 0.5, "mu")])
def test_chain_matches_jax(ddim_steps, eta, pred_mode):
    """Including t = 0 (the ladder [0, 0] stalls, then returns the x0
    prediction), eta > 0 with JAX's own draws handed to the port, and the
    eps and mu prediction modes."""
    jax_fn, torch_fn = _denoisers()
    rng = np.random.default_rng(3)
    x_t = rng.standard_normal((6, 8, 8, 2)).astype(np.float32)
    t = np.array([0, 1, 2, 37, 80, 99])
    key = jax.random.key(5)
    sched_j, sched_t = js.create_schedule(100), ts.create_schedule(100)
    ref, ref_first = jsamp.ddim_sample_x0(sched_j, jax_fn, jnp.asarray(x_t), jnp.asarray(t), key,
                                          ddim_steps=ddim_steps, eta=eta, pred_mode=pred_mode)
    # the scan's draws: one split of the carried key per ladder entry
    draws, k = [], key
    for _ in range(ddim_steps + 2):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(sub, x_t.shape, jnp.float32)))
    noise = torch.from_numpy(np.stack(draws)) if eta > 0 else None
    got, first = tsamp.ddim_sample_x0(sched_t, torch_fn, torch.from_numpy(x_t),
                                      torch.from_numpy(t), ddim_steps=ddim_steps, eta=eta,
                                      noise=noise, pred_mode=pred_mode)
    _close(got.numpy(), ref, "x0_sample")
    np.testing.assert_allclose(first.numpy(), np.asarray(ref_first), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(first.numpy(), torch_fn(torch.from_numpy(x_t),
                                                          torch.from_numpy(t)).numpy())
    if eta > 0:  # the noise reaches the output
        quiet, _ = tsamp.ddim_sample_x0(sched_t, torch_fn, torch.from_numpy(x_t),
                                        torch.from_numpy(t), ddim_steps=ddim_steps,
                                        pred_mode=pred_mode)
        assert (got - quiet).abs().max() > 1e-3


def test_chain_stalls_bit_for_bit_and_ends_on_the_prediction():
    """At t = 0 the ladder is [0, 0] then (0, -1): the first entry stalls
    (x kept exactly), the last returns the model's x0 prediction."""
    _, torch_fn = _denoisers()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 4, 4, 2))
                         .astype(np.float32))
    seen = []

    def recording(xx, tt):
        seen.append(xx.clone())
        return torch_fn(xx, tt)

    out, _ = tsamp.ddim_sample_x0(ts.create_schedule(100), recording, x,
                                  torch.zeros(2, dtype=torch.long))
    assert len(seen) == 2 and torch.equal(seen[1], x)
    assert torch.equal(out, torch_fn(x, torch.zeros(2, dtype=torch.long)))
    with pytest.raises(ValueError, match="noise"):
        tsamp.ddim_sample_x0(ts.create_schedule(100), torch_fn, x, torch.ones(2, dtype=torch.long),
                             eta=0.5)


def _models(seed):
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), np.zeros((1, P, P, 2)),
                            np.zeros((1,), np.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS)
    model.load_state_dict(torch_state_dict_from_flax(params))
    return flax_model, params, model


@pytest.mark.parametrize("ddim_steps", [0, 2])
def test_ddim_loss_and_input_gradient_match_jax(ddim_steps):
    """The loss closures of both ``train.py`` (JAX ``build_darcy_loss_fn``),
    with JAX's t and noise of the same key handed to the port."""
    flax_model, params, model = _models(21)
    kw = dict(x0_estimation="sample", ddim_steps=ddim_steps, pixels_per_dim=P, unet_dim=DIM,
              compute_dtype="float32", c_residual=1e-2)
    jcfg, cfg = JaxRunConfig(**kw), RunConfig(**kw)
    assert cfg.train_batch_size == jcfg.train_batch_size == 16
    jloss = jax_train.build_darcy_loss_fn(flax_model, js.create_schedule(100), JaxDarcy(P), jcfg)
    loss_fn = train.build_darcy_loss_fn(ts.create_schedule(100), DarcyResidual(P), cfg)
    batch = np.random.default_rng(22).standard_normal((4, P, P, 2)).astype(np.float32)
    key = jax.random.key(23)
    t_key, n_key, _ = jax.random.split(key, 3)
    t = np.array(jax.random.randint(t_key, (4,), 0, 100))
    t[0] = 0  # a stalled ladder
    noise = np.array(jax.random.normal(n_key, batch.shape, jnp.float32))

    def jax_total(b, tt):
        # the closure draws t from its key; this one is JAX's with t set
        return jl.pidm_loss(
            js.create_schedule(100), b, tt, n_key,
            denoise_fn=lambda x, s: flax_model.apply(params, x, s), physics_fn=JaxDarcy(P),
            weights=jl.LossWeights(jcfg.c_data, jcfg.c_residual, 0.0, 0.0),
            x0_sampler=lambda x_t, s, k: jsamp.ddim_sample_x0(
                js.create_schedule(100), lambda _, u: flax_model.apply(params, x_t, u), x_t, s,
                k, ddim_steps=ddim_steps))

    (jloss_v, jaux), jgrad = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(batch),
                                                                    jnp.asarray(t))
    # the closure of JAX's train.py gives the same loss when its t is drawn
    t_drawn = np.array(jax.random.randint(t_key, (4,), 0, 100))
    jl_closure = float(jloss(params, jnp.asarray(batch), key, 0)[0])
    b = torch.from_numpy(batch).requires_grad_(True)
    drawn, _ = loss_fn(model, b, torch.from_numpy(t_drawn), torch.from_numpy(noise))
    np.testing.assert_allclose(drawn.item(), jl_closure, rtol=LOSS_RTOL)

    loss, aux = loss_fn(model, b, torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(loss.item(), float(jloss_v), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux.residual_mean_abs.item(), float(jaux.residual_mean_abs),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux.data_loss.item(), float(jaux.data_loss), rtol=LOSS_RTOL)
    (grad,) = torch.autograd.grad(loss, b)
    _close(grad.numpy(), jgrad, "d loss / d batch")
    # the residual term reaches the gradient through the chain
    assert aux.residual_mean_abs.item() > 0 and np.abs(np.asarray(jgrad)).max() > 0


@pytest.mark.parametrize("ddim_steps", [0, 2])
def test_ddim_loss_makes_ddim_steps_plus_two_model_calls(ddim_steps):
    """Every call sees the original noisy input x_t; only the times change."""
    _, _, model = _models(24)
    cfg = RunConfig(x0_estimation="sample", ddim_steps=ddim_steps, pixels_per_dim=P,
                    unet_dim=DIM, compute_dtype="float32")
    loss_fn = train.build_darcy_loss_fn(ts.create_schedule(100), DarcyResidual(P), cfg)
    calls = []
    model.register_forward_pre_hook(lambda m, a: calls.append((a[0].clone(), a[1].clone())))
    rng = np.random.default_rng(25)
    batch = torch.from_numpy(rng.standard_normal((2, P, P, 2)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, P, P, 2)).astype(np.float32))
    t = torch.tensor([40, 99])
    loss_fn(model, batch, t, noise)
    assert len(calls) == ddim_steps + 2
    x_t = ts.q_sample(ts.create_schedule(100), batch, t, noise)
    assert all(torch.equal(x, x_t) for x, _ in calls)
    assert [c[1].tolist() for c in calls] == tsamp.ddim_time_ladders(t, ddim_steps)[0].tolist()
