"""The mechanics study's model, loss, trainer and sampler in the port against
the JAX package, at a small width (``UNet(dim=8, channels=10, out_dim=3,
sigmoid_last_channel=True)``, 16x16 predictions on 17x17 fields), with
Flax parameters carried across by ``models/convert.py`` and the same
batch, t and noise made with numpy: the forward (fp32; bf16 + fp32 head),
the loss of ``train_mechanics.build_mechanics_loss_fn`` and its gradients
(x0_estimation 'mean' and 'sample'), three trainer steps, and five
sampler steps with JAX's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_mechanics as jax_tm
from physicsinformeddiffusionmodels_tpu.config import RunConfig as JaxRunConfig
from physicsinformeddiffusionmodels_tpu.data import mechanics_generator as jgen
from physicsinformeddiffusionmodels_tpu.diffusion import create_schedule as jax_schedule
from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import sampling as jsamp
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.ops.reshape import resize_bilinear as jax_resize
from physicsinformeddiffusionmodels_tpu.physics.mechanics import MechanicsResidual as JaxMech
from physicsinformeddiffusionmodels_tpu.physics.mechanics import split_mechanics_batch
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch import train_mechanics as tm
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet, build_model
from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from test_torch_sampling import _jax_draws
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, DIM, MULTS, B = 16, 8, (1, 2), 2
# 4 groups of 2 channels at width 8 (test_torch_training.py): with one
# channel per group a conv bias before the GroupNorm has a zero gradient
GROUPS = 4
WEIGHTS = jl.LossWeights(1.0, 1e-3, 1e-3, 1e-6)  # the mechanics driver's
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-3


def _flax(dtype=None, fp32_head=False):
    return FlaxUNet(dim=DIM, channels=10, out_dim=3, sigmoid_last_channel=True,
                    dim_mults=MULTS, resnet_groups=GROUPS, dtype=dtype, fp32_head=fp32_head)


def _port(params, dtype=None, fp32_head=False) -> UNet:
    model = UNet(dim=DIM, channels=10, out_dim=3, sigmoid_last_channel=True, dim_mults=MULTS,
                 resnet_groups=GROUPS, dtype=dtype, fp32_head=fp32_head)
    model.load_state_dict(torch_state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def params():
    """Random parameters of the Flax tree's shapes, every leaf drawn."""
    shapes = jax.eval_shape(_flax().init, jax.random.key(0), np.zeros((1, P, P, 10)),
                            np.zeros((1,), np.int32))
    rng = np.random.default_rng(41)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def fields():
    """Four generator samples at P (two training families, two OOD)."""
    fem, rng = jgen.MechanicsFEM(P), np.random.default_rng(42)
    return np.stack([jgen.generate_sample(fem, rng, n_iter=2, family=f)
                     for f in ("cantilever", "partial_clamp", "bridge", "double_clamp")])


def _forward(model, x, t):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t).long()).float().numpy()


def test_forward_matches_flax(params):
    rng = np.random.default_rng(43)
    x = rng.standard_normal((B, P, P, 10)).astype(np.float32)
    t = rng.integers(0, 100, B).astype(np.int32)
    ref = np.asarray(jax.jit(_flax().apply)(params, x, t))
    got = _forward(_port(params), x, t)
    assert got.shape == (B, P, P, 3)
    assert 0.0 < got[..., 2].min() and got[..., 2].max() < 1.0  # the density's sigmoid
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    # bf16 compute with the fp32 head: the port within 2x the larger of the
    # two sides' own bf16 rounding (their gap to their fp32 forward), L2
    ref16 = np.asarray(jax.jit(_flax(jnp.bfloat16, True).apply)(params, x, t))
    got16 = _forward(_port(params, torch.bfloat16, True), x, t)
    assert ref16.dtype == np.float32  # the fp32 head's output, sigmoid in fp32
    gap = np.linalg.norm(got16 - ref16)
    limit = 2 * max(np.linalg.norm(ref16 - ref), np.linalg.norm(got16 - got))
    assert 0 < gap <= limit, (gap, limit)


def _jax_loss(flax_model, sched, mech, ddim: bool):
    """JAX's mechanics loss (the root ``train_mechanics.build_mechanics_loss_fn``)
    with t and the noise given: ``loss(params, (x0, t, noise), key, step)``."""

    def loss(p, batch, key, step):
        x0, t, noise = batch
        mb = split_mechanics_batch(x0)
        vf = mb.conditioning[..., 0][:, 0, 0]

        def denoise(x65, tt):
            return flax_model.apply(p, jax_tm.model_input_from_state(x65, mb, P), tt)

        sampler = None
        if ddim:
            def sampler(x_t65, tt, k):
                fixed = jax_tm.model_input_from_state(x_t65, mb, P)
                return jsamp.ddim_sample_x0(sched, lambda _, ttt: flax_model.apply(p, fixed, ttt),
                                            jax_resize(x_t65, P), tt, k, ddim_steps=0)

        return jl.pidm_loss(sched, mb.solution, t, key, denoise_fn=denoise,
                            physics_fn=lambda x0_64: mech.evaluate(x0_64, mb.bcs, vf),
                            weights=WEIGHTS, pred_mode="x0", x0_sampler=sampler,
                            model_out_transform=mech.model_out_to_nodes, noise=noise)

    return loss


def _port_loss(ddim: bool):
    cfg = RunConfig(gov_eqs="mechanics", pixels_per_dim=P, c_ineq=1e-3, lambda_opt=1e-6,
                    x0_estimation="sample" if ddim else "mean")
    return tm.build_mechanics_loss_fn(create_schedule(100), MechanicsResidual(P), cfg)


def _batch(fields, seed):
    rng = np.random.default_rng(seed)
    return (fields[rng.choice(len(fields), B, replace=False)],
            rng.integers(0, 100, B).astype(np.int32),
            rng.standard_normal((B, P + 1, P + 1, 3)).astype(np.float32))


@pytest.mark.parametrize("ddim", [False, True], ids=["mean", "sample"])
def test_loss_and_gradients_match_jax(params, fields, ddim):
    x0, t, noise = _batch(fields, 44)
    loss_j = _jax_loss(_flax(), jax_schedule(100), JaxMech(P), ddim)
    (ref, aux_j), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params, (x0, t, noise), jax.random.key(0), 0)
    model = _port(params)
    loss, aux = _port_loss(ddim)(model, torch.from_numpy(x0), torch.from_numpy(t).long(),
                                 torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=LOSS_RTOL)
    for name in ("data_loss", "residual_mean_abs", "ineq_mean", "opt_mean"):
        np.testing.assert_allclose(getattr(aux, name).item(), float(getattr(aux_j, name)),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    ref_g = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    compared = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # the guidance-conditioning modules, unused
            assert not ref_g[name].abs().max(), name
            continue
        err, scale = (p.grad - ref_g[name]).abs().max().item(), ref_g[name].abs().max().item()
        assert err <= GRAD_TOL * scale, f"{name}: {err:.3e} > {GRAD_TOL} x {scale:.3e}"
        compared += 1
    assert compared > 60


def test_three_train_steps_match_jax(params, fields):
    steps = [_batch(fields, 45 + i) for i in range(3)]
    tx = jt.make_optimizer(1e-4, 1.0)
    # ema_start=1: steps 0 and 1 copy the weights, step 2 interpolates
    step_fn = jt.make_train_step(_jax_loss(_flax(), jax_schedule(100), JaxMech(P), False), tx,
                                 ema_mu=0.99, ema_start=1, donate=False)
    jstate = jt.create_train_state(params, tx)
    model = _port(params)
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0))
    loss_fn = _port_loss(False)
    for x0, t, noise in steps:
        jstate, jaux = step_fn(jstate, (x0, t, noise), jax.random.key(0))
        aux = train_step(state, loss_fn, torch.from_numpy(x0), torch.from_numpy(t).long(),
                         torch.from_numpy(noise), ema_mu=0.99, ema_start=1)
        np.testing.assert_allclose(aux.loss.item(), float(jaux.loss), rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == 3
    # Adam maps each fp32 gradient to a step of about lr = 1e-4; 5e-6 is 5% of one
    for name, mine, ref in (("params", state.model, jstate.params),
                            ("ema", state.ema, jstate.ema_params)):
        ref_sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        for k, v in mine.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=5e-6, rtol=0,
                                       err_msg=f"{name} {k}")


def test_five_sampler_steps_match_jax(params, fields):
    """JAX's ``make_mech_sample_fn`` on a 5-step schedule, and the port's
    ``sample_mechanics`` with JAX's x_init and per-step draws: the final
    65x65 states, their residual, compliance and volume mismatch, and the
    topopt metrics (rel_CE checked on the host: the same fallbacks)."""
    steps, batch = 5, fields[:B]
    jcfg = JaxRunConfig(gov_eqs="mechanics", pixels_per_dim=P, diff_steps=steps, unet_dim=DIM)
    flax_model, jmech = _flax(), JaxMech(P)
    key = jax.random.key(46)
    ref = jax_tm.make_mech_sample_fn(flax_model, jax_schedule(steps), jmech, jcfg)(
        params, jnp.asarray(batch), key)
    x_init, noise = _jax_draws(key, (B, P + 1, P + 1, 3), steps)
    cfg = RunConfig(gov_eqs="mechanics", pixels_per_dim=P, diff_steps=steps, unet_dim=DIM)
    mech = MechanicsResidual(P)
    got = tm.sample_mechanics(cfg, _port(params).eval(), torch.from_numpy(batch),
                              torch.from_numpy(x_init), torch.from_numpy(noise), mech)
    final, residual, compliance, ineq, topopt = (np.asarray(a) if i < 4 else a
                                                 for i, a in enumerate(ref))
    np.testing.assert_allclose(got.final.numpy(), final, rtol=0, atol=1e-4)
    for name, mine, theirs in (("residual", got.residual, residual),
                               ("compliance", got.compliance, compliance)):
        err = np.abs(mine.numpy() - theirs).max() / np.abs(theirs).max()
        assert err <= 1e-4, f"{name}: {err:.3e}"
    np.testing.assert_allclose(got.ineq.numpy(), ineq, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.topopt["rho_binarized"].numpy(),
                                  np.asarray(topopt["rho_binarized"]))
    np.testing.assert_allclose(got.topopt["vf_error_full_batch"].numpy(),
                               np.asarray(topopt["vf_error_full_batch"]), rtol=1e-6)
    bcs = batch[..., 6:10]
    ref_c, got_c = jmech.topopt_eval_checked(topopt, bcs), mech.topopt_eval_checked(got.topopt,
                                                                                    bcs)
    assert got_c["n_solve_fallback"] == ref_c["n_solve_fallback"]
    np.testing.assert_allclose(got_c["rel_CE_error_full_batch"],
                               ref_c["rel_CE_error_full_batch"], rtol=5e-4)


def test_build_model_makes_the_mechanics_unet():
    cfg = RunConfig(gov_eqs="mechanics", unet_dim=DIM, compute_dtype="bfloat16", fp32_head=True)
    model = build_model(cfg)
    assert model.sigmoid_last_channel and model.fp32_head and model.dtype == torch.bfloat16
    assert model.final_conv.out_channels == 3 and model.init_conv.Conv_0.in_channels == 10
    # the two options no committed run uses (their parity with Flax:
    # tests/test_torch_unet_options.py)
    model = build_model(RunConfig(gov_eqs="mechanics", unet_dim=DIM, bcs="periodic",
                                  self_condition=True))
    assert model.padding_mode == "circular" and model.self_condition
    assert model.init_conv.Conv_0.in_channels == 20 and model.init_conv.circular
