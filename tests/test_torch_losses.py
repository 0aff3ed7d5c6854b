"""The port's training loss, schedule tables, Darcy physics terms and the plain
kernels' gradients against the JAX package, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.ops import pallas_attention as pa
from physicsinformeddiffusionmodels_tpu.ops import pallas_kernels as pk
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu_torch.diffusion import losses as tl
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu_plain
from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
    linear_attention_block_plain,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEW_TABLES = ["sqrt_recip_alphas", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "noise_mean_coeff", "posterior_variance_clipped", "p2_loss_weight"]
# elementwise float32 arithmetic, same formulas, possibly another operation order
F32 = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("p2_mode", ["min_snr", "constant_p2"])
def test_training_schedule_tables_equal_jax(p2_mode):
    # both build in float64 with numpy and cast: the float32 tables are identical
    ours, ref = ts.create_schedule(100, p2_mode=p2_mode), js.create_schedule(100, p2_mode=p2_mode)
    for name in NEW_TABLES:
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_predict_functions_match_golden_and_jax(golden_ops):
    g = golden_ops
    ours, ref = ts.create_schedule(100), js.create_schedule(100)
    t = g["t"].astype(np.int64)
    x0 = ts.predict_start_from_noise(ours, _t(g["x_t"]), _t(t), _t(g["noise"])).numpy()
    eps = ts.predict_noise_from_mean(ours, _t(g["x_t"]), _t(t), _t(g["mean_t"])).numpy()
    # the fixture came from the reference implementation (other rounding)
    np.testing.assert_allclose(x0, g["x0_from_noise"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eps, g["eps_from_mean"], rtol=1e-4, atol=1e-5)
    jt = jnp.asarray(t)
    np.testing.assert_allclose(
        x0, np.asarray(js.predict_start_from_noise(ref, g["x_t"], jt, g["noise"])), **F32)
    np.testing.assert_allclose(
        eps, np.asarray(js.predict_noise_from_mean(ref, g["x_t"], jt, g["mean_t"])), **F32)
    eps0 = ts.predict_noise_from_start(ours, _t(g["x_t"]), _t(t), _t(x0)).numpy()
    np.testing.assert_allclose(
        eps0, np.asarray(js.predict_noise_from_start(ref, g["x_t"], jt, x0)), rtol=1e-5,
        atol=1e-6)


def test_log_likelihood_and_variational_loss_match_golden(golden_ops):
    g = golden_ops
    sched = ts.create_schedule(100)
    t = _t(g["t"].astype(np.int64))
    var = ts.extract(sched.posterior_variance_clipped, t, 2)
    x_t = _t(g["x_t"])
    got = tl.gaussian_log_likelihood(torch.zeros_like(x_t), x_t, var, clamp=tl.TOY_LL_CLAMP)
    # the golden values' own tolerance in the JAX package's tests
    np.testing.assert_allclose(got.numpy(), g["gaussian_ll"], rtol=1e-4, atol=1e-5)
    lv = tl.loss_variational(sched, _t(g["mean_t"]), x_t, _t(g["noise"]), t)
    np.testing.assert_allclose(lv.item(), g["loss_variational"], rtol=1e-4)


def test_loss_terms_match_jax():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(3))
    t = np.array([0, 17, 99])
    ours, ref = ts.create_schedule(100), js.create_schedule(100)
    jt = jnp.asarray(t)
    np.testing.assert_allclose(tl.normal_kl(_t(a), _t(b), _t(c), _t(a)).numpy(),
                               np.asarray(jl.normal_kl(a, b, c, a)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.data_loss_x0(ours, _t(a), _t(b), _t(t)).item(),
                               float(jl.data_loss_x0(ref, a, b, jt)), rtol=1e-6)
    np.testing.assert_allclose(
        tl.residual_log_likelihood_loss(ours, _t(a), _t(t)).item(),
        float(jl.residual_log_likelihood_loss(ref, a, jt)), rtol=1e-6)
    np.testing.assert_allclose(
        tl.loss_variational(ours, _t(a), _t(b), _t(c), _t(t), clamp=tl.TOY_LL_CLAMP).item(),
        float(jl.loss_variational(ref, a, b, c, jt, clamp=jl.TOY_LL_CLAMP)), rtol=1e-5)
    for mode in ("x0", "eps", "mu"):
        got = tl.estimate_x0(ours, lambda x, tt: 0.5 * x, _t(a), _t(t), mode)
        want = jl.estimate_x0(ref, lambda x, tt: 0.5 * x, a, jt, mode)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5,
                                       err_msg=mode)


@pytest.mark.parametrize("mode", ["x0", "eps", "mu"])
def test_pidm_loss_modes_and_all_terms_match_jax(mode):
    """Every loss term (data, residual, inequality, optimisation) in each
    prediction mode, with the toy study's clamp, on a toy 2-d problem."""
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((6, 2)).astype(np.float32)
    noise = rng.standard_normal((6, 2)).astype(np.float32)
    t = np.array([0, 1, 30, 50, 98, 99])
    w = rng.standard_normal((2, 2)).astype(np.float32)
    weights = dict(c_data=1.0, c_residual=0.1, c_ineq=0.01, lambda_opt=0.05)

    def physics(terms_cls, x):
        return terms_cls(residual=x[:, :1] * x[:, 1:] - 0.1, inequality=x[:, 0] ** 2,
                         optimizer=x.sum(axis=1))

    loss, aux = tl.pidm_loss(
        ts.create_schedule(100), _t(x0), _t(t), _t(noise),
        denoise_fn=lambda x, tt: x @ _t(w), physics_fn=lambda x: physics(tl.PhysicsTerms, x),
        weights=tl.LossWeights(**weights), pred_mode=mode, ll_clamp=tl.TOY_LL_CLAMP)
    ref, ref_aux = jl.pidm_loss(
        js.create_schedule(100), jnp.asarray(x0), jnp.asarray(t), None,
        denoise_fn=lambda x, tt: x @ w, physics_fn=lambda x: physics(jl.PhysicsTerms, x),
        weights=jl.LossWeights(**weights), pred_mode=mode, ll_clamp=jl.TOY_LL_CLAMP,
        noise=jnp.asarray(noise))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for name, g, r in zip(aux._fields, aux, ref_aux):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5, atol=1e-7, err_msg=name)


def test_timestep_samplers():
    gen = torch.Generator().manual_seed(0)
    t = tl.uniform_timesteps(gen, 128, 100)
    assert t.shape == (128,) and 0 <= t.min() and t.max() < 100
    t = tl.antithetic_timesteps(gen, 128, 100)
    half = 128 // 2 + 1
    assert t.shape == (128,) and 0 <= t.min() and t.max() < 100
    np.testing.assert_array_equal(t[half:].numpy(), (100 - t[:128 - half] - 1).numpy())


def _small_unet(seed: int):
    """A random small Flax UNet (biases and norms drawn too) and the port's
    copy of it."""
    flax_model = FlaxUNet(dim=8, channels=2, dim_mults=(1, 2))
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), np.zeros((1, 16, 16, 2)),
                            np.zeros((1,), np.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = UNet(dim=8, channels=2, dim_mults=(1, 2))
    model.load_state_dict(torch_state_dict_from_flax(params))
    return flax_model, params, model


def test_pidm_loss_and_its_input_gradient_match_jax():
    """The Darcy loss of a small UNet (P=16, c_residual 1e-3) and its gradient
    with respect to the clean batch, which reaches the model through x_t."""
    flax_model, params, model = _small_unet(seed=4)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    noise = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    t = np.array([2, 40, 97])
    weights = dict(c_data=1.0, c_residual=1e-3)

    xt = _t(x0).requires_grad_(True)
    loss, aux = tl.pidm_loss(ts.create_schedule(100), xt, _t(t), _t(noise), denoise_fn=model,
                             physics_fn=DarcyResidual(16), weights=tl.LossWeights(**weights))
    (grad,) = torch.autograd.grad(loss, xt)

    def jax_loss(x):
        return jl.pidm_loss(js.create_schedule(100), x, jnp.asarray(t), None,
                            denoise_fn=lambda a, b: flax_model.apply(params, a, b),
                            physics_fn=JaxDarcy(16), weights=jl.LossWeights(**weights),
                            noise=jnp.asarray(noise))

    (ref, ref_aux), ref_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(x0))
    # fp32 forward and backward of the same network in two frameworks; the
    # residual term divides by sigma_t^2 and multiplies FD second
    # derivatives (1/d0^2 = 225 at P=16), so relative 1e-4 of the largest entry
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(aux.residual_mean_abs.item(), float(ref_aux.residual_mean_abs),
                               rtol=1e-5)
    scale = np.abs(np.asarray(ref_grad)).max()
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-4 * scale, rtol=0)


def test_darcy_physics_terms_gauge_and_residual_gradient_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    w = rng.standard_normal((2, 32 * 32, 3)).astype(np.float32)
    ours, ref = DarcyResidual(32), JaxDarcy(32)
    xt = _t(x).requires_grad_(True)
    terms = ours(xt)
    assert terms.inequality is None and terms.optimizer is None
    (g_res,) = torch.autograd.grad((terms.residual * _t(w)).sum(), xt)
    ref_g_res = jax.grad(lambda a: (ref(a).residual * w).sum())(jnp.asarray(x))
    # the FD operators scale by 1/d0^2 ~ 1e3: relative 1e-5 of the largest entry
    scale = np.abs(np.asarray(ref_g_res)).max()
    np.testing.assert_allclose(g_res.numpy(), np.asarray(ref_g_res), atol=1e-5 * scale, rtol=0)

    zm = ours.zero_mean_pressure(xt)
    np.testing.assert_allclose(zm.detach().numpy(),
                               np.asarray(ref.zero_mean_pressure(jnp.asarray(x))), **F32)
    # the gauge is taken on a detached copy: the gradient is the identity's
    (g_zm,) = torch.autograd.grad(zm.sum(), xt)
    ref_g_zm = jax.grad(lambda a: ref.zero_mean_pressure(a).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g_zm.numpy(), np.asarray(ref_g_zm))
    np.testing.assert_array_equal(g_zm.numpy(), np.ones_like(x))


HEADS, DH = 8, 32
# With unit-scale weights the attention term LA(LN(x)) is ~1e-4 (v is divided
# by N) and the gradients that reach gamma, W_qkv and W_out through it are
# ~0.04, no larger than the 5e-4 tolerance allows to be wrong. Scaling W_out
# and the v columns of W_qkv by sqrt(GRAD_LA_GAIN * N) each brings the term
# to ~0.5, and every gradient (each of W_qkv's q, k, v parts apart) must reach
# GRAD_MIN_MAX = 100 x the tolerance before it is compared.
GRAD_LA_GAIN, GRAD_TOL = 10.0, 5e-4
GRAD_MIN_MAX = 100 * GRAD_TOL


@pytest.mark.parametrize("n,c", [(256, 32), (128, 64)])
def test_linear_attention_plain_gradients_match_pallas_interpret(n, c):
    rng = np.random.default_rng(7)
    h = HEADS * DH
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    w_qkv = (rng.standard_normal((c, 3 * h)) / np.sqrt(c)).astype(np.float32)
    w_out = (rng.standard_normal((h, c)) / np.sqrt(h)).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gain = np.float32(np.sqrt(GRAD_LA_GAIN * n))
    w_qkv[:, 2 * h:] *= gain
    w_out *= gain
    args = (x, gamma, w_qkv, w_out, b_out)

    def pallas(x, gamma, w_qkv, w_out, b_out):
        yt = pa._linear_attention_block_pallas(
            jnp.swapaxes(x, -1, -2), gamma.reshape(c, 1), jnp.swapaxes(w_qkv, 0, 1), w_out,
            b_out.reshape(c, 1), HEADS, DH, 1e-5, True)
        return jnp.sum(jnp.sin(jnp.swapaxes(yt, -1, -2)))

    ref = [np.asarray(r) for r in
           jax.grad(pallas, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))]
    leaves = [_t(a).requires_grad_(True) for a in args]
    torch.sin(linear_attention_block_plain(*leaves, HEADS, DH)).sum().backward()
    names = ("dx", "dgamma", "dw_qkv", "dw_out", "db_out")
    parts = dict(zip(names, ref))
    parts.update({f"dw_{p}": ref[2][:, i * h:(i + 1) * h] for i, p in enumerate("qkv")})
    for name, r in parts.items():
        assert np.abs(r).max() >= GRAD_MIN_MAX, f"{name}: max |g| {np.abs(r).max():.3e}"
    # the JAX package's own tolerance for its Pallas VJP against autodiff
    for name, leaf, r in zip(names, leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r.reshape(leaf.shape),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


# the film flag alone names the (64, 32) cases; (64, 256) is a Darcy level's
# width with 32 channels a group
@pytest.mark.parametrize("film,n,c", [
    pytest.param(True, 64, 32, id="True"), pytest.param(False, 64, 32, id="False"),
    pytest.param(True, 64, 256, id="True-64-256"), pytest.param(False, 64, 256, id="False-64-256")])
def test_group_norm_plain_gradients_match_pallas_interpret(film, n, c):
    rng = np.random.default_rng(8)
    b = 3
    x = (rng.standard_normal((b, n, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    scale = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
    shift = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
    if not film:  # the JAX wrapper feeds zeros to the kernel for no FiLM
        scale, shift = np.zeros_like(scale), np.zeros_like(shift)
    args = (x, gamma, beta, scale, shift)

    def pallas(*a):
        return jnp.sum(jnp.sin(pk._gn_film_silu_pallas(*a, 8, 1e-5, True)))

    ref = jax.grad(pallas, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    ss = leaves[3:] if film else (None, None)
    torch.sin(group_norm_film_silu_plain(*leaves[:3], *ss, groups=8)).sum().backward()
    names = ("dx", "dgamma", "dbeta", "dscale", "dshift")
    for name, leaf, r in list(zip(names, leaves, ref))[:5 if film else 3]:
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4,
                                   err_msg=name)
