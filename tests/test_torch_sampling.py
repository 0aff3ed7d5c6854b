"""The port's ancestral sampler against the JAX ``p_sample_loop``: the same
``x_init`` and the same per-step noise, replayed from JAX's key splits, on a
10-step schedule; with the 300k Darcy weights, and with a small UNet under
CoCoGen corrections, dynamic thresholding and the history."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.diffusion import create_schedule as jax_schedule
from physicsinformeddiffusionmodels_tpu.diffusion import p_sample_loop as jax_p_sample_loop
from physicsinformeddiffusionmodels_tpu.diffusion import sampling as jsampling
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import p_sample_loop
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet, build_model
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN = Path(__file__).resolve().parent.parent / "results/darcy_300k_fp32head/portable"
STEPS, B, P = 10, 2, 64
PS = 16  # the small UNet's fields


def _jax_draws(key, shape, steps):
    """x_init and the [T, ...] noise JAX's p_sample_loop draws from ``key``:
    one split for the init, then one split per step."""
    key, init_key = jax.random.split(key)
    x_init = np.array(jax.random.normal(init_key, shape))
    noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.normal(sub, shape)))
    return x_init, np.stack(noise)


def test_sampling_trajectory_matches_jax():
    params = load_checkpoint(RUN / "model/checkpoint_300000.msgpack")["ema_params"]
    shape = (B, P, P, 2)
    key = jax.random.key(11)

    flax_model = FlaxUNet(dim=32, channels=2)
    ref = jax.jit(lambda k: jax_p_sample_loop(
        jax_schedule(STEPS), lambda x, t: flax_model.apply(params, x, t), shape, k).x)(key)
    ref = np.asarray(ref)

    model = build_model(RunConfig.load(RUN / "config.json"), "float32")
    model.load_state_dict(torch_state_dict_from_flax(params))
    x_init, noise = _jax_draws(key, shape, STEPS)
    with torch.no_grad():
        got = p_sample_loop(create_schedule(STEPS), model.eval(), torch.from_numpy(x_init),
                            torch.from_numpy(noise)).x.numpy()

    # the per-step forward agrees to ~1e-5 (test_torch_unet); ten steps of
    # the posterior-mean recursion carry that through without amplification
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    # the residual amplifies field noise by ~1/d0^2 ~ 4e3; its per-sample
    # mean |residual| (the evaluation metric) still agrees to 1e-4 relative
    res_ref = np.abs(np.asarray(JaxDarcy(pixels_per_dim=P).residual(ref))).mean(axis=(1, 2))
    res_got = DarcyResidual(pixels_per_dim=P).residual(torch.from_numpy(got)).abs()
    np.testing.assert_allclose(res_got.mean(dim=(1, 2)).numpy(), res_ref, rtol=1e-4)


@pytest.fixture(scope="module")
def small_unet():
    """Flax parameters of UNet(dim=8, dim_mults=(1, 2)), every leaf drawn."""
    flax_model = FlaxUNet(dim=8, channels=2, dim_mults=(1, 2))
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), np.zeros((1, PS, PS, 2)),
                            np.zeros((1,), np.int32))
    rng = np.random.default_rng(12)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = UNet(dim=8, channels=2, dim_mults=(1, 2))
    model.load_state_dict(torch_state_dict_from_flax(params))
    return flax_model, params, model.eval()


@pytest.mark.parametrize("mode,threshold,m_corr", [
    ("x0", False, 2), ("xt", False, 2),
    ("x0", False, 0), ("xt", False, 0),  # the in-loop corrections alone
    ("none", True, 0),
])
def test_corrected_sampling_trajectory_matches_jax(small_unet, mode, threshold, m_corr):
    flax_model, params, model = small_unet
    shape, key = (2, PS, PS, 2), jax.random.key(17)
    n_corr = 3 if mode != "none" else 0
    jphys = JaxDarcy(pixels_per_dim=PS)
    ref = jax.jit(lambda k: jsampling.p_sample_loop(
        jax_schedule(STEPS), lambda x, t: flax_model.apply(params, x, t), shape, k,
        use_dynamic_threshold=threshold, save_history=True,
        correction_fn=lambda x: jphys.residual_correction(x)[0], correction_mode=mode,
        n_correction=n_corr, m_correction=m_corr))(key)

    physics = DarcyResidual(pixels_per_dim=PS)
    x_init, noise = _jax_draws(key, shape, STEPS)
    with torch.no_grad():
        got = p_sample_loop(create_schedule(STEPS), model, torch.from_numpy(x_init),
                            torch.from_numpy(noise), use_dynamic_threshold=threshold,
                            save_history=True,
                            correction_fn=lambda x: physics.residual_correction(x)[0],
                            correction_mode=mode, n_correction=n_corr, m_correction=m_corr)
    assert got.history.shape == got.x0_history.shape == (STEPS, *shape)
    # fp32 on both sides: the small UNet's forward agrees to ~1e-6, and ten
    # steps of the posterior-mean recursion (and the corrections, which move
    # p by ~1e-6 of its gradient) carry that through
    for name in ("x", "x0_pred", "history", "x0_history"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    if m_corr:  # the M post-steps moved the final sample away from the loop's
        assert np.abs(got.x.numpy() - got.history[-1].numpy()).max() > 0
    elif mode != "none":  # the in-loop corrections moved the trajectory far beyond the tolerance
        with torch.no_grad():
            plain = p_sample_loop(create_schedule(STEPS), model, torch.from_numpy(x_init),
                                  torch.from_numpy(noise), save_history=True)
        for name in ("history", "x0_history"):
            moved = (getattr(got, name) - getattr(plain, name)).abs().max().item()
            assert moved >= 100 * 1e-5, f"{name} moved {moved:.3e}"
    if threshold:  # the threshold bounds every step's sample by 1
        assert np.abs(got.history.numpy()).max() <= 1.0
