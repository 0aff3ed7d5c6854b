"""The port's residual-gradient guidance against the JAX package: the
residual gradient, the UNet's conditioning path (masked and unmasked), the
committed guided checkpoint's forward at full width, two-pass guidance, and
three guided trainer steps with the same batches, t, noise and mask."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.models.unet import (
    apply_with_guidance as flax_apply_with_guidance,
)
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import (
    UNet,
    apply_with_guidance,
    build_model,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
GUIDED = ROOT / "results/darcy_guided_100k/portable"
P, DIM, MULTS = 16, 8, (1, 2)
# residual gradient and cond forward: within TOL x the largest entry (fp32)
TOL = 1e-5
# README "Parity": the transplant tolerance of the JAX package's own tests
TRANSPLANT_ATOL = 5e-4


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} x {scale:.3e}"


def _fields(b, seed, p=P):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, p, p, 2)).astype(np.float32)
    x[..., 1] = np.exp(0.3 * x[..., 1])  # a positive permeability
    return x


def _models(seed, groups=8):
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=groups)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), np.zeros((1, P, P, 2)),
                            np.zeros((1,), np.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=groups)
    model.load_state_dict(torch_state_dict_from_flax(params))
    return flax_model, params, model


@pytest.mark.parametrize("b", [1, 3])
def test_residual_gradient_matches_jax(b):
    x = _fields(b, seed=1)
    ref = JaxDarcy(P).residual_gradient(jnp.asarray(x))
    got = DarcyResidual(P).residual_gradient(torch.from_numpy(x))
    _close(got.numpy(), ref, "d mean|r| / dx")
    # under no_grad too (the sampler's), with no graph to the input
    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        again = DarcyResidual(P).residual_gradient(xt)
    assert torch.equal(again, got) and not again.requires_grad


@pytest.mark.parametrize("mask", ["none", "mixed", "all"])
def test_cond_forward_matches_flax(mask):
    """The conditioning branch with a mask of mixed 0s and 1s (JAX's draw of
    ``null_cond_prob`` 0.5 handed to the port), none, and every sample
    masked (``null_cond_prob`` 1)."""
    flax_model, params, model = _models(2)
    x = _fields(4, seed=3)
    t = np.array([0, 17, 50, 99], np.int32)
    cond = np.array(JaxDarcy(P).residual_gradient(jnp.asarray(x)))
    prob = {"none": 0.0, "mixed": 0.5, "all": 1.0}[mask]
    key = jax.random.key(4)
    ref = np.asarray(jax.jit(lambda p, a, b, c: flax_model.apply(
        p, a, b, cond=c, null_cond_prob=prob, rng=key))(params, x, t, cond))
    null = np.array(jax.random.uniform(key, (4,)) < prob) if prob < 1 else np.ones(4, bool)
    if mask == "mixed":
        assert 0 < null.sum() < 4
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), cond=torch.from_numpy(cond),
                    null_mask=torch.from_numpy(null)).numpy()
        plain = model(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    _close(got, ref, f"cond forward, mask {mask}")
    # the branch changes the output even where every sample is masked
    assert np.abs(got - plain).max() > 1e-3


def test_guided_checkpoint_forward_matches_flax():
    """The committed guided run's EMA weights at full width, conditioned on
    the residual gradient, and the two-pass guidance at scale 3."""
    cfg = RunConfig.load(GUIDED / "config.json")
    assert cfg.residual_grad_guidance
    params = load_checkpoint(GUIDED / "model/checkpoint_100000.msgpack")["ema_params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    model = build_model(cfg, "float32")
    model.load_state_dict(torch_state_dict_from_flax(params))
    x = _fields(2, seed=5, p=64)
    t = np.array([3, 71], np.int32)
    cond = np.array(JaxDarcy(64).residual_gradient(jnp.asarray(x)))
    flax_model = FlaxUNet(dim=32, channels=2)
    ref = np.asarray(jax.jit(lambda p, a, b, c: flax_apply_with_guidance(
        flax_model, p, a, b, c, 3.0))(params, x, t, cond))
    with torch.no_grad():
        got = apply_with_guidance(model.eval(), torch.from_numpy(x), torch.from_numpy(t).long(),
                                  torch.from_numpy(cond), 3.0).numpy()
        one = apply_with_guidance(model, torch.from_numpy(x), torch.from_numpy(t).long(),
                                  torch.from_numpy(cond), 1.0).numpy()
        cond_pass = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                          cond=torch.from_numpy(cond)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, ref, atol=TRANSPLANT_ATOL, rtol=0)
    np.testing.assert_array_equal(one, cond_pass)  # one pass at scale 1


def test_guided_sampling_denoiser_matches_jax():
    """The sampler's denoiser of a guided run (JAX ``train.py``'s: both passes
    at every scale) on one state."""
    flax_model, params, model = _models(6)
    x = _fields(3, seed=7)
    t = np.full(3, 40, np.int32)
    physics = JaxDarcy(P)

    def jax_denoise(p, xx, tt):
        dr_dx = physics.residual_gradient(xx)
        logits = flax_model.apply(p, xx, tt, cond=dr_dx, null_cond_prob=0.0)
        null_logits = flax_model.apply(p, xx, tt, cond=dr_dx, null_cond_prob=1.0)
        return null_logits + (logits - null_logits) * 2.5

    ref = np.asarray(jax.jit(jax_denoise)(params, x, t))
    with torch.no_grad():
        got = sample_eval.guided_denoise(model, DarcyResidual(P), 2.5)(
            torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    _close(got, ref, "guided denoiser", tol=1e-4)


def test_three_guided_train_steps_match_jax():
    """As ``test_torch_training.py::test_three_train_steps_match_jax``, with
    guidance: every model call conditioned on the residual gradient of x_t,
    under one null mask a step (JAX's draw handed to the port)."""
    flax_model, params, model = _models(11, groups=4)
    rng = np.random.default_rng(12)
    prob = 0.5
    keys = [jax.random.key(40 + i) for i in range(3)]
    steps = [(_fields(2, seed=13 + i), rng.integers(0, 100, 2),
              rng.standard_normal((2, P, P, 2)).astype(np.float32)) for i in range(3)]
    sched, physics = js.create_schedule(100), JaxDarcy(P)
    weights = dict(c_data=1.0, c_residual=1e-3)

    def jax_loss(p, batch, key, step):
        x0, t, noise, m_key = batch

        def denoise(x, tt):
            return flax_model.apply(p, x, tt, cond=physics.residual_gradient(x),
                                    null_cond_prob=prob, rng=m_key)

        return jl.pidm_loss(sched, x0, t, key, denoise_fn=denoise, physics_fn=physics,
                            weights=jl.LossWeights(**weights), noise=noise)

    tx = jt.make_optimizer(1e-4, 1.0)
    step_fn = jt.make_train_step(jax_loss, tx, ema_mu=0.99, ema_start=1, donate=False)
    jstate = jt.create_train_state(params, tx)
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0))
    cfg = RunConfig(residual_grad_guidance=True, null_cond_prob=prob, pixels_per_dim=P,
                    unet_dim=DIM, compute_dtype="float32", **weights)
    loss_fn = train.build_darcy_loss_fn(ts.create_schedule(100), DarcyResidual(P), cfg)
    masks = []
    for (x0, t, noise), key in zip(steps, keys):
        mask = np.array(jax.random.uniform(key, (2,)) < prob)
        masks.append(mask)
        jstate, jaux = step_fn(jstate, (x0, t, noise, key), jax.random.key(0))
        aux = train_step(state, loss_fn, torch.from_numpy(x0), torch.from_numpy(t),
                         torch.from_numpy(noise), torch.from_numpy(mask), ema_mu=0.99,
                         ema_start=1)
        np.testing.assert_allclose(aux.loss.item(), float(jaux.loss), rtol=1e-5)
    assert any(m.any() for m in masks) and any((~m).any() for m in masks)
    # the trainer-parity tolerance of test_torch_training.py (5% of an Adam step)
    for name, mine, ref in (("params", state.model, jstate.params),
                            ("ema", state.ema, jstate.ema_params)):
        ref_sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        for k, v in mine.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=5e-6, rtol=0,
                                       err_msg=f"{name} {k}")
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, torch_state_dict_from_flax(params)[k])]
    assert any(k.startswith(("emb_conv", "combine_conv")) for k in moved)


def test_guided_train_cli_and_guided_sample_eval_on_the_cpu(tmp_path):
    """The train CLI with --residual-grad-guidance for 2 steps, then the port's
    sample_eval of its checkpoint at --guidance-scale 1.5, whose
    eval_settings.json carries every key of the JAX ``sample_eval.py``'s."""
    from physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator import generate_dataset

    for split, n, seed in (("train", 4, 1), ("valid", 2, 100)):
        generate_dataset(n, pixels_per_dim=P, q=16, base_seed=seed, out_dir=tmp_path / split)
    args = ["--pixels-per-dim", str(P), "--data-dir", str(tmp_path / "train"),
            "--valid-data-dir", str(tmp_path / "valid"), "--output-dir", str(tmp_path / "out"),
            "--batch-size", "2", "--sample-freq", "2", "--test-eval-freq", "1",
            "--log-freq", "1", "--no-samples", "2", "--device", "cpu", "--name", "guided",
            "--compute-dtype", "float32", "--residual-grad-guidance", "--iterations", "1"]
    cfg = train.config_from_args(train.parse_args(args))
    cfg.unet_dim, cfg.diff_steps = DIM, 4
    state = train.run_darcy(cfg, "cpu")
    assert state.step == 2
    moved = [n for n, p in state.model.named_parameters() if n.startswith("emb_conv")]
    assert moved and all(p.grad is not None for n, p in state.model.named_parameters()
                         if n.startswith(("emb_conv", "combine_conv")))
    run = tmp_path / "out" / "guided"
    out = tmp_path / "eval"
    argv = ["--model-dir", str(run), "--no-samples", "2", "--device", "cpu", "--seed", "1",
            "--guidance-scale", "1.5", "--out", str(out)]
    sample_eval.main(argv)
    settings = json.loads((out / "eval_settings.json").read_text())
    jax_keys = {"argv", "model_dir", "checkpoint_step", "no_samples", "test_batches", "seed",
                "correction_mode", "M_correction", "N_correction", "guidance_scale",
                "use_dynamic_threshold", "compute_dtype", "platform", "device_kind", "n_devices"}
    assert jax_keys <= set(settings)
    assert settings["argv"] == argv and settings["guidance_scale"] == 1.5
    assert (settings["platform"], settings["n_devices"], settings["test_batches"]) == ("cpu", 1,
                                                                                       None)
    assert settings["residual_grad_guidance"] and settings["checkpoint_step"] == 1
    assert not (out / "eval_settings.json.pending").exists()
    assert np.isfinite(np.loadtxt(out / "validation" / "sample_0" / "sample_0.csv",
                                  delimiter=",")).all()
