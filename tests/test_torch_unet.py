"""The port's UNet, loaded through ``convert.py``, against the Flax forward on
the same inputs: the committed 300k Darcy checkpoint at full width, and a
randomly initialised small UNet with Upsample stages (a missing
ConvTranspose kernel flip fails it)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet, build_model
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
RUN = ROOT / "results/darcy_300k_fp32head/portable"
# README "Parity": the transplant tolerance of the JAX package's own tests
TRANSPLANT_ATOL = 5e-4


def _inputs(b, p, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, p, p, c)).astype(np.float32)
    t = rng.integers(0, 100, size=b).astype(np.int32)
    return x, t


def _torch_forward(model, x, t):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()


def test_checkpoint_forward_matches_flax():
    cfg = RunConfig.load(RUN / "config.json")
    params = load_checkpoint(RUN / "model/checkpoint_300000.msgpack")["ema_params"]
    model = build_model(cfg, "float32")
    model.load_state_dict(torch_state_dict_from_flax(params))
    x, t = _inputs(2, 64, 2, seed=0)
    ref = np.asarray(jax.jit(FlaxUNet(dim=32, channels=2).apply)(params, x, t))
    got = _torch_forward(model.eval(), x, t)
    assert got.shape == ref.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, ref, atol=TRANSPLANT_ATOL, rtol=0)


@pytest.mark.parametrize("frame_attention", [True, False])
def test_random_small_unet_matches_flax(frame_attention):
    flax_model = FlaxUNet(dim=8, channels=2, dim_mults=(1, 2, 4),
                          frame_attention=frame_attention)
    x, t = _inputs(2, 16, 2, seed=1)
    # random parameters of the Flax tree's shapes, biases included (the
    # zero-initialised biases of an init would hide a bias that is dropped)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), x, t)
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)

    model = UNet(dim=8, channels=2, dim_mults=(1, 2, 4), frame_attention=frame_attention)
    assert sum(1 for k in model.state_dict() if k.startswith("Upsample_")) == 4
    model.load_state_dict(torch_state_dict_from_flax(params))
    ref = np.asarray(jax.jit(flax_model.apply)(params, x, t))
    got = _torch_forward(model.eval(), x, t)
    np.testing.assert_allclose(got, ref, atol=TRANSPLANT_ATOL, rtol=0)


def test_state_dict_covers_every_flax_leaf():
    params = load_checkpoint(RUN / "model/checkpoint_300000.msgpack")["ema_params"]
    sd = torch_state_dict_from_flax(params)
    model = UNet(dim=32, channels=2)
    assert sd.keys() == model.state_dict().keys()
    assert len(sd) == 271
    assert sum(v.numel() for v in sd.values()) == sum(p.numel() for p in model.parameters())
