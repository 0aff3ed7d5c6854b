"""The UNet's frame axis (x of [B, F, H, W, C]) on the CPU: the port against
the Flax UNet of the JAX package on the same carried weights, at the shape of
JAX's ``tests/test_unet.py::test_video_frames_path`` (B=1, F=3, 16x16): the
forward and the gradients of the input and of every parameter, the frame
attention's F > 1 tree (``RelativePositionBias_0``, ``Attention_0``) carried
by ``convert.py``; an F == 1 input keeps its frame axis; the F == 1 tree
refuses F > 1 and the F > 1 tree F == 1.

A small UNet (DIM 8, mults (1, 2), four groups of two channels, as
``test_torch_unet_options.py``): the frame path is the same at any width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import RelativePositionBias, UNet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DIM, MULTS, P, GROUPS = 8, (1, 2), 16, 4
B, F = 1, 3
# fp32 on both sides, summed in another order: the output within FWD_TOL of
# its largest entry, each gradient within GRAD_TOL of its own
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _random_params(flax_model, args, seed):
    """Random parameters of the Flax tree's shapes, biases included."""
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _case(frames, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, frames, P, P, 2)).astype(np.float32)
    t = rng.integers(0, 100, size=B).astype(np.int32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, t, dy


def _flax_model():
    return FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS)


def _port_model(params, multi_frame):
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS,
                 multi_frame=multi_frame)
    sd = torch_state_dict_from_flax(params)
    assert sd.keys() == model.state_dict().keys()  # nothing missing, nothing unexpected
    model.load_state_dict(sd)
    return model


def test_frames_match_flax_forward_and_gradients():
    x, t, dy = _case(F, seed=0)
    flax_model = _flax_model()
    params = _random_params(flax_model, (x, t), seed=1)
    frame_leaves = [k for k in torch_state_dict_from_flax(params) if "_frame_attn.fn." in k]
    assert sorted(frame_leaves) == sorted(
        f"{m}_frame_attn.fn.{leaf}" for m in ("init", "mid")
        for leaf in ("RelativePositionBias_0.Embed_0.embedding", "Attention_0.Dense_0.weight",
                     "Attention_0.Dense_1.weight"))

    @jax.jit
    def f(p, xx, cot):
        y, vjp = jax.vjp(lambda a, b: flax_model.apply(a, b, t), p, xx)
        return (y, *vjp(cot))

    ref_y, ref_gp, ref_gx = f(params, jnp.asarray(x), jnp.asarray(dy))
    ref_y, ref_gx = np.asarray(ref_y), np.asarray(ref_gx)
    ref_g = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref_gp))

    model = _port_model(params, multi_frame=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = model(xt, torch.from_numpy(t).long())
    (y * torch.from_numpy(dy)).sum().backward()
    assert y.shape == ref_y.shape == (B, F, P, P, 2)
    np.testing.assert_allclose(y.detach().numpy(), ref_y, atol=FWD_TOL * np.abs(ref_y).max(),
                               rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), ref_gx, atol=GRAD_TOL * np.abs(ref_gx).max(),
                               rtol=0)
    compared = 0
    for name, p in model.named_parameters():
        ref = ref_g[name].numpy()
        if p.grad is None:  # the guidance-conditioning modules, unused without cond
            assert not ref.any(), name
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=name)
        compared += 1
    assert compared > 60
    # the frames mix: a frame's output moves with another frame's input
    assert np.abs(xt.grad.numpy()[:, 1]).max() > 0
    with torch.no_grad():
        x2 = torch.from_numpy(x).clone()
        x2[:, 2] += 1.0
        moved = (model(x2, torch.from_numpy(t).long()) - y)[:, 0].abs().max().item()
    assert moved > 1e-3


def test_single_frame_keeps_its_frame_axis():
    x, t, _ = _case(1, seed=2)
    flax_model = _flax_model()
    params = _random_params(flax_model, (x, t), seed=3)
    ref = np.asarray(jax.jit(flax_model.apply)(params, x, t))
    model = _port_model(params, multi_frame=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
        flat = model(torch.from_numpy(x[:, 0]), torch.from_numpy(t).long()).numpy()
    assert got.shape == ref.shape == (B, 1, P, P, 2)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL * np.abs(ref).max(), rtol=0)
    np.testing.assert_array_equal(got[:, 0], flat)


def test_frame_trees_refuse_the_other_frame_count():
    t = torch.tensor([5])
    with pytest.raises(ValueError, match="F == 1"):
        UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS)(
            torch.zeros(B, F, P, P, 2), t)
    with pytest.raises(ValueError, match="F > 1"):
        UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, multi_frame=True)(
            torch.zeros(B, P, P, 2), t)


@pytest.mark.parametrize("n", [1, 3, 40])
def test_relative_position_bias_matches_flax(n):
    from physicsinformeddiffusionmodels_tpu.models.unet import (
        RelativePositionBias as FlaxRelativePositionBias,
    )

    flax_bias = FlaxRelativePositionBias(heads=8, max_distance=32)
    table = np.random.default_rng(n).standard_normal((32, 8)).astype(np.float32)
    ref = np.asarray(flax_bias.apply({"params": {"Embed_0": {"embedding": table}}}, n))
    bias = RelativePositionBias(8, max_distance=32)
    bias.Embed_0.embedding.data = torch.from_numpy(table)
    with torch.no_grad():
        np.testing.assert_array_equal(bias(n).numpy(), ref)
