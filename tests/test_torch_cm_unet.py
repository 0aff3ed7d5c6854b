"""The channel-major conv-stage UNet (``cm_conv_stages=True``) on the CPU:
the port against the JAX package's, whose channel-major stages take their
XLA reference path on the CPU (``conv_gn_film_silu_reference``, and K1's
reference on transposed tokens), and against the port's own default path.

A small UNet (DIM 8, mults (1, 2, 4), 16x16) runs every level stage
channel-major (all are narrower than 128 channels; the mid blocks stay
natural, as in JAX); the committed 300k checkpoint runs at full width, where
the 64x64 and 32x32 levels are channel-major.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu_torch.models import unet as port_unet
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN = Path(__file__).resolve().parent.parent / "results/darcy_300k_fp32head/portable"
# README "Parity": the transplant tolerance of the JAX package's own tests
TRANSPLANT_ATOL = 5e-4
DIM, MULTS, P = 8, (1, 2, 4), 16


def _inputs(b, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, p, p, 2)).astype(np.float32),
            rng.integers(0, 100, size=b).astype(np.int32))


def _random_params(flax_model, x, t, seed):
    """Random parameters of the Flax tree's shapes, biases included (the
    zero-initialised biases of an init would hide a bias that is dropped)."""
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), x, t)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(params, groups=8, **kw):
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=groups, **kw)
    sd = torch_state_dict_from_flax(params)
    assert sd.keys() == model.state_dict().keys()  # nothing missing, nothing unexpected
    model.load_state_dict(sd)
    return model


def test_small_cm_unet_matches_flax():
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, cm_conv_stages=True)
    x, t = _inputs(2, P, seed=1)
    params = _random_params(flax_model, x, t, seed=2)
    ref = np.asarray(jax.jit(flax_model.apply)(params, x, t))
    with torch.no_grad():
        got = _port(params, cm_conv_stages=True).eval()(torch.from_numpy(x),
                                                        torch.from_numpy(t).long())
    assert got.shape == ref.shape == (2, P, P, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=TRANSPLANT_ATOL, rtol=0)


def test_cm_forward_and_gradients_match_the_default_path():
    """The same weights through both layouts: the output and every
    parameter's gradient within 1e-4 of each tensor's max. Four groups of
    two channels at width 8: with one channel per group the conv bias before
    the GroupNorm has a zero gradient, whose rounding noise no tolerance
    relative to its max can hold."""
    x, t = _inputs(2, P, seed=3)
    params = _random_params(FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=4),
                            x, t, seed=4)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(x.shape).astype(np.float32))
    out, grads = {}, {}
    for cm in (False, True):
        model = _port(params, groups=4, cm_conv_stages=cm)
        y = model(torch.from_numpy(x), torch.from_numpy(t).long())
        (y * dy).sum().backward()
        out[cm] = y.detach()
        grads[cm] = {n: p.grad for n, p in model.named_parameters()}
    scale = out[False].abs().max().item()
    assert (out[True] - out[False]).abs().max().item() <= 1e-4 * scale
    compared = 0
    for name, g in grads[False].items():
        g_cm = grads[True][name]
        if g is None:  # the guidance-conditioning modules, unused by the forward
            assert g_cm is None, name
            continue
        scale = g.abs().max().item()
        err = (g_cm - g).abs().max().item()
        assert scale > 0 and err <= 1e-4 * scale, f"{name}: {err:.3e} vs max {scale:.3e}"
        compared += 1
    assert compared > 100


def test_checkpoint_cm_forward_matches_flax():
    params = load_checkpoint(RUN / "model/checkpoint_300000.msgpack")["ema_params"]
    x, t = _inputs(2, 64, seed=0)
    ref = np.asarray(jax.jit(FlaxUNet(dim=32, channels=2, cm_conv_stages=True).apply)(
        params, x, t))
    model = UNet(dim=32, channels=2, cm_conv_stages=True)
    model.load_state_dict(torch_state_dict_from_flax(params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, ref, atol=TRANSPLANT_ATOL, rtol=0)


def _recording(fn, calls):
    def call(x, *args, **kwargs):
        calls.append((x.dtype, args[0]))
        return fn(x, *args, **kwargs)

    return call


def test_bf16_fp32_head_cm_unet_matches_jax_bf16(monkeypatch):
    """bf16 compute with the fp32 head, channel-major stages on. The port's
    output lies within 2x JAX's own bf16 rounding (its bf16 output against
    its fp32 output) of JAX's bf16 output, as tests/test_torch_bf16.py holds
    the default path; the activations reach K4, K2 and K1 in bf16, all but
    the fp32 head's two K2 calls; and the gradient of every Block weight
    that K4 takes on bf16 x is rounded to bf16, as the TPU kernel's VJP
    returns dW in the dtype of the weight it was given."""
    x, t = _inputs(2, P, seed=7)
    flax_kw = dict(dim=DIM, channels=2, dim_mults=MULTS, cm_conv_stages=True)
    params = _random_params(FlaxUNet(**flax_kw), x, t, seed=8)
    jax_fp32 = np.asarray(jax.jit(FlaxUNet(**flax_kw).apply)(params, x, t), np.float32)
    jax_bf16 = np.asarray(jax.jit(FlaxUNet(**flax_kw, dtype=jnp.bfloat16, fp32_head=True).apply)(
        params, x, t), np.float32)

    k4, k2, k1 = [], [], []
    for name, calls in (("conv_gn_film_silu_cm", k4), ("group_norm_film_silu", k2),
                        ("linear_attention_block", k1)):
        monkeypatch.setattr(port_unet, name, _recording(getattr(port_unet, name), calls))
    model = _port(params, dtype=torch.bfloat16, fp32_head=True, cm_conv_stages=True)
    y = model(torch.from_numpy(x), torch.from_numpy(t).long())
    assert y.dtype == torch.float32 and y.shape == (2, P, P, 2)

    rounding = np.abs(jax_bf16 - jax_fp32).max()
    gap = np.abs(y.detach().numpy() - jax_bf16).max()
    assert 0 < gap <= 2 * rounding, (gap, rounding)

    # every level stage is channel-major: 2 ResnetBlocks x 2 Blocks x 6
    # stages through K4; the two mid ResnetBlocks and the fp32 head through K2
    assert len(k4) == 24 and {d for d, _ in k4} == {torch.bfloat16}, k4
    assert [d for d, _ in k2] == [torch.bfloat16] * 4 + [torch.float32] * 2, k2
    assert len(k1) == 6 and {d for d, _ in k1} == {torch.bfloat16}, k1

    y.square().sum().backward()
    for _, weight in k4:
        g = weight.grad
        assert g.dtype == torch.float32 and g.abs().max() > 0
        assert torch.equal(g, g.bfloat16().float()), "dW not rounded to bf16"
