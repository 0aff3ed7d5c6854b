"""The UNet's circular padding (``bcs='periodic'``) and self-conditioning on
the CPU: the port against the Flax UNet of the JAX package on the same
carried weights, forward and the gradients of the input and of every
parameter; a circular UNet with ``cm_conv_stages`` runs the default Blocks,
as JAX's ``_use_cm`` has it; and ``build_model`` builds both options from a
``RunConfig``.

A small UNet (DIM 8, mults (1, 2), 16x16, four groups of two channels: with
one channel a group the conv bias before the GroupNorm has a zero gradient,
whose rounding noise no tolerance relative to its max can hold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu_torch import train
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet, build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DIM, MULTS, P, GROUPS = 8, (1, 2), 16, 4
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


def _case(seed, self_cond_given=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, P, P, 2)).astype(np.float32)
    t = rng.integers(0, 100, size=2).astype(np.int32)
    sc = rng.standard_normal(x.shape).astype(np.float32) if self_cond_given else None
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, t, sc, dy


def _flax_reference(flax_model, params, x, t, sc, dy):
    """Flax's output and the gradients of <y, dy> with respect to the
    parameters (in the port's layout) and to x."""
    @jax.jit
    def f(p, xx, cot):
        y, vjp = jax.vjp(lambda a, b: flax_model.apply(a, b, t, x_self_cond=sc), p, xx)
        return (y, *vjp(cot))

    y, g_params, g_x = f(params, jnp.asarray(x), jnp.asarray(dy))
    return (np.asarray(y), torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_params)),
            np.asarray(g_x))


def _port_run(params, x, t, sc, dy, **kw):
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, **kw)
    sd = torch_state_dict_from_flax(params)
    assert sd.keys() == model.state_dict().keys()  # nothing missing, nothing unexpected
    model.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = model(xt, torch.from_numpy(t).long(),
              x_self_cond=None if sc is None else torch.from_numpy(sc))
    (y * torch.from_numpy(dy)).sum().backward()
    return y.detach(), {n: p.grad for n, p in model.named_parameters()}, xt.grad


def _hold(flax_kw, port_kw, seed, self_cond_given=False):
    x, t, sc, dy = _case(seed, self_cond_given)
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, **flax_kw)
    params = _random_params(flax_model, (x, t), seed + 100)
    ref_y, ref_g, ref_gx = _flax_reference(flax_model, params, x, t, sc, dy)
    y, grads, gx = _port_run(params, x, t, sc, dy, **port_kw)
    assert y.shape == ref_y.shape == (2, P, P, 2)
    np.testing.assert_allclose(y.numpy(), ref_y, atol=FWD_TOL * np.abs(ref_y).max(), rtol=0)
    np.testing.assert_allclose(gx.numpy(), ref_gx, atol=GRAD_TOL * np.abs(ref_gx).max(), rtol=0)
    compared = 0
    for name, g in grads.items():
        ref = ref_g[name].numpy()
        if g is None:  # the guidance-conditioning modules, unused without cond
            assert not ref.any(), name
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), ref, atol=GRAD_TOL * scale, rtol=0, err_msg=name)
        compared += 1
    assert compared > 60
    return y


def test_circular_unet_matches_flax():
    """Every spatial padding wraps: the init conv, the Blocks, Downsample
    and Upsample (pre-pad, VALID transposed conv, crop)."""
    y = _hold({"padding_mode": "circular"}, {"padding_mode": "circular"}, seed=1)
    # the wrap is seen: the zero-padded UNet on the same weights differs
    x, t, _, _ = _case(1)
    params = _random_params(FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS,
                                     resnet_groups=GROUPS), (x, t), 101)
    zero = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS)
    zero.load_state_dict(torch_state_dict_from_flax(params))
    with torch.no_grad():
        assert (zero(torch.from_numpy(x), torch.from_numpy(t).long()) - y).abs().max() > 1e-2


@pytest.mark.parametrize("self_cond_given", [False, True], ids=["zeros", "given"])
def test_self_conditioned_unet_matches_flax(self_cond_given):
    """x_self_cond (zeros when None) before x: the init conv takes 4 inputs."""
    _hold({"self_condition": True}, {"self_condition": True}, seed=2,
          self_cond_given=self_cond_given)


def test_circular_cm_unet_runs_the_default_blocks():
    """``cm_conv_stages`` with circular padding: no stage runs channel-major
    (K4 pads with zeros only), so the output is the default path's, bit for
    bit; with zero padding the flag does change the path."""
    x, t, _, _ = _case(3)
    params = _random_params(FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS,
                                     resnet_groups=GROUPS), (x, t), 103)
    outs = {}
    for mode in ("circular", "zeros"):
        model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS,
                     padding_mode=mode)
        model.load_state_dict(torch_state_dict_from_flax(params))
        with torch.no_grad():
            for cm in (False, True):
                model.cm_conv_stages = cm
                assert model._use_cm(DIM, torch.zeros(1, P, P, DIM)) == (cm and mode == "zeros")
                outs[mode, cm] = model(torch.from_numpy(x), torch.from_numpy(t).long())
    assert torch.equal(outs["circular", True], outs["circular", False])
    assert not torch.equal(outs["zeros", True], outs["zeros", False])


@pytest.mark.parametrize("bcs,self_condition", [("periodic", False), ("none", True),
                                                ("periodic", True)])
def test_build_model_accepts_both_options(bcs, self_condition):
    cfg = RunConfig(unet_dim=DIM, bcs=bcs, self_condition=self_condition)
    model = build_model(cfg)
    assert model.padding_mode == ("circular" if bcs == "periodic" else "zeros")
    assert model.self_condition == self_condition
    assert model.init_conv.Conv_0.in_channels == (4 if self_condition else 2)
    # the residual of a periodic run wraps its finite differences
    wraps = train.make_physics(cfg, "cpu").grads.Dc0[0, -1].item() != 0
    assert wraps == (bcs == "periodic")
    with torch.no_grad():
        y = model(torch.zeros(1, P, P, 2), torch.zeros(1, dtype=torch.long))
    assert y.shape == (1, P, P, 2) and torch.isfinite(y).all()


@pytest.mark.parametrize("kw", [{"init_dim": 12}, {"use_sparse_linear_attn": False},
                                {"cond_path": False},
                                {"init_dim": 12, "use_sparse_linear_attn": False,
                                 "cond_path": False}],
                         ids=["init_dim", "no_linear_attn", "no_cond_path", "all_three"])
def test_unet_build_options_match_flax(kw):
    """``init_dim`` (the init conv, the init frame attention and the cond
    modules at 12 channels, the first level 12 -> 8, the final block 24 ->
    8), ``use_sparse_linear_attn=False`` (no LinearAttentionBlock_<i> in the
    tree) and ``cond_path=False`` (no emb_conv_* or combine_conv): the
    forward and every gradient against Flax's UNet of the same fields."""
    _hold(kw, kw, seed=4)
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, **kw)
    names = [n.split(".")[0] for n in model.state_dict()]
    assert any(n.startswith("LinearAttentionBlock") for n in names) == kw.get(
        "use_sparse_linear_attn", True)
    assert ("emb_conv_0" in names) == ("combine_conv" in names) == kw.get("cond_path", True)
    assert model.init_conv.Conv_0.out_channels == kw.get("init_dim", DIM)


def test_cond_is_ignored_without_the_cond_path():
    """A UNet built with ``cond_path=False`` ignores ``cond``, as JAX's
    does: its output with a cond equals Flax's with and its own without."""
    x, t, _, _ = _case(6)
    cond = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    flax_model = FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS,
                          cond_path=False)
    params = _random_params(flax_model, (x, t), 106)
    ref = np.asarray(flax_model.apply(params, x, t, cond=cond))
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, cond_path=False)
    model.load_state_dict(torch_state_dict_from_flax(params))
    with torch.no_grad():
        y = model(torch.from_numpy(x), torch.from_numpy(t).long(), cond=torch.from_numpy(cond))
        y0 = model(torch.from_numpy(x), torch.from_numpy(t).long())
    assert torch.equal(y, y0)
    np.testing.assert_allclose(y.numpy(), ref, atol=FWD_TOL * np.abs(ref).max(), rtol=0)


def test_unconditioned_matches_condpath_free():
    """JAX's case on the port: with cond=None the output does not depend on
    the (dead) cond-path parameters."""
    torch.manual_seed(0)
    m1, m2 = UNet(dim=DIM, channels=2, cond_path=True), UNet(dim=DIM, channels=2, cond_path=False)
    m2.load_state_dict({k: v for k, v in m1.state_dict().items()
                        if not k.startswith(("emb_conv", "combine_conv"))})
    x = torch.randn(1, P, P, 2, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(m1(x, torch.tensor([1])), m2(x, torch.tensor([1])),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("padding_mode", ["circular", "zeros"])
def test_circular_padding_shift_equivariance(padding_mode):
    """JAX's two cases on the port: with circular padding the
    attention-free UNet commutes with cyclic shifts by a multiple of its
    total stride (2^3); with zero padding it does not."""
    torch.manual_seed(0)
    model = UNet(dim=DIM, channels=2, padding_mode=padding_mode,
                 use_sparse_linear_attn=False, frame_attention=False)
    x = torch.randn(1, P, P, 2, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([5])
    shift = 8 if padding_mode == "circular" else 4
    with torch.no_grad():
        y, y_s = model(x, t), model(torch.roll(x, shift, dims=1), t)
    diff = (torch.roll(y, shift, dims=1) - y_s).abs().max().item()
    if padding_mode == "circular":
        assert diff <= 1e-4
    else:
        assert diff > 1e-3
