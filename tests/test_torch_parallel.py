"""The port's parallel layer (``parallel/``) against the JAX package, on gloo
ranks of the CPU (``torch_ranks.spawn``): the mesh layout and the
tensor-parallel parameter rule; sequence-parallel linear attention at 4
ranks; three data-parallel train steps at 2 ranks and on a (slice, dp) =
(2, 2) mesh; the tensor-parallel UNet (its output, its gradients, each
rank's channels at the wide stages); the sequence-parallel UNet; and a
tensor-parallel checkpoint restored into one rank, and the reverse."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.ops.pallas_attention import (
    linear_attention_block_reference,
    linear_attention_reference,
)
from physicsinformeddiffusionmodels_tpu.parallel import mesh as jmesh
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch.models.convert import (
    flax_last_dim,
    torch_state_dict_from_flax,
)
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.parallel import mesh as pm
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from torch_ranks import Aux, dp_steps, spawn, world4_suite
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the UNet against Flax (test_torch_unet.py, test_torch_mechanics_unet.py):
# the forward within the transplant tolerance, each gradient within
# GRAD_TOL of its tensor's largest entry
TRANSPLANT_ATOL, GRAD_TOL = 5e-4, 1e-3


def _flax_params(flax_model, x, t, seed):
    """Random parameters of the Flax tree's shapes (biases and norms drawn
    too, so a bias that is dropped or not trained shows)."""
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), x, t)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key in ("gn_scale", "ln_gamma", "gamma"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _save_params(path, params):
    np.savez(path, **{k: v.numpy() for k, v in torch_state_dict_from_flax(params).items()})


def _unet_inputs(b, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, p, p, 2)).astype(np.float32),
            rng.integers(0, 100, b).astype(np.int64),
            rng.standard_normal((b, p, p, 2)).astype(np.float32))


def _prefixed(npz, prefix):
    return {k[len(prefix):]: v for k, v in npz.items() if k.startswith(prefix)}


# --- the mesh and the parameter rule (no ranks) ------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(dp=4, tp=2), dict(tp=4), dict(dp=3, tp=2),
                                dict(tp=2, n_slices=2), dict(tp=1, n_slices=3),
                                dict(dp=3, tp=1, n_slices=2), dict(dp=1, tp=2, n_slices=4)])
def test_mesh_layout_matches_jax(kw):
    devices = jax.devices()[:8]
    try:
        ref = jmesh.make_mesh(devices=devices, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            pm.mesh_layout(8, **kw)
        return
    names, ranks = pm.mesh_layout(8, **kw)
    assert names == tuple(ref.axis_names)
    np.testing.assert_array_equal(ranks, np.vectorize(lambda d: d.id)(ref.devices))


def _flax_shapes(flax_model, p, c):
    return jax.eval_shape(flax_model.init, jax.random.key(0), np.zeros((1, p, p, c)),
                          np.zeros((1,), np.int32))


@pytest.mark.parametrize("study", ["darcy", "mechanics"])
def test_param_partition_spec_matches_jax_on_every_leaf(study):
    if study == "darcy":
        flax_model, model, c = FlaxUNet(dim=32, channels=2), UNet(dim=32, channels=2), 2
    else:
        kw = dict(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True)
        flax_model, model, c = FlaxUNet(**kw), UNet(**kw), 10
    shapes = _flax_shapes(flax_model, 16, c)
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    for tp in (2, 4):
        for path, leaf in leaves:
            want = tuple(jmesh.param_partition_spec(path, leaf, tp))
            assert pm.param_partition_spec(leaf.shape, tp) == want, (path, tp)
    # the torch layout: the dim flax_last_dim names holds the Flax leaf's last axis
    sd = torch_state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    state = model.state_dict()
    assert set(sd) == set(state)
    split = 0
    for k, v in state.items():
        dim = flax_last_dim(k, v.ndim)
        assert v.shape[dim] == sd[k].shape[dim]
        split += v.numel() if pm.param_partition_spec(
            (*(s for i, s in enumerate(v.shape) if i != dim), v.shape[dim]), 2) else 0
    n_flax = sum(leaf.size for _, leaf in leaves)
    n_split = sum(leaf.size for path, leaf in leaves
                  if jmesh.param_partition_spec(path, leaf, 2) != jax.sharding.PartitionSpec())
    assert split == n_split and n_flax == sum(v.numel() for v in state.values())
    if study == "mechanics":
        assert (n_split, n_flax) == (131_627_520, 131_706_499)


# --- four ranks: one start for every check (torch_ranks.world4_suite) --------

SEQ_B, SEQ_N, SEQ_C = 2, 512, 32
DP_STEPS, DP_B, DP_P = 3, 4, 16


def _dp_inputs(workdir):
    flax_model = FlaxUNet(dim=8, channels=2, dim_mults=(1, 2), resnet_groups=4)
    params = _flax_params(flax_model, np.zeros((1, DP_P, DP_P, 2)), np.zeros((1,), np.int32), 11)
    rng = np.random.default_rng(12)
    steps = dict(x0=rng.standard_normal((DP_STEPS, DP_B, DP_P, DP_P, 2)).astype(np.float32),
                 t=rng.integers(0, 100, (DP_STEPS, DP_B)).astype(np.int64),
                 noise=rng.standard_normal((DP_STEPS, DP_B, DP_P, DP_P, 2)).astype(np.float32))
    _save_params(workdir / "dp_params.npz", params)
    np.savez(workdir / "dp_inputs.npz", **steps)
    return flax_model, params, steps


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Inputs written, the four ranks run (torch_ranks.world4_suite), the
    workdir returned with their outputs."""
    work = tmp_path_factory.mktemp("world4")
    rng = np.random.default_rng(0)
    h = 256
    np.savez(work / "seq_inputs.npz",
             x=rng.standard_normal((SEQ_B, SEQ_N, SEQ_C)).astype(np.float32),
             w_qkv=(rng.standard_normal((SEQ_C, 3 * h)) / np.sqrt(SEQ_C)).astype(np.float32),
             # scaled by N so that the attention term is O(1) beside x
             w_out=(rng.standard_normal((h, SEQ_C)) * SEQ_N / np.sqrt(h)).astype(np.float32),
             gamma=(1.0 + 0.1 * rng.standard_normal(SEQ_C)).astype(np.float32),
             b_out=(0.1 * rng.standard_normal(SEQ_C)).astype(np.float32),
             dy=rng.standard_normal((SEQ_B, SEQ_N, SEQ_C)).astype(np.float32))
    dp = _dp_inputs(work)
    x, t, dy = _unet_inputs(8, 16, 1)
    tp_flax = FlaxUNet(dim=32, channels=2, frame_attention=False)
    tp_params = _flax_params(tp_flax, x, t, 2)
    _save_params(work / "tp_params.npz", tp_params)
    np.savez(work / "tp_inputs.npz", x=x, t=t, dy=dy)
    # a one-rank checkpoint after one step, for the TP ranks to restore
    model = UNet(dim=32, channels=2, frame_attention=False)
    model.load_state_dict(torch_state_dict_from_flax(tp_params))
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0))

    def loss_fn(m, xx, tt, dd):
        loss = (m(xx, tt) * dd).mean()
        return loss, Aux(loss)

    train_step(state, loss_fn, *(torch.from_numpy(a) for a in (x, t, dy)), ema_start=0)
    save_checkpoint(work / "one_rank_ckpt", 1, model=state.model, ema=state.ema,
                    optimizer=state.optimizer)
    sp_flax = FlaxUNet(dim=16, channels=2, resnet_groups=8, frame_attention=False)
    xs, ts, dys = _unet_inputs(8, 16, 3)
    sp_params = _flax_params(sp_flax, xs, ts, 4)
    _save_params(work / "sp_params.npz", sp_params)
    np.savez(work / "sp_inputs.npz", x=xs, t=ts, dy=dys)
    spawn(world4_suite, 4, work)
    return dict(work=work, dp=dp, tp=(tp_flax, tp_params, x, t, dy),
                sp=(sp_flax, sp_params, xs, ts, dys))


@pytest.mark.parametrize("kind", ["la", "block"])
def test_sequence_sharded_attention_matches_jax(world4, kind):
    work = world4["work"]
    a = dict(np.load(work / "seq_inputs.npz"))
    outs = [dict(np.load(work / f"seq_out_{r}.npz")) for r in range(4)]

    def ref(x, gamma, w_qkv, w_out, b_out):
        if kind == "la":
            return linear_attention_reference(x, w_qkv, w_out, 8, 32)
        return linear_attention_block_reference(x, gamma, w_qkv, w_out, b_out, 8, 32)

    names = ("x", "gamma", "w_qkv", "w_out", "b_out")
    y, vjp = jax.vjp(ref, *(jnp.asarray(a[k]) for k in names))
    grads = dict(zip(names, vjp(jnp.asarray(a["dy"]))))
    got = np.concatenate([o[f"{kind}_y"] for o in outs], axis=1)
    # JAX's own test of its sequence-sharded attention holds the forward to 2e-5
    np.testing.assert_allclose(got, np.asarray(y), atol=2e-5, rtol=0)
    assert np.abs(np.asarray(y) - a["x"]).max() > 0.1  # the attention term counts
    dx = np.concatenate([o[f"{kind}_dx"] for o in outs], axis=1)
    np.testing.assert_allclose(dx, np.asarray(grads["x"]), atol=GRAD_TOL * np.abs(
        np.asarray(grads["x"])).max(), rtol=0)
    weights = ("w_qkv", "w_out") if kind == "la" else ("gamma", "w_qkv", "w_out", "b_out")
    for k in weights:
        ref_g = np.asarray(grads[k])
        for o in outs:  # every rank holds the whole weight gradient
            np.testing.assert_allclose(o[f"{kind}_d{k}"], ref_g,
                                       atol=GRAD_TOL * np.abs(ref_g).max(), rtol=0, err_msg=k)


def _jax_dp_reference(flax_model, params, steps):
    sched, physics = js.create_schedule(100), JaxDarcy(DP_P)

    def jax_loss(p, batch, key, step):
        x0, t, noise = batch
        return jl.pidm_loss(sched, x0, t, key, denoise_fn=lambda a, b: flax_model.apply(p, a, b),
                            physics_fn=physics,
                            weights=jl.LossWeights(c_data=1.0, c_residual=1e-3), noise=noise)

    tx = jt.make_optimizer(1e-4, 1.0)
    step_fn = jt.make_train_step(jax_loss, tx, ema_mu=0.99, ema_start=1, donate=False)
    state, losses = jt.create_train_state(params, tx), []
    for i in range(DP_STEPS):
        state, aux = step_fn(state, tuple(steps[k][i] for k in ("x0", "t", "noise")),
                             jax.random.key(0))
        losses.append(float(aux.loss))
    return losses, state


def _hold_dp_steps(out, reference):
    losses, jstate = reference
    # the tolerances of test_torch_training.py's three-step parity test
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    for prefix, ref in (("params/", jstate.params), ("ema/", jstate.ema_params)):
        ref_sd = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref))
        got = _prefixed(out, prefix)
        assert set(got) == set(ref_sd)
        for k, v in got.items():
            np.testing.assert_allclose(v, ref_sd[k].numpy(), atol=5e-6, rtol=0,
                                       err_msg=f"{prefix}{k}")


@pytest.fixture(scope="module")
def dp_reference(world4):
    return _jax_dp_reference(*world4["dp"])


def test_dp_steps_on_a_slice_mesh_match_jax(world4, dp_reference):
    _hold_dp_steps(dict(np.load(world4["work"] / "dp_out_2.npz")), dp_reference)


def test_dp_steps_at_two_ranks_match_jax(tmp_path, dp_reference):
    _dp_inputs(tmp_path)
    spawn(dp_steps, 2, tmp_path)
    _hold_dp_steps(dict(np.load(tmp_path / "dp_out_1.npz")), dp_reference)


def _assert_unet_matches_jax(flax_model, params, x, t, dy, out, y_atol):
    """The ranks' gathered output, input gradient and parameter gradients
    of sum(out * dy) (``out``) against JAX's single-device vjp."""
    def f(p, xx):
        return flax_model.apply(p, xx, t)

    y, (g_params, g_x) = jax.jit(lambda p, xx, d: (lambda yv: (yv[0], yv[1](d)))(
        jax.vjp(f, p, xx)))(params, jnp.asarray(x), jnp.asarray(dy))
    np.testing.assert_allclose(out["y"], np.asarray(y), atol=y_atol, rtol=0)
    np.testing.assert_allclose(out["dx"], np.asarray(g_x),
                               atol=GRAD_TOL * np.abs(np.asarray(g_x)).max(), rtol=0)
    ref_g = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_params))
    got = _prefixed(out, "grad/")
    compared = 0
    for k, ref in ref_g.items():
        scale = ref.abs().max().item()
        if k not in got:  # the guidance-conditioning modules, unused
            assert scale == 0, k
            continue
        err = np.abs(got[k] - ref.numpy()).max()
        assert err <= GRAD_TOL * scale, f"{k}: {err:.3e} > {GRAD_TOL} x {scale:.3e}"
        compared += 1
    assert compared > 100


def test_tp_unet_matches_jax(world4):
    _assert_unet_matches_jax(*world4["tp"], dict(np.load(world4["work"] / "tp_out.npz")),
                             TRANSPLANT_ATOL)


def test_tp_unet_wide_stages_hold_their_channels(world4):
    """tp_min_width 32: every ResnetBlock and LinearAttentionBlock of the
    level and mid stages returns C / 2 channels on each rank; the head's
    ResnetBlock, which JAX does not constrain, the whole."""
    model = UNet(dim=32, channels=2, frame_attention=False)
    widths = {name: m.Block_1.weight.shape[0] if hasattr(m, "Block_1") else m.b_out.shape[0]
              for name, m in model.named_modules() if hasattr(m, "Block_1") or
              hasattr(m, "ln_gamma")}
    for r in range(4):
        channels = dict(np.load(world4["work"] / f"tp_channels_{r}.npz"))
        assert set(channels) == set(widths)
        for name, width in widths.items():
            want = width if name == "final_block" else width // 2
            assert int(channels[name]) == want, (r, name)


def test_tp_checkpoint_restores_into_one_rank_and_back(world4):
    work = world4["work"]
    raw = load_checkpoint(latest_checkpoint(work / "tp_ckpt"))
    model = UNet(dim=32, channels=2, frame_attention=False)
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0))
    restore_train_state(work / "tp_ckpt", state)
    assert state.step == 2 and state.optimizer.count == 1
    for k, v in torch_state_dict_from_flax(raw["params"]).items():
        assert torch.equal(state.model.state_dict()[k], v), k
    # the TP step moved the weights as a one-rank step does (Adam's first
    # step is about lr = 1e-4 an entry)
    tp_flax, params, x, t, dy = world4["tp"]
    ref = UNet(dim=32, channels=2, frame_attention=False)
    ref.load_state_dict(torch_state_dict_from_flax(params))
    ref_state = create_train_state(ref, make_optimizer(ref, 1e-4, 1.0))

    def loss_fn(m, xx, tt, dd):
        loss = (m(xx, tt) * dd).mean()
        return loss, Aux(loss)

    train_step(ref_state, loss_fn, *(torch.from_numpy(a) for a in (x, t, dy)), ema_start=0)
    for k, v in ref_state.model.state_dict().items():
        np.testing.assert_allclose(state.model.state_dict()[k].numpy(), v.numpy(), atol=5e-6,
                                   rtol=0, err_msg=k)
    # a one-rank checkpoint, restored on the TP ranks and saved again, is unchanged
    first = load_checkpoint(latest_checkpoint(work / "one_rank_ckpt"))
    again = load_checkpoint(latest_checkpoint(work / "one_rank_ckpt_again"))
    assert again["step"] == first["step"]
    for part in ("params", "ema_params"):
        a, b = (jax.tree_util.tree_leaves_with_path(c[part]) for c in (first, again))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, u), (_, v) in zip(a, b):
            np.testing.assert_array_equal(u, v, err_msg=f"{part} {path}")
    for name, entry in first["opt_state"]["state"].items():
        for k, v in entry.items():
            np.testing.assert_array_equal(again["opt_state"]["state"][name][k], v,
                                          err_msg=f"{name} {k}")


def test_sp_unet_matches_jax(world4):
    # JAX's own test of its sequence-parallel UNet holds the output to 3e-5
    _assert_unet_matches_jax(*world4["sp"], dict(np.load(world4["work"] / "sp_out.npz")),
                             3e-5)
