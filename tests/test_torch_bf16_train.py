"""One bf16 training step of the port against the JAX package, on the CPU.

The study trains in bf16 (``RunConfig.compute_dtype``), with or without the
fp32 head. At a small UNet (DIM 8, P 16) both frameworks take one step from
the same weights on the same batch, t and noise, made with numpy: the
port's ``train_step`` with ``UNet(dtype=bfloat16)``, and JAX's
``make_train_step`` with ``UNet(dtype=bfloat16)``, each with the clip and
Adam of the study (the JAX step's gradient is read from the optimizer
state, where a pass-through transform after the clip keeps it).

The two bf16 paths round in different places (which ops run in bf16, where
the casts sit, the order of sums), and each rounds about as much as the
other, independently. So a side's own bf16 rounding, the gap between its
bf16 and fp32 step on the same inputs, is the yardstick:
  * the activations reach K1 and K2 in bf16, all but the fp32 head's two
    K2 calls (a port that quietly computes in fp32 passes every rule below,
    since it then lies one JAX rounding from JAX's bf16 step);
  * the fp32 losses agree to 1e-5, and the bf16 loss lies within 2x the
    larger of the two sides' rounding. The loss is one sum, so its rounding
    is one draw a side: with the fp32 head, JAX's bf16 loss is 8130.2 in its
    jitted train step and 8109.2 from ``apply`` alone (fp32 8134.2), and
    the port's 8090.1. With the fp32 losses equal, this bounds each bf16
    loss by its own rounding, no more. The gradients are what tell a wrong
    bf16 step:
  * the whole gradient before Adam (after the global-norm clip; every
    parameter's, as one vector) within 2x JAX's rounding plus 1e-3 of its
    norm, in the L2 norm;
  * each parameter's gradient within 6x JAX's rounding plus 1e-3 of its
    norm, in the L2 norm. A tensor whose gradient nearly cancels (a
    GroupNorm scale deep in the net) carries a rounding of 3-10% of its
    norm in both frameworks, and the two draws differ: over 12 seeds x 2
    head settings the worst tensor's gap was 1.35-4.09x JAX's rounding (the
    whole gradient's 0.43-0.67 of its limit).
Gradients are compared, not the weights after Adam: Adam scales each
gradient to a step of about lr whatever its size, so a gradient that is
zero but for rounding turns into a full step of random sign in either
framework.
Planted faults (a copy of the port, on the CPU): ``_conv`` computing in its
input's dtype (the fp32 input's convolutions stay fp32, and 6 of the 22
GroupNorm calls with them) fails the dtype check; the gradient of one
Block's GroupNorm scale zeroed in bf16 fails the per-parameter rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy
from physicsinformeddiffusionmodels_tpu.training import trainer as jt
from physicsinformeddiffusionmodels_tpu_torch.models import unet as port_unet
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from test_torch_training import DIM, MULTS, P, WEIGHTS, _flax_params, _port_loss_fn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# 4 groups of 2 channels at width 8, as in test_torch_training.py: with one
# channel per group the conv bias before the GroupNorm has a zero gradient
GROUPS = 4
LR, CLIP = 1e-4, 1.0


def _inputs():
    rng = np.random.default_rng(31)
    return (rng.standard_normal((2, P, P, 2)).astype(np.float32), rng.integers(0, 100, 2),
            rng.standard_normal((2, P, P, 2)).astype(np.float32))


def _flax(dtype=None, fp32_head=False):
    return FlaxUNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, dtype=dtype,
                    fp32_head=fp32_head)


def _jax_loss(flax_model):
    sched, physics = js.create_schedule(100), JaxDarcy(P)

    def loss(p, batch, key, step):
        x0, t, noise = batch
        return jl.pidm_loss(sched, x0, t, key, denoise_fn=lambda a, b: flax_model.apply(p, a, b),
                            physics_fn=physics, weights=jl.LossWeights(**WEIGHTS), noise=noise)

    return loss


def _kept():
    """A pass-through transform that keeps the update it is given in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def _jax_step(flax_model, params, batch):
    """(loss, the gradients after the global-norm clip) of one JAX
    ``make_train_step`` with the study's clip and Adam."""
    tx = optax.chain(optax.clip_by_global_norm(CLIP), _kept(), optax.adam(LR))
    step_fn = jt.make_train_step(_jax_loss(flax_model), tx, donate=False)
    state, aux = step_fn(jt.create_train_state(params, tx), batch, jax.random.key(0))
    grads = jax.tree_util.tree_map(np.asarray, state.opt_state[1])
    return float(aux.loss), torch_state_dict_from_flax(grads)


@pytest.fixture(scope="module")
def jax_fp32():
    """The weights, the batch, and JAX's fp32 step on them (the same for
    both head settings: an fp32 model has no separate head)."""
    params = _flax_params(_flax(), seed=32)
    batch = _inputs()
    return params, batch, _jax_step(_flax(), params, batch)


def _port_step(params, batch, dtype, fp32_head):
    model = UNet(dim=DIM, channels=2, dim_mults=MULTS, resnet_groups=GROUPS, dtype=dtype,
                 fp32_head=fp32_head)
    model.load_state_dict(torch_state_dict_from_flax(params))
    state = create_train_state(model, make_optimizer(model, LR, CLIP))
    x0, t, noise = (torch.from_numpy(np.asarray(a)) for a in batch)
    return state, train_step(state, _port_loss_fn(), x0, t, noise)


def _recording(fn, dtypes):
    def call(x, *args, **kwargs):
        dtypes.append(x.dtype)
        return fn(x, *args, **kwargs)

    return call


@pytest.mark.parametrize("fp32_head", [True, False])
def test_bf16_train_step_matches_jax_bf16(jax_fp32, fp32_head, monkeypatch):
    params, batch, (loss32, grads32) = jax_fp32
    loss16, grads16 = _jax_step(_flax(jnp.bfloat16, fp32_head), params, batch)
    port32 = _port_step(params, batch, None, False)[1].loss.item()

    k1, k2 = [], []
    monkeypatch.setattr(port_unet, "linear_attention_block",
                        _recording(port_unet.linear_attention_block, k1))
    monkeypatch.setattr(port_unet, "group_norm_film_silu",
                        _recording(port_unet.group_norm_film_silu, k2))
    state, aux = _port_step(params, batch, torch.bfloat16, fp32_head)
    assert k1 and set(k1) == {torch.bfloat16}, k1
    assert k2.count(torch.float32) == (2 if fp32_head else 0), k2
    assert k2.count(torch.bfloat16) == len(k2) - k2.count(torch.float32) > 0, k2
    # with fp32_head off the model's output is bf16; the loss is fp32 either way
    assert aux.loss.dtype == torch.float32
    port16 = aux.loss.item()
    np.testing.assert_allclose(port32, loss32, rtol=1e-5)
    limit = 2 * max(abs(loss16 - loss32), abs(port16 - port32))
    assert abs(port16 - loss16) <= limit, (port16, loss16, port32, loss32)

    names = []
    for name, p in state.model.named_parameters():
        ref, ref32 = grads16[name], grads32[name]
        if p.grad is None:  # the guidance-conditioning modules, unused by this loss
            assert not ref.abs().max() and not ref32.abs().max(), name
            continue
        assert p.grad.dtype == torch.float32, name
        gap, rounding = (p.grad - ref).norm().item(), (ref - ref32).norm().item()
        limit = 6 * rounding + 1e-3 * ref.norm().item()
        assert gap <= limit, f"{name}: |port - jax_bf16| {gap:.3e} > {limit:.3e}"
        names.append(name)
    assert len(names) > 60
    port = torch.cat([state.model.get_parameter(n).grad.flatten() for n in names])
    ref, ref32 = (torch.cat([g[n].flatten() for n in names]) for g in (grads16, grads32))
    gap, limit = (port - ref).norm().item(), 2 * (ref - ref32).norm().item() + 1e-3 * ref.norm()
    assert gap <= limit, f"whole gradient: |port - jax_bf16| {gap:.3e} > {limit:.3e}"
