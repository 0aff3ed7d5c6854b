"""Ranks of ``torch.distributed`` on the CPU for the port's parallel tests.

``spawn(fn, world, workdir)`` starts ``world`` processes (the ``spawn``
start method), each joins a gloo process group through a ``file://`` store
in ``workdir`` (no TCP port, which the test workers would race for), runs
``fn(rank, world, workdir)`` on one torch thread, and leaves. A rank that
fails, or a run past ``timeout``, fails the test.

This module imports torch and the port only, never JAX: the rank
functions below run in the spawned processes, read their inputs from
``.npz`` files the test wrote into ``workdir`` and write their results
there, and the test compares those with the JAX package.
"""

from __future__ import annotations

import datetime
import time
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from physicsinformeddiffusionmodels_tpu_torch.diffusion import losses as tl
from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
from physicsinformeddiffusionmodels_tpu_torch.models.unet import (
    LinearAttentionBlock,
    ResnetBlock,
    UNet,
)
from physicsinformeddiffusionmodels_tpu_torch.parallel import mesh as pm
from physicsinformeddiffusionmodels_tpu_torch.parallel.seq_attention import (
    sequence_sharded_linear_attention,
    sequence_sharded_linear_attention_block,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    restore_train_state,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)


def _rank_main(rank: int, world: int, workdir: str, store: str, fn) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, world, Path(workdir))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, workdir: Path, timeout: float = 240.0) -> None:
    """Run ``fn(rank, world, workdir)`` on ``world`` gloo ranks."""
    store = Path(workdir) / f"store_{time.monotonic_ns()}"
    ctx = mp.start_processes(_rank_main, args=(world, str(workdir), str(store), fn),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")


def _load(path: Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _params(path: Path) -> dict:
    """A torch state dict from an .npz the test wrote."""
    return {k: _t(v) for k, v in _load(path).items()}


def _whole_grads(model, mesh) -> dict:
    """Each parameter's gradient whole (gathered over tp) and summed over
    the data ranks: the gradient of the sum of the ranks' losses. A
    parameter without one is left out."""
    grads = {}
    for k, p in model.named_parameters():
        if p.grad is not None:
            g = p.grad.clone()
            dist.all_reduce(g, group=mesh.data_group)
            grads[k] = g
    return pm.gather_state(grads, pm.sharded_dims(model), mesh)


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The data ranks' rows gathered whole, in batch order."""
    from physicsinformeddiffusionmodels_tpu_torch.parallel.collectives import gather_tensor

    return gather_tensor(x.detach().contiguous(), 0, mesh.data_group)


# --- sequence-parallel attention, tp = world ---------------------------------

def seq_attention(rank: int, world: int, workdir: Path) -> None:
    """LA and the pre-norm block of the rank's tokens; the outputs, the
    gradients of sum(out * dy) with respect to the rank's tokens and the
    (whole) weights."""
    a = _load(workdir / "seq_inputs.npz")
    group = pm.make_mesh(1, world, device_type="cpu").tp_group
    n = a["x"].shape[1] // world
    part = slice(rank * n, (rank + 1) * n)
    out = {}
    for name in ("la", "block"):
        x = _t(a["x"][:, part]).requires_grad_(True)
        w = {k: _t(a[k]).requires_grad_(True) for k in ("gamma", "w_qkv", "w_out", "b_out")}
        if name == "la":
            y = sequence_sharded_linear_attention(x, w["w_qkv"], w["w_out"], group)
        else:
            y = sequence_sharded_linear_attention_block(x, w["gamma"], w["w_qkv"], w["w_out"],
                                                        w["b_out"], group)
        (y * _t(a["dy"][:, part])).sum().backward()
        out[f"{name}_y"], out[f"{name}_dx"] = y.detach().numpy(), x.grad.numpy()
        for k, v in w.items():
            if v.grad is not None:
                out[f"{name}_d{k}"] = v.grad.numpy()
    np.savez(workdir / f"seq_out_{rank}.npz", **out)


# --- data-parallel training steps --------------------------------------------

def _darcy_loss_fn(p: int):
    sched, physics = ts.create_schedule(100), DarcyResidual(p)

    def loss_fn(model, batch, t, noise):
        return tl.pidm_loss(sched, batch, t, noise, denoise_fn=model, physics_fn=physics,
                            weights=tl.LossWeights(c_data=1.0, c_residual=1e-3))

    return loss_fn


def dp_steps(rank: int, world: int, workdir: Path, slices: int = 1) -> None:
    """Three train steps of the small UNet of ``dp_inputs.npz`` on a mesh of
    ``world`` data ranks (``slices`` of them on the slice axis); rank 0
    writes the losses, weights and EMA."""
    a = _load(workdir / "dp_inputs.npz")
    mesh = pm.make_mesh(None, 1, slices, device_type="cpu")
    model = UNet(dim=8, channels=2, dim_mults=(1, 2), resnet_groups=4)
    model.load_state_dict(_params(workdir / "dp_params.npz"))
    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0, mesh=mesh))
    loss_fn = _darcy_loss_fn(a["x0"].shape[2])
    losses = []
    for i in range(a["x0"].shape[0]):
        args = (pm.shard_batch(_t(a[k][i]), mesh) for k in ("x0", "t", "noise"))
        losses.append(train_step(state, loss_fn, *args, ema_mu=0.99, ema_start=1).loss.item())
    if rank == 0:
        np.savez(workdir / f"dp_out_{slices}.npz", losses=np.array(losses),
                 **{f"params/{k}": v.numpy() for k, v in state.model.state_dict().items()},
                 **{f"ema/{k}": v.numpy() for k, v in state.ema.state_dict().items()})


def dp_steps_sliced(rank: int, world: int, workdir: Path) -> None:
    dp_steps(rank, world, workdir, slices=2)


# --- tensor-parallel UNet, mesh (dp, tp) = (world // 2, 2) -------------------

Aux = namedtuple("Aux", "loss")


def tp_unet(rank: int, world: int, workdir: Path) -> None:
    """The TP UNet of ``tp_inputs.npz`` (wide stages split, tp_min_width 32):
    its output and the gradients of sum(out * dy), gathered whole; each
    wide-stage module's output channels on this rank; then one train step,
    a TP checkpoint of it, and a 1-rank checkpoint restored and saved again."""
    a = _load(workdir / "tp_inputs.npz")
    mesh = pm.make_mesh(world // 2, 2, device_type="cpu")
    model = UNet(dim=32, channels=2, frame_attention=False, tp_mesh=mesh, tp_min_width=32)
    model.load_state_dict(_params(workdir / "tp_params.npz"))
    pm.shard_params(model, mesh)
    channels = {}

    def record(name):
        def hook(module, args, out):
            channels.setdefault(name, out.shape[-1])
        return hook

    for name, module in model.named_modules():
        if isinstance(module, (ResnetBlock, LinearAttentionBlock)):
            module.register_forward_hook(record(name))
    x = pm.shard_batch(_t(a["x"]), mesh).requires_grad_(True)
    t, dy = (pm.shard_batch(_t(a[k]), mesh) for k in ("t", "dy"))
    y = model(x, t)
    (y * dy).sum().backward()
    grads = _whole_grads(model, mesh)
    y_all, dx_all = _rows(y, mesh), _rows(x.grad, mesh)
    np.savez(workdir / f"tp_channels_{rank}.npz", **{k: np.array(v) for k, v in channels.items()})
    if rank == 0:
        np.savez(workdir / "tp_out.npz", y=y_all.numpy(), dx=dx_all.numpy(),
                 **{f"grad/{k}": v.numpy() for k, v in grads.items()})

    def loss_fn(m, xx, tt, dd):
        loss = (m(xx, tt) * dd).mean()
        return loss, Aux(loss)

    state = create_train_state(model, make_optimizer(model, 1e-4, 1.0, mesh=mesh))
    train_step(state, loss_fn, x.detach(), t, dy, ema_start=0)
    save_checkpoint(workdir / "tp_ckpt", 1, model=state.model, ema=state.ema,
                    optimizer=state.optimizer, mesh=mesh)
    restored = create_train_state(model, make_optimizer(model, 1e-4, 1.0, mesh=mesh))
    restore_train_state(workdir / "one_rank_ckpt", restored, mesh)
    save_checkpoint(workdir / "one_rank_ckpt_again", restored.step - 1, model=restored.model,
                    ema=restored.ema, optimizer=restored.optimizer, mesh=mesh)


# --- sequence-parallel UNet, mesh (dp, tp) = (world // 2, 2) -----------------

def sp_unet(rank: int, world: int, workdir: Path) -> None:
    """The sequence-parallel UNet of ``sp_inputs.npz`` (dim 16): its output,
    input gradient and parameter gradients of sum(out * dy), gathered
    whole."""
    a = _load(workdir / "sp_inputs.npz")
    mesh = pm.make_mesh(world // 2, 2, device_type="cpu")
    model = UNet(dim=16, channels=2, resnet_groups=8, frame_attention=False, sp_mesh=mesh)
    model.load_state_dict(_params(workdir / "sp_params.npz"))
    pm.shard_params(model, mesh)
    x = pm.shard_batch(_t(a["x"]), mesh).requires_grad_(True)
    t, dy = (pm.shard_batch(_t(a[k]), mesh) for k in ("t", "dy"))
    y = model(x, t)
    (y * dy).sum().backward()
    grads = _whole_grads(model, mesh)
    y_all, dx_all = _rows(y, mesh), _rows(x.grad, mesh)
    if rank == 0:
        np.savez(workdir / "sp_out.npz", y=y_all.numpy(), dx=dx_all.numpy(),
                 **{f"grad/{k}": v.numpy() for k, v in grads.items()})


def world4_suite(rank: int, world: int, workdir: Path) -> None:
    """Every four-rank check in one start of the ranks."""
    for fn in (seq_attention, dp_steps_sliced, tp_unet, sp_unet):
        fn(rank, world, workdir)


# --- the mechanics sweep split over the data ranks ---------------------------

def mech_sweep(rank: int, world: int, workdir: Path) -> None:
    """``sample_eval``'s mechanics sweep of ``workdir/run`` on ``world``
    data ranks, into ``workdir/sweep_ranks``."""
    from physicsinformeddiffusionmodels_tpu_torch.sample_eval import evaluate

    evaluate(workdir / "run", 2, "float32", "cpu", seed=0, out=workdir / "sweep_ranks",
             test_data_root=workdir / "sets", mesh_flags={"mesh_dp": world})


# --- two ranks on one card ---------------------------------------------------

def cuda_dp_step(rank: int, world: int, workdir: Path) -> None:
    """One train step of UNet(dim=32, dim_mults=(1, 2)) at B=8, 16x16, on
    ``world`` data ranks sharing cuda:0 (gloo), against the one-process step
    on rank 0; rank 0 writes the loss's relative gap, the worst gradient's
    (each within its tensor's largest entry) and its rank's K1 and K2
    launches (forward and backward) in the two-rank step."""
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu
    from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
        linear_attention_block,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = pm.make_mesh(None, 1, 1, "cuda")
    gen = torch.Generator().manual_seed(5)
    x, dy = (torch.randn(8, 16, 16, 2, generator=gen).to(dev) for _ in range(2))
    t = torch.randint(0, 100, (8,), generator=gen).to(dev)

    def loss_fn(m, xx, tt, dd):
        loss = (m(xx, tt) * dd).mean()
        return loss, Aux(loss)

    def step(m, args, mesh):
        state = create_train_state(m, make_optimizer(m, 1e-4, 1.0, mesh=mesh))
        return train_step(state, loss_fn, *(pm.shard_batch(a, mesh) for a in args)).loss

    def model():
        torch.manual_seed(0)
        with torch.device(dev):
            return UNet(dim=32, channels=2, dim_mults=(1, 2))

    counters = (linear_attention_block, group_norm_film_silu)
    before = [f.launches + f.backward_launches for f in counters]
    two = model()
    loss = step(two, (x, t, dy), mesh)
    launched = [f.launches + f.backward_launches - b for f, b in zip(counters, before)]
    if rank == 0:
        one = model()
        ref = step(one, (x, t, dy), None)
        worst = max((p.grad - q.grad).abs().max().item() / q.grad.abs().max().item()
                    for p, q in zip(two.parameters(), one.parameters()) if q.grad is not None)
        np.savez(workdir / "cuda_dp.npz", loss_rel=abs(loss.item() - ref.item()) / abs(ref.item()),
                 worst_grad=worst, k1_launches=launched[0], k2_launches=launched[1])
    dist.barrier()
