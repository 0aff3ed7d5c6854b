"""Training driver (port of the root ``train.py``): the Darcy study here,
the mechanics study in ``train_mechanics`` (``--gov-eqs mechanics``).

    python -m physicsinformeddiffusionmodels_tpu_torch.train --iterations N \\
        [--gov-eqs {darcy,mechanics}] [--batch-size B] [--data-dir DIR --valid-data-dir DIR] \\
        [--device cpu] [--resume] [--compute-dtype {float32,bfloat16}] [--fp32-head] \\
        [--x0-estimation {mean,sample}] [--residual-grad-guidance] [--chunk-steps K] \\
        [--mesh-dp D] [--mesh-tp T] [--mesh-slices S] [--tp-shard-activations] \\
        [--seq-parallel-attn]

    torchrun --nproc-per-node N -m physicsinformeddiffusionmodels_tpu_torch.train \\
        --mesh-dp N ...            (N GPUs, NCCL; with --device cpu, N processes, gloo)

Physics-informed diffusion training of ``UNet(dim=32, channels=2)`` on the
Darcy data (``data/darcy_generator.py`` writes it), in the config's compute
dtype: bfloat16 unless ``--compute-dtype float32``, as in the JAX driver;
``--fp32-head`` keeps the final block and 1x1 conv in fp32 (the recipe of
``results/darcy_300k_fp32head``). The loss adds the PDE
residual log-likelihood of the x0 estimate to the p2-weighted data loss;
global-norm clip, Adam, EMA. The x0 estimate is the model's prediction
(``--x0-estimation mean``) or a DDIM chain of ``ddim_steps + 2`` model
calls (``sample``; batch 16 by default). ``--residual-grad-guidance``
conditions the model on the residual gradient of its noisy input, zeroed
for a ``null_cond_prob`` share of each batch, and samples with
classifier-free guidance at ``guidance_scale``. The whole dataset lives on
the device and each step samples its batch there. With ``--chunk-steps K >
1`` step 0 runs alone and then K steps at a time, with every periodic event
on a chunk end (``RunConfig.validate_chunking``); on the card a chunk's
steps replay a CUDA graph of one step (``trainer.GraphedTrainStep``),
bit-identical to eager steps. Every ``log_freq`` steps the losses go to
``metrics.csv``; every ``test_eval_freq`` steps the EMA weights are scored
on a validation batch; every ``sample_freq`` steps (and at the end) the EMA
model samples ``no_samples`` fields (CSV outputs) and a checkpoint is saved.
SIGTERM/SIGINT save a full checkpoint and stop; ``--resume`` continues from
the newest one. Outputs go to ``<output_dir>/<name>/``. With ``--gov-eqs
mechanics`` the run takes the mechanics driver's loss weights and data
directories (``train_mechanics.MECHANICS_DEFAULTS``) where no flag sets them.

Under torchrun each process joins the process group (NCCL on its own GPU,
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and the run takes JAX's
mesh flags: ``--mesh-dp`` ranks split the batch (every rank draws the
global batch and keeps its rows), ``--mesh-tp`` ranks split the
parameters, and with ``--tp-shard-activations`` the wide stages' channels,
or with ``--seq-parallel-attn`` the linear attention's tokens;
``--mesh-slices`` adds a leading data axis (``parallel/mesh.py``). A step
gives the one-rank step's numbers up to the order of the gradient sum;
the periodic evaluation and sampling run alike on every rank and give the
one-rank run's numbers; rank 0 alone writes ``metrics.csv``, the samples,
``config.json`` and the checkpoints, which hold whole arrays whatever the
mesh. ``--chunk-steps`` on a mesh steps per dispatch (no graph), with a
warning, as JAX's driver does. Mesh flags that ask for more than one rank
without torchrun raise.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.datasets import (
    cycle_batches,
    load_darcy_dataset,
)
from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import (
    LossWeights,
    pidm_loss,
    uniform_timesteps,
)
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import ddim_sample_x0
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    create_schedule,
)
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model as _build_unet
from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
    Mesh,
    any_rank,
    is_main,
    run_mesh,
    shard_params,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.sample_eval import (
    sample_darcy,
    write_darcy_outputs,
)
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    restore_train_state,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.metrics import MetricsLogger
from physicsinformeddiffusionmodels_tpu_torch.training.shutdown import install_graceful_stop
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    GraphedTrainStep,
    create_train_state,
    make_optimizer,
    resident_train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import (
    init_distributed,
    launched_by_torchrun,
    resolve_device,
    set_fp32_exact,
)


# metrics.csv columns, in the JAX driver's order
_COLUMNS = ["step", "time", "loss", "loss_data", "residual_mean_abs", "loss_test",
            "loss_data_test", "residual_mean_abs_test", "residual_mean_abs_samples",
            "residual_median_abs_samples"]


def build_model(cfg: RunConfig, mesh: Mesh | None = None) -> UNet:
    """The study's UNet for ``cfg``, in ``cfg.compute_dtype`` (with the fp32
    head when ``cfg.fp32_head``), its tp options on ``mesh``."""
    return _build_unet(cfg, mesh=mesh)


def join_run(cfg: RunConfig, device=None) -> tuple[torch.device, Mesh | None]:
    """The run's device and mesh: under torchrun the process joins the
    process group first (``utils.platform.init_distributed``); without it
    there is no mesh, and mesh flags of more than one rank raise."""
    dev = resolve_device(device)
    if launched_by_torchrun():
        dev = init_distributed(dev)
    mesh = run_mesh(dev, cfg.mesh_dp, cfg.mesh_tp, cfg.mesh_slices)
    if mesh is not None and cfg.chunk_steps > 1 and is_main(mesh):
        print(f"warning: --chunk-steps {cfg.chunk_steps} replays no CUDA graph on a mesh; "
              "stepping per dispatch", flush=True)
    return dev, mesh


def start_model(cfg: RunConfig, dev: torch.device, mesh: Mesh | None):
    """The run's seeded UNet on ``dev`` with its parameters split over
    ``mesh``, and its optimizer over them."""
    torch.manual_seed(cfg.seed)
    model = build_model(cfg, mesh).to(dev)
    if is_main(mesh):
        print(f"Number of trainable parameters: {sum(p.numel() for p in model.parameters())}")
        if mesh is not None:
            print(f"mesh: {mesh.shape}", flush=True)
    shard_params(model, mesh)
    opt = make_optimizer(model, cfg.lr, cfg.grad_clip, cfg.lr_schedule, cfg.train_iterations,
                         cfg.lr_final_frac, mesh)
    return model, opt


def make_physics(cfg: RunConfig, device) -> DarcyResidual:
    return DarcyResidual(
        pixels_per_dim=cfg.pixels_per_dim, fd_acc=cfg.fd_acc,
        pixels_at_boundary=cfg.pixels_at_boundary, reverse_d1=cfg.reverse_d1,
        domain_length=cfg.domain_length, periodic=cfg.bcs == "periodic", device=device,
    )


def null_cond_prob(cfg: RunConfig):
    """The null-conditioning probability whose [B] mask each training step
    draws (guidance training), or None (no mask)."""
    return cfg.null_cond_prob if cfg.residual_grad_guidance else None


def build_darcy_loss_fn(sched: DiffusionSchedule, physics: DarcyResidual, cfg: RunConfig):
    """``loss_fn(model, batch, t, noise[, null_mask]) -> (loss, aux)``: the
    physics-informed loss with the Darcy residual of the x0 estimate, as the
    JAX ``train.py`` builds it.

    With ``residual_grad_guidance`` every model call is conditioned on the
    residual gradient of its input, with the step's ``null_mask`` (one draw
    a step, reused by every call of the step). With x0_estimation='sample'
    the x0 estimate is the DDIM chain's, whose every call re-queries the
    model on the original noisy input x_t at the ladder's times: only the
    DDIM algebra chains, the model input does not. The chain's first call
    is the data loss's prediction."""
    weights = LossWeights(cfg.c_data, cfg.c_residual, cfg.c_ineq, cfg.lambda_opt)

    def loss_fn(model, batch, t, noise, null_mask=None):
        if cfg.residual_grad_guidance:
            def denoise(x, tt):
                return model(x, tt, cond=physics.residual_gradient(x), null_mask=null_mask)
        else:
            denoise = model

        sampler = None
        if cfg.use_ddim_x0:
            def sampler(x_t, tt):
                return ddim_sample_x0(sched, lambda _, ttt: denoise(x_t, ttt), x_t, tt,
                                      ddim_steps=cfg.ddim_steps)

        return pidm_loss(sched, batch, t, noise, denoise_fn=denoise, physics_fn=physics,
                         weights=weights, pred_mode="x0", x0_sampler=sampler)

    return loss_fn


@torch.no_grad()
def eval_loss(loss_fn, model, batch: torch.Tensor, n_steps: int, generator: torch.Generator,
              null_prob: float | None = None, noise_channels: int | None = None):
    """The loss aux of ``model`` on ``batch`` with fresh t and noise (with
    ``noise_channels`` channels in place of the batch's, as
    ``trainer.resident_batch`` draws it; and, with ``null_prob``, a fresh
    null-conditioning mask)."""
    t = uniform_timesteps(generator, batch.shape[0], n_steps, device=batch.device)
    shape = batch.shape if noise_channels is None else (*batch.shape[:-1], noise_channels)
    noise = torch.randn(shape, generator=generator, device=batch.device)
    if null_prob is None:
        return loss_fn(model, batch, t, noise)[1]
    mask = torch.rand((batch.shape[0],), generator=generator, device=batch.device) < null_prob
    return loss_fn(model, batch, t, noise, mask)[1]


def run_darcy(cfg: RunConfig, device=None):
    """Train per ``cfg``; returns the final ``TrainState``. Under torchrun,
    on the mesh of ``cfg``'s mesh fields (``join_run``)."""
    cfg.validate_chunking()
    dev, mesh = join_run(cfg, device)
    main = is_main(mesh)
    set_fp32_exact()
    out_dir = Path(cfg.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    if main:
        (out_dir / "config.json").write_text(cfg.to_json())

    ds = load_darcy_dataset(cfg.data_dir)
    ds_valid = load_darcy_dataset(cfg.valid_data_dir)
    if main:
        print(f"train samples: {len(ds)}, valid: {len(ds_valid)}")
    dl_valid = cycle_batches(ds_valid, min(cfg.train_batch_size, len(ds_valid)))
    data = torch.as_tensor(ds.stacked(), device=dev)

    sched = create_schedule(cfg.diff_steps)
    physics = make_physics(cfg, dev)
    model, opt = start_model(cfg, dev, mesh)
    state = create_train_state(model, opt)
    start_it = 0
    if cfg.resume:
        state, start_it = restore_train_state(out_dir / "model", state, mesh)
    loss_fn = build_darcy_loss_fn(sched, physics, cfg)

    logger = MetricsLogger(out_dir) if main else None
    should_stop = install_graceful_stop()
    step_gen = torch.Generator(device=dev)
    eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1 + start_it)
    chunk = cfg.chunk_steps
    graphed = (GraphedTrainStep(state, loss_fn, cfg.ema_decay, cfg.ema_start)
               if chunk > 1 and dev.type == "cuda" and mesh is None else None)

    def step(graph):
        return resident_train_step(state, loss_fn, data, cfg.train_batch_size, cfg.diff_steps,
                                   cfg.seed, step_gen, ema_mu=cfg.ema_decay,
                                   ema_start=cfg.ema_start, null_cond_prob=null_cond_prob(cfg),
                                   graphed=graph)

    t0 = time.time()
    it = start_it
    while it <= cfg.train_iterations:
        if chunk > 1 and it % chunk == 1 and it + chunk - 1 <= cfg.train_iterations:
            # a chunk's end lands on every log, eval and sample step; a
            # graph's aux is overwritten by its next replay, so it is read
            # (cloned) at the chunk end only
            for _ in range(chunk):
                aux = step(graphed)
            it += chunk - 1
        else:
            aux = step(None)
        if it % cfg.log_freq == 0 and main:
            logger.log({"loss": aux.loss.detach().clone(),
                        "loss_data": aux.data_loss.detach().clone(),
                        "residual_mean_abs": aux.residual_mean_abs.detach().clone()}, step=it)
        if it % cfg.test_eval_freq == 0:
            vb = torch.as_tensor(next(dl_valid), device=dev)
            aux_t = eval_loss(loss_fn, state.ema, vb, cfg.diff_steps, eval_gen,
                              null_cond_prob(cfg))
            if main:
                print(f"it {it}: loss={aux.loss.item():.3e} test={aux_t.loss.item():.3e} "
                      f"res|_train={aux.residual_mean_abs.item():.3e} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                logger.log({"loss_test": aux_t.loss, "loss_data_test": aux_t.data_loss,
                            "residual_mean_abs_test": aux_t.residual_mean_abs}, step=it)
                logger.flush(_COLUMNS)
        if (it % cfg.sample_freq == 0 and it > 0) or it == cfg.train_iterations:
            samples, residual, _ = sample_darcy(cfg, state.ema, cfg.no_samples,
                                                cfg.seed + it, dev)
            res_b = residual.abs().mean(dim=(1, 2)).cpu().numpy()
            if main:
                logger.log({"residual_mean_abs_samples": float(np.nanmean(res_b)),
                            "residual_median_abs_samples": float(np.nanmedian(res_b))},
                           step=it)
                write_darcy_outputs(out_dir / "training" / f"step_{it}",
                                    samples.cpu().numpy(), res_b)
            # intermediate saves leave the optimizer state out; the final one keeps it
            save_checkpoint(out_dir / "model", it, model=state.model, ema=state.ema,
                            optimizer=opt if it == cfg.train_iterations else None, config=cfg,
                            mesh=mesh)
            if main:
                print(f"it {it}: sampled, residual mean {np.nanmean(res_b):.3e}", flush=True)
        # on a mesh the ranks agree on a stop (a host-device sync) at log steps only
        if (mesh is None or it % cfg.log_freq == 0) and any_rank(should_stop(), mesh, dev):
            save_checkpoint(out_dir / "model", it, model=state.model, ema=state.ema,
                            optimizer=opt, config=cfg, mesh=mesh)
            if main:
                print(f"it {it}: checkpoint saved on shutdown request", flush=True)
            break
        it += 1
    if main:
        logger.flush(_COLUMNS)
    return state


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gov-eqs", default="darcy", choices=["darcy", "mechanics"])
    ap.add_argument("--name", default="run_1")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--x0-estimation", default=None, choices=["mean", "sample"])
    ap.add_argument("--c-residual", type=float, default=None)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--valid-data-dir", default=None)
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--sample-freq", type=int, default=None)
    ap.add_argument("--test-eval-freq", type=int, default=None)
    ap.add_argument("--log-freq", type=int, default=None)
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                    help="default: the config's (bfloat16)")
    ap.add_argument("--fp32-head", action="store_true",
                    help="with bf16 compute: the final block and 1x1 conv in fp32")
    ap.add_argument("--pixels-per-dim", type=int, default=None)
    ap.add_argument("--no-samples", type=int, default=None)
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help=">1: steps a chunk, every periodic event on a chunk end; on the card "
                    "a chunk replays a CUDA graph of one step (bit-identical)")
    ap.add_argument("--residual-grad-guidance", action="store_true")
    ap.add_argument("--lr-schedule", default=None, choices=["constant", "cosine"])
    ap.add_argument("--lr-final-frac", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint of this run name")
    ap.add_argument("--model-yaml", default=None,
                    help="reference-format model.yaml to configure the run (needs PyYAML)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    """JAX's five mesh flags (ranks come from torchrun)."""
    ap.add_argument("--mesh-dp", type=int, default=None,
                    help="data-parallel mesh size (default: the world size / tp)")
    ap.add_argument("--mesh-tp", type=int, default=None,
                    help="tensor-parallel mesh size (default 1)")
    ap.add_argument("--mesh-slices", type=int, default=None,
                    help="a leading data-parallel axis of this many blocks of ranks (default 1)")
    ap.add_argument("--tp-shard-activations", action="store_true",
                    help="with --mesh-tp>1: split the wide stages' channels over 'tp'")
    ap.add_argument("--seq-parallel-attn", action="store_true",
                    help="with --mesh-tp>1: sequence-parallel linear attention over 'tp'")


def mesh_kwargs(args: argparse.Namespace) -> dict:
    """The RunConfig fields of the mesh flags that were given."""
    kw = {k: getattr(args, k) for k in ("mesh_dp", "mesh_tp", "mesh_slices")
          if getattr(args, k) is not None}
    kw.update({k: True for k in ("tp_shard_activations", "seq_parallel_attn")
               if getattr(args, k)})
    return kw


def config_from_args(args: argparse.Namespace) -> RunConfig:
    kw = {"gov_eqs": args.gov_eqs, "name": args.name}
    if args.gov_eqs == "mechanics":
        from physicsinformeddiffusionmodels_tpu_torch.train_mechanics import MECHANICS_DEFAULTS

        kw.update(MECHANICS_DEFAULTS)
    for k_arg, k_cfg in [
        ("iterations", "train_iterations"), ("batch_size", "train_batch_size"),
        ("x0_estimation", "x0_estimation"), ("c_residual", "c_residual"),
        ("data_dir", "data_dir"), ("valid_data_dir", "valid_data_dir"),
        ("output_dir", "output_dir"), ("sample_freq", "sample_freq"),
        ("test_eval_freq", "test_eval_freq"), ("log_freq", "log_freq"),
        ("pixels_per_dim", "pixels_per_dim"), ("no_samples", "no_samples"),
        ("chunk_steps", "chunk_steps"), ("lr_schedule", "lr_schedule"),
        ("lr_final_frac", "lr_final_frac"), ("seed", "seed"),
        ("compute_dtype", "compute_dtype"),
    ]:
        v = getattr(args, k_arg)
        if v is not None:
            kw[k_cfg] = v
    if args.fp32_head:
        kw["fp32_head"] = True
    if args.residual_grad_guidance:
        kw["residual_grad_guidance"] = True
    if args.resume:
        kw["resume"] = True
    kw.update(mesh_kwargs(args))
    if getattr(args, "model_yaml", None):
        return RunConfig.from_model_yaml(args.model_yaml, **kw)
    return RunConfig(**kw)


def main(argv=None):
    args = parse_args(argv)
    cfg = config_from_args(args)
    if cfg.gov_eqs == "mechanics":
        from physicsinformeddiffusionmodels_tpu_torch.train_mechanics import run_mechanics

        return run_mechanics(cfg, args.device)
    return run_darcy(cfg, args.device)


if __name__ == "__main__":
    main()
