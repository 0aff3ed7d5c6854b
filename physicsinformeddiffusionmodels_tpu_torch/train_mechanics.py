"""Mechanics (topology-optimisation) training driver (port of the root
``train_mechanics.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.train_mechanics --iterations N \\
        [--batch-size B] [--unet-dim D] [--data-dir DIR --valid-data-dir DIR] \\
        [--output-dir DIR] [--device cpu] [--resume] [--compute-dtype {float32,bfloat16}] \\
        [--fp32-head] [--x0-estimation {mean,sample}] [--chunk-steps K] \\
        [--mesh-dp D] [--mesh-tp T] [--mesh-slices S] [--tp-shard-activations] \\
        [--seq-parallel-attn]

(or ``python -m physicsinformeddiffusionmodels_tpu_torch.train --gov-eqs
mechanics ...``). Conditional physics-informed diffusion over (u1, u2, rho)
given (vf, strain-energy density, von Mises, BCs, loads) on the 65x65
samples that ``generate_mechanics_sets`` writes, with
``UNet(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True)``. The
diffusion state is the 65x65 solution; the model sees its 64x64 bilinear
resize beside the resized conditioning, and its 64x64 prediction goes back
to the nodes (``MechanicsResidual.model_out_to_nodes``) for the data loss.
The loss adds the FEM equilibrium residual, the volume-fraction mismatch
(c_ineq 1e-3) and the compliance (lambda_opt 1e-6) of the x0 estimate.

The dataset lives on the device; ``--chunk-steps K > 1`` replays a CUDA
graph of one step on the card (``trainer.GraphedTrainStep``), a plain loop on
the CPU, with every periodic event on a chunk end. Every ``sample_freq``
steps (and at the end) the EMA model samples ``no_samples`` validation
conditions; the samples' residual, rel_CE, vf and floating-material errors
go to ``metrics.csv`` (the solves checked on the host by
``topopt_eval_checked``), their fields to CSVs, and the weights to a
checkpoint in Flax's bytes: params and EMA only, the final one (and one on
SIGTERM/SIGINT) with Adam's state too, so ``--resume`` continues exactly.
Under torchrun the run takes the mesh flags as ``train`` does (the
mechanics UNet's wide stages are every level at dim 128; ``--mesh-tp 2
--tp-shard-activations`` halves each rank's parameters, Adam state and
EMA); every rank samples alike and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.datasets import NpyFieldDataset, cycle_batches
from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import LossWeights, pidm_loss
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import (
    Noise,
    RowNoise,
    ddim_sample_x0,
    p_sample_loop,
)
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    create_schedule,
)
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
from physicsinformeddiffusionmodels_tpu_torch.ops.connected_components import floating_material
from physicsinformeddiffusionmodels_tpu_torch.ops.reshape import resize_bilinear
from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import any_rank, is_main
from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import (
    MechanicsBatch,
    MechanicsResidual,
    split_mechanics_batch,
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
    resident_train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.utils import viz
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

# the JAX mechanics driver's settings that differ from RunConfig's defaults
MECHANICS_DEFAULTS = dict(c_ineq=1e-3, lambda_opt=1e-6,
                          data_dir="./data/mechanics/train/fields",
                          valid_data_dir="./data/mechanics/test/valid/fields")
# metrics.csv columns, in the order the JAX driver first logs them
COLUMNS = ["step", "time", "loss", "loss_data", "residual_mean_abs", "loss_inequality",
           "loss_optimization", "loss_test", "residual_mean_abs_test",
           "residual_mean_abs_samples", "residual_median_abs_samples", "rel_CE_error",
           "rel_vf_error", "fm_error", "n_solve_fallback"]
SOLUTION_CHANNELS = 3


def model_input_from_state(noisy_solution: torch.Tensor, cond: MechanicsBatch,
                           P: int) -> torch.Tensor:
    """The 10-channel P x P model input of a noisy 65x65 solution state:
    resize(noisy ++ conditioning) ++ resize(bcs)."""
    six = torch.cat([noisy_solution, cond.conditioning.to(noisy_solution.dtype)], dim=-1)
    return torch.cat([resize_bilinear(six, P),
                      resize_bilinear(cond.bcs.to(noisy_solution.dtype), P)], dim=-1)


def build_mechanics_loss_fn(sched: DiffusionSchedule, mech: MechanicsResidual, cfg: RunConfig):
    """``loss_fn(model, batch, t, noise) -> (loss, aux)`` on a [B, 65, 65, 10]
    batch with [B, 65, 65, 3] noise, as the JAX driver builds it: the x0
    target is the 65x65 solution, the prediction goes back to the nodes for
    the data loss, the physics takes the raw 64x64 prediction. With
    x0_estimation='sample' the DDIM chain runs on the 64x64 resize of x_t and
    every call re-queries the model on the original x_t's input."""
    weights = LossWeights(cfg.c_data, cfg.c_residual, cfg.c_ineq, cfg.lambda_opt)
    P = cfg.pixels_per_dim

    def loss_fn(model, batch, t, noise):
        mb = split_mechanics_batch(batch)
        vf = mb.conditioning[..., 0][:, 0, 0]

        def denoise(x65, tt):
            return model(model_input_from_state(x65, mb, P), tt)

        sampler = None
        if cfg.use_ddim_x0:
            def sampler(x_t65, tt):
                fixed_input = model_input_from_state(x_t65, mb, P)
                return ddim_sample_x0(sched, lambda _, ttt: model(fixed_input, ttt),
                                      resize_bilinear(x_t65, P), tt, ddim_steps=cfg.ddim_steps)

        return pidm_loss(sched, mb.solution, t, noise, denoise_fn=denoise,
                         physics_fn=lambda x0_64: mech.evaluate(x0_64, mb.bcs, vf),
                         weights=weights, pred_mode="x0", x0_sampler=sampler,
                         model_out_transform=mech.model_out_to_nodes)

    return loss_fn


class MechanicsSample(NamedTuple):
    """A sampling pass's final 65x65 states [B, 65, 65, 3], their residual
    [B, neq], compliance and volume mismatch [B], the ``topopt_eval`` dict
    (empty without ``cfg.topopt_eval``) and the [T, B, 65, 65, 3] history or
    None."""

    final: torch.Tensor
    residual: torch.Tensor
    compliance: torch.Tensor
    ineq: torch.Tensor
    topopt: dict
    history: Optional[torch.Tensor] = None


@torch.no_grad()
def sample_mechanics(cfg: RunConfig, model: UNet, batch: torch.Tensor, x_init: torch.Tensor,
                     noise: Noise, mech: MechanicsResidual,
                     save_history: bool = False) -> MechanicsSample:
    """Conditional ancestral sampling of ``batch``'s conditions at the 65x65
    state resolution (the JAX ``make_mech_sample_fn``): each step resizes the
    state for the model and takes its prediction back to the nodes. The
    final state is scored by the FEM residual, the compliance, the volume
    mismatch and, with ``cfg.topopt_eval``, ``topopt_eval`` (rel_CE, vf
    error, the binarised designs). ``x_init`` [B, 65, 65, 3] and ``noise``
    are as ``p_sample_loop`` takes them."""
    sched = create_schedule(cfg.diff_steps)
    P = cfg.pixels_per_dim
    mb = split_mechanics_batch(batch)
    vf = mb.conditioning[..., 0][:, 0, 0]
    b = batch.shape[0]

    def denoise(x65, t):
        return mech.model_out_to_nodes(model(model_input_from_state(x65, mb, P), t))

    result = p_sample_loop(sched, denoise, x_init, noise,
                           use_dynamic_threshold=cfg.use_dynamic_threshold,
                           save_history=save_history)
    final = result.x
    rho_e = final[:, :-1, :-1, 2].reshape(b, -1)
    residual, u, _, mask = mech.residual_from_fields(final[..., :2], rho_e, mb.bcs)
    compliance = mech.compliance(u, rho_e, mask)
    ineq = rho_e.mean(dim=1) - vf
    topopt = topopt_eval_of_final(mech, final, batch) if cfg.topopt_eval else {}
    return MechanicsSample(final, residual, compliance, ineq, topopt, result.history)


def topopt_eval_of_final(mech: MechanicsResidual, final: torch.Tensor,
                         batch: torch.Tensor) -> dict:
    """``topopt_eval`` of final 65x65 states: the displacements regridded to
    the 64x64 prediction layout, rho cropped to the elements."""
    x0_64 = torch.cat([resize_bilinear(final[..., :2], mech.pixels_per_dim),
                       final[:, :-1, :-1, 2:3]], dim=-1)
    return mech.topopt_eval(x0_64, split_mechanics_batch(batch))


def draw_sample(cfg: RunConfig, model: UNet, batch: torch.Tensor, mech: MechanicsResidual,
                generator: torch.Generator, save_history: bool = False,
                rows: Optional[tuple[int, slice]] = None) -> MechanicsSample:
    """``sample_mechanics`` with x_init and every step's noise drawn from
    ``generator`` (on the batch's device). ``rows`` = (n, slice): ``batch``
    is that slice of a batch of n, whose draws are made whole and cut to
    it, so its samples equal those rows of the whole batch's."""
    n, keep = rows or (batch.shape[0], slice(None))
    shape = (n, cfg.pixels_per_dim + 1, cfg.pixels_per_dim + 1, SOLUTION_CHANNELS)
    x_init = torch.randn(shape, generator=generator, device=batch.device)[keep]
    noise = generator if rows is None else RowNoise(generator, n, keep)
    return sample_mechanics(cfg, model, batch, x_init, noise, mech, save_history)


def topopt_metrics(mech: MechanicsResidual, sample: MechanicsSample,
                   batch: torch.Tensor) -> tuple[dict, np.ndarray]:
    """The host check of a sample's solves (``topopt_eval_checked``) and the
    floating-material flags: (the checked topopt dict, fm flags [B])."""
    topopt = mech.topopt_eval_checked(sample.topopt, batch[..., 6:10].float().cpu().numpy())
    return topopt, floating_material(topopt["rho_binarized"])


def write_sample_csvs(step_dir: Path, finals: np.ndarray, n: int) -> None:
    """``sample_<s>/sample_<c>.csv`` of the first ``n`` final states."""
    for s in range(min(n, finals.shape[0])):
        for c in range(finals.shape[-1]):
            viz.save_csv(finals[s, :, :, c], step_dir / f"sample_{s}" / f"sample_{c}.csv")


def run_mechanics(cfg: RunConfig, device=None):
    """Train per ``cfg``; returns the final ``TrainState``. Under torchrun,
    on the mesh of ``cfg``'s mesh fields (``train.join_run``)."""
    from physicsinformeddiffusionmodels_tpu_torch.train import eval_loss, join_run, start_model

    cfg.validate_chunking()
    dev, mesh = join_run(cfg, device)
    main = is_main(mesh)
    set_fp32_exact()
    out_dir = Path(cfg.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    if main:
        (out_dir / "config.json").write_text(cfg.to_json())

    ds, ds_valid = NpyFieldDataset(cfg.data_dir), NpyFieldDataset(cfg.valid_data_dir)
    if main:
        print(f"train samples: {len(ds)}, valid: {len(ds_valid)}")
    dl_valid = cycle_batches(ds_valid, min(cfg.train_batch_size, len(ds_valid)))
    data = torch.as_tensor(ds.stacked(), device=dev)

    sched = create_schedule(cfg.diff_steps)
    mech = MechanicsResidual(pixels_per_dim=cfg.pixels_per_dim, device=dev)
    model, opt = start_model(cfg, dev, mesh)
    state = create_train_state(model, opt)
    start_it = 0
    if cfg.resume:
        state, start_it = restore_train_state(out_dir / "model", state, mesh)
    loss_fn = build_mechanics_loss_fn(sched, mech, cfg)

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
                                   ema_start=cfg.ema_start, graphed=graph,
                                   noise_channels=SOLUTION_CHANNELS)

    t0 = time.time()
    it = start_it
    while it <= cfg.train_iterations:
        if chunk > 1 and it % chunk == 1 and it + chunk - 1 <= cfg.train_iterations:
            # a graph's aux is overwritten by its next replay: read at the chunk end
            for _ in range(chunk):
                aux = step(graphed)
            it += chunk - 1
        else:
            aux = step(None)
        if it % cfg.log_freq == 0 and main:
            logger.log({"loss": aux.loss.clone(), "loss_data": aux.data_loss.clone(),
                        "residual_mean_abs": aux.residual_mean_abs.clone(),
                        "loss_inequality": aux.ineq_mean.clone(),
                        "loss_optimization": aux.opt_mean.clone()}, step=it)
        if it % cfg.test_eval_freq == 0:
            vb = torch.as_tensor(next(dl_valid), device=dev)
            aux_t = eval_loss(loss_fn, state.ema, vb, cfg.diff_steps, eval_gen,
                              noise_channels=SOLUTION_CHANNELS)
            if main:
                print(f"it {it}: loss={aux.loss.item():.3e} test={aux_t.loss.item():.3e} "
                      f"res={aux.residual_mean_abs.item():.3e} ({time.time() - t0:.0f}s)",
                      flush=True)
                logger.log({"loss_test": aux_t.loss,
                            "residual_mean_abs_test": aux_t.residual_mean_abs}, step=it)
                logger.flush(COLUMNS)
        if (it % cfg.sample_freq == 0 and it > 0) or it == cfg.train_iterations:
            vb = torch.as_tensor(next(dl_valid)[:cfg.no_samples], device=dev)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + it)
            sample = draw_sample(cfg, state.ema, vb, mech, gen)
            if main:
                res_b = sample.residual.abs().mean(dim=1).cpu().numpy()
                metrics = {"residual_mean_abs_samples": float(np.nanmean(res_b)),
                           "residual_median_abs_samples": float(np.nanmedian(res_b))}
                if cfg.topopt_eval:
                    topopt, fm = topopt_metrics(mech, sample, vb)
                    metrics.update(
                        rel_CE_error=float(np.nanmean(topopt["rel_CE_error_full_batch"])),
                        rel_vf_error=float(np.nanmean(topopt["vf_error_full_batch"])),
                        fm_error=float(fm.mean()), n_solve_fallback=topopt["n_solve_fallback"])
                logger.log(metrics, step=it)
                write_sample_csvs(out_dir / "training" / f"step_{it}",
                                  sample.final.float().cpu().numpy(), cfg.no_samples)
            # intermediate saves leave the optimizer state out (at dim 128 it
            # doubles the file to 2.1 GB); the final one keeps it
            save_checkpoint(out_dir / "model", it, model=state.model, ema=state.ema,
                            optimizer=opt if it == cfg.train_iterations else None, config=cfg,
                            mesh=mesh)
            if main:
                print(f"it {it}: sampled; {metrics}", flush=True)
        # on a mesh the ranks agree on a stop (a host-device sync) at log steps only
        if (mesh is None or it % cfg.log_freq == 0) and any_rank(should_stop(), mesh, dev):
            save_checkpoint(out_dir / "model", it, model=state.model, ema=state.ema,
                            optimizer=opt, config=cfg, mesh=mesh)
            if main:
                print(f"it {it}: checkpoint saved on shutdown request", flush=True)
            break
        it += 1
    if main:
        logger.flush(COLUMNS)
    return state


def parse_args(argv=None) -> argparse.Namespace:
    from physicsinformeddiffusionmodels_tpu_torch.train import add_mesh_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--name", default="mech_run")
    ap.add_argument("--iterations", type=int, default=600_000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--pixels-per-dim", type=int, default=64)
    ap.add_argument("--unet-dim", type=int, default=None)
    ap.add_argument("--data-dir", default=MECHANICS_DEFAULTS["data_dir"])
    ap.add_argument("--valid-data-dir", default=MECHANICS_DEFAULTS["valid_data_dir"])
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--x0-estimation", default="mean", choices=["mean", "sample"])
    ap.add_argument("--c-residual", type=float, default=1e-3)
    ap.add_argument("--sample-freq", type=int, default=20000)
    ap.add_argument("--test-eval-freq", type=int, default=500)
    ap.add_argument("--log-freq", type=int, default=None)
    ap.add_argument("--no-samples", type=int, default=8)
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help=">1: steps a chunk, every periodic event on a chunk end; on the card "
                    "a chunk replays a CUDA graph of one step (bit-identical)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint of this run name")
    ap.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"])
    ap.add_argument("--lr-final-frac", type=float, default=0.1)
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                    help="default: the config's (bfloat16)")
    ap.add_argument("--fp32-head", action="store_true",
                    help="with bf16 compute: the final block and 1x1 conv in fp32")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def config_from_args(a: argparse.Namespace) -> RunConfig:
    from physicsinformeddiffusionmodels_tpu_torch.train import mesh_kwargs

    kw = dict(MECHANICS_DEFAULTS, gov_eqs="mechanics", name=a.name,
              train_iterations=a.iterations, train_batch_size=a.batch_size,
              pixels_per_dim=a.pixels_per_dim, unet_dim=a.unet_dim, data_dir=a.data_dir,
              valid_data_dir=a.valid_data_dir, x0_estimation=a.x0_estimation,
              c_residual=a.c_residual, sample_freq=a.sample_freq,
              test_eval_freq=a.test_eval_freq, no_samples=a.no_samples,
              chunk_steps=a.chunk_steps, resume=a.resume, lr_schedule=a.lr_schedule,
              lr_final_frac=a.lr_final_frac, fp32_head=a.fp32_head)
    for k_arg, k_cfg in (("output_dir", "output_dir"), ("log_freq", "log_freq"),
                         ("compute_dtype", "compute_dtype"), ("seed", "seed")):
        if getattr(a, k_arg) is not None:
            kw[k_cfg] = getattr(a, k_arg)
    kw.update(mesh_kwargs(a))
    return RunConfig(**kw)


def main(argv=None):
    args = parse_args(argv)
    return run_mechanics(config_from_args(args), args.device)


if __name__ == "__main__":
    main()
