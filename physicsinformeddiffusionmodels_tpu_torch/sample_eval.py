"""Evaluation of a trained checkpoint (port of the JAX ``sample_eval.py``):
sample, then score the samples by their physics.

    python -m physicsinformeddiffusionmodels_tpu_torch.sample_eval \\
        --model-dir results/darcy_300k_fp32head/portable --no-samples 64 \\
        --compute-dtype float32 [--device cpu] [--seed 0] [--out DIR] \\
        [--correction-mode {none,x0,xt} --n-correction N --m-correction M] \\
        [--dynamic-threshold {on,off}] [--guidance-scale S] [--create-gif] \\
        [--test-batches K] [--test-data-root DIR] [--mesh-dp D] [--mesh-tp T] \\
        [--mesh-slices S] [--tp-shard-activations] [--seq-parallel-attn]

Darcy writes ``<out>/validation/sample_statistics.csv`` (per-sample mean
|residual| and their mean, in the format of the JAX ``sample_eval.py``) and
one CSV per sample and channel (``<out>/validation/sample_<s>/sample_<c>.csv``).
A mechanics run sweeps ``test_level_1`` and ``test_level_2`` (the first
``--test-batches`` batches of each, all by default, under
``--test-data-root``/test/), and writes a level's ``residuals.csv``,
``rel_CE_error.csv``, ``rel_vf_error.csv``, ``fm_error.csv`` and
``sample_statistics.csv`` to ``<out>/<level>/``, with its first batch's
per-sample CSVs. The default ``--out`` is a fresh
``<model dir>/evaluation[_i]``, as the JAX ``sample_eval.py``'s (which
``scripts/diagnose_ood_tail.py`` reads). The correction,
thresholding and guidance options override the run's config, as in the JAX
``sample_eval.py`` (the corrections are Darcy's alone). A run trained with
``residual_grad_guidance`` samples with classifier-free guidance on its
residual gradient: two UNet calls a step, null + scale * (cond - null).
``<out>/eval_settings.json`` records the settings (the JAX ``sample_eval.py``'s keys,
and the port's timing and metric summary) once the evaluation has
finished; until then ``eval_settings.json.pending`` marks the directory as
in flight. ``--create-gif`` also writes each sample's PNGs and its
denoising GIFs (``sample_<s>_<c>.png``, ``sample_<s>/sample_<c>.gif``); it
needs matplotlib and imageio.

Under torchrun the evaluation runs on the mesh of the mesh flags (those of
``train``; the run's own describe its training): the mechanics sweep
splits each batch over the data ranks when it divides (every rank draws
the whole batch's x_init and noise and keeps its rows, so the samples equal
the one-rank sweep's) and gathers the statistics; Darcy sampling runs alike
on every rank; rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import p_sample_loop
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet, build_model
from physicsinformeddiffusionmodels_tpu_torch.parallel.collectives import gather_tensor
from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
    Mesh,
    is_main,
    run_mesh,
    shard_batch,
    shard_params,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.utils import viz
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import (
    init_distributed,
    launched_by_torchrun,
    resolve_device,
    set_fp32_exact,
)

# a run's mesh fields when no flag sets them: one rank
_ONE_RANK = dict(mesh_dp=None, mesh_tp=1, mesh_slices=1, tp_shard_activations=False,
                 seq_parallel_attn=False)


def load_run(model_dir: str | Path, step: int | None = None,
             compute_dtype: str | None = None,
             device: str | torch.device | None = None, mesh: Mesh | None = None,
             mesh_flags: dict | None = None) -> tuple[RunConfig, UNet, int]:
    """Config, EMA-weight UNet on ``device`` (in eval mode) and checkpoint
    step. The config's mesh fields are ``mesh_flags``' (one rank by
    default), and on ``mesh`` the UNet takes their tp options and keeps its
    rank's parameter shards."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    cfg = dataclasses.replace(RunConfig.load(model_dir / "config.json"),
                              **{**_ONE_RANK, **(mesh_flags or {})})
    ckpt_dir = model_dir / "model"
    path = ckpt_dir / f"checkpoint_{step}.msgpack" if step is not None else latest_checkpoint(ckpt_dir)
    if path is None or not Path(path).exists():
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    raw = load_checkpoint(path)
    model = build_model(cfg, compute_dtype, mesh)
    model.load_state_dict(torch_state_dict_from_flax(raw["ema_params"] or raw["params"]))
    return cfg, shard_params(model.to(dev), mesh).eval(), int(raw["step"])


def guided_denoise(model: UNet, physics: DarcyResidual, guidance_scale: float):
    """The denoiser of guided sampling: the residual gradient of x conditions
    one call, a zero cond the other, and the output is null + scale * (cond
    - null), at every scale (the JAX ``train.py`` sampler makes both calls at
    scale 1 too)."""

    def denoise(x, t):
        dr_dx = physics.residual_gradient(x)
        logits = model(x, t, cond=dr_dx)
        null_logits = model(x, t, cond=torch.zeros_like(dr_dx))
        return null_logits + (logits - null_logits) * guidance_scale

    return denoise


def _fresh_dir(base: Path) -> Path:
    out, i = base, 1
    while out.exists():
        out = base.with_name(f"{base.name}_{i}")
        i += 1
    return out


@torch.no_grad()
def sample_darcy(cfg: RunConfig, model: UNet, no_samples: int, seed: int,
                 device: torch.device, save_history: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Draw ``no_samples`` fields with the config's dynamic thresholding,
    CoCoGen corrections (one ``residual_correction`` step per correction)
    and, for a guided run, residual-gradient guidance at
    ``cfg.guidance_scale``; returns (samples [n, P, P, 2], residual [n, P*P,
    3], the [T, n, P, P, 2] history or None). All randomness comes from one
    generator seeded with ``seed`` on ``device``."""
    sched = create_schedule(cfg.diff_steps)
    physics = DarcyResidual(
        pixels_per_dim=cfg.pixels_per_dim, fd_acc=cfg.fd_acc,
        pixels_at_boundary=cfg.pixels_at_boundary, reverse_d1=cfg.reverse_d1,
        domain_length=cfg.domain_length, periodic=cfg.bcs == "periodic", device=device,
    )
    corrections = cfg.correction_mode in ("x0", "xt") and (cfg.N_correction or cfg.M_correction)
    P = cfg.pixels_per_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    x_init = torch.randn((no_samples, P, P, cfg.output_channels), generator=gen, device=device)
    denoise = (guided_denoise(model, physics, cfg.guidance_scale)
               if cfg.residual_grad_guidance else model)
    result = p_sample_loop(
        sched, denoise, x_init, gen, use_dynamic_threshold=cfg.use_dynamic_threshold,
        save_history=save_history,
        correction_fn=(lambda x: physics.residual_correction(x)[0]) if corrections else None,
        correction_mode=cfg.correction_mode, n_correction=cfg.N_correction,
        m_correction=cfg.M_correction)
    return result.x, physics.residual(result.x), result.history


def write_darcy_outputs(step_dir: Path, samples: np.ndarray, res_b: np.ndarray,
                        history: np.ndarray | None = None) -> None:
    """Per-sample CSVs (``sample_<s>/sample_<c>.csv``) and
    ``sample_statistics.csv`` under ``step_dir``; with a [T, n, P, P, C]
    ``history``, also each sample's PNGs and denoising GIFs."""
    for s in range(samples.shape[0]):
        (step_dir / f"sample_{s}").mkdir(parents=True, exist_ok=True)
        for c in range(samples.shape[-1]):
            np.savetxt(step_dir / f"sample_{s}" / f"sample_{c}.csv", samples[s, :, :, c],
                       delimiter=",")
            if history is not None:
                viz.save_field_image(samples[s, :, :, c], step_dir / f"sample_{s}_{c}.png",
                                     title=f"residual: {res_b[s]:.2e}")
                viz.image_history_to_gif(history[:, s, :, :, c],
                                         step_dir / f"sample_{s}" / f"sample_{c}.gif")
    with open(step_dir / "sample_statistics.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Sample Index", "Residuals (abs)"])
        for i, r in enumerate(res_b):
            w.writerow([i, r])
        w.writerow(["Mean", np.nanmean(res_b)])


def evaluate(model_dir: str | Path, no_samples: int = 3, compute_dtype: str | None = None,
             device: str | torch.device | None = None, seed: int = 0,
             out: str | Path | None = None, step: int | None = None, *,
             correction_mode: str | None = None, n_correction: int | None = None,
             m_correction: int | None = None, dynamic_threshold: bool | None = None,
             guidance_scale: float | None = None, create_gif: bool = False,
             test_batches: int = -1, test_data_root: str | Path | None = None,
             argv: list[str] | None = None, mesh_flags: dict | None = None) -> dict:
    """Load, sample, score and write; returns a summary dict. Darcy: the
    per-sample residuals (``res_b``) and the samples (``samples``, on the
    host), their residual median and mean, the sampling seconds and
    samples/s. Mechanics: the sweep of ``eval_mechanics`` over both test
    levels (``test_batches`` batches a level, -1 for all, from
    ``test_data_root``), under ``levels``. Both: the correction and guidance
    settings, the output directory and the device. The correction,
    thresholding and guidance arguments that are not None override the run's
    config. ``argv`` is the command line recorded in ``eval_settings.json``.
    ``mesh_flags``: the mesh fields of a run under torchrun (``train``'s
    flags); without torchrun, flags of more than one rank raise."""
    dev = resolve_device(device)
    if launched_by_torchrun():
        dev = init_distributed(dev)
    flags = {**_ONE_RANK, **(mesh_flags or {})}
    mesh = run_mesh(dev, flags["mesh_dp"], flags["mesh_tp"], flags["mesh_slices"])
    main = is_main(mesh)
    set_fp32_exact()
    cfg, model, ckpt_step = load_run(model_dir, step, compute_dtype, dev, mesh, flags)
    for name, value in (("correction_mode", correction_mode), ("N_correction", n_correction),
                        ("M_correction", m_correction),
                        ("use_dynamic_threshold", dynamic_threshold),
                        ("guidance_scale", guidance_scale)):
        if value is not None:
            setattr(cfg, name, value)
    mechanics = cfg.gov_eqs == "mechanics"
    if mechanics and cfg.correction_mode not in (None, "none"):
        # as in the JAX sample_eval.py: the corrections are Darcy's alone
        print(f"WARNING: correction_mode={cfg.correction_mode!r} is darcy-only; running "
              "UNCORRECTED and recording 'none'.", file=sys.stderr)
        cfg.correction_mode, cfg.M_correction, cfg.N_correction = "none", 0, 0
    out_dir = Path(out) if out is not None else _fresh_dir(Path(model_dir) / "evaluation")
    if main:
        out_dir.mkdir(parents=True, exist_ok=True)
        print(f"Checkpoint step {ckpt_step} from {model_dir}; sampling on {dev}")
    # the JAX sample_eval.py's keys (test_batches is its mechanics sweep's,
    # None for Darcy), then the port's own
    settings = {
        "argv": list(argv or []), "model_dir": str(model_dir), "checkpoint_step": ckpt_step,
        "no_samples": no_samples, "test_batches": test_batches if mechanics else None,
        "seed": seed, "correction_mode": cfg.correction_mode,
        "M_correction": cfg.M_correction, "N_correction": cfg.N_correction,
        "guidance_scale": cfg.guidance_scale,
        "use_dynamic_threshold": cfg.use_dynamic_threshold,
        "compute_dtype": compute_dtype or cfg.compute_dtype,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_devices": dist.get_world_size() if mesh is not None else 1,
        "residual_grad_guidance": cfg.residual_grad_guidance, "diff_steps": cfg.diff_steps,
        "device": str(dev),
    }
    pending = out_dir / "eval_settings.json.pending"
    if main:
        pending.write_text(json.dumps(settings, indent=2) + "\n")
    if mechanics:
        levels = eval_mechanics(cfg, model, out_dir, no_samples, test_batches, seed,
                                test_data_root, create_gif, dev, mesh)
        summary = {**settings, "levels": {k: {m: v for m, v in d.items()
                                              if not isinstance(v, np.ndarray)}
                                          for k, d in levels.items()}}
        extra = {"levels": levels}
    else:
        summary, extra = _evaluate_darcy(cfg, model, out_dir, no_samples, seed, create_gif,
                                         dev, settings, main)
    if main:
        (out_dir / "eval_settings.json").write_text(json.dumps(summary, indent=2) + "\n")
        pending.unlink(missing_ok=True)
    return {**summary, **extra, "out_dir": out_dir}


def _evaluate_darcy(cfg: RunConfig, model: UNet, out_dir: Path, no_samples: int, seed: int,
                    create_gif: bool, dev: torch.device, settings: dict,
                    write: bool = True) -> tuple[dict, dict]:
    """Darcy sampling, scored and (``write``) written: (summary, host arrays)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    samples, residual, history = sample_darcy(cfg, model, no_samples, seed, dev,
                                              save_history=create_gif)
    res_b = residual.abs().mean(dim=(1, 2)).cpu().numpy()  # host copy waits for the device
    seconds = time.perf_counter() - t0

    samples = samples.float().cpu().numpy()
    if write:
        write_darcy_outputs(out_dir / "validation", samples, res_b,
                            None if history is None else history.float().cpu().numpy())
    summary = {
        **settings,
        "residual_median": float(np.nanmedian(res_b)),
        "residual_mean": float(np.nanmean(res_b)),
        "seconds": seconds, "samples_per_s": no_samples / seconds,
    }
    if write:
        print(f"residual mean {summary['residual_mean']:.3e} "
              f"median {summary['residual_median']:.3e}")
        print(f"Evaluation done ({seconds:.2f} s, {summary['samples_per_s']:.2f} samples/s); "
              f"outputs in {out_dir}")
    return summary, {"res_b": res_b, "samples": samples}


MECHANICS_LEVELS = ("test_level_1", "test_level_2")


def _rows_whole(values: list, mesh: Mesh | None, split: bool, dev: torch.device) -> list:
    """Each array of the rank's rows of a split batch gathered whole over
    the data ranks (in rank order: the batch's), in its own dtype; the
    arrays as they are when the batch was not split."""
    if not split:
        return values
    out = []
    for v in values:
        a = np.asarray(v)
        whole = gather_tensor(torch.as_tensor(a, dtype=torch.float64, device=dev), 0,
                              mesh.data_group)
        out.append(whole.cpu().numpy().astype(a.dtype))
    return out


def eval_mechanics(cfg: RunConfig, model: UNet, out_dir: Path, no_samples: int,
                   test_batches: int, seed: int, test_data_root: str | Path | None,
                   create_gif: bool, dev: torch.device, mesh: Mesh | None = None) -> dict:
    """The mechanics sweep of the JAX ``sample_eval.py``: for the
    in-distribution (``test_level_1``) and out-of-distribution
    (``test_level_2``) sets under ``<test_data_root>/test/`` (default: two
    levels above ``cfg.data_dir``), sample each batch of ``train_batch_size``
    conditions (the first ``test_batches``; -1 for all), score it (residual,
    rel_CE from the checked solves, vf error, floating material) and write
    ``residuals.csv``, ``rel_CE_error.csv``, ``rel_vf_error.csv``,
    ``fm_error.csv`` and ``sample_statistics.csv`` (JAX's columns and its
    Mean row) a level, with the first batch's per-sample CSVs (and, with
    ``create_gif``, its PNGs and GIFs). Returns, a level, the per-sample
    arrays and the summary (medians, means, fallbacks, sampling and solve
    seconds, samples/s). On a ``mesh`` a batch that divides over the data
    ranks is split over them and its results gathered (the fallbacks
    summed, the solve iterations the most of a rank's); rank 0 writes."""
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import (
        NpyFieldDataset,
        iter_batches,
    )
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual
    from physicsinformeddiffusionmodels_tpu_torch.train_mechanics import (
        draw_sample,
        topopt_eval_of_final,
        topopt_metrics,
        write_sample_csvs,
    )

    main = is_main(mesh)
    base = Path(test_data_root) if test_data_root else Path(cfg.data_dir).parent.parent
    dirs = {level: base / "test" / level / "fields" for level in MECHANICS_LEVELS}
    for level, ddir in dirs.items():
        if not ddir.exists():
            raise FileNotFoundError(
                f"{ddir} not found: the mechanics sweep needs both test_level_1 "
                "(in-distribution) and test_level_2 (out-of-distribution); make them with "
                "python -m physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets")
    mech = MechanicsResidual(pixels_per_dim=cfg.pixels_per_dim, device=dev)
    sample_cfg = dataclasses.replace(cfg, topopt_eval=False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_data = 1 if mesh is None else mesh.n_data
    out, t_start = {}, time.perf_counter()
    for level, ddir in dirs.items():
        ldir = out_dir / level
        if main:
            ldir.mkdir(parents=True, exist_ok=True)
        res_l, ce_l, vf_l, fm_l = [], [], [], []
        fallback, sample_s, solve_s, iters = 0, 0.0, 0.0, []
        batches = iter_batches(NpyFieldDataset(ddir), cfg.train_batch_size)
        for bi, batch in enumerate(batches):
            b = torch.as_tensor(batch, device=dev)
            split = n_data > 1 and b.shape[0] % n_data == 0
            rows = None
            if split:
                k = b.shape[0] // n_data
                rows = (b.shape[0], slice(mesh.data_rank * k, (mesh.data_rank + 1) * k))
                b = shard_batch(b, mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            sample = draw_sample(sample_cfg, model, b, mech, gen,
                                 save_history=create_gif and bi == 0, rows=rows)
            res_b = sample.residual.abs().mean(dim=1).cpu().numpy()
            t1 = time.perf_counter()
            sample = sample._replace(topopt=topopt_eval_of_final(mech, sample.final, b))
            iters.append(int(sample.topopt["solve_iterations"]))
            t2 = time.perf_counter()
            topopt, fm = topopt_metrics(mech, sample, b)
            sample_s, solve_s = sample_s + (t1 - t0), solve_s + (t2 - t1)
            counts = torch.tensor([topopt["n_solve_fallback"], iters[-1]], device=dev)
            if split:  # the whole batch's fallbacks, and its slowest solve
                dist.all_reduce(counts[:1], group=mesh.data_group)
                dist.all_reduce(counts[1:], op=dist.ReduceOp.MAX, group=mesh.data_group)
            fallback += int(counts[0])
            iters[-1] = int(counts[1])
            res_b, ce_b, vf_b, fm = _rows_whole(
                [res_b, topopt["rel_CE_error_full_batch"], topopt["vf_error_full_batch"], fm],
                mesh, split, dev)
            res_l.append(res_b)
            ce_l.append(ce_b)
            vf_l.append(vf_b)
            fm_l.append(fm)
            if bi == 0:
                finals, comp = _rows_whole([sample.final.float().cpu().numpy(),
                                            sample.compliance.cpu().numpy()], mesh, split, dev)
                history = None
                if create_gif:
                    history = sample.history.float().cpu().numpy()
                    if split:
                        history = np.swapaxes(_rows_whole([np.swapaxes(history, 0, 1)], mesh,
                                                          split, dev)[0], 0, 1)
                if main:
                    write_sample_csvs(ldir, finals, no_samples)
                    if create_gif:
                        _write_mechanics_images(ldir, finals, history, res_b, comp, no_samples)
            if test_batches != -1 and bi + 1 >= test_batches:
                break
        res, ce, vfe, fm = (np.concatenate(v) for v in (res_l, ce_l, vf_l, fm_l))
        if main:
            for name, values in (("residuals", res), ("rel_CE_error", ce),
                                 ("rel_vf_error", vfe), ("fm_error", fm)):
                np.savetxt(ldir / f"{name}.csv", values, delimiter=",")
            with open(ldir / "sample_statistics.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["Sample Index", "Residuals (abs)", "rel_CE_error", "rel_vf_error",
                            "fm"])
                for i in range(len(res)):
                    w.writerow([i, res[i], ce[i], vfe[i], fm[i]])
                w.writerow(["Mean", np.nanmean(res), np.nanmean(ce), np.nanmean(vfe),
                            np.nanmean(fm)])
            print(f"On {level}:")
            print("CE median error:", np.median(ce), "CE mean error:", np.mean(ce),
                  "CE max error:", np.max(ce), "VF mean error:", np.mean(vfe),
                  "FM mean error:", np.mean(fm), "Mean residual:", np.mean(res),
                  "Median residual:", np.median(res),
                  f"(exact-solve fallbacks: {fallback}/{len(ce)})")
        out[level] = {
            "res_b": res, "rel_CE": ce, "rel_vf": vfe, "fm": fm,
            "n": int(len(ce)), "rel_CE_median": float(np.median(ce)),
            "rel_CE_mean": float(np.mean(ce)), "rel_vf_mean": float(np.mean(vfe)),
            "fm_mean": float(np.mean(fm)), "residual_median": float(np.median(res)),
            "residual_mean": float(np.mean(res)), "n_solve_fallback": int(fallback),
            "solve_iterations": iters, "sampling_seconds": sample_s,
            "samples_per_s": len(ce) / sample_s, "solve_seconds": solve_s,
        }
    if main:
        print(f"Evaluation done ({time.perf_counter() - t_start:.2f} s); outputs in {out_dir}")
    return out


def _write_mechanics_images(ldir: Path, finals: np.ndarray, history: np.ndarray,
                            res_b: np.ndarray, compliance: np.ndarray, n: int) -> None:
    """PNGs of the first ``n`` final states, titled with their residual and
    compliance, and their denoising GIFs (needs matplotlib and imageio)."""
    for s in range(min(n, finals.shape[0])):
        for c in range(finals.shape[-1]):
            viz.save_field_image(finals[s, :, :, c], ldir / f"sample_{s}_{c}.png",
                                 title=f"eq: {res_b[s]:.2e}\nopt: {compliance[s]:.2f}")
            viz.image_history_to_gif(history[:, s, :, :, c],
                                     ldir / f"sample_{s}" / f"sample_{c}.gif")


def parse_args(argv=None) -> argparse.Namespace:
    from physicsinformeddiffusionmodels_tpu_torch.train import add_mesh_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--no-samples", type=int, default=3)
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                    help="override the training compute dtype at sampling time")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="output directory")
    # inference-time overrides of the run's config, as in the JAX sample_eval.py
    ap.add_argument("--correction-mode", default=None, choices=["none", "x0", "xt"])
    ap.add_argument("--n-correction", type=int, default=None,
                    help="correct in the last N steps")
    ap.add_argument("--m-correction", type=int, default=None,
                    help="M correction steps after the loop")
    ap.add_argument("--dynamic-threshold", default=None, choices=["on", "off"])
    ap.add_argument("--guidance-scale", type=float, default=None,
                    help="classifier-free guidance scale of a guided run")
    ap.add_argument("--create-gif", action="store_true",
                    help="also write PNGs and denoising GIFs (needs matplotlib and imageio)")
    ap.add_argument("--test-batches", type=int, default=-1,
                    help="mechanics: batches a test level (-1: all)")
    ap.add_argument("--test-data-root", default=None,
                    help="mechanics: the directory holding test/test_level_{1,2}/fields")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from physicsinformeddiffusionmodels_tpu_torch.train import mesh_kwargs

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    threshold = None if args.dynamic_threshold is None else args.dynamic_threshold == "on"
    evaluate(args.model_dir, args.no_samples, args.compute_dtype, args.device, args.seed,
             args.out, args.step, correction_mode=args.correction_mode,
             n_correction=args.n_correction, m_correction=args.m_correction,
             dynamic_threshold=threshold, guidance_scale=args.guidance_scale,
             create_gif=args.create_gif, test_batches=args.test_batches,
             test_data_root=args.test_data_root, argv=argv, mesh_flags=mesh_kwargs(args))


if __name__ == "__main__":
    sys.exit(main())
