"""Darcy evaluation of a trained checkpoint: sample, then score the samples
by their PDE residual (port of the Darcy part of the JAX ``sample_eval.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.sample_eval \\
        --model-dir results/darcy_300k_fp32head/portable --no-samples 64 \\
        --compute-dtype float32 [--device cpu] [--seed 0] [--out DIR] \\
        [--correction-mode {none,x0,xt} --n-correction N --m-correction M] \\
        [--dynamic-threshold {on,off}] [--guidance-scale S] [--create-gif]

Writes ``<out>/validation/sample_statistics.csv`` (per-sample mean |residual|
and their mean, in the format of the JAX ``sample_eval.py``) and one CSV per sample and
channel (``<out>/validation/sample_<s>/sample_<c>.csv``). The default
``--out`` is a fresh ``trained_models/<run name>/evaluation_torch[_i]``.
The correction, thresholding and guidance options override the run's
config, as in the JAX ``sample_eval.py``. A run trained with
``residual_grad_guidance`` samples with classifier-free guidance on its
residual gradient: two UNet calls a step, null + scale * (cond - null).
``<out>/eval_settings.json`` records the settings (the JAX ``sample_eval.py``'s keys,
and the port's timing and residual summary) once the evaluation has
finished; until then ``eval_settings.json.pending`` marks the directory as
in flight. ``--create-gif`` also writes each sample's PNGs and its
denoising GIFs (``sample_<s>_<c>.png``, ``sample_<s>/sample_<c>.gif``); it
needs matplotlib and imageio.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import p_sample_loop
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet, build_model
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.utils import viz
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import resolve_device, set_fp32_exact


def load_run(model_dir: str | Path, step: int | None = None,
             compute_dtype: str | None = None,
             device: str | torch.device | None = None) -> tuple[RunConfig, UNet, int]:
    """Config, EMA-weight UNet on ``device`` (in eval mode) and checkpoint step."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    cfg = RunConfig.load(model_dir / "config.json")
    ckpt_dir = model_dir / "model"
    path = ckpt_dir / f"checkpoint_{step}.msgpack" if step is not None else latest_checkpoint(ckpt_dir)
    if path is None or not Path(path).exists():
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    raw = load_checkpoint(path)
    model = build_model(cfg, compute_dtype)
    model.load_state_dict(torch_state_dict_from_flax(raw["ema_params"] or raw["params"]))
    return cfg, model.to(dev).eval(), int(raw["step"])


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
             argv: list[str] | None = None) -> dict:
    """Load, sample, score and write; returns a summary dict with the
    per-sample residuals (``res_b``) and the samples (``samples``, on the
    host), their residual median and mean, the sampling seconds and
    samples/s, the correction and guidance settings, the output directory
    and the device. The correction, thresholding and guidance arguments
    that are not None override the run's config. ``argv`` is the command
    line recorded in ``eval_settings.json``."""
    dev = resolve_device(device)
    set_fp32_exact()
    cfg, model, ckpt_step = load_run(model_dir, step, compute_dtype, dev)
    for name, value in (("correction_mode", correction_mode), ("N_correction", n_correction),
                        ("M_correction", m_correction),
                        ("use_dynamic_threshold", dynamic_threshold),
                        ("guidance_scale", guidance_scale)):
        if value is not None:
            setattr(cfg, name, value)
    out_dir = Path(out) if out is not None else _fresh_dir(
        Path("trained_models") / cfg.name / "evaluation_torch")
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"Checkpoint step {ckpt_step} from {model_dir}; sampling {no_samples} on {dev}")
    # the JAX sample_eval.py's keys (test_batches is its mechanics sweep's: None
    # here), then the port's own
    settings = {
        "argv": list(argv or []), "model_dir": str(model_dir), "checkpoint_step": ckpt_step,
        "no_samples": no_samples, "test_batches": None, "seed": seed,
        "correction_mode": cfg.correction_mode, "M_correction": cfg.M_correction,
        "N_correction": cfg.N_correction, "guidance_scale": cfg.guidance_scale,
        "use_dynamic_threshold": cfg.use_dynamic_threshold,
        "compute_dtype": compute_dtype or cfg.compute_dtype,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "residual_grad_guidance": cfg.residual_grad_guidance, "diff_steps": cfg.diff_steps,
        "device": str(dev),
    }
    pending = out_dir / "eval_settings.json.pending"
    pending.write_text(json.dumps(settings, indent=2) + "\n")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    samples, residual, history = sample_darcy(cfg, model, no_samples, seed, dev,
                                              save_history=create_gif)
    res_b = residual.abs().mean(dim=(1, 2)).cpu().numpy()  # host copy waits for the device
    seconds = time.perf_counter() - t0

    samples = samples.float().cpu().numpy()
    write_darcy_outputs(out_dir / "validation", samples, res_b,
                        None if history is None else history.float().cpu().numpy())
    summary = {
        **settings,
        "residual_median": float(np.nanmedian(res_b)),
        "residual_mean": float(np.nanmean(res_b)),
        "seconds": seconds, "samples_per_s": no_samples / seconds,
    }
    (out_dir / "eval_settings.json").write_text(json.dumps(summary, indent=2) + "\n")
    pending.unlink(missing_ok=True)
    print(f"residual mean {summary['residual_mean']:.3e} "
          f"median {summary['residual_median']:.3e}")
    print(f"Evaluation done ({seconds:.2f} s, {summary['samples_per_s']:.2f} samples/s); "
          f"outputs in {out_dir}")
    return {**summary, "res_b": res_b, "samples": samples, "out_dir": out_dir}


def parse_args(argv=None) -> argparse.Namespace:
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
    return ap.parse_args(argv)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    threshold = None if args.dynamic_threshold is None else args.dynamic_threshold == "on"
    evaluate(args.model_dir, args.no_samples, args.compute_dtype, args.device, args.seed,
             args.out, args.step, correction_mode=args.correction_mode,
             n_correction=args.n_correction, m_correction=args.m_correction,
             dynamic_threshold=threshold, guidance_scale=args.guidance_scale,
             create_gif=args.create_gif, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
