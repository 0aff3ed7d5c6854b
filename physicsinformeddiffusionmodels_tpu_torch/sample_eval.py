"""Darcy evaluation of a trained checkpoint: sample, then score the samples
by their PDE residual (port of the Darcy part of the JAX ``sample_eval.py``).

    python -m physicsinformeddiffusionmodels_tpu_torch.sample_eval \\
        --model-dir results/darcy_300k_fp32head/portable --no-samples 64 \\
        --compute-dtype float32 [--device cpu] [--seed 0] [--out DIR]

Writes ``<out>/validation/sample_statistics.csv`` (per-sample mean |residual|
and their mean, in the format of the JAX ``sample_eval.py``) and one CSV per sample and
channel (``<out>/validation/sample_<s>/sample_<c>.csv``). The default
``--out`` is a fresh ``trained_models/<run name>/evaluation_torch[_i]``.
Images and GIFs are not written in this slice.
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


def _check_supported(cfg: RunConfig) -> None:
    corrections = cfg.correction_mode in ("x0", "xt") and (cfg.N_correction or cfg.M_correction)
    missing = [name for name, on in (
        ("residual corrections", corrections),
        ("residual-gradient guidance", cfg.residual_grad_guidance),
        ("dynamic thresholding", cfg.use_dynamic_threshold),
    ) if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def _fresh_dir(base: Path) -> Path:
    out, i = base, 1
    while out.exists():
        out = base.with_name(f"{base.name}_{i}")
        i += 1
    return out


@torch.no_grad()
def sample_darcy(cfg: RunConfig, model: UNet, no_samples: int, seed: int,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``no_samples`` fields; returns (samples [n, P, P, 2], residual
    [n, P*P, 3]). All randomness comes from one generator seeded with
    ``seed`` on ``device``."""
    _check_supported(cfg)
    sched = create_schedule(cfg.diff_steps)
    physics = DarcyResidual(
        pixels_per_dim=cfg.pixels_per_dim, fd_acc=cfg.fd_acc,
        pixels_at_boundary=cfg.pixels_at_boundary, reverse_d1=cfg.reverse_d1,
        domain_length=cfg.domain_length, periodic=cfg.bcs == "periodic", device=device,
    )
    P = cfg.pixels_per_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    x_init = torch.randn((no_samples, P, P, cfg.output_channels), generator=gen, device=device)
    x = p_sample_loop(sched, model, x_init, gen)
    return x, physics.residual(x)


def write_darcy_outputs(step_dir: Path, samples: np.ndarray, res_b: np.ndarray) -> None:
    """Per-sample CSVs (``sample_<s>/sample_<c>.csv``) and
    ``sample_statistics.csv`` under ``step_dir``."""
    for s in range(samples.shape[0]):
        (step_dir / f"sample_{s}").mkdir(parents=True, exist_ok=True)
        for c in range(samples.shape[-1]):
            np.savetxt(step_dir / f"sample_{s}" / f"sample_{c}.csv", samples[s, :, :, c],
                       delimiter=",")
    with open(step_dir / "sample_statistics.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Sample Index", "Residuals (abs)"])
        for i, r in enumerate(res_b):
            w.writerow([i, r])
        w.writerow(["Mean", np.nanmean(res_b)])


def evaluate(model_dir: str | Path, no_samples: int = 3, compute_dtype: str | None = None,
             device: str | torch.device | None = None, seed: int = 0,
             out: str | Path | None = None, step: int | None = None) -> dict:
    """Load, sample, score and write; returns a summary dict with the
    per-sample residuals (``res_b``), their median and mean, the sampling
    seconds and samples/s, the output directory and the device."""
    dev = resolve_device(device)
    set_fp32_exact()
    cfg, model, ckpt_step = load_run(model_dir, step, compute_dtype, dev)
    out_dir = Path(out) if out is not None else _fresh_dir(
        Path("trained_models") / cfg.name / "evaluation_torch")
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"Checkpoint step {ckpt_step} from {model_dir}; sampling {no_samples} on {dev}")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    samples, residual = sample_darcy(cfg, model, no_samples, seed, dev)
    res_b = residual.abs().mean(dim=(1, 2)).cpu().numpy()  # host copy waits for the device
    seconds = time.perf_counter() - t0

    write_darcy_outputs(out_dir / "validation", samples.float().cpu().numpy(), res_b)
    summary = {
        "model_dir": str(model_dir), "checkpoint_step": ckpt_step, "no_samples": no_samples,
        "seed": seed, "compute_dtype": compute_dtype or cfg.compute_dtype,
        "diff_steps": cfg.diff_steps, "device": str(dev),
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "residual_median": float(np.nanmedian(res_b)),
        "residual_mean": float(np.nanmean(res_b)),
        "seconds": seconds, "samples_per_s": no_samples / seconds,
    }
    (out_dir / "eval_settings.json").write_text(json.dumps(summary, indent=2) + "\n")
    print(f"residual mean {summary['residual_mean']:.3e} "
          f"median {summary['residual_median']:.3e}")
    print(f"Evaluation done ({seconds:.2f} s, {summary['samples_per_s']:.2f} samples/s); "
          f"outputs in {out_dir}")
    return {**summary, "res_b": res_b, "out_dir": out_dir}


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
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    evaluate(args.model_dir, args.no_samples, args.compute_dtype, args.device, args.seed,
             args.out, args.step)


if __name__ == "__main__":
    sys.exit(main())
