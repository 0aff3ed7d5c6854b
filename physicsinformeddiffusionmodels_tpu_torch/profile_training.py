"""Where the device time of a Darcy training step goes, on the card.

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_training \\
        [--model-dir results/darcy_300k_fp32head/portable]

Trains the checkpoint's EMA weights (fp32, fresh Adam) on a device-resident
set of 256 random fields with the main path's step (``train.
build_darcy_loss_fn`` + ``trainer.resident_train_step``): three steps to
warm up, then ``STEPS`` steps of ``BATCH`` (the run's training batch) under
``torch.profiler``. A step's device work does not depend on the field
values, so no data is generated. Prints per step the wall time, the device
busy time and idle share, and the device time by kernel group (K1 and K2
forward and backward, convolutions, matmuls, other) and by kernel name; the
last line is the same as one JSON object.
"""

from __future__ import annotations

import argparse

import torch

from physicsinformeddiffusionmodels_tpu_torch import train
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.profile_sampling import device_profile, report
from physicsinformeddiffusionmodels_tpu_torch.sample_eval import load_run
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    resident_train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

BATCH, STEPS = 64, 10


def profile(model_dir: str) -> dict:
    dev = torch.device("cuda")
    set_fp32_exact()
    cfg, model, _ = load_run(model_dir, compute_dtype="float32", device=dev)
    cfg.compute_dtype = "float32"
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip))
    P = cfg.pixels_per_dim
    data = torch.randn((256, P, P, 2), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    gen = torch.Generator(device=dev)

    def run(n):
        for _ in range(n):
            resident_train_step(state, loss_fn, data, BATCH, cfg.diff_steps, cfg.seed, gen,
                                ema_mu=cfg.ema_decay, ema_start=cfg.ema_start)

    run(3)  # warm-up: kernel build, cuDNN choice, Adam state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = device_profile(lambda: run(STEPS), STEPS)
    return {**r, "batch": BATCH, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="results/darcy_300k_fp32head/portable")
    args = ap.parse_args(argv)
    report(profile(args.model_dir), f"train batch {BATCH}")


if __name__ == "__main__":
    main()
