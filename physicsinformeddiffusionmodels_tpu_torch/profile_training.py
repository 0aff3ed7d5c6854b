"""Where the device time of a Darcy training step goes, on the card.

    python -m physicsinformeddiffusionmodels_tpu_torch.profile_training \\
        [--model-dir results/darcy_300k_fp32head/portable]

Trains the checkpoint's EMA weights (fresh Adam) on a device-resident set
of 256 random fields with the main path's step (``train.
build_darcy_loss_fn`` + ``trainer.resident_train_step``), in each of
``CONFIGS``: fp32, and the study's recipe, bf16 compute with the fp32 head,
each with the default UNet and with ``cm_conv_stages`` on (the channel-major
level stages through K4); each step eager, then replayed from a CUDA graph
of one step (``trainer.GraphedTrainStep``, as ``train --chunk-steps K``
runs it on the card). For each: three steps to warm up (the graph's
capture among them), then ``STEPS`` steps of ``BATCH`` (the run's training
batch) under ``torch.profiler``, then ``STEPS`` more timed by the host clock
alone (``wall_ms_per_step_unprofiled``: the profiler adds host time a
launch). A step's device work does not depend on the field values, so no
data is generated. Prints per step the wall time, the device busy time and
idle share, and the device time by kernel group (K1, K2 and K4 forward and
backward, convolutions, matmuls, other) and by kernel name; each
profile ends in a line with the same as one JSON object.
"""

from __future__ import annotations

import argparse
import time

import torch

from physicsinformeddiffusionmodels_tpu_torch import train
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.profile_sampling import device_profile, report
from physicsinformeddiffusionmodels_tpu_torch.sample_eval import load_run
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    GraphedTrainStep,
    create_train_state,
    make_optimizer,
    resident_train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

BATCH, STEPS = 64, 10
# (compute dtype, fp32 head, channel-major conv stages) of each profiled step
CONFIGS = (("float32", False, False), ("bfloat16", True, False),
           ("float32", False, True), ("bfloat16", True, True))


def profile(model_dir: str, compute_dtype: str, fp32_head: bool, cm: bool,
            graph: bool = False) -> dict:
    dev = torch.device("cuda")
    set_fp32_exact()
    cfg, weights, _ = load_run(model_dir, device="cpu")
    cfg.compute_dtype, cfg.fp32_head = compute_dtype, fp32_head
    model = train.build_model(cfg)
    model.load_state_dict(weights.state_dict())
    model.cm_conv_stages = cm
    model = model.to(dev)
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip))
    P = cfg.pixels_per_dim
    data = torch.randn((256, P, P, 2), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    gen = torch.Generator(device=dev)
    graphed = GraphedTrainStep(state, loss_fn, cfg.ema_decay, cfg.ema_start) if graph else None

    def run(n):
        for _ in range(n):
            resident_train_step(state, loss_fn, data, BATCH, cfg.diff_steps, cfg.seed, gen,
                                ema_mu=cfg.ema_decay, ema_start=cfg.ema_start, graphed=graphed)

    run(3)  # warm-up: kernel build, cuDNN choice, Adam state, the graph's capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = device_profile(lambda: run(STEPS), STEPS)
    t0 = time.perf_counter()
    run(STEPS)
    torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / STEPS
    return {**r, "batch": BATCH, "compute_dtype": compute_dtype, "fp32_head": fp32_head,
            "cm_conv_stages": cm, "cuda_graph": graph, "wall_ms_per_step_unprofiled": unprofiled,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default="results/darcy_300k_fp32head/portable")
    args = ap.parse_args(argv)
    for dtype, head, cm in CONFIGS:
        for graph in (False, True):
            r = profile(args.model_dir, dtype, head, cm, graph)
            report(r, f"train batch {BATCH}, {dtype}{' + fp32 head' if head else ''}"
                      f"{', cm_conv_stages' if cm else ''}{', CUDA graph' if graph else ''}")
            print(f"  {r['wall_ms_per_step_unprofiled']:.3f} ms/step wall without the profiler")


if __name__ == "__main__":
    main()
