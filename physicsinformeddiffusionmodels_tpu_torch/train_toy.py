"""Toy study driver (port of the root ``train_toy.py``): 2-D points on the
unit circle.

    python -m physicsinformeddiffusionmodels_tpu_torch.train_toy [--name N] \\
        [--pred-mode {x0,eps,mu}] [--x0-estimation {mean,sample}] [--epochs E] \\
        [--c-residual C] [--output-dir DIR] [--create-gif] [--device cpu]

Trains the conditional MLP denoiser (``models/toy.py``) with the
physics-informed diffusion loss (data + residual + inequality +
optimisation terms of ``physics/toy.py``) in any of the three prediction
modes (x0, eps, mu), with the model's own x0 estimate or a DDIM chain
(``x0_estimation='sample'``), antithetic timesteps and the toy's
log-likelihood clamp. The data are 10^4 points on the circle from
``np.random.default_rng(42)``, as the JAX driver draws them; each epoch
takes them in a fresh permutation, B = 128 a step; Adam with a global-norm
clip of 1.0, no EMA. Every ``sample_freq`` epochs the model samples
``no_samples`` points (100 steps, noise suppressed at t = 0); the run
writes ``metrics.csv`` with the JAX driver's keys, ``csv/step_<N>_sample.csv``
a sampling epoch, and at the end ``model/checkpoint_<N>.msgpack`` with
``config.json``, which the JAX package's ``load_toy_run`` reads. The
scatter panels (``step_<N>.png``) and the trajectory GIFs are written only
with ``--create-gif``, which needs matplotlib and imageio.

Randomness: the permutations, timesteps, noise and sampling draws come from
one ``torch.Generator`` on the run's device, seeded with the config's
``seed``; the initial weights from a CPU generator with the same seed.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import (
    TOY_LL_CLAMP,
    LossWeights,
    antithetic_timesteps,
    pidm_loss,
)
from physicsinformeddiffusionmodels_tpu_torch.diffusion.sampling import (
    ddim_sample_x0,
    p_sample_loop,
)
from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.toy import ConditionalModel
from physicsinformeddiffusionmodels_tpu_torch.physics.toy import (
    build_toy_constraint,
    hypersphere_residual,
    sample_hypersphere,
)
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    msgpack_restore,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.metrics import MetricsLogger
from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    create_train_state,
    make_optimizer,
    train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.utils import viz
from physicsinformeddiffusionmodels_tpu_torch.utils.platform import resolve_device, set_fp32_exact

# the columns of the JAX driver's metrics.csv, in its order
_COLUMNS = ["step", "time", "loss", "loss_data", "loss_residual", "loss_inequality",
            "loss_optimization", "residual_samples"]
N_DATA = 10**4
# the JAX driver's EMA gate: past every run, so the EMA stays a copy
EMA_START = 10**9


def default_config() -> dict:
    """The JAX driver's toy config, key for key."""
    return {
        "name": "run_1",
        "x0_estimation": "sample",  # 'mean' or 'sample'
        "reduced_ddim_steps": 0,
        "model_pred_mode": "x0",  # 'x0', 'eps', 'mu'
        "c_data": 1.0,
        "c_residual": 0.005,  # 0.1 for mean estimation, 0.005 for sample
        "c_ineq": 0.0,
        "lambda_opt": 0.0,
        "true_randomness": False,
        "dim": 2,
        "n_steps": 100,
        "use_dynamic_threshold": False,
        "train_num_steps": 400,  # epochs over the 10^4-point dataset
        "batch_size": 128,
        "no_samples": 1000,
        "sample_freq": 10,
        "tot_eval_steps": 11,
        "fix_axes": True,
        "save_output": True,
        "create_gif": False,
        "wandb_track": False,
        "lr": 5e-4,
        "seed": 0,
        # the constraint as a registry spec; a saved run rebuilds it from this
        "constraint_spec": {"name": "hypersphere", "kwargs": {}},
    }


def build_loss_fn(sched, config: dict):
    """``loss_fn(model, batch, t, noise) -> (loss, aux)`` of the config: the
    toy physics, TOY_LL_CLAMP, and with ``x0_estimation='sample'`` the DDIM
    estimate, whose chain calls the model on its own advancing state (the
    model is the chain's ``denoise_fn``, as in the JAX toy driver; the Darcy
    driver's chain re-queries the original x_t instead)."""
    physics_fn = build_toy_constraint(config.get("constraint_spec"))
    weights = LossWeights(c_data=config["c_data"], c_residual=config["c_residual"],
                          c_ineq=config["c_ineq"], lambda_opt=config["lambda_opt"])
    pred_mode = config["model_pred_mode"]
    use_ddim = config["x0_estimation"] == "sample"
    ddim_steps = config["reduced_ddim_steps"]

    def loss_fn(model, batch, t, noise):
        sampler = None
        if use_ddim:
            def sampler(x_t, tt):
                return ddim_sample_x0(sched, model, x_t, tt, ddim_steps=ddim_steps,
                                      pred_mode=pred_mode)

        return pidm_loss(sched, batch, t, noise, denoise_fn=model, physics_fn=physics_fn,
                         weights=weights, pred_mode=pred_mode, x0_sampler=sampler,
                         ll_clamp=TOY_LL_CLAMP)

    return loss_fn


def load_toy_run(model_dir, device=None):
    """A saved toy run (the port's or the JAX package's): (model with the
    checkpoint's weights on ``device``, schedule, config, physics_fn rebuilt
    from the stored constraint spec)."""
    path = latest_checkpoint(Path(model_dir) / "model")
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {Path(model_dir) / 'model'}")
    raw = msgpack_restore(path.read_bytes())
    config = json.loads((path.parent / "config.json").read_text())
    model = ConditionalModel(dim=config["dim"], n_steps=config["n_steps"])
    model.load_state_dict(torch_state_dict_from_flax(raw["params"]))
    model = model.to(resolve_device(device))
    sched = create_schedule(config["n_steps"])
    return model, sched, config, build_toy_constraint(config.get("constraint_spec"))


class ToyResult(NamedTuple):
    """The trained state, the last sampling pass's mean |residual|, and the
    run's counts and seconds (training steps, and sampling passes)."""

    state: object
    residual: float
    steps: int
    train_seconds: float
    samples: int
    sample_seconds: float


@torch.no_grad()
def sample_toy(model, sched, config: dict, n: int, generator: torch.Generator):
    """One sampling pass of ``n`` points: (x_init, the ``p_sample_loop``
    result with history)."""
    dev = next(model.parameters()).device
    x_init = torch.randn((n, config["dim"]), generator=generator, device=dev)
    result = p_sample_loop(sched, model, x_init, generator, pred_mode=config["model_pred_mode"],
                           suppress_noise=True,
                           use_dynamic_threshold=config["use_dynamic_threshold"],
                           save_history=True)
    return x_init, result


def _write_sample_outputs(out_dir: Path, epoch: int, config: dict, x_init, result) -> None:
    final = result.x.cpu().numpy()
    viz.save_csv(final, out_dir / "csv" / f"step_{epoch}_sample.csv")
    if not config["create_gif"]:
        return
    history = np.concatenate([x_init.cpu().numpy()[None], result.history.cpu().numpy()])
    eval_steps = np.linspace(0, config["n_steps"], config["tot_eval_steps"]).astype(int)
    viz.save_scatter_panels(history, eval_steps, out_dir / f"step_{epoch}.png",
                            config["n_steps"], fix_axes=config["fix_axes"])
    lims = (history[-1].min() - 0.5, history[-1].max() + 0.5)
    viz.scatter_history_to_gif(history, out_dir / f"step_{epoch}.gif", x_lim=lims, y_lim=lims)


def run_toy(config: dict, output_dir: str | Path, device=None) -> ToyResult:
    """Train per ``config`` into ``output_dir/<name>``."""
    dev = resolve_device(device)
    set_fp32_exact()
    out_dir = Path(output_dir) / config["name"]
    out_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(42)
    data = torch.as_tensor(sample_hypersphere(rng, N_DATA, config["dim"]), dtype=torch.float32,
                           device=dev)
    sched = create_schedule(config["n_steps"])
    model = ConditionalModel(dim=config["dim"], n_steps=config["n_steps"],
                             seed=config["seed"]).to(dev)
    print(f"Number of trainable parameters: {sum(p.numel() for p in model.parameters())}")
    opt = make_optimizer(model, config["lr"], grad_clip=1.0)
    state = create_train_state(model, opt)
    loss_fn = build_loss_fn(sched, config)
    gen = torch.Generator(device=dev).manual_seed(config["seed"])
    logger = MetricsLogger(out_dir)

    bs, n_steps = config["batch_size"], config["n_steps"]
    steps, train_s, samples, sample_s, residual = 0, 0.0, 0, 0.0, float("nan")
    t0 = time.time()
    for epoch in range(config["train_num_steps"] + 1):
        t_train = time.perf_counter()
        perm = torch.randperm(N_DATA, generator=gen, device=dev)
        for i in range(0, N_DATA - bs + 1, bs):
            batch = data[perm[i:i + bs]]
            if config["true_randomness"]:
                batch = torch.randn(batch.shape, generator=gen, device=dev)
            t = antithetic_timesteps(gen, bs, n_steps, device=dev)
            noise = torch.randn(batch.shape, generator=gen, device=dev)
            aux = train_step(state, loss_fn, batch, t, noise, ema_start=EMA_START)
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        train_s += time.perf_counter() - t_train
        logger.log({"loss": aux.loss, "loss_data": aux.data_loss,
                    "loss_residual": aux.residual_mean_abs, "loss_inequality": aux.ineq_mean,
                    "loss_optimization": aux.opt_mean}, step=epoch)

        if epoch % config["sample_freq"] == 0:
            t_sample = time.perf_counter()
            x_init, result = sample_toy(state.model, sched, config, config["no_samples"], gen)
            residual = hypersphere_residual(result.x).abs().mean().item()
            sample_s += time.perf_counter() - t_sample
            samples += config["no_samples"]
            logger.log({"residual_samples": residual}, step=epoch)
            print(f"epoch {epoch}: loss={aux.loss.item():.4f} "
                  f"sample residual={residual:.4f} ({time.time() - t0:.1f}s)", flush=True)
            if config["save_output"]:
                _write_sample_outputs(out_dir, epoch, config, x_init, result)

    save_checkpoint(out_dir / "model", config["train_num_steps"], model=state.model,
                    ema=state.ema, optimizer=opt, config=config)
    (out_dir / "config.json").write_text(json.dumps(config, indent=2))
    logger.flush(_COLUMNS)
    print(f"checkpoint saved to {out_dir / 'model'}")
    return ToyResult(state, residual, steps, train_s, samples, sample_s)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--name", default=None)
    ap.add_argument("--pred-mode", default=None, choices=["x0", "eps", "mu"])
    ap.add_argument("--x0-estimation", default=None, choices=["mean", "sample"])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--c-residual", type=float, default=None)
    ap.add_argument("--output-dir", default="./trained_models/toy")
    ap.add_argument("--create-gif", action="store_true",
                    help="also write the scatter PNGs and GIFs (needs matplotlib and imageio)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> dict:
    config = default_config()
    if args.name:
        config["name"] = args.name
    if args.pred_mode:
        config["model_pred_mode"] = args.pred_mode
    if args.x0_estimation:
        config["x0_estimation"] = args.x0_estimation
    if args.epochs is not None:
        config["train_num_steps"] = args.epochs
    if args.c_residual is not None:
        config["c_residual"] = args.c_residual
    if args.create_gif:
        config["create_gif"] = True
    config["use_ddim_x0"] = config["x0_estimation"] == "sample"
    return config


def main(argv=None) -> ToyResult:
    args = parse_args(argv)
    return run_toy(config_from_args(args), args.output_dir, args.device)


if __name__ == "__main__":
    main()
