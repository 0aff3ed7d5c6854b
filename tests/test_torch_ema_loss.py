"""The training loss of the committed 300k Darcy EMA weights: the port (CPU)
against the JAX package on the same fields, t and noise, in fp32 and in the
run's own recipe, bf16 with the fp32 head.

The test takes 2 validation fields. Run as a script, the same comparison
gives the reference that bounds ``chip_smoke.py`` phase 9c: the loss over 8
batches of that phase's 64 validation fields, from the JAX package (fp32, and
bf16 with the fp32 head as the run was trained) and from the port on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_ema_loss.py [--batches 8]

It caches the fields under the git-ignored ``data/.cache/ema_loss_valid``,
prints one JSON object with the per-batch loss, data loss and mean |residual|
of each model and their means, and takes about two minutes on 8 CPU cores.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
RUN = ROOT / "results" / "darcy_300k_fp32head" / "portable"
VALID_SEED, N_VALID = 10_000, 64  # as chip_smoke.py phase 9a
WEIGHTS = dict(c_data=1.0, c_residual=1e-3)


def _batches(shape, n_batches):
    rng = np.random.default_rng(1)
    return [(rng.integers(0, 100, shape[0]), rng.standard_normal(shape).astype(np.float32))
            for _ in range(n_batches)]


def _params():
    from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint

    return load_checkpoint(RUN / "model" / "checkpoint_300000.msgpack")["ema_params"]


def jax_terms(x0, batches, params, bf16_fp32_head=False):
    """(loss, data loss, residual_mean_abs) of each batch, JAX package."""
    import jax
    import jax.numpy as jnp

    from physicsinformeddiffusionmodels_tpu.diffusion import losses as jl
    from physicsinformeddiffusionmodels_tpu.diffusion import schedule as js
    from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
    from physicsinformeddiffusionmodels_tpu.physics.darcy import DarcyResidual as JaxDarcy

    extra = dict(dtype=jnp.bfloat16, fp32_head=True) if bf16_fp32_head else {}
    model = FlaxUNet(dim=32, channels=2, **extra)

    @jax.jit
    def aux_of(x, t, n):
        return jl.pidm_loss(js.create_schedule(100), x, t, None,
                            denoise_fn=lambda a, b: model.apply(params, a, b),
                            physics_fn=JaxDarcy(x.shape[1]), weights=jl.LossWeights(**WEIGHTS),
                            noise=n)[1]

    return [[float(v) for v in aux_of(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(n))[:3]]
            for t, n in batches]


def port_terms(x0, batches, compute_dtype="float32"):
    """(loss, data loss, residual_mean_abs) of each batch, the port on the CPU
    (in bf16 with the run's fp32 head for ``compute_dtype="bfloat16"``)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval
    from physicsinformeddiffusionmodels_tpu_torch.diffusion import losses as tl
    from physicsinformeddiffusionmodels_tpu_torch.diffusion import schedule as ts
    from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual

    _, model, _ = sample_eval.load_run(RUN, compute_dtype=compute_dtype, device="cpu")
    with torch.no_grad():
        return [[v.item() for v in tl.pidm_loss(
            ts.create_schedule(100), torch.from_numpy(x0), torch.from_numpy(t),
            torch.from_numpy(n), denoise_fn=model, physics_fn=DarcyResidual(x0.shape[1]),
            weights=tl.LossWeights(**WEIGHTS))[1][:3]]
            for t, n in batches]


def _valid_fields(n, out_dir, workers=1):
    from physicsinformeddiffusionmodels_tpu_torch.data.darcy_generator import generate_dataset
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset

    if not (Path(out_dir) / "p_data.csv").exists():
        generate_dataset(n, base_seed=VALID_SEED, out_dir=out_dir, num_workers=workers)
    return load_darcy_dataset(out_dir).stacked()


@pytest.fixture(scope="module")
def fp32_reference(tmp_path_factory):
    """2 validation fields, one batch of t and noise, the weights, and the
    JAX package's fp32 terms on them."""
    x0 = _valid_fields(2, tmp_path_factory.mktemp("valid"))
    assert x0.shape == (2, 64, 64, 2)
    batches, params = _batches(x0.shape, 1), _params()
    return x0, batches, params, jax_terms(x0, batches, params)[0]


@pytest.mark.parametrize("recipe", ["fp32", "bf16_fp32_head"])
def test_ema_weights_loss_matches_jax(fp32_reference, recipe):
    x0, batches, params, ref32 = fp32_reference
    names = ("loss", "data loss", "residual_mean_abs")
    if recipe == "fp32":
        got = port_terms(x0, batches)[0]
        # fp32 forward of the same network in two frameworks, as in
        # test_torch_losses.py's pidm_loss comparison at P=16
        for name, g, r in zip(names, got, ref32):
            assert np.isfinite(g) and g > 0, name
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=name)
        return
    got = port_terms(x0, batches, "bfloat16")[0]
    ref = jax_terms(x0, batches, params, bf16_fp32_head=True)[0]
    # the two bf16 paths round in different places: each term within twice
    # JAX's own bf16 rounding (its gap to its fp32 term) plus 1e-2 of the
    # term, as in test_torch_bf16_train.py
    for name, g, r, r32 in zip(names, got, ref, ref32):
        assert np.isfinite(g) and g > 0, name
        assert abs(g - r) <= 2 * abs(r - r32) + 1e-2 * abs(r), (name, g, r, r32)
    # that band is 40% wide for the mean |residual|, which bf16 moves by
    # itself: the finite-difference stencil turns the output's rounding into
    # residual (JAX: 0.02968 in fp32, 0.03551 in bf16 + fp32 head). The
    # port's bf16 term must lie nearer JAX's bf16 term than its fp32 one,
    # which the port's fp32 term (0.02968) does not.
    g, r, r32 = got[2], ref[2], ref32[2]
    assert abs(g - r) < abs(g - r32), (g, r, r32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    x0 = _valid_fields(N_VALID, ROOT / "data" / ".cache" / "ema_loss_valid", workers=8)
    batches, params = _batches(x0.shape, args.batches), _params()
    out = {"jax_fp32": jax_terms(x0, batches, params),
           "jax_bf16_fp32_head": jax_terms(x0, batches, params, bf16_fp32_head=True),
           "port_fp32_cpu": port_terms(x0, batches),
           "port_bf16_fp32_head_cpu": port_terms(x0, batches, "bfloat16")}
    summary = {k: {"per_batch_loss_data_residual": v,
                   "mean_loss": float(np.mean([b[0] for b in v])),
                   "mean_data_loss": float(np.mean([b[1] for b in v])),
                   "mean_residual_mean_abs": float(np.mean([b[2] for b in v]))}
               for k, v in out.items()}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
