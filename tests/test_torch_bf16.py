"""The port's bf16 UNet forward against the JAX package's, on the CPU.

Both run the committed 300k Darcy EMA weights in bf16 with the fp32 head
(``UNet(dtype=bfloat16, fp32_head=True)`` in JAX, ``build_model(cfg,
"bfloat16")`` in the port) and in fp32, on the same x and t made with numpy
from a seed. Run as a script (``JAX_PLATFORMS=cpu python
tests/test_torch_bf16.py``), it prints the numbers the test compares.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu.models.unet import UNet as FlaxUNet
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.models.convert import torch_state_dict_from_flax
from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
from physicsinformeddiffusionmodels_tpu_torch.physics.darcy import DarcyResidual
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN = Path(__file__).resolve().parent.parent / "results/darcy_300k_fp32head/portable"


def _forwards():
    cfg = RunConfig.load(RUN / "config.json")
    params = load_checkpoint(RUN / "model/checkpoint_300000.msgpack")["ema_params"]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 64, 64, 2)).astype(np.float32)
    t = np.array([5, 60], np.int32)
    out = {}
    for name, jdt in (("fp32", None), ("bf16", jnp.bfloat16)):
        flax_model = FlaxUNet(dim=32, channels=2, dtype=jdt, fp32_head=jdt is not None)
        out[f"jax_{name}"] = np.array(jax.jit(flax_model.apply)(params, x, t), np.float32)
        model = build_model(cfg, "float32" if jdt is None else "bfloat16")
        model.load_state_dict(torch_state_dict_from_flax(params))
        with torch.no_grad():
            y = model.eval()(torch.from_numpy(x), torch.from_numpy(t).long())
        out[f"port_{name}"] = y.float().numpy()
    return out


def _compared(y: dict) -> dict:
    physics = DarcyResidual(pixels_per_dim=64)
    return {"jax_rounding": float(np.abs(y["jax_bf16"] - y["jax_fp32"]).max()),
            "gap": float(np.abs(y["port_bf16"] - y["jax_bf16"]).max()),
            **{f"residual_{k}": physics.residual(torch.from_numpy(v)).abs().mean().item()
               for k, v in y.items()}}


def test_bf16_forward_matches_jax_bf16():
    y = _forwards()
    assert all(v.shape == (2, 64, 64, 2) and np.isfinite(v).all() for v in y.values())
    r = _compared(y)
    # the two bf16 paths round in different places (which ops run in bf16,
    # where the casts sit, the order of sums), so the port's bf16 forward is
    # held to twice JAX's own bf16 rounding error against its fp32 forward
    assert r["gap"] <= 2 * r["jax_rounding"], r
    # the evaluation metric, the mean |FD residual| of the x0 prediction,
    # within 0.5x-2x between the two bf16 paths
    assert 0.5 <= r["residual_port_bf16"] / r["residual_jax_bf16"] <= 2.0, r


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(_compared(_forwards())))
