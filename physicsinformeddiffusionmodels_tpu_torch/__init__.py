"""PyTorch/CUDA port of ``physicsinformeddiffusionmodels_tpu``.

A second package beside the JAX one, which stays the reference: denoising
diffusion models whose training loss is informed by PDE/FEM residuals
evaluated on the model's x0 prediction (Darcy flow, linear elasticity and
the toy study), with the training, sampling and evaluation drivers, the
data generators, checkpoints in the JAX package's bytes, and data, tensor
and sequence parallelism over ``torch.distributed``. The fused kernels of
the UNet (linear attention, GroupNorm-FiLM-SiLU, the channel-major conv
block) are written in CUDA C++ for Hopper (``csrc/``), each beside its
plain PyTorch version, which runs on CPU tensors.

Subpackages
-----------
diffusion : schedules, losses, ancestral/DDIM sampling, EMA
models    : the denoisers (attention UNet, toy conditional MLP)
ops       : finite-difference operators, the fused kernels, reshapes
physics   : PDE/FEM residuals (Darcy flow, linear elasticity, toy)
data      : dataset loaders and ground-truth generators
parallel  : the mesh of ranks, sharding and sequence-parallel attention
training  : train step, optimizer, checkpointing, metrics
utils     : device selection, timing, visualization

The package imports torch, numpy, scipy and the standard library only; a
kernel is built at its first launch, never at import. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

``diffusion``, ``models``, ``ops`` and ``physics`` are the package's
attributes, as in the JAX package, but each is imported on first access:
the data generators' spawned workers import modules of this package that
need numpy and scipy only, and torch would add seconds to each worker's
start (``chip_smoke.py`` phase 21c times a batch with eight of them).
"""

import importlib

__version__ = "0.1.0"

__all__ = ["diffusion", "models", "ops", "physics", "__version__"]


def __getattr__(name: str):
    if name in ("diffusion", "models", "ops", "physics"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
