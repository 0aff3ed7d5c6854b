"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A missing
GPU is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when a CUDA device is
    asked for (or implied) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def launched_by_torchrun() -> bool:
    """Whether torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK) is set."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def init_distributed(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Join the process group that torchrun's environment describes: NCCL on
    ``cuda`` (the default), gloo on ``cpu``, each collective failed after
    ``parallel.mesh.TIMEOUT``. Returns the rank's device, ``cuda:LOCAL_RANK``
    (made current) or the CPU; raises when LOCAL_RANK has no GPU of its own."""
    import torch.distributed as dist

    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import TIMEOUT

    dev = resolve_device(device)
    if not launched_by_torchrun():
        raise RuntimeError("init_distributed: RANK, WORLD_SIZE and LOCAL_RANK are not set; "
                           "launch with torchrun")
    if dev.type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no GPU of its own: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", timeout=TIMEOUT)
    return dev


def set_fp32_exact() -> None:
    """Run float32 matmuls and convolutions in full float32.

    cuDNN convolutions default to TF32 (about three decimal digits); the
    finite-difference Darcy residual amplifies output noise by ~1/d0^2
    (about 4000 at 64x64), so the fp32 sampling path turns TF32 off first.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
