"""Training loop components: optimizer, train step, checkpointing, metrics.

The JAX package's ``make_train_step``, ``make_device_resident_step`` and
``make_chunked_resident_step`` return jitted closures (the last a
``lax.scan`` of steps); here ``train_step`` and ``resident_train_step``
take one step eagerly and ``GraphedTrainStep`` replays one step's CUDA
graph.
"""

from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
    GraphedTrainStep,
    TrainState,
    create_train_state,
    make_optimizer,
    resident_train_step,
    train_step,
)
from physicsinformeddiffusionmodels_tpu_torch.training.shutdown import (
    install_graceful_stop,
)
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
from physicsinformeddiffusionmodels_tpu_torch.training.metrics import MetricsLogger

__all__ = [
    "GraphedTrainStep",
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "resident_train_step",
    "train_step",
    "install_graceful_stop",
    "latest_checkpoint",
    "load_checkpoint",
    "restore_train_state",
    "save_checkpoint",
    "MetricsLogger",
]
