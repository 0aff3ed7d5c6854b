"""Data, tensor and sequence parallelism over ``torch.distributed`` ranks.

The JAX package's ``batch_sharding`` and ``replicated`` make a
``NamedSharding``; ranks here hold their shard themselves, so
``shard_batch`` and ``shard_params`` take the ``Mesh`` instead.
"""

from physicsinformeddiffusionmodels_tpu_torch.parallel.seq_attention import (
    sequence_sharded_linear_attention,
)
from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
    Mesh,
    data_axes,
    make_mesh,
    param_partition_spec,
    shard_batch,
    shard_params,
)

__all__ = [
    "Mesh",
    "data_axes",
    "make_mesh",
    "param_partition_spec",
    "shard_batch",
    "shard_params",
    "sequence_sharded_linear_attention",
]
