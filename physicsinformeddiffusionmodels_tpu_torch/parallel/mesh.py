"""The device mesh and what is split over it (port of ``parallel/mesh.py``).

Axes, as in the JAX package: ``dp`` splits the batch; ``tp`` splits the
output channels of the wide stages' convolutions (and the parameters'
output-feature axis); an optional leading ``slice`` axis is more data
parallelism (in JAX, across TPU slices; here, contiguous blocks of ranks).
A rank is one process with one device; ``make_mesh`` lays the ranks of the
running process group out row-major over the axes, as JAX lays out its
device array, so the data index of a rank is its (slice, dp) position and
its tp index the last coordinate.

Parameters follow JAX's rule (``param_partition_spec``): a leaf of two or
more dims whose last axis divides over tp and that has at least 256 x tp
elements is split on that axis, stated on Flax's layout. ``shard_params``
keeps the rank's part of each such parameter; torch holds a conv weight as
[O, I, kh, kw], so the axis Flax puts last (O) is dim 0 here
(``models.convert.flax_last_dim``). A module reads a split parameter whole
through ``whole`` (gathered at use), or its rank's output channels through
``cols``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from physicsinformeddiffusionmodels_tpu_torch.parallel.collectives import (
    rank_part,
    gather,
    gather_tensor,
    shard,
)

# what a collective of the port may wait for before the process group fails it
TIMEOUT = datetime.timedelta(minutes=10)


def mesh_layout(world: int, dp: Optional[int] = None, tp: int = 1,
                n_slices: int = 1) -> tuple[tuple[str, ...], np.ndarray]:
    """The axis names and the rank array of a (dp, tp) mesh, or (slice, dp,
    tp) when ``n_slices > 1``, over ``world`` ranks; ``dp`` defaults to the
    ranks of a slice // tp. Raises JAX ``make_mesh``'s ``ValueError``s."""
    if n_slices > 1:
        if world % n_slices:
            raise ValueError(f"{world} devices not divisible by {n_slices} slices")
        per_slice = world // n_slices
        if dp is None:
            dp = per_slice // tp
        if dp * tp != per_slice:
            raise ValueError(f"dp*tp = {dp}*{tp} != {per_slice} devices per slice")
        return ("slice", "dp", "tp"), np.arange(world).reshape(n_slices, dp, tp)
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp*tp = {dp}*{tp} != {world} devices")
    return ("dp", "tp"), np.arange(world).reshape(dp, tp)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``DeviceMesh`` over the running process group and the two groups
    the port's collectives take: the rank's tp group and its data group
    (the ranks of its tp index over the data axes)."""

    device_mesh: "torch.distributed.device_mesh.DeviceMesh"
    data_group: object

    def __deepcopy__(self, memo):  # an EMA copy of a model shares its mesh
        return self

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.device_mesh.mesh_dim_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    @property
    def tp_group(self):
        return self.device_mesh.get_group("tp")

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.device_mesh.get_coordinate()[-1]

    @property
    def n_data(self) -> int:
        return math.prod(self.shape[a] for a in data_axes(self))

    @property
    def data_rank(self) -> int:
        """The rank's index over the flattened data axes (JAX's order)."""
        coord, shape = self.device_mesh.get_coordinate()[:-1], self.device_mesh.mesh.shape[:-1]
        return int(np.ravel_multi_index(coord, shape))


def make_mesh(dp: Optional[int] = None, tp: int = 1, n_slices: int = 1,
              device_type: str = "cuda") -> Mesh:
    """The mesh of ``mesh_layout`` over the ranks of the running process
    group (every rank calls it, in the same order as its other groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with torchrun "
                           "(utils.platform.init_distributed joins it)")
    names, ranks = mesh_layout(dist.get_world_size(), dp, tp, n_slices)
    device_mesh = DeviceMesh(device_type, torch.from_numpy(ranks), mesh_dim_names=names)
    if n_slices > 1:  # one group a tp index over the flattened data axes
        columns = ranks.reshape(-1, ranks.shape[-1]).T
        groups = [dist.new_group(col.tolist(), timeout=TIMEOUT) for col in columns]
        data_group = groups[device_mesh.get_coordinate()[-1]]
    else:
        data_group = device_mesh.get_group("dp")
    return Mesh(device_mesh, data_group)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes the batch is split over: ('slice', 'dp') on a multislice
    mesh, ('dp',) otherwise."""
    return ("slice", "dp") if "slice" in mesh.axis_names else ("dp",)


def shard_batch(batch: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The rank's contiguous rows of a global batch, split over the data
    axes in JAX's order (the whole batch without a mesh)."""
    if mesh is None or mesh.n_data == 1:
        return batch
    n, b = mesh.n_data, batch.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} data ranks")
    return batch[mesh.data_rank * (b // n):(mesh.data_rank + 1) * (b // n)]


def param_partition_spec(shape: tuple[int, ...], tp_size: int, min_size: int = 256) -> tuple:
    """JAX's tensor-parallel rule for a parameter of Flax shape ``shape``:
    ``(None, ..., "tp")`` splits the last axis over tp, ``()`` replicates.
    Split when tp > 1, the leaf has two or more dims, its last axis
    divides by tp and it has at least ``min_size`` x tp elements."""
    if tp_size <= 1 or len(shape) < 2:
        return ()
    if shape[-1] % tp_size == 0 and math.prod(shape) >= min_size * tp_size:
        return (None,) * (len(shape) - 1) + ("tp",)
    return ()


@dataclasses.dataclass
class _Shards:
    """A module's split parameters: name -> the torch dim split over tp."""

    mesh: Mesh
    dims: dict


def shard_params(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Keep, in place, the rank's part of each parameter JAX's rule splits
    (nothing at tp = 1). Call it once, on whole weights, before the
    optimizer is made. Returns ``model``."""
    from physicsinformeddiffusionmodels_tpu_torch.models.convert import flax_last_dim

    if mesh is None or mesh.tp == 1:
        return model
    for prefix, module in model.named_modules():
        dims = {}
        for name, p in module.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            dim = flax_last_dim(key, p.ndim)
            flax_shape = tuple(s for i, s in enumerate(p.shape) if i != dim) + (p.shape[dim],)
            if param_partition_spec(flax_shape, mesh.tp):
                with torch.no_grad():
                    p.data = rank_part(p.data, dim, mesh.tp_group)
                dims[name] = dim
        if dims:
            module._tp = _Shards(mesh, dims)
    return model


def sharded_dims(model: nn.Module) -> dict[str, int]:
    """The split parameters of ``model`` by state-dict key: key -> dim."""
    out = {}
    for prefix, module in model.named_modules():
        shards = module.__dict__.get("_tp")
        if shards is not None:
            out.update({f"{prefix}.{n}" if prefix else n: d for n, d in shards.dims.items()})
    return out


def whole(module: nn.Module, name: str) -> torch.Tensor:
    """The module's parameter ``name`` whole: gathered over tp where it is
    split (every rank then computes the same from it)."""
    p = getattr(module, name)
    shards = module.__dict__.get("_tp")
    if shards is None or name not in shards.dims:
        return p
    return gather(p, shards.dims[name], shards.mesh.tp_group, partial=False)


def cols(module: nn.Module, name: str, dim: int, mesh: Mesh) -> torch.Tensor:
    """The rank's part of the module's parameter ``name`` along its output
    dim ``dim``: the parameter itself where it is split there, else its
    slice (whose gradient the ranks gather)."""
    p = getattr(module, name)
    shards = module.__dict__.get("_tp")
    if shards is not None and name in shards.dims:
        if shards.dims[name] != dim:
            raise ValueError(f"{name} is split on dim {shards.dims[name]}, not {dim}")
        return p
    return shard(p, dim, mesh.tp_group)


def gather_state(state: dict, dims: dict[str, int], mesh: Optional[Mesh]) -> dict:
    """A state dict with each split entry (``dims``) gathered whole over tp."""
    if mesh is None or mesh.tp == 1:
        return state
    return {k: gather_tensor(v.contiguous(), dims[k], mesh.tp_group) if k in dims else v
            for k, v in state.items()}


def shard_state(state: dict, dims: dict[str, int], mesh: Optional[Mesh]) -> dict:
    """A whole state dict cut to the rank's parts of the split entries."""
    if mesh is None or mesh.tp == 1:
        return state
    return {k: rank_part(v, dims[k], mesh.tp_group) if k in dims else v for k, v in state.items()}


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files: rank 0, or no mesh."""
    return mesh is None or dist.get_rank() == 0


def any_rank(flag: bool, mesh: Optional[Mesh], device) -> bool:
    """Whether ``flag`` holds on any rank (every rank calls it)."""
    if mesh is None:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run_mesh(device: torch.device, mesh_dp: Optional[int] = None, mesh_tp: int = 1,
             mesh_slices: int = 1) -> Optional[Mesh]:
    """The mesh of a run's ``mesh_*`` settings over the running process
    group, or None where there is none and they ask for one rank. A mesh of
    more than one rank with no process group raises: torchrun starts the
    ranks."""
    if not dist.is_initialized():
        if (mesh_dp or 1) * mesh_tp * mesh_slices > 1:
            raise RuntimeError(
                f"mesh_dp={mesh_dp}, mesh_tp={mesh_tp}, mesh_slices={mesh_slices} need a "
                "process group of as many ranks: launch with torchrun --nproc-per-node N "
                "-m physicsinformeddiffusionmodels_tpu_torch.train ...")
        return None
    return make_mesh(mesh_dp, mesh_tp, mesh_slices, device.type)
