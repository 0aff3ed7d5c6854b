"""Checkpoints in the Flax msgpack format the JAX package writes.

``flax.serialization.msgpack_serialize`` writes a msgpack map whose array
leaves are msgpack ext values: type 1 is an ndarray and type 3 a numpy
scalar, each with a payload that is itself msgpack ``(shape, dtype_name,
row-major bytes)``. This module reads and writes that subset of the format
in plain Python (maps, arrays, str, bin, ints, floats, nil, bool, ext), so
the port needs neither ``flax`` nor ``msgpack``.

A checkpoint the port writes holds ``step``, ``params`` and ``ema_params``
in the Flax tree layout (``{"params": {...}}``, the inverse of
``models/convert.py``), so both packages' ``sample_eval`` read it, and
``opt_state`` in the port's own layout: Adam's moments and step count per
parameter name, under string keys (Flax's reader refuses others).

On a mesh with tp > 1 the file still holds whole arrays: a save gathers
the tp shards of the weights, the EMA and Adam's moments (every rank takes
part) and rank 0 alone writes; a restore reads on every rank and keeps
each rank's shards. A checkpoint of any mesh thus restores on any other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
    Mesh,
    gather_state,
    is_main,
    shard_state,
    sharded_dims,
)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

# fixed-width scalars: tag -> (struct format, byte count)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# tags whose length prefix follows: tag -> (kind, length-prefix format)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


@dataclasses.dataclass(frozen=True)
class RawArray:
    """An array of a dtype numpy lacks (bfloat16) as its shape, dtype name
    and row-major bytes: what ``msgpack_restore(..., keep_bfloat16=True)``
    returns for such a leaf, and ``msgpack_serialize`` writes back unchanged
    (as an ndarray)."""

    shape: tuple
    dtype: str
    data: bytes


class _Reader:
    def __init__(self, data: bytes, raw: bool, keep_bfloat16: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str values as bytes (flax decodes ndarray payloads so)
        self.keep_bfloat16 = keep_bfloat16

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self):
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self._str(tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in _SCALARS:
            return self.unpack(*_SCALARS[tag])
        if tag in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(_FIXEXT[tag])), self.keep_bfloat16)
        if tag in _SIZED:
            kind, fmt = _SIZED[tag]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(n)), self.keep_bfloat16)
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x} at byte {self.pos - 1}")

    def _str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray(payload: bytes, keep_bfloat16: bool = False) -> np.ndarray | RawArray:
    shape, dtype_name, buf = _Reader(payload, raw=True).read()
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16" and keep_bfloat16:
        return RawArray(tuple(shape), name, bytes(buf))
    if name == "bfloat16":
        # numpy has no bfloat16: widen the bit pattern to float32 exactly
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes, keep_bfloat16: bool = False):
    if code == _EXT_NDARRAY:
        return _ndarray(payload, keep_bfloat16)
    if code == _EXT_NPSCALAR:
        a = _ndarray(payload, keep_bfloat16)
        return a if isinstance(a, RawArray) else a[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_restore(data: bytes, keep_bfloat16: bool = False):
    """Decode Flax msgpack bytes into a tree of dicts, lists, Python scalars
    and numpy arrays (the arrays are read-only views of ``data``). A
    bfloat16 array comes back widened to float32, or with
    ``keep_bfloat16`` as a ``RawArray`` of its own bytes."""
    r = _Reader(data, raw=False, keep_bfloat16=keep_bfloat16)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return out


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree


def load_checkpoint(path: str | os.PathLike) -> dict:
    """Load a checkpoint written by the JAX package's ``save_checkpoint``.

    Returns the raw tree (``step``, ``params``, ``ema_params``,
    ``opt_state``) with numpy leaves. Portable exports store their weights
    as float16; those leaves come back as float32, as the JAX package's
    ``sample_eval.py`` restores them.
    """
    return _to_float32(msgpack_restore(Path(path).read_bytes()))


def _pack_len(out: bytearray, n: int, tags: tuple, fix_tag: Optional[int], fix_max: int) -> None:
    """Append the header of a str/bin/array/map of length n: the fix form
    when it fits, else the 8-, 16- or 32-bit length form (``tags``)."""
    if fix_tag is not None and n <= fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt in zip(tags, (">B", ">H", ">I")):
        if tag is not None and n < 2 ** (8 * struct.calcsize(fmt)):
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too long ({n})")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        out.append(fixed[len(payload)])
    else:
        _pack_len(out, len(payload), (0xC7, 0xC8, 0xC9), None, 0)
    out += struct.pack(">b", code)
    out += payload


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):  # the shortest form, as msgpack-python writes it
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        else:
            forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if obj > 0 else \
                ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
            for tag, fmt in forms:
                bits = 8 * struct.calcsize(fmt)
                if (obj < 2**bits) if obj > 0 else (obj >= -(2 ** (bits - 1))):
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    break
            else:
                raise ValueError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), (0xD9, 0xDA, 0xDB), 0xA0, 31)
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), (0xC4, 0xC5, 0xC6), None, 0)
        out += obj
    elif isinstance(obj, dict):  # keys in sorted order, as Flax writes them
        _pack_len(out, len(obj), (None, 0xDE, 0xDF), 0x80, 15)
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (None, 0xDC, 0xDD), 0x90, 15)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, RawArray):
        payload = bytearray()
        _pack((tuple(int(d) for d in obj.shape), obj.dtype, obj.data), payload)
        _pack_ext(out, _EXT_NDARRAY, bytes(payload))
    elif isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        payload = bytearray()
        _pack((tuple(int(d) for d in a.shape), a.dtype.name, a.tobytes("C")), payload)
        _pack_ext(out, _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR,
                  bytes(payload))
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists, Python scalars and numpy arrays as
    ``flax.serialization.msgpack_serialize`` does."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# torch module prefixes of the attention modules that sit at the top of the
# Flax tree (the inverse of convert.py's map)
_UNWRAPPED = {"mid_spatial_attn.fn": "Attention_0", "init_frame_attn.fn": "FrameAttention_0",
              "mid_frame_attn.fn": "FrameAttention_1"}


def flax_params_from_torch(state_dict: dict) -> dict:
    """The inverse of ``models.convert.torch_state_dict_from_flax``: a
    ``UNet`` state dict as a Flax tree ``{"params": {...}}`` of float32
    numpy arrays."""
    tree: dict = {}
    for key, t in state_dict.items():
        for prefix, name in _UNWRAPPED.items():
            if key.startswith(prefix + "."):
                key = name + key[len(prefix):]
        *modules, name = key.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            name = "kernel"
            if a.ndim == 4 and modules[-1].startswith("ConvTranspose"):
                a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": tree}


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _adam_state(model: torch.nn.Module, optimizer, mesh: Optional[Mesh] = None) -> dict:
    """Adam's per-parameter state under the parameters' names (the moments
    of a tp-split parameter gathered whole), and the optimizer's schedule
    count."""
    state = optimizer.state_dict()["state"]
    dims = sharded_dims(model)
    out = {}
    for i, (name, _) in enumerate(n for n in model.named_parameters() if n[1].requires_grad):
        if i in state:
            entry = dict(state[i])
            if name in dims:
                entry.update(gather_state({k: entry[k] for k in _MOMENTS},
                                          dict.fromkeys(_MOMENTS, dims[name]), mesh))
            out[name] = {k: np.asarray(v.detach().cpu().numpy()) if torch.is_tensor(v) else v
                         for k, v in entry.items()}
    return {"format": "torch.optim.Adam", "state": out, "count": optimizer.count}


def _load_adam_state(model: torch.nn.Module, optimizer, saved: dict, count: int,
                     mesh: Optional[Mesh] = None) -> None:
    """Load Adam's state (each rank's part of a tp-split parameter's
    moments) and the schedule count; ``count`` is used when the checkpoint
    predates saving it."""
    if saved.get("format") != "torch.optim.Adam":
        raise ValueError(f"unknown optimizer state format {saved.get('format')!r}")
    device = next(model.parameters()).device
    dims = sharded_dims(model)
    state = {}
    for i, (name, _) in enumerate(n for n in model.named_parameters() if n[1].requires_grad):
        if name in saved["state"]:
            entry = saved["state"][name]
            # Adam keeps its step count on the host unless capturable/fused
            state[i] = {k: torch.tensor(v) if k == "step" else torch.from_numpy(np.array(v)).to(device)
                        for k, v in entry.items()}
            if name in dims:
                state[i].update(shard_state({k: state[i][k] for k in _MOMENTS},
                                            dict.fromkeys(_MOMENTS, dims[name]), mesh))
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})
    optimizer.count = int(saved.get("count", count))


def save_checkpoint(directory: str | os.PathLike, step: int, *, model: torch.nn.Module,
                    ema: Optional[torch.nn.Module] = None, optimizer=None,
                    config=None, mesh: Optional[Mesh] = None) -> Path:
    """Write ``checkpoint_<step>.msgpack`` (and ``config.json`` when a
    config is given) under ``directory``. ``optimizer=None`` leaves the
    optimizer state out, as intermediate saves do. The file is written to
    a temporary name and moved into place. On a ``mesh`` every rank calls
    it (the tp shards are gathered) and rank 0 alone writes."""
    directory = Path(directory)
    path = directory / f"checkpoint_{step}.msgpack"
    dims = sharded_dims(model)
    params = gather_state(model.state_dict(), dims, mesh)
    ema_params = gather_state(ema.state_dict(), dims, mesh) if ema is not None else None
    opt_state = _adam_state(model, optimizer, mesh) if optimizer is not None else {}
    if not is_main(mesh):
        return path
    directory.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": int(step),
        "params": flax_params_from_torch(params),
        "ema_params": flax_params_from_torch(ema_params) if ema is not None else {},
        "opt_state": opt_state,
    }
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(msgpack_serialize(payload))
    os.replace(tmp, path)
    if config is not None:
        cfg = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else config
        (directory / "config.json").write_text(json.dumps(cfg, indent=2, default=str))
    return path


def restore_train_state(directory: str | os.PathLike, state,
                        mesh: Optional[Mesh] = None) -> tuple[object, int]:
    """Restore a ``TrainState`` (model, EMA, optimizer, step) in place from
    the newest checkpoint under ``directory``. The stored step is the loop
    label of the save, whose update is already in the weights, so the run
    continues at label + 1. Returns (state, start step); (state, 0) when
    there is no checkpoint. A checkpoint without EMA restores the EMA as the
    weights; one without optimizer state keeps the fresh optimizer, whose
    schedule count is 0, as the JAX package keeps a fresh ``opt_state``.
    On a ``mesh`` each rank keeps its shards of what it reads."""
    from physicsinformeddiffusionmodels_tpu_torch.models.convert import (
        torch_state_dict_from_flax,
    )

    path = latest_checkpoint(directory)
    if path is None:
        return state, 0
    raw = msgpack_restore(path.read_bytes())
    dims = sharded_dims(state.model)
    params = shard_state(torch_state_dict_from_flax(raw["params"]), dims, mesh)
    state.model.load_state_dict(params)
    state.ema.load_state_dict(
        shard_state(torch_state_dict_from_flax(raw["ema_params"]), dims, mesh)
        if raw.get("ema_params") else params)
    state.step = int(raw["step"]) + 1
    if raw.get("opt_state"):
        # checkpoints written before the count was saved ran the schedule
        # on the step, which continues at state.step
        _load_adam_state(state.model, state.optimizer, raw["opt_state"], state.step, mesh)
    else:
        state.optimizer.count = 0
    if is_main(mesh):
        print(f"Resumed from {path} at step {state.step}")
    return state, state.step


def latest_checkpoint(directory: str | os.PathLike) -> Path | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(
        directory.glob("checkpoint_*.msgpack"),
        key=lambda p: int(p.stem.split("_")[-1]),
    )
    return ckpts[-1] if ckpts else None
