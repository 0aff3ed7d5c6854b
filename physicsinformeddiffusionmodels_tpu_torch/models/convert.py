"""Carry Flax UNet parameters over to the PyTorch ``UNet``.

Torch modules are named after the Flax tree, so a Flax path maps to a state
dict key by name, with these changes:
  * Dense kernel [in, out]            -> nn.Linear ``weight`` [out, in];
  * Conv kernel HWIO                  -> ``weight`` OIHW;
  * ConvTranspose kernel [kh, kw, I, O] -> nn.ConvTranspose2d ``weight``
    [I, O, kh, kw], spatially flipped: with the same 'SAME'/p=1 geometry,
    torch's transposed conv correlates with the flipped kernel relative to
    Flax's (the inverse of ``models/reference_port.py``'s transform);
  * the attention modules a ``PreNormResidual`` wraps sit at the top of the
    Flax tree (``Attention_0``, ``FrameAttention_0/1``) and under ``fn``
    here. A ``PreNormResidual`` that is itself the top module (such as
    ``PreNormResidual(dim, SpatialLinearAttention(dim))``) keeps ``fn`` in
    both trees, so its parameters map by name.
Every other leaf (``gn_scale``, ``w_qkv``, ``res_kernel``, ...) keeps its
name and layout.
"""

from __future__ import annotations

import numpy as np
import torch

_WRAPPED = {
    "Attention_0": "mid_spatial_attn.fn",
    "FrameAttention_0": "init_frame_attn.fn",
    "FrameAttention_1": "mid_frame_attn.fn",
}


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """Map a Flax UNet parameter tree (numpy leaves; with or without the
    top-level ``params`` collection) to a float32 ``UNet`` state dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _leaves(params):
        modules = [_WRAPPED.get(path[0], path[0]), *path[1:-1]]
        name = path[-1]
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            name = "weight"
            if a.ndim == 4 and modules[-1].startswith("ConvTranspose"):
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
        out[".".join([*modules, name])] = torch.from_numpy(np.array(a, order="C"))  # a copy
    return out


def flax_last_dim(key: str, ndim: int) -> int:
    """The dim of the state-dict entry ``key`` (``ndim`` dims) that holds the
    last axis of its Flax leaf: a conv weight's O (0 in OIHW, 1 in a
    transposed conv's IOHW), a Linear weight's out (0), else the last."""
    *modules, name = key.split(".")
    if name != "weight" or ndim < 2:
        return ndim - 1
    return 1 if ndim == 4 and modules[-1].startswith("ConvTranspose") else 0
