"""Auxiliary model blocks (port of ``models/blocks.py``).

``SignalEmbedding`` encodes a [B, L] response signal (a stress-strain curve)
into a [B, cond_dim] conditioning vector, the ablation encoder of the
reference. No training script calls it. Its modules are named after the
Flax tree (``Conv_0`` ... ``Conv_4``; ``GRUCell_0`` ... ``GRUCell_2`` with
Flax's gate layers ``ir``, ``iz``, ``in``, ``hr``, ``hz``, ``hn``), so
``state_dict_from_flax`` maps a Flax parameter tree onto it by name.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class GRUCell(nn.Module):
    """Flax's ``GRUCell``: r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) +
    hz(h)), n = tanh(in(x) + r hn(h)), h' = (1 - z) n + z h; the input
    layers and ``hn`` carry a bias, ``hr`` and ``hz`` none."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            self.add_module(g, nn.Linear(cin, features))
        for g in ("hr", "hz", "hn"):
            self.add_module(g, nn.Linear(features, features, bias=g == "hn"))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class SignalEmbedding(nn.Module):
    """arch='CNN': stride-2 Conv1D (kernel 4, padding 1) + SiLU per entry of
    ``channel_upsamplings``, then the one remaining position (or the mean
    over the positions); arch='GRU': three GRU layers of
    ``channel_upsamplings[-1]`` features from a zero state, the last
    layer's state after the last step."""

    def __init__(self, arch: str = "CNN", init_channel: int = 1,
                 channel_upsamplings: Sequence[int] = (16, 32, 64, 128, 128)):
        super().__init__()
        if arch not in ("CNN", "GRU"):
            raise ValueError(f"Unknown architecture: {arch}")
        self.arch = arch
        if arch == "CNN":
            cin = init_channel
            for i, ch in enumerate(channel_upsamplings):
                self.add_module(f"Conv_{i}", nn.Conv1d(cin, ch, 4, stride=2, padding=1))
                cin = ch
            self.n_convs = len(channel_upsamplings)
        else:
            feat = channel_upsamplings[-1]
            for i in range(3):
                self.add_module(f"GRUCell_{i}", GRUCell(init_channel if i == 0 else feat, feat))
            self.features = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            x = x[..., None]  # [B, L, 1]
        if self.arch == "CNN":
            h = x.transpose(1, 2)  # [B, C, L]
            for i in range(self.n_convs):
                h = F.silu(getattr(self, f"Conv_{i}")(h))
            h = h.transpose(1, 2)  # [B, L', C]
            return h.reshape(h.shape[0], -1).squeeze() if h.shape[1] == 1 else h.mean(dim=1)
        h = x
        for i in range(3):
            cell = getattr(self, f"GRUCell_{i}")
            state = h.new_zeros(h.shape[0], self.features)
            outs = []
            for step in range(h.shape[1]):
                state = cell(state, h[:, step])
                outs.append(state)
            h = torch.stack(outs, dim=1)
        return h[:, -1]


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A float32 ``SignalEmbedding`` state dict from its Flax parameter tree
    (numpy leaves; with or without the ``params`` collection): a Conv
    kernel [k, in, out] becomes ``weight`` [out, in, k], a Dense kernel [in,
    out] ``weight`` [out, in]; biases keep their layout."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for module, leaves in params.items():
        for sub, leaf in leaves.items():
            if isinstance(leaf, dict):  # a GRU gate layer
                for name, a in leaf.items():
                    a = np.asarray(a, np.float32)
                    out[f"{module}.{sub}.{'weight' if name == 'kernel' else name}"] = \
                        torch.from_numpy(np.ascontiguousarray(a.T if name == "kernel" else a))
            else:
                a = np.asarray(leaf, np.float32)
                out[f"{module}.{'weight' if sub == 'kernel' else sub}"] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(2, 1, 0) if sub == "kernel" else a))
    return out
