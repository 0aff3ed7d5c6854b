"""The toy study's conditional MLP denoiser (port of ``models/toy.py``).

Two 128-wide linear layers, each output multiplied by a learned
per-timestep gate (initialised uniform in [0, 1)), softplus after each, and
a linear projection back to the data dimension. Modules and parameters are
named after the Flax tree (``ConditionalDense_0/Dense_0/kernel``,
``ConditionalDense_0/Embed_0/embedding``, ``Dense_0``), so that
``models/convert.py`` and ``training/checkpoint.py`` carry the weights both
ways by name. The initial weights follow Flax's initialisers (``Dense``:
lecun normal truncated at two standard deviations, zero bias), drawn from a
generator seeded with ``seed``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _dense(cin: int, cout: int, generator: torch.Generator) -> nn.Linear:
    """An ``nn.Linear`` with Flax ``Dense``'s initial weights."""
    layer = nn.Linear(cin, cout)
    # variance_scaling(1, fan_in, truncated_normal): the std of the normal
    # before truncation to [-2, 2] is sqrt(1 / fan_in) / 0.8796...
    std = math.sqrt(1.0 / cin) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class Embed(nn.Module):
    """A [n, features] table looked up by integer index (Flax ``Embed``)."""

    def __init__(self, n: int, features: int, generator: torch.Generator):
        super().__init__()
        self.embedding = nn.Parameter(torch.rand(n, features, generator=generator))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.embedding[t]


class ConditionalDense(nn.Module):
    """A linear layer whose output is multiplied by a learned gate of the
    timestep."""

    def __init__(self, cin: int, features: int, n_steps: int, generator: torch.Generator):
        super().__init__()
        self.Dense_0 = _dense(cin, features, generator)
        self.Embed_0 = Embed(n_steps, features, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.Embed_0(t) * self.Dense_0(x)


class ConditionalModel(nn.Module):
    """The toy denoiser: ``model(x [B, dim], t)`` with t a [B] or scalar
    integer timestep."""

    def __init__(self, dim: int = 2, n_steps: int = 100, hidden: int = 128, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.dim, self.n_steps, self.hidden = dim, n_steps, hidden
        self.ConditionalDense_0 = ConditionalDense(dim, hidden, n_steps, gen)
        self.ConditionalDense_1 = ConditionalDense(hidden, hidden, n_steps, gen)
        self.Dense_0 = _dense(hidden, dim, gen)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=x.device)
        t = torch.broadcast_to(torch.atleast_1d(t), (x.shape[0],)).long()
        h = F.softplus(self.ConditionalDense_0(x, t))
        h = F.softplus(self.ConditionalDense_1(h, t))
        return self.Dense_0(h)
