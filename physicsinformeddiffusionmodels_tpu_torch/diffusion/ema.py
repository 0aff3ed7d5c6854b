"""Exponential moving average of a model's parameters (port of
``diffusion/ema.py``).

The EMA is a second module of the same architecture, updated in place:
shadow <- (1 - mu) * param + mu * shadow once the step passes ``ema_start``,
and a copy of the parameters before that.
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def ema_init(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with its own parameters, out of the autograd graph."""
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, mu: float = 0.99) -> None:
    """shadow <- (1 - mu) * param + mu * shadow, in place."""
    shadow, params = list(ema.parameters()), list(model.parameters())
    torch._foreach_mul_(shadow, mu)
    torch._foreach_add_(shadow, params, alpha=1.0 - mu)


@torch.no_grad()
def ema_update_after(ema: nn.Module, model: nn.Module, step: int, mu: float = 0.99,
                     ema_start: int = 1000) -> None:
    """Update the EMA when ``step`` (the step before its increment) is past
    ``ema_start``; until then the EMA is a copy of the (updated) parameters."""
    if step > ema_start:
        ema_update(ema, model, mu)
    else:
        torch._foreach_copy_(list(ema.parameters()), list(model.parameters()))
