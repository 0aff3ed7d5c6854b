"""Jacobian and Hessian helpers, numeric and by autodiff (port of
``ops/gradients.py``): central-difference jacobians and forward-difference
Hessians for checks, ``torch.func`` jacobians and Hessians (batched with
``vmap``), and the finite-difference image jacobian of the stencil
operators."""

from __future__ import annotations

from typing import Callable

import torch

from physicsinformeddiffusionmodels_tpu_torch.ops.fd import StencilGradients


def _step(x: torch.Tensor, i: int, eps: float) -> torch.Tensor:
    d = torch.zeros_like(x)
    d[..., i] = eps
    return d


def jacobian_numeric(func: Callable, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Central-difference jacobian over the last axis of ``x``:
    [*out_shape, x.shape[-1]]."""
    cols = []
    for i in range(x.shape[-1]):
        d = _step(x, i, eps)
        cols.append((func(x + d) - func(x - d)) / (2 * eps))
    return torch.stack(cols, dim=-1)


def hessian_numeric(func: Callable, x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Forward-difference Hessian over the last axis of ``x``:
    [*out_shape, n, n]."""
    f0, n = func(x), x.shape[-1]
    rows = []
    for i in range(n):
        di = _step(x, i, eps)
        rows.append(torch.stack([
            (func(x + di + _step(x, j, eps)) - func(x + di) - func(x + _step(x, j, eps)) + f0)
            / eps**2 for j in range(n)], dim=-1))
    return torch.stack(rows, dim=-2)


def jacobian_autodiff(func: Callable, x: torch.Tensor, mode: str = "rev",
                      batched: bool = False) -> torch.Tensor:
    """The jacobian of ``func`` at ``x`` by reverse (``jacrev``) or forward
    (``jacfwd``) mode; ``batched``: of each row of ``x`` (``vmap``)."""
    ad = torch.func.jacrev if mode == "rev" else torch.func.jacfwd
    return torch.func.vmap(ad(func))(x) if batched else ad(func)(x)


def hessian_autodiff(func: Callable, x: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """jacfwd(jacrev(func)) at ``x``; ``batched``: of each row of ``x``."""
    h = torch.func.jacfwd(torch.func.jacrev(func))
    return torch.func.vmap(h)(x) if batched else h(x)


def image_jacobian(grads: StencilGradients, tensor: torch.Tensor) -> torch.Tensor:
    """The first derivatives along the two pixel axes of [..., H, W],
    stacked on a new axis before them: [..., 2, H, W]."""
    return torch.stack([grads.d_d0(tensor), grads.d_d1(tensor)], dim=-3)
