"""Analytic constraints and data of the toy study (port of ``physics/toy.py``).

The residual, inequality and optimisation terms of points on the unit
hypersphere, the toy data samplers (NumPy, so that a seed gives the JAX
package's arrays), and the constraint registry: a saved toy run stores a
spec (registry name + kwargs) with its checkpoint, and loading rebuilds
its ``physics_fn`` from the spec. A user plugs in a constraint by
registering a factory under a name.
"""

from __future__ import annotations

import numpy as np
import torch

from physicsinformeddiffusionmodels_tpu_torch.diffusion.losses import PhysicsTerms


def hypersphere_residual(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) - 1 per sample."""
    return torch.sum(x**2, dim=1) - 1.0


def density_inequality(x: torch.Tensor, threshold: float = 1.0, mode: str = "leq") -> torch.Tensor:
    """relu(sum|x| - threshold) per sample (mirrored unless ``mode`` is 'leq')."""
    shift = torch.sum(torch.abs(x), dim=1) - threshold
    return torch.relu(shift if mode == "leq" else -shift)


def first_coordinate_objective(x: torch.Tensor) -> torch.Tensor:
    """x[:, 0], minimised through the exponential log-likelihood term."""
    return x[:, 0]


def toy_physics(x0_pred: torch.Tensor, threshold: float = 1.0) -> PhysicsTerms:
    """The three toy terms for ``pidm_loss``."""
    return PhysicsTerms(
        residual=hypersphere_residual(x0_pred),
        inequality=density_inequality(x0_pred, threshold),
        optimizer=first_coordinate_objective(x0_pred),
    )


def sample_hypersphere(rng: np.random.Generator, size: int, dim: int = 2) -> np.ndarray:
    """Points uniform on the unit hypersphere."""
    x = rng.normal(0.0, 1.0, (size, dim))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def sample_zeros(rng: np.random.Generator, size: int, dim: int = 2) -> np.ndarray:
    return np.zeros((size, dim))


def sample_gaussian(rng: np.random.Generator, size: int, dim: int = 2) -> np.ndarray:
    return rng.standard_normal((size, dim))


def sample_circle(rng: np.random.Generator, size: int) -> np.ndarray:
    """Uniform angles on the 2-D unit circle."""
    theta = rng.uniform(0.0, 2.0 * np.pi, size)
    return np.stack([np.cos(theta), np.sin(theta)], axis=1)


def sample_two_points(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random picks from {(-0.5, -0.5), (0.5, 0.5)}."""
    pts = np.array([[-0.5, -0.5], [0.5, 0.5]])
    return pts[rng.integers(0, 2, size)]


def sample_four_points(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random picks from the four corners of [-1, 1]^2."""
    pts = np.array([[-1.0, -1.0], [-1.0, 1.0], [1.0, -1.0], [1.0, 1.0]])
    return pts[rng.integers(0, 4, size)]


TOY_CONSTRAINTS: dict = {}


def register_toy_constraint(name: str):
    """Register a factory ``factory(**kwargs) -> physics_fn`` under ``name``,
    where ``physics_fn(x0_pred) -> PhysicsTerms``."""

    def deco(factory):
        TOY_CONSTRAINTS[name] = factory
        return factory

    return deco


@register_toy_constraint("hypersphere")
def _hypersphere_factory(threshold: float = 1.0):
    def physics_fn(x0_pred: torch.Tensor) -> PhysicsTerms:
        return toy_physics(x0_pred, threshold)

    return physics_fn


def build_toy_constraint(spec: dict | None):
    """The ``physics_fn`` of a spec ``{"name": ..., "kwargs": {...}}``; None
    gives the built-in hypersphere constraints."""
    if spec is None:
        spec = {"name": "hypersphere", "kwargs": {}}
    name = spec["name"]
    if name not in TOY_CONSTRAINTS:
        raise KeyError(f"unknown toy constraint '{name}'; register it with "
                       f"register_toy_constraint before loading (known: "
                       f"{sorted(TOY_CONSTRAINTS)})")
    return TOY_CONSTRAINTS[name](**spec.get("kwargs", {}))


TOY_DISTRIBUTIONS = {
    "zeros": sample_zeros,
    "gaussian": sample_gaussian,
    "circle": sample_circle,
    "hypersphere": sample_hypersphere,
    "two_points": sample_two_points,
    "four_points": sample_four_points,
}
