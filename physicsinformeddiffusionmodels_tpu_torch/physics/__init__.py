"""PDE/FEM residual definitions.

The names load on first access, so that ``physics.fem_grid`` (numpy only,
which the SIMP generator's workers import) does not import torch.
"""

import importlib

__all__ = ["toy", "DarcyResidual", "MechanicsResidual", "split_mechanics_batch"]

_MODULE_OF = {"toy": None, "DarcyResidual": "darcy", "MechanicsResidual": "mechanics",
              "split_mechanics_batch": "mechanics"}


def __getattr__(name: str):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if _MODULE_OF[name] is None:
        return importlib.import_module(f"{__name__}.{name}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
