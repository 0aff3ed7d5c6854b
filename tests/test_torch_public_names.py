"""The port's public names against the JAX package's: every name of a JAX
subpackage's ``__all__`` is exported by the port's counterpart under the
same name and of the same kind, or is listed in README's "Public names"
table with the port's counterparts; every exported name resolves; and the
package imports its subpackages with JAX, Flax and the optional libraries
blocked, building no kernel, while the module a generator's worker imports
pulls in no torch."""

import importlib
import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = "physicsinformeddiffusionmodels_tpu", "physicsinformeddiffusionmodels_tpu_torch"
SUBPACKAGES = ("data", "diffusion", "models", "ops", "parallel", "physics", "training")
# a row of README's table: | `sub.jax_name` | the port's `sub.counterpart`s ... |
_ROW = re.compile(r"^\s*\| `(\w+)\.(\w+)` \|(.*)\|\s*$")


def _departures() -> dict[str, dict[str, list[str]]]:
    """{subpackage: {JAX name: [the port's counterparts]}} from README."""
    out: dict[str, dict[str, list[str]]] = {}
    for line in (ROOT / "README.md").read_text().splitlines():
        m = _ROW.match(line)
        if m:
            sub, name, rest = m.groups()
            out.setdefault(sub, {})[name] = re.findall(rf"`{sub}\.(\w+)", rest)
    return out


def _pair(sub: str):
    suffix = f".{sub}" if sub else ""
    return importlib.import_module(JAX + suffix), importlib.import_module(PORT + suffix)


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else "value"


def test_the_departure_table_is_in_readme():
    table = _departures()
    assert set(table) == {"parallel", "training"}
    assert set(table["parallel"]) == {"batch_sharding", "replicated"}
    assert set(table["training"]) == {"make_train_step", "make_device_resident_step",
                                      "make_chunked_resident_step"}


@pytest.mark.parametrize("sub", ("",) + SUBPACKAGES, ids=("package",) + SUBPACKAGES)
def test_every_jax_name_is_exported_or_a_listed_departure(sub):
    jmod, tmod = _pair(sub)
    listed = _departures().get(sub, {})
    missing = [n for n in jmod.__all__ if n not in tmod.__all__ and n not in listed]
    assert not missing, f"{sub or 'package'}: JAX exports {missing}, the port does not"
    for name, counterparts in listed.items():
        assert name in jmod.__all__ and name not in tmod.__all__, name
        assert counterparts and set(counterparts) <= set(tmod.__all__), (name, counterparts)
    for name in set(jmod.__all__) & set(tmod.__all__):
        if name != "__version__":
            assert _kind(getattr(tmod, name)) == _kind(getattr(jmod, name)), name


@pytest.mark.parametrize("sub", ("",) + SUBPACKAGES, ids=("package",) + SUBPACKAGES)
def test_every_exported_name_resolves(sub):
    _, tmod = _pair(sub)
    assert len(set(tmod.__all__)) == len(tmod.__all__)
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        assert obj is not None, name
        if not inspect.ismodule(obj) and name != "__version__" and hasattr(obj, "__module__"):
            assert obj.__module__.startswith(PORT + "."), (name, obj.__module__)


_BLOCKED_IMPORT = """
import json, sys
banned = ("jax", "jaxlib", "flax", "optax", "msgpack", "matplotlib", "imageio", "yaml",
          "physicsinformeddiffusionmodels_tpu")
for name in banned:  # an import of any of them now raises ImportError
    sys.modules[name] = None
# what a generator's spawned worker imports: numpy and scipy, no torch
import physicsinformeddiffusionmodels_tpu_torch.generate_mechanics_sets
import physicsinformeddiffusionmodels_tpu_torch.physics.fem_grid
worker_torch = "torch" in sys.modules
import physicsinformeddiffusionmodels_tpu_torch as pidm
attrs = [type(getattr(pidm, n)).__name__ for n in ("diffusion", "models", "ops", "physics")]
from physicsinformeddiffusionmodels_tpu_torch import (data, diffusion, models, ops, parallel,
                                                      physics, training, utils)
from physicsinformeddiffusionmodels_tpu_torch.ops import _build
import torch
mods = (pidm, data, diffusion, models, ops, parallel, physics, training)
print(json.dumps({
    "version": pidm.__version__, "worker_torch": worker_torch, "attrs": attrs,
    "unresolved": [f"{m.__name__}.{n}" for m in mods for n in m.__all__
                   if getattr(m, n, None) is None],
    "banned": sorted(k for k in sys.modules
                     if k.split(".")[0] in banned and sys.modules[k] is not None),
    "built": _build.build.cache_info().currsize + _build.library.cache_info().currsize,
    "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_package_imports_its_subpackages_with_jax_and_optional_libraries_blocked():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["version"] == importlib.import_module(JAX).__version__
    assert not report["worker_torch"] and report["attrs"] == ["module"] * 4
    assert report["unresolved"] == [] and report["banned"] == []
    assert report["built"] == 0 and not report["cuda_initialized"]
