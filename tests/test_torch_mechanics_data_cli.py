"""The port's one-set mechanics data CLI (``generate_mechanics_data``) on the
CPU: ``--device host`` writes the files of the JAX package's
``scripts/generate_mechanics_data.py`` (its default host path) for the same
flags, with and without ``--start-index`` and on the OOD families; ``--device
cpu`` (the batched SIMP) names its files from the start index too and
writes ``generate_dataset_gpu``'s samples.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from physicsinformeddiffusionmodels_tpu_torch import generate_mechanics_data
from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
    generate_dataset_gpu,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--n-samples", "2", "--nels-per-side", "16", "--n-iter", "3"]


def _jax_main(monkeypatch, argv):
    """JAX's script (it reads ``sys.argv``) run in this process."""
    spec = importlib.util.spec_from_file_location(
        "jax_generate_mechanics_data", ROOT / "scripts" / "generate_mechanics_data.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["generate_mechanics_data.py", *argv])
    module.main()


@pytest.mark.parametrize("extra", [[], ["--start-index", "5"],
                                   ["--families", "cantilever_multiload,bridge", "--seed", "3",
                                    "--vf-range", "0.25,0.7"]],
                         ids=["plain", "start_index", "families"])
def test_host_files_equal_the_jax_script(tmp_path, monkeypatch, extra):
    _jax_main(monkeypatch, [*SMALL, *extra, "--out", str(tmp_path / "jax")])
    generate_mechanics_data.main([*SMALL, *extra, "--device", "host",
                                  "--out", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    start = int(extra[1]) if extra[:1] == ["--start-index"] else 0
    assert names == sorted(f"{start + i}.npy" for i in range(2))
    assert sorted(p.name for p in (tmp_path / "port").glob("*.npy")) == names
    for name in names:
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.shape == (17, 17, 10) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_batched_path_names_files_from_the_start_index(tmp_path):
    samples = generate_mechanics_data.main([*SMALL, "--device", "cpu", "--batch", "2",
                                            "--start-index", "3", "--out", str(tmp_path)])
    ref = generate_dataset_gpu(2, nels_per_side=16, n_iter=3, batch=2, device="cpu")
    assert sorted(p.name for p in tmp_path.glob("*.npy")) == ["3.npy", "4.npy"]
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"{3 + i}.npy"), ref[i])
        np.testing.assert_array_equal(samples[i], ref[i])
