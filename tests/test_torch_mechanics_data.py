"""The port's NumPy/SciPy SIMP generator against the JAX package's: every
scenario family from the same seed, the dataset writer, and the four-set
layout of ``scripts/generate_mechanics_sets.py`` (its host SIMP path), at a
small grid."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from physicsinformeddiffusionmodels_tpu.data import mechanics_generator as jgen
from physicsinformeddiffusionmodels_tpu_torch import generate_mechanics_sets as tsets
from physicsinformeddiffusionmodels_tpu_torch.data import mechanics_generator as tgen
from physicsinformeddiffusionmodels_tpu_torch.data.datasets import NpyFieldDataset
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
P = 16


def test_family_lists_equal_jax():
    assert list(tgen.SCENARIO_FAMILIES) == list(jgen.SCENARIO_FAMILIES)
    assert tgen.IN_DIST_FAMILIES == jgen.IN_DIST_FAMILIES
    assert tgen.OOD_FAMILIES == jgen.OOD_FAMILIES
    assert tsets.IN_DIST_FAMILIES + tsets.OOD_FAMILIES == tuple(jgen.SCENARIO_FAMILIES)


@pytest.mark.parametrize("family", list(jgen.SCENARIO_FAMILIES))
def test_family_sample_matches_jax(family):
    """One sample a family, the same seed: JAX's fields (both NumPy/SciPy),
    and the dataset invariant K(E) u = f at solver precision."""
    got = tgen.generate_sample(tgen.MechanicsFEM(P), np.random.default_rng(3), n_iter=2,
                               family=family)
    ref = jgen.generate_sample(jgen.MechanicsFEM(P), np.random.default_rng(3), n_iter=2,
                               family=family)
    assert got.shape == (P + 1, P + 1, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    fem = tgen.MechanicsFEM(P)
    e = got[:-1, :-1, 5].reshape(-1).astype(np.float64)
    u = got[..., 3:5].reshape(-1).astype(np.float64)
    f = got[..., 8:10].reshape(-1).astype(np.float64)
    free = ~np.stack([got[..., 6], got[..., 7]], axis=-1).reshape(-1).astype(bool)
    r = (fem.assemble(e) @ u - f)[free]
    assert np.abs(r).max() < 1e-5 * np.abs(f).max()


def test_dataset_writer_matches_jax(tmp_path):
    kw = dict(nels_per_side=P, seed=5, n_iter=2, families=("cantilever", "bridge"),
              vf_range=(0.25, 0.7))
    got = tgen.generate_dataset(3, out_dir=tmp_path / "port", **kw)
    ref = jgen.generate_dataset(3, out_dir=tmp_path / "jax", **kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(NpyFieldDataset(tmp_path / "port").stacked(), ref)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_mechanics_sets", ROOT / "scripts" / "generate_mechanics_sets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sets_match_the_jax_scripts_host_path(tmp_path):
    """The four sets in the JAX script's layout and order, one generator
    seeded (seed, 0), eight scenario draws a round (so a short last round
    still draws eight): the same files and scenarios.csv. The port runs the
    SIMP in two worker processes."""
    script = _jax_script()
    sizes = dict(n_train=9, n_valid=2, n_test=3)
    tsets.generate_sets(tmp_path / "port", **sizes, n_iter=1, seed=4, pixels_per_dim=P, workers=2,
                        device="host")
    fem, rng, root = jgen.MechanicsFEM(P), np.random.default_rng((4, 0)), tmp_path / "jax"
    for sub, n, families, vf_range in (
            ("train", sizes["n_train"], jgen.IN_DIST_FAMILIES, (0.3, 0.6)),
            ("test/valid", sizes["n_valid"], jgen.IN_DIST_FAMILIES, (0.3, 0.6)),
            ("test/test_level_1", sizes["n_test"], jgen.IN_DIST_FAMILIES, (0.3, 0.6)),
            ("test/test_level_2", sizes["n_test"], jgen.OOD_FAMILIES, (0.25, 0.7))):
        script.generate_set(fem, None, root / sub / "fields", n, 8, families, vf_range, rng,
                            n_iter=1)
        ours, theirs = tmp_path / "port" / sub / "fields", root / sub / "fields"
        assert sorted(p.name for p in ours.glob("*.npy")) == sorted(
            p.name for p in theirs.glob("*.npy")) and len(list(ours.glob("*.npy"))) == n
        np.testing.assert_array_equal(NpyFieldDataset(ours).stacked(),
                                      NpyFieldDataset(theirs).stacked())
        assert (ours / "scenarios.csv").read_text() == (theirs / "scenarios.csv").read_text()


def test_sets_cli_writes_the_layout(tmp_path):
    tsets.main(["--root", str(tmp_path), "--n-train", "2", "--n-valid", "1", "--n-test", "1",
                "--n-iter", "1", "--pixels-per-dim", "8", "--device", "host"])
    for sub, n in (("train", 2), ("test/valid", 1), ("test/test_level_1", 1),
                   ("test/test_level_2", 1)):
        assert NpyFieldDataset(tmp_path / sub / "fields").stacked().shape == (n, 9, 9, 10)
