"""The port's Darcy generator, dataset loader and batch iterators against the
JAX package's, on the same seeds and files."""

import numpy as np
import pytest

from physicsinformeddiffusionmodels_tpu.data import darcy_generator as jgen
from physicsinformeddiffusionmodels_tpu.data import datasets as jds
from physicsinformeddiffusionmodels_tpu_torch.data import darcy_generator as tgen
from physicsinformeddiffusionmodels_tpu_torch.data import datasets as tds
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Two P=32 samples from each package's generator, same seed."""
    out = tmp_path_factory.mktemp("darcy")
    ours = tgen.generate_dataset(2, pixels_per_dim=32, q=32, base_seed=5, out_dir=out / "torch")
    ref = jgen.generate_dataset(2, pixels_per_dim=32, q=32, base_seed=5, out_dir=out / "jax")
    return out, ours, ref


def test_generator_equals_jax(generated):
    _, ours, ref = generated
    # the same numpy/scipy arithmetic on the same FD matrices and KLE draws
    for name, a, b in zip(("K", "p", "res", "seeds"), ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)


def test_generator_cli_writes_the_reference_files(tmp_path, capsys):
    tgen.main(["--n-samples", "2", "--pixels-per-dim", "16", "--q", "16", "--seed", "3",
               "--out", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "K_data.csv", "p_data.csv", "res_data.csv", "seeds.csv"]
    assert "Generated 2 samples" in capsys.readouterr().out
    K, p, _, _ = tgen.generate_dataset(2, pixels_per_dim=16, q=16, base_seed=3)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "K_data.csv", delimiter=","), K)


def test_dataset_loader_equals_jax(generated):
    out, _, _ = generated
    ours = tds.load_darcy_dataset(out / "torch")
    ref = jds.load_darcy_dataset(str(out / "jax"))
    assert ours.stacked().shape == (2, 32, 32, 2) and ours.stacked().dtype == np.float32
    np.testing.assert_array_equal(ours.stacked(), ref.stacked())
    np.testing.assert_array_equal(ours[1], ref[1])
    assert len(ours) == len(ref) == 2


def test_batch_iterators_equal_jax():
    fields = np.random.default_rng(0).standard_normal((7, 4, 4, 2)).astype(np.float32)
    ours, ref = tds.DarcyDataset(fields), jds.DarcyDataset(fields)
    for drop in (False, True):
        a = list(tds.iter_batches(ours, 3, drop_remainder=drop))
        b = list(jds.iter_batches(ref, 3, drop_remainder=drop))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    it_a, it_b = tds.cycle_batches(ours, 3, seed=4), jds.cycle_batches(ref, 3, seed=4)
    for _ in range(6):  # across epoch ends, with the tail carried over
        np.testing.assert_array_equal(next(it_a), next(it_b))


def test_dataset_refuses_other_layouts():
    with pytest.raises(ValueError, match=r"\[N, P, P, 2\]"):
        tds.DarcyDataset(np.zeros((2, 4, 4, 3), np.float32))
