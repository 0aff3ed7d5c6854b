"""Sharded mechanics-set generation in the port against the JAX script
``scripts/generate_mechanics_sets.py``: ``--only``, ``--start-index`` and
``--in-dist-families``, the shard files ``scenarios_<start>.csv`` and their
merge into ``scenarios.csv``, at a small grid (P=16, one SIMP iteration).
The JAX script's ``main`` runs as a user runs it, with its 64-pixel FEM
(and, for its device path, its TPU generator) swapped for small stand-ins;
every comparison is exact. Last, ``scripts/diagnose_ood_tail.py`` reads the
port's ``sample_eval`` output over sets made of two shards."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.data import mechanics_generator as jgen
from physicsinformeddiffusionmodels_tpu_torch import generate_mechanics_sets as tsets
from physicsinformeddiffusionmodels_tpu_torch import sample_eval
from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import MechanicsFEM
from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
P = 16
SUBDIRS = {"train": "train", "valid": "test/valid", "test_level_1": "test/test_level_1",
           "test_level_2": "test/test_level_2"}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_mechanics_sets", ROOT / "scripts" / "generate_mechanics_sets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _UniformDesign:
    """A stand-in for the JAX script's TPU generator: the uniform design
    rho = vf, so its run draws the scenarios without a SIMP."""

    def scenarios_from_host(self, fixed, f, vf):
        return vf

    def optimize(self, vf):
        return np.repeat(vf[:, None], P * P, axis=1), np.zeros(len(vf))


def _run_jax(script, monkeypatch, root, *argv):
    """The JAX script's ``main`` on ``argv`` (seed 4, one SIMP iteration)."""
    monkeypatch.setattr(script, "MechanicsFEM", lambda n: jgen.MechanicsFEM(P))
    monkeypatch.setattr(script, "TpuSimpGenerator", lambda n, n_iter: _UniformDesign())
    monkeypatch.setattr(sys, "argv", ["generate_mechanics_sets.py", "--root", str(root),
                                      "--seed", "4", "--n-iter", "1", *argv])
    script.main()


def _run_port(root, *argv):
    tsets.main(["--root", str(root), "--seed", "4", "--n-iter", "1", "--pixels-per-dim",
                str(P), *argv])


def _assert_same_dir(ours: Path, theirs: Path, fields: bool = True):
    """The same file names; every CSV byte-equal; with ``fields``, every
    ``.npy`` array-equal."""
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    for name in names:
        if name.endswith(".csv"):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
        elif fields:
            np.testing.assert_array_equal(np.load(ours / name), np.load(theirs / name),
                                          err_msg=name)


def _rows(path: Path) -> list[list[str]]:
    return [line.split(",") for line in path.read_text().splitlines()[1:]]


@pytest.mark.parametrize("only,start,n", [("train", 5, 3), ("test_level_2", 5, 2),
                                          ("test_level_1", 0, 2)])
def test_one_shard_on_the_host_path_matches_jax(script, monkeypatch, tmp_path, only, start, n):
    """``--only SET --start-index I`` on the host path: the train set's
    files start at I, every set's draws are seeded (seed, I); the same
    files, ``scenarios_<start>.csv`` and merged ``scenarios.csv``, and no
    other set is made."""
    argv = ("--device", "host", "--only", only, "--start-index", str(start),
            "--n-train", str(n), "--n-test", str(n))
    _run_port(tmp_path / "port", *argv)
    _run_jax(script, monkeypatch, tmp_path / "jax", *argv)
    ours = tmp_path / "port" / SUBDIRS[only] / "fields"
    _assert_same_dir(ours, tmp_path / "jax" / SUBDIRS[only] / "fields")
    first = start if only == "train" else 0
    assert sorted(int(p.stem) for p in ours.glob("*.npy")) == list(range(first, first + n))
    assert (ours / f"scenarios_{first}.csv").read_text() == (ours / "scenarios.csv").read_text()
    made = sorted(str(p.relative_to(tmp_path / "port")) for p in
                  (tmp_path / "port").rglob("fields"))
    assert made == [f"{SUBDIRS[only]}/fields"]


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale_shard"])
def test_two_shards_in_one_directory_merge_as_jax(script, monkeypatch, tmp_path, stale):
    """A start-0 shard, then a start-3 shard of the train set in one
    directory: the same six files and merged ``scenarios.csv``, the
    families round-robin over indices 0-5. With ``stale_shard`` a
    ``scenarios_4.csv`` of an earlier run (rows 4-6, mtime an hour back)
    is there first: the fresher start-3 shard wins indices 4 and 5 in
    both, though its start is lower, and the stale row 6 stays."""
    for side in ("port", "jax"):
        out = tmp_path / side / "train" / "fields"
        if stale:
            out.mkdir(parents=True)
            (out / "scenarios_4.csv").write_text(
                "index,family,vf\n4,stale,0.1\n5,stale,0.1\n6,stale,0.1\n")
            old = (tmp_path / side).stat().st_mtime - 3600
            os.utime(out / "scenarios_4.csv", (old, old))
        for start in (0, 3):
            argv = ("--device", "host", "--only", "train", "--start-index", str(start),
                    "--n-train", "3")
            if side == "port":
                _run_port(tmp_path / side, *argv)
            else:
                _run_jax(script, monkeypatch, tmp_path / side, *argv)
    ours = tmp_path / "port" / "train" / "fields"
    _assert_same_dir(ours, tmp_path / "jax" / "train" / "fields")
    rows = _rows(ours / "scenarios.csv")
    fams = jgen.IN_DIST_FAMILIES
    assert [(int(i), f) for i, f, _ in rows[:6]] == [(i, fams[i % 3]) for i in range(6)]
    assert [r[:2] for r in rows[6:]] == ([["6", "stale"]] if stale else [])


def _merge_layout(out: Path, layout: str) -> None:
    """A directory's scenario files as an interrupted or older generation
    leaves them; mtimes set so that the shards' order is fixed."""
    out.mkdir(parents=True)
    files = {
        "legacy_truncated_empty": {
            "scenarios.csv": "index,family,vf\n0,cantilever,0.400000\n1,bridge,0.500000\n"
                             "2,bridge,0.310000\n3,old,0.300000\n",
            "scenarios_3.csv": "index,family,vf\n3,partial_clamp,0.450000\n4,cantil",
            "scenarios_5.csv": "",
            "scenarios_x.csv": "index,family,vf\n\nseven,bridge,0.3\n7,bridge,0.350000\n",
        },
        "legacy_only": {"scenarios.csv": "index,family,vf\n0,cantilever,0.400000\n"},
        "header_only_shards": {"scenarios_0.csv": "index,family,vf\n",
                               "scenarios_2.csv": "index,fam"},
        "shards_without_base": {
            "scenarios_2.csv": "index,family,vf\n2,bridge,0.500000\n3,bridge,0.600000\n",
            "scenarios_0.csv": "index,family,vf\n0,cantilever,0.400000\n1,cantilever,0.4\n"
                               "2,edge_cantilever,0.300000\n",
        },
    }[layout]
    for k, (name, text) in enumerate(files.items()):
        (out / name).write_text(text)
        os.utime(out / name, (1_000_000 + k, 1_000_000 + k))


@pytest.mark.parametrize("layout", ["legacy_truncated_empty", "legacy_only",
                                    "header_only_shards", "shards_without_base"])
def test_merge_scenarios_byte_equal_to_jax(script, tmp_path, layout):
    """``merge_scenarios`` on a directory copied twice, JAX's merge on one
    copy and the port's on the other: the same files, byte for byte (a
    legacy ``scenarios.csv`` as the base, truncated, blank, header-only and
    non-integer lines skipped, nothing written without a shard or a row)."""
    _merge_layout(tmp_path / "src", layout)
    shutil.copytree(tmp_path / "src", tmp_path / "port")
    shutil.copytree(tmp_path / "src", tmp_path / "jax")
    tsets.merge_scenarios(tmp_path / "port")
    script.merge_scenarios(tmp_path / "jax")
    _assert_same_dir(tmp_path / "port", tmp_path / "jax")
    merged = tmp_path / "port" / "scenarios.csv"
    if layout == "legacy_truncated_empty":
        assert [r[:2] for r in _rows(merged)] == [["0", "cantilever"], ["1", "bridge"],
                                                  ["2", "bridge"], ["3", "partial_clamp"],
                                                  ["7", "bridge"]]
    elif layout == "header_only_shards":
        assert not merged.exists()


def test_custom_family_mix_matches_jax(script, monkeypatch, tmp_path):
    """``--in-dist-families cantilever,partial_clamp --only valid``: the
    valid set's families alternate between the two, as JAX's do."""
    argv = ("--device", "host", "--only", "valid", "--n-valid", "3",
            "--in-dist-families", "cantilever,partial_clamp")
    _run_port(tmp_path / "port", *argv)
    _run_jax(script, monkeypatch, tmp_path / "jax", *argv)
    ours = tmp_path / "port" / "test" / "valid" / "fields"
    _assert_same_dir(ours, tmp_path / "jax" / "test" / "valid" / "fields")
    assert [r[1] for r in _rows(ours / "scenarios.csv")] == [
        "cantilever", "partial_clamp", "cantilever"]


def test_batched_path_shard_matches_jax_device_path(script, monkeypatch, tmp_path):
    """``--device cpu --batch 4 --only train --start-index 4`` (the batched
    SIMP, on the CPU) against the JAX script's device path with a uniform
    design: the same file names and scenario CSVs (the designs differ by
    construction); the port's fields are finite, one a scenario row."""
    argv = ("--only", "train", "--start-index", "4", "--n-train", "5", "--batch", "4")
    _run_port(tmp_path / "port", "--device", "cpu", *argv)
    _run_jax(script, monkeypatch, tmp_path / "jax", "--device", "tpu", *argv)
    ours = tmp_path / "port" / "train" / "fields"
    _assert_same_dir(ours, tmp_path / "jax" / "train" / "fields", fields=False)
    rows = _rows(ours / "scenarios.csv")
    assert [int(r[0]) for r in rows] == list(range(4, 9))
    for i, _, _ in rows:
        field = np.load(ours / f"{i}.npy")
        assert field.shape == (P + 1, P + 1, 10) and np.isfinite(field).all()


def test_generate_sets_rejects_an_unknown_set(tmp_path):
    with pytest.raises(ValueError, match="only"):
        tsets.generate_sets(tmp_path, only="test", device="host")


def test_diagnose_ood_tail_reads_the_ports_evaluation(tmp_path):
    """Each test level made of two shards (starts 0 and 2) by the port's
    set writer, a tiny mechanics run's ``sample_eval`` sweep written to its
    default directory, then ``scripts/diagnose_ood_tail.py`` as it stands:
    every sample gets its family from the merged ``scenarios.csv``; none is
    'unknown'."""
    fem = MechanicsFEM(P)
    for level, families, vf_range in (("test_level_1", tsets.IN_DIST_FAMILIES, tsets.IN_DIST_VF),
                                      ("test_level_2", tsets.OOD_FAMILIES, tsets.OOD_VF)):
        for start in (0, 2):
            tsets.generate_set(fem, tmp_path / "sets" / "test" / level / "fields", 2, families,
                               vf_range, np.random.default_rng((5, start)), n_iter=1,
                               start_index=start)
    cfg = RunConfig(gov_eqs="mechanics", unet_dim=8, pixels_per_dim=P, train_batch_size=2,
                    compute_dtype="float32", name="tiny", diff_steps=4)
    torch.manual_seed(0)
    model = build_model(cfg)
    run = tmp_path / "run"
    save_checkpoint(run / "model", 0, model=model, ema=model, config=cfg)
    (run / "config.json").write_text(cfg.to_json())
    sample_eval.main(["--model-dir", str(run), "--no-samples", "1", "--device", "cpu",
                      "--test-data-root", str(tmp_path / "sets")])
    assert (run / "evaluation" / "eval_settings.json").exists()
    for level, families in (("test_level_1", tsets.IN_DIST_FAMILIES),
                            ("test_level_2", tsets.OOD_FAMILIES)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "diagnose_ood_tail.py"), "--model-dir",
             str(run), "--level", level, "--data-root", str(tmp_path / "sets")],
            capture_output=True, text=True, timeout=120, check=True)
        assert "warning" not in proc.stderr and "unknown" not in proc.stdout
        report = (run / "evaluation" / level / "ood_tail_report.md").read_text()
        want = {f: sum(1 for i in range(4) if families[i % 3] == f) for f in families}
        for fam, n in want.items():
            assert (f"- {fam:22s} rel_CE" in report) == (n > 0), fam
            if n:
                line = next(x for x in report.splitlines() if x.startswith(f"- {fam} "))
                assert f"n={n}" in line, line
