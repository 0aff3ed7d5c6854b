"""The batched SIMP generator (``data/mechanics_generator_gpu.py``) on the
CPU against the JAX package's ``TpuSimpGenerator`` and against the host
SIMP, on the scenarios of tests/test_mechanics_generator_tpu.py (P = 16):
its filter, element compliance and optimality-criteria update; one
warm-started PCG; ``optimize``; ``generate_dataset_gpu``'s files and their
K u - f ~= 0 invariant; and ``generate_mechanics_sets --device cpu``.

float32 CG drifts from JAX's as the iterations go (the two sum the
stiffness product in another order: 1e-7 relative at 5 iterations, 1e-3 at
50, PR 13's measurements), so ten iterations are held tightly and a
converged solve loosely; ``optimize`` carries that drift into the designs.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsinformeddiffusionmodels_tpu.data import mechanics_generator_tpu as jgpu
from physicsinformeddiffusionmodels_tpu_torch import generate_mechanics_sets as tsets
from physicsinformeddiffusionmodels_tpu_torch.data import mechanics_generator_gpu as tgpu
from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
    E_MIN,
    SCENARIO_FAMILIES,
    MechanicsFEM,
    simp_topopt,
)
from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import (
    MechanicsResidual,
    split_mechanics_batch,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
P = 16


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def scenarios():
    """Three load cases and target volume fractions (the JAX test's)."""
    fem = MechanicsFEM(P)
    rng = np.random.default_rng(21)
    fixed = np.zeros((3, fem.neq), bool)
    f = np.zeros((3, fem.neq))
    for b, fam in enumerate(["cantilever", "bridge", "double_clamp"]):
        fixed[b], f[b] = SCENARIO_FAMILIES[fam](fem, rng)
    return fem, fixed, f, np.array([0.4, 0.5, 0.35])


def _pair(scenarios, **kw):
    _, fixed, f, vf = scenarios
    jg = jgpu.TpuSimpGenerator(P, **kw)
    tg = tgpu.GpuSimpGenerator(P, device="cpu", **kw)
    return jg, jg.scenarios_from_host(fixed, f, vf), tg, tg.scenarios_from_host(fixed, f, vf)


def test_filter_kernel_and_hs_match_jax(scenarios):
    for rmin in (1.5, 2.5):
        np.testing.assert_array_equal(tgpu._filter_kernel(rmin), jgpu._filter_kernel(rmin))
    jg, _, tg, _ = _pair(scenarios)
    np.testing.assert_allclose(tg.Hs.numpy(), np.asarray(jg.Hs), rtol=1e-6)
    x = np.random.default_rng(0).random((3, P, P)).astype(np.float32)
    np.testing.assert_allclose(tgpu._conv_filter(torch.from_numpy(x), tg.kernel).numpy(),
                               np.asarray(jgpu._conv_filter(jnp.asarray(x), jg.kernel)),
                               rtol=1e-6, atol=1e-6)


def test_element_compliance_and_oc_update_match_jax(scenarios):
    """On the same inputs, to 1e-6 of each output's max: the element
    compliance in exact float32 products, and the 64 fixed halvings of the
    OC update (a sample at its move limits included)."""
    jg, jscen, tg, tscen = _pair(scenarios)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, tg.mech.neq)).astype(np.float32)
    ce = tg._element_compliance(torch.from_numpy(u)).numpy()
    assert _rel(ce, jg._element_compliance(jnp.asarray(u))) <= 1e-6
    rho = rng.uniform(0.05, 1.0, (3, P * P)).astype(np.float32)
    dc = -rng.uniform(0.0, 50.0, (3, P * P)).astype(np.float32)
    dc[1, :5] = 0.3  # positive sensitivities clamp to zero
    got = tg._oc_update(torch.from_numpy(rho), torch.from_numpy(dc), tscen.vf).numpy()
    ref = np.asarray(jg._oc_update(jnp.asarray(rho), jnp.asarray(dc), jscen.vf))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.mean(axis=1), np.asarray(jscen.vf), atol=2e-3)


def test_warm_started_pcg_matches_jax(scenarios):
    """One solve of the batch from a warm start u0 (zeroed at the fixed
    dofs): ten iterations within 1e-5 of JAX's iterate, then the converged
    solve (tol 1e-5, maxiter 600) within 1e-3, both far from u0."""
    rng = np.random.default_rng(2)
    rho = rng.uniform(0.1, 1.0, (3, P * P)).astype(np.float32)
    e = E_MIN + rho**3.0 * (1.0 - E_MIN)
    for maxiter, tol in ((10, 1e-5), (600, 1e-3)):
        jg, jscen, tg, tscen = _pair(scenarios, cg_maxiter=maxiter)
        u_ref = np.asarray(jax.jit(jg._solve_pcg)(jnp.asarray(e), jscen,
                                                 jnp.zeros((3, tg.mech.neq))))
        u0 = (u_ref * (1 + 0.2 * rng.standard_normal(u_ref.shape))).astype(np.float32)
        ref = np.asarray(jax.jit(jg._solve_pcg)(jnp.asarray(e), jscen, jnp.asarray(u0)))
        got = tg._solve_pcg(torch.from_numpy(e), tscen, torch.from_numpy(u0)).numpy()
        assert tg.cg_iterations[-1] == maxiter if maxiter == 10 else tg.cg_iterations[-1] < 600
        assert _rel(got, ref) <= tol, (maxiter, _rel(got, ref))
        assert _rel(u0, ref) > 1e-2


def test_optimize_matches_jax(scenarios):
    """Three SIMP iterations at the defaults (cg tol 1e-5, maxiter 600):
    the designs within 2e-4 (the CG drift carried through the filter and
    the OC update; 3.8e-5 measured), each at its volume fraction, and the
    final warm-start relres of the same size."""
    jg, jscen, tg, tscen = _pair(scenarios, n_iter=3)
    ref, jrel = (np.asarray(a) for a in jg.optimize(jscen))
    got, rel = (a.numpy() for a in tg.optimize(tscen))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.mean(axis=1), scenarios[3], atol=2e-3)
    assert len(tg.cg_iterations) == 4 and all(0 < k < 600 for k in tg.cg_iterations)
    assert (rel < 1e-4).all() and (jrel < 1e-4).all()


def test_device_simp_matches_host_designs(scenarios):
    """Twelve iterations against the host SIMP (float64 LU), to the JAX
    package's own tolerances for its device generator."""
    fem, fixed, f, vf = scenarios
    gen = tgpu.GpuSimpGenerator(P, n_iter=12, cg_tol=1e-8, cg_maxiter=3000, device="cpu")
    rho_dev, relres = gen.optimize(gen.scenarios_from_host(fixed, f, vf))
    rho_dev = rho_dev.numpy()
    assert (relres.numpy() < 1e-3).all()
    for b in range(3):
        rho_host = simp_topopt(fem, float(vf[b]), f[b], fixed[b], n_iter=12)
        assert rho_dev[b].mean() == pytest.approx(float(vf[b]), abs=2e-3)
        assert np.abs(rho_dev[b] - rho_host).mean() < 0.01
        assert np.mean((rho_dev[b] > 0.5) == (rho_host > 0.5)) > 0.97


def _check_fields(samples: np.ndarray) -> None:
    """K u - f ~= 0 by the training residual, max |u| = 1, and the vf channel
    equal to the E field's mean."""
    n = samples.shape[0]
    mb = split_mechanics_batch(torch.from_numpy(samples))
    rho_e = mb.solution[..., 2][:, :-1, :-1].reshape(n, -1)
    residual, _, fv, _ = MechanicsResidual(P).residual_from_fields(mb.solution[..., :2], rho_e,
                                                                   mb.bcs)
    rel = residual.norm(dim=1) / fv.norm(dim=1).clamp(min=1e-30)
    assert (rel < 1e-4).all(), rel
    disp = mb.solution[..., :2].reshape(n, -1).abs().amax(dim=1)
    np.testing.assert_allclose(disp.numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(mb.conditioning[..., 0][:, 0, 0].numpy(),
                               mb.solution[..., 2][:, :-1, :-1].mean(dim=(1, 2)).numpy(),
                               rtol=1e-5)


def test_generate_dataset_gpu_layout_and_invariant(tmp_path):
    samples = tgpu.generate_dataset_gpu(5, nels_per_side=P, seed=5, out_dir=str(tmp_path),
                                        batch=3, n_iter=4, families=("cantilever", "bridge"),
                                        start_index=2, device="cpu")
    assert samples.shape == (5, P + 1, P + 1, 10) and samples.dtype == np.float32
    assert sorted(p.name for p in tmp_path.glob("*.npy")) == [f"{i}.npy" for i in range(2, 7)]
    np.testing.assert_array_equal(np.load(tmp_path / "4.npy"), samples[2])
    _check_fields(samples)


class _UniformDesign:
    """A stand-in for the JAX script's device generator: the uniform design
    rho = vf, so its run draws the scenarios without a SIMP."""

    def scenarios_from_host(self, fixed, f, vf):
        return vf

    def optimize(self, vf):
        return np.repeat(vf[:, None], P * P, axis=1), np.zeros(len(vf))


def test_generate_mechanics_sets_cli_on_the_cpu(tmp_path):
    """``--device cpu --batch 4``: the four sets of the JAX script's layout,
    four scenario draws a batch (so a short last batch draws four too): the
    same scenarios.csv as the JAX script's device path with ``--batch 4``."""
    tsets.main(["--root", str(tmp_path / "port"), "--n-train", "5", "--n-valid", "1",
                "--n-test", "2", "--n-iter", "2", "--pixels-per-dim", str(P),
                "--device", "cpu", "--batch", "4", "--seed", "3"])
    spec = importlib.util.spec_from_file_location(
        "jax_generate_mechanics_sets", ROOT / "scripts" / "generate_mechanics_sets.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    from physicsinformeddiffusionmodels_tpu.data import mechanics_generator as jgen

    fem, rng, root = jgen.MechanicsFEM(P), np.random.default_rng((3, 0)), tmp_path / "jax"
    for sub, n, families, vf_range in (
            ("train", 5, jgen.IN_DIST_FAMILIES, (0.3, 0.6)),
            ("test/valid", 1, jgen.IN_DIST_FAMILIES, (0.3, 0.6)),
            ("test/test_level_1", 2, jgen.IN_DIST_FAMILIES, (0.3, 0.6)),
            ("test/test_level_2", 2, jgen.OOD_FAMILIES, (0.25, 0.7))):
        script.generate_set(fem, _UniformDesign(), root / sub / "fields", n, 4, families,
                            vf_range, rng)
        port = tmp_path / "port" / sub / "fields"
        assert ((port / "scenarios.csv").read_text()
                == (root / sub / "fields" / "scenarios.csv").read_text())
        assert sorted(p.name for p in port.glob("*.npy")) == [f"{i}.npy" for i in range(n)]
        _check_fields(np.stack([np.load(port / f"{i}.npy") for i in range(n)]))
