"""Energy minimization of openmm_tpu_torch against openmm_tpu on a 343-water
PME box (1,029 atoms, 20^3 grid): the objective (Context.
_make_position_energy_fn, through TileEnergy and the dense PME), the
vectorized constraint penalty, L-BFGS, and a whole short minimization.

Tolerances: the port's float64 objective on the "CPU" platform evaluates
the formulas of the JAX "Reference" platform (float64, dense pairs):
1e-10 relative in energy and 1e-10 of the largest force (measured 1e-14).
Its float32 objective keeps the bars of tests/test_torch_slice.py: energy
within 1e-5 relative, median relative force error <= 1e-5. The penalty and
L-BFGS repeat the JAX module's arithmetic in its order, so they must give
the same floats. Five L-BFGS iterations per penalty stage from the lattice
start, float64 on both sides, end within 1e-10 nm and 1e-10 relative
energy (measured 3e-15 nm): longer runs are not compared, because tiny
differences in the objective grow along a minimization path."""
import numpy as np
import pytest
import torch

import chip_smoke
import openmm_tpu as mm
from openmm_tpu import minimize as jmin
from openmm_tpu.models import tip3p_water_box as jax_water_box

import openmm_tpu_torch as omm
from openmm_tpu_torch import minimize as tmin
from torch_port_helpers import median_relative_error, system_params


@pytest.fixture(scope="module")
def box343():
    jsys, jpos = jax_water_box(n_waters=343)
    pos = np.array([[p.x, p.y, p.z] for p in jpos])
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    return jctx, pos, omm.from_numpy(system_params(jsys))


def _context(system, pos, precision):
    ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": precision})
    ctx.setPositions(pos)
    return ctx


class _Iterates(omm.MinimizationReporter):
    def __init__(self):
        self.x = []

    def report(self, iteration, x, grad, args):
        self.x.append(np.array(x))
        return False


def test_objective_matches_jax_reference(box343):
    jctx, pos, system = box343
    jfn = jctx._make_position_energy_fn()
    ctx64 = _context(system, pos, "double")
    ctx32 = _context(system, pos, "mixed")
    fn64 = ctx64._make_position_energy_fn()
    fn32 = ctx32._make_position_energy_fn()
    shaken = pos + np.random.RandomState(6).uniform(-0.01, 0.01, pos.shape)
    for x in (pos, shaken):
        je, jf = jfn(x)
        e, f = fn64(x)
        assert abs(e - je) < 1e-10 * abs(je)
        assert np.abs(f - jf).max() < 1e-10 * np.abs(jf).max()
        e, f = fn32(x)
        assert abs(e - je) < 1e-5 * abs(je)
        assert median_relative_error(f, jf) <= 1e-5
    assert ctx64.energy_evaluations == ctx32.energy_evaluations == 2
    # the objective leaves the Context's own positions alone
    assert np.array_equal(ctx64.getState(getPositions=True).getPositions(),
                          pos)


def _jax_penalty_loop(pos, cons, k_penalty, e, g):
    """The per-constraint loop of openmm_tpu/minimize.py's objective."""
    for (p1, p2, d) in cons:
        delta = pos[p1] - pos[p2]
        r = np.linalg.norm(delta)
        viol = r - d
        e += 0.5 * k_penalty * viol * viol
        gdir = k_penalty * viol * delta / max(r, 1e-12)
        g[p1] += gdir
        g[p2] -= gdir
    return e


def test_penalty_matches_per_constraint_loop(box343):
    _, pos, system = box343
    rng = np.random.RandomState(2)
    x = pos + rng.uniform(-0.003, 0.003, pos.shape)
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    p1, p2, d = (np.array(c) for c in zip(*cons))
    g0 = rng.randn(*pos.shape)
    for k in (1e7, 1e9):
        g_loop, g_vec = g0.copy(), g0.copy()
        e_loop = _jax_penalty_loop(x, cons, k, -1234.5, g_loop)
        e_vec = tmin._add_penalty(x, p1.astype(np.int64),
                                  p2.astype(np.int64), d, k, -1234.5, g_vec)
        assert e_vec == e_loop
        assert np.array_equal(g_vec, g_loop)


def test_lbfgs_iterates_match_jax():
    rng = np.random.RandomState(9)
    m = rng.randn(45, 45)
    a = m @ m.T / 45 + np.eye(45)
    b = rng.randn(45)

    def objective(x):
        return (0.5 * x @ a @ x - b @ x + 0.05 * np.sum(x ** 4),
                a @ x - b + 0.2 * x ** 3)

    runs = []
    for mod in (jmin, tmin):
        rep = _Iterates()
        x = mod._lbfgs(objective, np.full(45, 0.7), 1e-6, 40, rep)
        runs.append((x, rep.x))
    (xj, itj), (xt, itt) = runs
    assert len(itj) == len(itt) > 5
    assert all(np.array_equal(p, q) for p, q in zip(itj, itt))
    assert np.array_equal(xj, xt)


def test_minimize_matches_jax_reference(box343):
    jctx, pos, system = box343
    jctx.setPositions(pos)
    jrep = _Iterates()
    mm.LocalEnergyMinimizer.minimize(jctx, 10.0, 5, jrep)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)
    e_want = jctx.getState(getEnergy=True).getPotentialEnergy()._value

    ctx = _context(system, pos, "double")
    rep = _Iterates()
    omm.LocalEnergyMinimizer.minimize(ctx, 10.0, 5, rep)
    got = ctx.getState(getPositions=True).getPositions()
    e_got = ctx.getState(getEnergy=True).getPotentialEnergy()
    assert len(rep.x) == len(jrep.x) > 5      # penalty stages escalated
    assert np.abs(got - want).max() < 1e-10
    assert abs(e_got - e_want) < 1e-10 * abs(e_want)


def test_minimize_lowers_energy_and_keeps_constraints(box343):
    _, pos, system = box343
    ctx = _context(system, pos, "mixed")
    assert ctx.getSystem() is system
    integ = ctx.getIntegrator()
    assert integ.getConstraintTolerance() == 1e-5
    before = ctx.getState(getEnergy=True).getPotentialEnergy()

    class Raises(omm.MinimizationReporter):
        calls = 0

        def report(self, iteration, x, grad, args):
            Raises.calls += 1
            raise RuntimeError("a reporter's exception is ignored")

    omm.LocalEnergyMinimizer.minimize(ctx, 10.0, 20, Raises())
    assert Raises.calls >= 20 and ctx.energy_evaluations > Raises.calls
    assert ctx._tiles is None             # built for the old positions
    st = ctx.getState(getEnergy=True, getPositions=True)
    after = st.getPotentialEnergy()
    assert np.isfinite(after) and after < before - 100.0
    x = st.getPositions()
    for i in range(system.getNumConstraints()):
        p1, p2, d = system.getConstraintParameters(i)
        r = np.linalg.norm(x[p1] - x[p2])
        assert abs(r - d) / d < 2 * integ.getConstraintTolerance()


def test_chip_smoke_minimize_phase_on_cpu():
    result = chip_smoke.phase_minimize(torch.device("cpu"), n_waters=343,
                                       calls=2, iterations=3)
    assert result["iterations"] >= 6
    assert result["evaluations"] > result["iterations"]
    before, after = result["energies"]
    assert after < before
    assert result["grad_err"] <= chip_smoke.FORCE_ERR_BAR
    assert result["recip_err"] <= chip_smoke.FORCE_ERR_BAR
    # CPU tensors take the plain versions: no kernel launched
    assert set(result["launches"].values()) == {0}
