"""GayBerneForce of openmm_tpu_torch (forces/gayberne.py) against the JAX
package and against Lennard-Jones.

Spherical particles with unit energy scales and one sigma (the pattern of
tests/test_gayberne_manyparticle.py:21) against the port's own
NonbondedForce Lennard-Jones: energy within 1e-10 (relative), forces
within 1e-9 of the largest. Eight ellipsoids, each with an x frame
particle and (all but two) a y frame particle, Lorentz-Berthelot mixing,
an exception, at each of the three methods with the switch: against the
JAX "Reference" platform, energy within 1e-10 (relative) and forces
within 1e-9 of the largest. The hand-written forces (the pair's gradient
in its displacement and in both frames, carried to the frame particles)
against torch.autograd of the same energy (1e-12 of the largest force).
Ten steps at 0 K against the JAX "Reference" Context (1e-9 nm),
updateParametersInContext, from_numpy/to_numpy and the step body on fake
tensors.
"""
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from torch_port_helpers import jax_system
from openmm_tpu_torch.unit import plain

E_TOL = 1e-10
F_TOL = 1e-9
AUTOGRAD_TOL = 1e-12
POS_TOL = 1e-9
ELLIPSOIDS = 8


def _bare(n, box=3.0):
    return {"masses": np.full(n, 15.0), "charges": np.zeros(n),
            "sigma": np.full(n, 0.3), "epsilon": np.zeros(n),
            "exception_pairs": np.zeros((0, 2), np.int64),
            "exception_params": np.zeros((0, 3)),
            "constraint_pairs": np.zeros((0, 2), np.int64),
            "constraint_distances": np.zeros(0),
            "box": np.diag([box] * 3), "cutoff": 1.0, "method": "NoCutoff",
            "ewald_tolerance": 5e-4, "dispersion_correction": False,
            "switch_distance": -1.0}


def _fluid(method, switch=True):
    """(from_numpy dict, positions): ELLIPSOIDS ellipsoids on a jittered
    lattice, each followed by its x frame particle and (all but the last
    two) its y frame particle, as massive particles of epsilon 0."""
    rng = np.random.RandomState(5)
    pos, particles = [], []
    for k in range(ELLIPSOIDS):
        centre = 0.55 * np.asarray([k % 2, (k // 2) % 2, k // 4]) + 0.6 \
            + rng.uniform(-0.05, 0.05, 3)
        i = len(pos)
        with_y = k < ELLIPSOIDS - 2
        pos.append(centre)
        pos.append(centre + 0.1 * rng.normal(size=3))
        particles.append([0.3 + 0.02 * (k % 3), 0.8 + 0.1 * (k % 2), i + 1,
                          i + 2 if with_y else -1, 0.5, 0.3, 0.25,
                          1.3, 0.9, 0.7])
        particles.append([0.1, 0.0, -1, -1, 0.1, 0.1, 0.1, 1, 1, 1])
        if with_y:
            pos.append(centre + 0.1 * rng.normal(size=3))
            particles.append([0.1, 0.0, -1, -1, 0.1, 0.1, 0.1, 1, 1, 1])
    pos = np.asarray(pos)
    params = _bare(len(pos))
    spec = {"kind": "GayBerneForce", "group": 1, "particles": particles,
            "exceptions": [(0, 3, 0.28, 0.5)], "method": method,
            "cutoff": 1.0, "switch_distance": 0.8 if switch else -1.0}
    params["custom_forces"] = [spec]
    return params, pos


def _contexts(params, pos, integrators=None):
    integ, jinteg = integrators or (omm.VerletIntegrator(0.001),
                                    mm.VerletIntegrator(0.001))
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    jctx = mm.Context(jax_system(params), jinteg,
                      mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    jctx.setPositions(pos)
    return ctx, jctx


def _close(ctx, jctx):
    st = ctx.getState(getEnergy=True, getForces=True, groups={1})
    jst = jctx.getState(getEnergy=True, getForces=True, groups={1})
    e, f = plain(st.getPotentialEnergy()), plain(st.getForces(asNumpy=True))
    e_ref = float(u.strip(jst.getPotentialEnergy()))
    f_ref = np.asarray(u.strip(jst.getForces(asNumpy=True)))
    assert abs(e_ref) > 1e-3
    assert abs(e - e_ref) <= E_TOL * abs(e_ref), (e, e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL * np.abs(f_ref).max()


def test_spheres_are_lennard_jones():
    rng = np.random.RandomState(1)
    n = 6
    pos = rng.rand(n, 3) * 2
    eps = [0.5 + 0.1 * (i % 2) for i in range(n)]
    lj = _bare(n)
    lj["epsilon"] = np.asarray(eps)
    spheres = _bare(n)
    spheres["custom_forces"] = [{
        "kind": "GayBerneForce", "group": 0,
        "particles": [[0.3, e, -1, -1, 0.3, 0.3, 0.3, 1.0, 1.0, 1.0]
                      for e in eps],
        "exceptions": [], "method": 0, "cutoff": 1.0,
        "switch_distance": -1.0}]
    readings = []
    for params in (lj, spheres):
        ctx = omm.Context(omm.from_numpy(params),
                          omm.VerletIntegrator(0.001), "CPU",
                          {"Precision": "double"})
        ctx.setPositions(pos)
        st = ctx.getState(getEnergy=True, getForces=True)
        readings.append((plain(st.getPotentialEnergy()),
                         plain(st.getForces(asNumpy=True))))
    (e1, f1), (e2, f2) = readings
    assert abs(e1 - e2) <= E_TOL * abs(e1)
    assert np.abs(f1 - f2).max() <= F_TOL * np.abs(f1).max()


@pytest.mark.parametrize("method", [0, 1, 2],
                         ids=["NoCutoff", "CutoffNonPeriodic",
                              "CutoffPeriodic"])
def test_anisotropic_against_jax_reference(method):
    _close(*_contexts(*_fluid(method)))


@pytest.mark.parametrize("switch", [True, False], ids=["switch", "plain"])
def test_hand_forces_against_autograd(switch):
    params, pos = _fluid(1, switch)
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    (module,) = ctx._custom
    x = torch.as_tensor(pos, dtype=torch.float64).requires_grad_(True)
    energy, forces = module.ef(x, ctx._box)
    (grad,) = torch.autograd.grad(energy, x)
    forces = forces.detach()
    assert float((forces + grad).abs().max()) <= AUTOGRAD_TOL * float(
        forces.abs().max())


def test_ten_steps_at_zero_kelvin_match_jax_reference():
    params, pos = _fluid(0)
    ctx, jctx = _contexts(params, pos, (
        omm.LangevinMiddleIntegrator(0.0, 0.0, 0.001),
        mm.LangevinMiddleIntegrator(0.0, 0.0, 0.001)))
    vel = np.random.RandomState(3).randn(*pos.shape) * 0.3
    ctx.setVelocities(vel)
    jctx.setVelocities(vel)
    ctx.getIntegrator().step(10)
    jctx.getIntegrator().step(10)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(want - pos).max() > 1e-3
    assert np.abs(got - want).max() <= POS_TOL


def test_update_parameters_in_context():
    """New particle parameters in both packages (the JAX package keeps an
    exception's parameters from its compile, so they are not changed
    here), with no new step program."""
    params, pos = _fluid(2)
    integ = omm.VerletIntegrator(0.001)
    ctx, jctx = _contexts(params, pos, (integ, mm.VerletIntegrator(0.001)))
    integ.step(1)
    programs = dict(ctx._programs)
    ctx.setPositions(pos)
    for c in (ctx, jctx):
        (force,) = [f for f in c.getSystem().getForces()
                    if type(f).__name__ == "GayBerneForce"]
        p = list(plain(force.getParticleParameters(0)))
        p[1], p[4] = 1.2, 0.55
        force.setParticleParameters(0, *p)
        force.updateParametersInContext(c)
    _close(ctx, jctx)
    assert ctx._programs == programs


def test_from_numpy_round_trip():
    params, _ = _fluid(2)
    (spec,) = params["custom_forces"]
    (back,) = omm.to_numpy(omm.from_numpy(params))["custom_forces"]
    assert [list(p) for p in back["particles"]] == [
        list(p) for p in spec["particles"]]
    assert [tuple(e) for e in back["exceptions"]] == spec["exceptions"]
    for key in ("method", "cutoff", "switch_distance", "group"):
        assert back[key] == spec[key]


def test_step_body_reads_nothing_from_the_device():
    from torch._subclasses.fake_tensor import FakeTensorMode
    params, pos = _fluid(2)
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.001)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx.setPositions(pos)
    integ.step(1)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)
