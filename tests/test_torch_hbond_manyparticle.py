"""CustomHbondForce and CustomManyParticleForce of openmm_tpu_torch
(forces/customhbond.py, forces/custommanyparticle.py) against the JAX
package.

CustomHbondForce on 16 TIP3P waters (48 atoms; each water's hydrogens
two donors, its oxygen an acceptor, the pairs within one water
excluded) with an expression of distance, angle and dihedral, per-donor
and per-acceptor parameters and a global parameter whose derivative is
requested, at each of the three methods; CustomManyParticleForce as
Axilrod-Teller on 12 particles (held also against a direct Python sum
over the triples, 1e-12 relative) at NoCutoff and CutoffPeriodic, and
the type filters of tests/test_gayberne_manyparticle.py:112 in both
permutation modes (the port's enumeration equal to the JAX package's,
and the counted energy), with exclusions from bonds. Against the JAX
"Reference" platform: energies within 1e-10 (relative), forces within
1e-9 of the largest, parameter derivatives within 1e-9 (relative). The
hand-written gradients against torch.autograd of the same energy (1e-12
of the largest force), ten steps at 0 K against the JAX "Reference"
Context (1e-9 nm), updateParametersInContext, from_numpy/to_numpy, the
step body on fake tensors, and chip_smoke.py's phase_more_custom
rehearsed on the CPU.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import jax_custom_force, jax_system
from openmm_tpu_torch.unit import plain

E_TOL = 1e-10
F_TOL = 1e-9
D_TOL = 1e-9
AUTOGRAD_TOL = 1e-12
POS_TOL = 1e-9
AXILROD_TELLER = ("C*(1+3*cos(t1)*cos(t2)*cos(t3))/(r12*r13*r23)^3;"
                  "t1=angle(p2,p1,p3); t2=angle(p1,p2,p3);"
                  "t3=angle(p1,p3,p2); r12=distance(p1,p2);"
                  "r13=distance(p1,p3); r23=distance(p2,p3)")
HBOND = ("k*(distance(a1,d1)-r0)^2*cos(angle(a1,d1,d2))^2"
         " + eps*cos(dihedral(a2,a1,d1,d2)) + 0.1*angle(d1,a1,a2)")


def _bare(n, box=3.0, masses=None):
    """from_numpy keys of n particles with a NoCutoff NonbondedForce of
    no charges and no Lennard-Jones."""
    return {"masses": np.full(n, 20.0) if masses is None else masses,
            "charges": np.zeros(n), "sigma": np.full(n, 0.3),
            "epsilon": np.zeros(n),
            "exception_pairs": np.zeros((0, 2), np.int64),
            "exception_params": np.zeros((0, 3)),
            "constraint_pairs": np.zeros((0, 2), np.int64),
            "constraint_distances": np.zeros(0),
            "box": np.diag([box] * 3), "cutoff": 1.0, "method": "NoCutoff",
            "ewald_tolerance": 5e-4, "dispersion_correction": False,
            "switch_distance": -1.0}


def _hbond_case(method, waters=16):
    system, pos = tip3p_water_box(216)
    n = 3 * waters
    params = _bare(n, masses=omm.to_numpy(system)["masses"][:n])
    pos = pos[:n]
    rng = np.random.RandomState(2)
    spec = {"kind": "CustomHbondForce", "energy": HBOND, "group": 1,
            "globals": [("eps", 0.4)], "derivatives": ["eps"],
            "functions": [], "periodic": method == 2,
            "donor_parameters": ["k"], "acceptor_parameters": ["r0"],
            "donors": [((3 * w + h, 3 * w, -1), [float(rng.uniform(5, 9))])
                       for w in range(waters) for h in (1, 2)],
            "acceptors": [((3 * w, 3 * w + 1, 3 * w + 2),
                           [float(rng.uniform(0.18, 0.22))])
                          for w in range(waters)],
            "exclusions": [(2 * w + h, w) for w in range(waters)
                           for h in (0, 1)],
            "method": method, "cutoff": 0.45}
    params["custom_forces"] = [spec]
    return params, pos


def _axilrod_case(method, n=12):
    rng = np.random.RandomState(3)
    box = 1.6
    pos = rng.uniform(0.0, box, (n, 3))
    params = _bare(n, box=box)
    spec = {"kind": "CustomManyParticleForce", "energy": AXILROD_TELLER,
            "group": 1, "globals": [("C", 1.5)], "derivatives": ["C"],
            "functions": [], "periodic": method == 2,
            "particles_per_set": 3, "parameters": [],
            "particles": [([], 0)] * n, "type_filters": [],
            "permutation_mode": 0, "exclusions": [], "method": method,
            "cutoff": 0.75}
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


def _close(ctx, jctx, group=1):
    st = ctx.getState(getEnergy=True, getForces=True,
                      getParameterDerivatives=True, groups={group})
    jst = jctx.getState(getEnergy=True, getForces=True,
                        getParameterDerivatives=True, groups={group})
    e, f, d = (plain(st.getPotentialEnergy()),
               plain(st.getForces(asNumpy=True)),
               st.getEnergyParameterDerivatives())
    e_ref = float(u.strip(jst.getPotentialEnergy()))
    f_ref = np.asarray(u.strip(jst.getForces(asNumpy=True)))
    d_ref = {k: float(v) for k, v in
             jst.getEnergyParameterDerivatives().items()}
    assert abs(e_ref) > 1e-6
    assert abs(e - e_ref) <= E_TOL * abs(e_ref), (e, e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL * np.abs(f_ref).max()
    assert set(d) == set(d_ref)
    for name, value in d_ref.items():
        assert abs(d[name] - value) <= D_TOL * max(abs(value), 1e-12)
    return e


METHODS = {"NoCutoff": 0, "CutoffNonPeriodic": 1, "CutoffPeriodic": 2}


@pytest.mark.parametrize("method", list(METHODS))
def test_hbond_against_jax_reference(method):
    ctx, jctx = _contexts(*_hbond_case(METHODS[method]))
    _close(ctx, jctx)
    ctx.setParameter("eps", 1.1)
    jctx.setParameter("eps", 1.1)
    _close(ctx, jctx)


@pytest.mark.parametrize("method", ["NoCutoff", "CutoffPeriodic"])
def test_axilrod_teller_against_jax_reference(method):
    params, pos = _axilrod_case(METHODS[method])
    ctx, jctx = _contexts(params, pos)
    e = _close(ctx, jctx)
    if method != "NoCutoff":
        return
    def ang(a, b, c):
        v1, v2 = pos[a] - pos[b], pos[c] - pos[b]
        return math.acos(np.dot(v1, v2) / (np.linalg.norm(v1)
                                           * np.linalg.norm(v2)))
    want = 0.0
    for i, j, k in itertools.combinations(range(len(pos)), 3):
        r = (np.linalg.norm(pos[i] - pos[j]) * np.linalg.norm(pos[i] - pos[k])
             * np.linalg.norm(pos[j] - pos[k]))
        want += 1.5 * (1 + 3 * math.cos(ang(j, i, k)) * math.cos(
            ang(i, j, k)) * math.cos(ang(i, k, j))) / r ** 3
    assert abs(e - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("mode", [0, 1], ids=["SinglePermutation",
                                              "UniqueCentralParticle"])
def test_type_filters_and_exclusions(mode):
    """The tuple enumeration with type filters, both permutation modes and
    exclusions from bonds equals the JAX package's, and a counting
    expression gives the same energy."""
    n = 7
    params = _bare(n)
    pos = np.stack([0.1 * np.arange(n), 0.05 * np.arange(n) ** 1.3,
                    np.zeros(n)], axis=1)
    ours = omm.CustomManyParticleForce(3, "1.0 + 0.01*distance(p1,p2)")
    theirs = mm.CustomManyParticleForce(3, "1.0 + 0.01*distance(p1,p2)")
    for f in (ours, theirs):
        for i in range(n):
            f.addParticle([], 0 if i < 3 else 1)
        f.setPermutationMode(mode)
        f.setTypeFilter(0, [0])
        f.setTypeFilter(1, [1])
        f.setTypeFilter(2, [1])
        f.createExclusionsFromBonds([(0, 3), (3, 4), (5, 6)], 1)
        f.setForceGroup(1)
    assert ours._exclusions == theirs._exclusions
    assert np.array_equal(ours._enumerate_tuples(),
                          theirs._enumerate_tuples())
    assert len(ours._enumerate_tuples()) > 0
    system = omm.from_numpy(params)
    system.addForce(ours)
    jsystem = jax_system(params)
    jsystem.addForce(theirs)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    jctx = mm.Context(jsystem, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    jctx.setPositions(pos)
    _close(ctx, jctx)


@pytest.mark.parametrize("which", ["hbond", "axilrod_teller"])
def test_gradients_against_autograd(which):
    params, pos = (_hbond_case(1) if which == "hbond"
                   else _axilrod_case(2))
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    (module,) = ctx._custom
    x = torch.as_tensor(pos, dtype=torch.float64).requires_grad_(True)
    energy, forces, _ = module._compute(x, ctx._box, False)
    (grad,) = torch.autograd.grad(energy, x)
    forces = forces.detach()
    assert float((forces + grad).abs().max()) <= AUTOGRAD_TOL * float(
        forces.abs().max())


@pytest.mark.parametrize("which", ["hbond", "axilrod_teller"])
def test_ten_steps_at_zero_kelvin_match_jax_reference(which):
    params, pos = (_hbond_case(0) if which == "hbond"
                   else _axilrod_case(0))
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
    params, pos = _hbond_case(1)
    integ = omm.VerletIntegrator(0.001)
    ctx, jctx = _contexts(params, pos, (integ, mm.VerletIntegrator(0.001)))
    integ.step(1)
    programs = dict(ctx._programs)
    ctx.setPositions(pos)
    for c in (ctx, jctx):
        (force,) = [f for f in c.getSystem().getForces()
                    if type(f).__name__ == "CustomHbondForce"]
        for i in range(force.getNumAcceptors()):
            *atoms, p = force.getAcceptorParameters(i)
            force.setAcceptorParameters(i, *atoms, [p[0] + 0.02])
        force.updateParametersInContext(c)
    _close(ctx, jctx)
    assert ctx._programs == programs


def test_from_numpy_round_trip():
    for params, _ in (_hbond_case(2), _axilrod_case(1)):
        (spec,) = params["custom_forces"]
        (back,) = omm.to_numpy(omm.from_numpy(params))["custom_forces"]
        for key, value in spec.items():
            got = back[key]
            if key in ("donors", "acceptors"):
                assert [(list(a), list(b)) for a, b in got] == [
                    (list(a), list(b)) for a, b in value]
            elif key == "particles":
                assert [(list(a), b) for a, b in got] == [
                    (list(a), b) for a, b in value]
            elif key == "exclusions":
                assert [tuple(e) for e in got] == [tuple(e) for e in value]
            else:
                assert got == value, key
        jax_custom_force(back)


def test_step_body_reads_nothing_from_the_device():
    from torch._subclasses.fake_tensor import FakeTensorMode
    for params, pos in (_hbond_case(2), _axilrod_case(2)):
        integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.001)
        ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
        ctx.setPositions(pos)
        integ.step(1)
        program = ctx._program()
        with FakeTensorMode(allow_non_fake_inputs=True):
            program.body(program.gate_always)


def test_chip_smoke_more_custom_phase_on_cpu():
    """chip_smoke.py's phase_more_custom rehearsed on 16 waters, 20 argon
    atoms and 8 ellipsoids (20 steps, 2 replayed; the drift gate, which
    needs the card's 300 steps, left open): every other gate holds."""
    import chip_smoke
    systems = chip_smoke.more_custom_systems(16, 20, 8)
    out = chip_smoke.phase_more_custom(torch.device("cpu"), systems=systems,
                                       steps=20, every=5, replay=2,
                                       gate=math.inf)
    assert set(out) == {"hbond", "axilrod-teller", "gay-berne"}
    for r in out.values():
        assert max(r["err"]) <= chip_smoke.MORE_BAR
