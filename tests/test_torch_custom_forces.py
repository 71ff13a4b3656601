"""The seven custom forces of openmm_tpu_torch (forces/custom.py,
ops/custom_pairs.py) against the JAX package's "Reference" platform.

One System carries them all, each in a force group of its own, on 128
TIP3P waters (384 atoms: a multiple of the JAX Reference platform's pair
block, so its padded pair sweep adds no pairs whose jax.grad is NaN): a
flat-bottom CustomExternalForce with periodicdistance and a Discrete1D
table, a Lennard-Jones CustomBondForce (periodic) with a Continuous1D
table, a CustomAngleForce, a CustomTorsionForce (periodic), the soft-core
CustomNonbondedForce of an alchemical run with two overlapping interaction
groups, exclusions, the switch and the long-range correction, a
CustomCompoundBondForce over distance, angle, dihedral, pointdistance,
scalar coordinates and a periodic Continuous2D table of two dihedrals, and
a CustomCentroidBondForce with mass, unit and zero-sum weights. Each
force's energy (1e-10 relative), forces (1e-9 of the largest) and energy
parameter derivatives (1e-9 relative) are held against the JAX
"Reference" platform, in float64; then updateParametersInContext, the
pair sweep's rules (no groups, overlapping groups), ten steps at 0 K (1e-9
nm), the minimizer's objective, the float32 pairs, the step program
against the eager loop, from_numpy/to_numpy, and a derivative of a
parameter that NonbondedForce offsets use (served since the offsets'
derivative was ported).
"""
import copy

import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from openmm_tpu_torch.models.builders import SOFTCORE
from torch_port_helpers import jax_system, median_relative_error

WATERS = 128
E_TOL = 1e-10           # energies, relative
F_TOL = 1e-9            # forces, of the largest force
D_TOL = 1e-9            # parameter derivatives, relative
POS_TOL = 1e-9          # nm after ten steps
KINDS = ("CustomExternalForce", "CustomBondForce", "CustomAngleForce",
         "CustomTorsionForce", "CustomNonbondedForce",
         "CustomCompoundBondForce", "CustomCentroidBondForce")


def _waters(k):
    """(from_numpy dict, positions) of the first k waters of the
    216-water box (its box and PME settings)."""
    system, pos = tip3p_water_box(216)
    params = omm.to_numpy(system)
    n = 3 * k
    for key in ("masses", "charges", "sigma", "epsilon"):
        params[key] = params[key][:n]
    for pairs, values in (("exception_pairs", "exception_params"),
                          ("constraint_pairs", "constraint_distances")):
        keep = (params[pairs] < n).all(axis=1)
        params[pairs] = params[pairs][keep]
        params[values] = params[values][keep]
    return params, pos[:n]


def _specs(params, pos):
    """One custom_spec of each kind, group 1..7 in KINDS' order."""
    n = len(params["masses"])
    ox = list(range(0, n, 3))
    rng = np.random.RandomState(3)
    table1 = np.exp(-np.linspace(0.0, 3.0, 40))
    twod = np.cos(np.linspace(-np.pi, np.pi, 9))[:, None] * np.sin(
        np.linspace(-np.pi, np.pi, 8))[None, :]
    sigma = params["sigma"]
    eps = params["epsilon"]
    specs = [
        {"kind": "CustomExternalForce",
         "energy": "k*max(0, periodicdistance(x,y,z,x0,y0,z0)-d0)^2"
                   " + 0.1*x*y + 0.01*disc(x0*3)",
         "globals": [("k", 500.0), ("d0", 0.01)], "derivatives": ["k"],
         "functions": [("disc", "Discrete1DFunction",
                        (list(rng.randn(8)),), False)],
         "parameters": ["x0", "y0", "z0"],
         "terms": [((i,), list(pos[i] + rng.randn(3) * 0.05))
                   for i in ox[:12]], "periodic": False},
        {"kind": "CustomBondForce",
         "energy": "lam*4*eps*((sig/r)^12-(sig/r)^6) + 0.2*table1(r)",
         "globals": [("lam", 0.7)], "derivatives": ["lam"],
         "functions": [("table1", "Continuous1DFunction",
                        (list(table1), 0.0, 2.0), False)],
         "parameters": ["sig", "eps"],
         "terms": [((ox[i], ox[j]), [0.315, 0.6]) for i in range(7)
                   for j in range(i + 1, 7)], "periodic": True},
        {"kind": "CustomAngleForce", "energy": "0.5*ka*(theta-t0)^2",
         "globals": [], "derivatives": [], "functions": [],
         "parameters": ["ka", "t0"],
         "terms": [((3 * i + 1, 3 * i, 3 * i + 2), [300.0, 1.9])
                   for i in range(20)], "periodic": False},
        {"kind": "CustomTorsionForce",
         "energy": "kt*(1+cos(2*theta-0.3)) + 0.1*theta^2",
         "globals": [("kt", 2.0)], "derivatives": ["kt"], "functions": [],
         "parameters": [],
         "terms": [((ox[i], ox[i + 1], ox[i + 2], ox[i + 3]), [])
                   for i in range(12)], "periodic": True},
        {"kind": "CustomNonbondedForce", "energy": SOFTCORE,
         "globals": [("lambda_sterics", 0.5)],
         "derivatives": ["lambda_sterics"], "functions": [],
         "parameters": ["sigma", "epsilon"],
         "terms": [((), [float(sigma[i]), float(eps[i])])
                   for i in range(n)],
         "method": 2, "cutoff": 0.8, "switch_distance": 0.7,
         "long_range_correction": True,
         "exclusions": [(3 * i, 3 * i + 1) for i in range(10)]
         + [(3 * i, 3 * i + 2) for i in range(10)],
         "interaction_groups": [(list(range(12)), list(range(12, n))),
                                (list(range(6, 18)), list(range(12, 30)))],
         "periodic": True},
        {"kind": "CustomCompoundBondForce",
         "energy": "kc*(distance(p1,p2)-0.3)^2 + 0.5*(angle(p1,p2,p3)-1.5)^2"
                   " + w*cos(dihedral(p1,p2,p3,p4)) + 0.01*x1*z4"
                   " + pointdistance(x1,y1,z1,x3,y3,z3)"
                   " + 0.3*cmap(dihedral(p1,p2,p3,p4),"
                   " dihedral(p2,p3,p4,p1))",
         "globals": [("kc", 100.0)], "derivatives": ["kc"],
         "functions": [("cmap", "Continuous2DFunction",
                        (9, 8, list(twod.ravel(order="F")), -np.pi, np.pi,
                         -np.pi, np.pi), True)],
         "parameters": ["w"], "particles_per_bond": 4,
         "terms": [((ox[i], ox[i + 1], ox[i + 2], ox[i + 3]), [1 + 0.1 * i])
                   for i in range(10)], "periodic": True},
        {"kind": "CustomCentroidBondForce",
         "energy": "0.5*kg*(distance(g1,g2)-r0)^2",
         "globals": [("kg", 200.0)], "derivatives": ["kg"], "functions": [],
         "parameters": ["r0"], "groups_per_bond": 2,
         "groups": [(tuple(range(0, 30)), None),
                    (tuple(range(30, 60)), [1.0] * 30),
                    (tuple(range(60, 63)), [0.0, 0.0, 0.0])],
         "terms": [((0, 1), [0.5]), ((1, 2), [0.3])], "periodic": True},
    ]
    for g, spec in enumerate(specs):
        spec["group"] = g + 1
    return specs


def _jax_context(params, pos, integrator=None):
    ctx = mm.Context(jax_system(params),
                     integrator or mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    return ctx


def _context(params, pos, precision="double", integrator=None):
    props = {"Precision": "double"} if precision == "double" else None
    ctx = omm.Context(omm.from_numpy(params),
                      integrator or omm.VerletIntegrator(0.001), "CPU",
                      props)
    ctx.setPositions(pos)
    return ctx


def _jax_reading(ctx, group):
    st = ctx.getState(getEnergy=True, getForces=True,
                      getParameterDerivatives=True,
                      groups=group if isinstance(group, set) else {group})
    return (float(u.strip(st.getPotentialEnergy())),
            np.asarray(u.strip(st.getForces(asNumpy=True))),
            {k: float(v) for k, v in
             st.getEnergyParameterDerivatives().items()})


def _reading(ctx, group):
    st = ctx.getState(getEnergy=True, getForces=True,
                      getParameterDerivatives=True,
                      groups=group if isinstance(group, set) else {group})
    return (st.getPotentialEnergy(), st.getForces(),
            st.getEnergyParameterDerivatives())


def _close(got, want):
    e, f, d = got
    e_ref, f_ref, d_ref = want
    assert abs(e - e_ref) <= E_TOL * max(abs(e_ref), 1e-12), (e, e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL * max(np.abs(f_ref).max(),
                                                  1e-12)
    assert set(d) == set(d_ref)
    for name, value in d_ref.items():
        assert abs(d[name] - value) <= D_TOL * max(abs(value), 1e-12), (
            name, d[name], value)


@pytest.fixture(scope="module")
def case():
    params, pos = _waters(WATERS)
    params["custom_forces"] = _specs(params, pos)
    return params, pos, _jax_context(params, pos), _context(params, pos)


@pytest.mark.parametrize("kind", KINDS)
def test_energy_forces_and_derivatives_against_jax_reference(case, kind):
    params, pos, jctx, ctx = case
    group = KINDS.index(kind) + 1
    want = _jax_reading(jctx, group)
    assert abs(want[0]) > 1e-6
    _close(_reading(ctx, group), want)


def test_all_groups_and_parameters_together(case):
    params, pos, jctx, ctx = case
    for name, value in (("lam", 0.3), ("lambda_sterics", 0.8),
                        ("kc", 40.0)):
        jctx.setParameter(name, value)
        ctx.setParameter(name, value)
    try:
        _close(_reading(ctx, set(range(8))),
               _jax_reading(jctx, set(range(8))))
    finally:
        for name, value in (("lam", 0.7), ("lambda_sterics", 0.5),
                            ("kc", 100.0)):
            jctx.setParameter(name, value)
            ctx.setParameter(name, value)


def _change(c, force, kind):
    """New per-term parameters (same terms) for updateParametersInContext,
    on either package's force (the torsions, which have none, a new value
    of their global parameter through Context c)."""
    if kind == "CustomNonbondedForce":
        for i in range(0, force.getNumParticles(), 7):
            p = force.getParticleParameters(i)
            force.setParticleParameters(i, [p[0] * 1.05, p[1] * 0.9])
    elif kind == "CustomExternalForce":
        for i in range(force.getNumParticles()):
            atom, p = force.getParticleParameters(i)
            force.setParticleParameters(i, atom, [x + 0.03 for x in p])
    elif kind == "CustomCentroidBondForce":
        groups, p = force.getBondParameters(0)
        force.setBondParameters(0, groups, [p[0] * 1.5])
    elif kind == "CustomCompoundBondForce":
        for i in range(force.getNumBonds()):
            atoms, p = force.getBondParameters(i)
            force.setBondParameters(i, atoms, [p[0] * 3.0])
    elif kind == "CustomAngleForce":
        for i in range(force.getNumAngles()):
            *atoms, p = force.getAngleParameters(i)
            force.setAngleParameters(i, *atoms, [p[0] * 2, p[1] - 0.1])
    elif kind == "CustomTorsionForce":
        force.setGlobalParameterDefaultValue(0, 3.0)
        c.setParameter("kt", 3.0)
    else:
        for i in range(force.getNumBonds()):
            a, b, p = force.getBondParameters(i)
            force.setBondParameters(i, a, b, [p[0] * 1.1, p[1] * 0.5])


@pytest.mark.parametrize("kind", KINDS)
def test_update_parameters_in_context(kind):
    """New per-term parameters through updateParametersInContext in both
    packages: the same energies, and the port's step program is not
    captured again (its Context's programs unchanged)."""
    params, pos = _waters(WATERS)
    params["custom_forces"] = [s for s in _specs(params, pos)
                               if s["kind"] == kind]
    jctx = _jax_context(params, pos)
    integ = omm.VerletIntegrator(0.001)
    ctx = _context(params, pos, integrator=integ)
    integ.step(1)
    programs = dict(ctx._programs)
    group = params["custom_forces"][0]["group"]
    for c in (jctx, ctx):
        system = c.getSystem()
        (force,) = [f for f in system.getForces()
                    if type(f).__name__ == kind]
        _change(c, force, kind)
        force.updateParametersInContext(c)
    jctx.setPositions(pos)
    ctx.setPositions(pos)
    _close(_reading(ctx, group), _jax_reading(jctx, group))
    integ.step(1)
    assert ctx._programs == programs


@pytest.mark.parametrize("groups", ["none", "overlapping"])
def test_pair_sweep_counts_each_pair_once(groups):
    """Without interaction groups the sweep is every pair once; with
    groups whose sets overlap each other and themselves, each allowed pair
    once, as JAX's masked sum counts it; with exclusions, NoCutoff and an
    expression that is not symmetric in its particles only where no
    group repeats a pair (both orientations agree)."""
    params, pos = _waters(WATERS)
    n = len(params["masses"])
    spec = _specs(params, pos)[4]
    spec.update(method=0, switch_distance=-1.0,
                long_range_correction=False,
                energy="q1*q2/r + 0.001*(q1-q2)^2*r",
                parameters=["q"],
                terms=[((), [float(q)]) for q in params["charges"]],
                globals=[], derivatives=[])
    spec["interaction_groups"] = ([] if groups == "none" else [
        (list(range(0, 40)), list(range(20, 90))),
        (list(range(30, 60)), list(range(0, 50))),
        (list(range(100, 120)), list(range(100, 120))),
        (list(range(200, n)), list(range(0, 10)))])
    params["custom_forces"] = [spec]
    want = _jax_reading(_jax_context(params, pos), 5)
    _close(_reading(_context(params, pos), 5), want)


def test_long_range_coefficient_matches_jax():
    params, pos = _waters(WATERS)
    spec = _specs(params, pos)[4]
    ours = omm.system.custom_force(spec)
    from torch_port_helpers import jax_custom_force
    theirs = jax_custom_force(spec)
    for switched in (True, False):
        ours.setUseSwitchingFunction(switched)
        theirs.setUseSwitchingFunction(switched)
        want = theirs._long_range_coefficient()
        assert abs(ours._long_range_coefficient() - want) <= 1e-12 * abs(
            want)


def test_ten_steps_at_zero_kelvin_match_jax_reference(case):
    """Ten LangevinMiddle steps at 0 K and no friction under every force,
    from constrained positions and seeded velocities, in both packages."""
    params, pos, _, _ = case
    jctx = _jax_context(params, pos, mm.LangevinMiddleIntegrator(
        0.0, 0.0, 0.002))
    jctx.applyConstraints()
    vel = np.random.RandomState(3).randn(*pos.shape) * 0.3
    jctx.setVelocities(vel)
    jctx.applyVelocityConstraints()
    st = jctx.getState(getPositions=True, getVelocities=True)
    start = np.asarray(u.strip(st.getPositions(asNumpy=True)))
    vel = np.asarray(u.strip(st.getVelocities(asNumpy=True)))
    jctx.getIntegrator().step(10)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    integ = omm.LangevinMiddleIntegrator(0.0, 0.0, 0.002)
    ctx = _context(params, start, integrator=integ)
    ctx.setVelocities(vel)
    integ.step(10)
    got = ctx.getState(getPositions=True).getPositions()
    assert np.abs(want - start).max() > 1e-3
    assert np.abs(got - want).max() <= POS_TOL


def test_minimizer_objective_matches_jax(case):
    params, pos, jctx, ctx = case
    shaken = pos + np.random.RandomState(2).uniform(-0.01, 0.01, pos.shape)
    e_ref, f_ref = jctx._make_position_energy_fn()(shaken)
    e, f = ctx._make_position_energy_fn()(shaken)
    assert abs(e - e_ref) <= E_TOL * abs(e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL * np.abs(f_ref).max()


def test_float32_pairs_and_step_program_against_eager_loop(case):
    """The mixed-precision Context (float32 pairs, float64 terms) against
    float64 at the median relative force error bar, and its step program
    against the eager loop in bits."""
    params, pos, _, ctx64 = case
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(5)
    ctx = _context(params, pos, precision="mixed", integrator=integ)
    for g in range(1, 8):
        f32 = ctx.getState(getForces=True, groups={g}).getForces()
        f64 = ctx64.getState(getForces=True, groups={g}).getForces()
        assert median_relative_error(f32[np.abs(f64).sum(1) > 0],
                                     f64[np.abs(f64).sum(1) > 0]) <= 1e-5
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
    snap = ctx._snapshot()
    integ.step(6)
    a = ctx.getState(getPositions=True, getVelocities=True)
    ctx._restore(snap)
    ctx._step_eager(6)
    b = ctx.getState(getPositions=True, getVelocities=True)
    assert np.array_equal(a.getPositions(), b.getPositions())
    assert np.array_equal(a.getVelocities(), b.getVelocities())


def test_from_numpy_round_trip(case):
    params = case[0]
    again = omm.to_numpy(omm.from_numpy(params))
    assert len(again["custom_forces"]) == len(KINDS)
    for spec, back in zip(params["custom_forces"], again["custom_forces"]):
        for key, value in spec.items():
            got = back[key]
            if key == "terms":
                assert [tuple(a) for a, _ in got] == [tuple(a)
                                                      for a, _ in value]
                np.testing.assert_array_equal(
                    np.asarray([p for _, p in got], float),
                    np.asarray([p for _, p in value], float))
            elif key == "functions":
                assert [f[:2] for f in got] == [f[:2] for f in value]
            elif key in ("groups", "interaction_groups"):
                assert [(list(a), b if b is None else list(b))
                        for a, b in got] == [
                    (list(a), b if b is None else list(b))
                    for a, b in value]
            else:
                assert got == value, key


def test_derivative_of_an_offset_parameter_raises():
    """dE/dlambda where lambda also drives NonbondedForce offsets: the port
    serves it (the offsets' part from NonbondedModule.parameter_derivatives;
    tests/test_torch_offset_derivatives.py holds it to the JAX package),
    here against a central difference of float64 energies; an unknown
    parameter still raises."""
    params, pos = _waters(16)
    params["global_parameters"] = [("lambda", 1.0)]
    params["particle_offsets"] = [("lambda", 0, -0.8, 0.0, 0.0)]
    spec = _specs(params, pos)[1]
    spec["terms"] = [((0, 3), [0.3, 0.5])]
    spec["globals"] = [("lambda", 1.0)]
    spec["energy"] = "lambda*eps*(r-sig)^2"
    spec["functions"] = []
    spec["derivatives"] = ["lambda"]
    spec["group"] = 0
    params["custom_forces"] = [spec]
    ctx = _context(params, pos)
    ctx.setParameter("lambda", 0.7)
    got = ctx.getState(getParameterDerivatives=True)\
        .getEnergyParameterDerivatives()["lambda"]
    e = []
    for lam in (0.7 + 1e-5, 0.7 - 1e-5):
        ctx.setParameter("lambda", lam)
        e.append(ctx.getState(getEnergy=True).getPotentialEnergy())
    want = (e[0] - e[1]) / 2e-5
    assert abs(want) > 1.0
    assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError, match="unknown global parameter"):
        omm.CustomBondForce("r").addEnergyParameterDerivative("nope")


def test_step_body_reads_nothing_from_the_device(case):
    """The step body with every custom force (tabulated functions, the
    pair sweep, the point functions) on fake tensors, the build run as
    before a capture: no host read of tensor data, which a CUDA graph's
    capture forbids."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    params, pos, _, _ = case
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    ctx = _context(params, pos, precision="mixed", integrator=integ)
    integ.step(1)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)


def test_alchemical_box_builder():
    """models.alchemical_water_box at a small size: its forces, groups,
    parameters and derivative request, and dE/dlambda_sterics against a
    central difference of float64 energies."""
    from openmm_tpu_torch.models import alchemical_water_box
    from openmm_tpu_torch.models.builders import ALCHEMICAL_GROUPS
    system, pos = alchemical_water_box(216, 8)
    kinds = [type(f).__name__ for f in system.getForces()]
    assert kinds == ["NonbondedForce"] + list(ALCHEMICAL_GROUPS)
    nb, soft, lj, restraint, centroid = system.getForces()
    assert nb.getNumParticleParameterOffsets() == 24
    assert soft.getInteractionGroupParameters(0)[0] == list(range(24))
    assert lj.getNumBonds() == 8 * 7 // 2 and restraint.getNumParticles() == 8
    assert centroid.getNumGroups() == 2
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    for lam in (0.2, 0.5, 1.0):
        ctx.setParameter("lambda_sterics", lam)
        d = ctx.getState(getParameterDerivatives=True,
                         groups={1}).getEnergyParameterDerivatives()
        e = []
        for h in (1e-4, -1e-4):
            ctx.setParameter("lambda_sterics", lam + h)
            e.append(ctx.getState(getEnergy=True,
                                  groups={1}).getPotentialEnergy())
        want = (e[0] - e[1]) / 2e-4
        assert abs(d["lambda_sterics"] - want) <= 1e-6 * abs(want)


def test_chip_smoke_custom_phases_on_cpu():
    """chip_smoke.py's phase_alchemical and phase_while_draws rehearsed on
    a 216-water box (8 solute waters, 4 steps at each lambda, 2 replayed),
    and phase_custom_bilayer and phase_tables on the cropped bilayer: every
    gate holds on the CPU (no capture there)."""
    import math

    import chip_smoke
    from torch_port_helpers import cropped_bilayer, system_params
    cpu = torch.device("cpu")
    system, pos = tip3p_water_box(216)
    integ = omm.LangevinMiddleIntegrator(300.0, 50.0, 0.0005)
    integ.setRandomNumberSeed(1)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    integ.step(20)
    main = {"context": ctx}
    out = chip_smoke.phase_alchemical(cpu, main, solute=8, chunk=4,
                                      replay=2, iterations=3,
                                      t_range=(0.0, math.inf))
    assert [(r["lambda"], r["lambda_elec"]) for r in out["rows"]] == list(
        chip_smoke.ALCHEMICAL_LAMBDAS)
    assert out["minimized"][1] < out["minimized"][0]
    draws = chip_smoke.phase_while_draws(cpu, main, steps=4, replay=4)
    assert 0.0 < draws["mean"] < 1.0
    jsys, bpos, _ = cropped_bilayer()
    params = system_params(jsys)
    bsys = omm.from_numpy(params)
    for force in bsys.getForces():
        force.setForceGroup(chip_smoke.BILAYER_GROUPS[type(force).__name__])
    bctx = omm.Context(bsys, omm.VerletIntegrator(0.001), "CPU")
    bctx.setPositions(bpos)
    bctx.applyConstraints()
    bctx.setVelocitiesToTemperature(chip_smoke.BILAYER_TEMPERATURE,
                                    randomSeed=4)
    state = {"system": bsys, "context": bctx,
             "graph": {"wall_ms_per_step": 0.0}}
    twins = chip_smoke.phase_custom_bilayer(cpu, state, steps=2, replay=2,
                                            t_range=(0.0, math.inf))
    assert set(twins["errors"]) == set(chip_smoke.TWIN_GROUPS)
    # the bilayer's own forces keep their groups
    assert [f.getForceGroup() for f in bsys.getForces()] == [
        chip_smoke.BILAYER_GROUPS[type(f).__name__]
        for f in bsys.getForces()]
    last = bctx.getState(getPositions=True)
    tables = chip_smoke.phase_tables(cpu, last.getPositions(),
                                     last.getPeriodicBoxVectors())
    assert tables["errors"] == (0.0, 0.0)
