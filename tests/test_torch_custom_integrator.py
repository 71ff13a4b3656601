"""CustomIntegrator, the MTS and aMD integrators built on it, and the
step program's IF and WHILE nodes, in openmm_tpu_torch against openmm_tpu.

The trajectory cases run the droplet of tests/test_torch_integrators.py
(SETTLE waters, the reaction field over every pair, four massless anchors
on bonds) from the same positions and velocities on both sides, float64,
25 steps: a velocity Verlet and the leapfrog Verlet of
tests/test_custom_integrator.py written as programs, MTSIntegrator and
frictionless MTSLangevinIntegrator with the NonbondedForce in group 0 and
the anchor bonds in group 1 ([(0, 1), (1, 3)]), and the three aMD
integrators with thresholds above the start energies (the boost active)
follow the JAX "Reference" Context to 1e-9 nm, the anchors never move, and
the reported kinetic energy agrees to 1e-9 relative. The blocks are those
of tests/test_custom_integrator.py:90-128 and an if inside a while. On a
216-water PME box whose candidate state starts too small, the step
program gives the eager loop's bits (positions, velocities, the clock, the
integrator's variables and force cache) across an undone chunk."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                          FakeTensorMode)

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import ANCHORS, anchored_droplet, jax_system
from openmm_tpu_torch.unit import plain

STEPS = 25


@pytest.fixture(scope="module")
def droplet():
    return anchored_droplet()


def velocity_verlet(mod, dt=0.001):
    integ = mod.CustomIntegrator(dt)
    integ.addPerDofVariable("x1", 0)
    integ.addUpdateContextState()
    integ.addComputePerDof("v", "v+0.5*dt*f/m")
    integ.addComputePerDof("x", "x+dt*v")
    integ.addComputePerDof("x1", "x")
    integ.addConstrainPositions()
    integ.addComputePerDof("v", "v+0.5*dt*f/m+(x-x1)/dt")
    integ.addConstrainVelocities()
    return integ


def leapfrog(mod, dt=0.001):
    integ = mod.CustomIntegrator(dt)
    integ.addPerDofVariable("x1", 0)
    integ.addUpdateContextState()
    integ.addComputePerDof("v", "v+dt*f/m")
    integ.addComputePerDof("x1", "x")
    integ.addComputePerDof("x", "x+dt*v")
    integ.addConstrainPositions()
    integ.addComputePerDof("v", "(x-x1)/dt")
    return integ


def _start_energies(params, pos):
    """(total potential energy, group 0's, group 1's) at the start."""
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    return tuple(plain(ctx.getState(getEnergy=True,
                                    groups=g).getPotentialEnergy())
                 for g in (-1, {0}, {1}))


def _amd(kind, params, pos):
    """Constructors (mod -> integrator) of the aMD integrators with E 20 %
    of |V| above the start energy V and alpha 20 % of |V|."""
    total, g0, g1 = _start_energies(params, pos)

    def above(v):
        return v + 0.2 * abs(v) + 1.0, 0.2 * abs(v) + 1.0

    et, at = above(total)
    eg, ag = above(g1)
    if kind == "amd":
        return lambda mod: mod.AMDIntegrator(0.001, at, et)
    if kind == "amd_group":
        e0, a0 = above(g0)
        return lambda mod: mod.AMDForceGroupIntegrator(0.001, 0, a0, e0)
    return lambda mod: mod.DualAMDIntegrator(0.001, 1, at, et, ag, eg)


def _mts(mod):
    return mod.MTSIntegrator(0.002, [(0, 1), (1, 3)])


def _mts_langevin(mod):
    return mod.MTSLangevinIntegrator(300.0, 0.0, 0.002, [(1, 3), (0, 1)])


CASES = {
    "velocity_verlet": lambda p, x: velocity_verlet,
    "leapfrog": lambda p, x: leapfrog,
    "mts": lambda p, x: _mts,
    # frictionless, its innermost step is MTSIntegrator's velocity Verlet
    # from the last constrained configuration: the JAX MTSIntegrator's
    # (the JAX MTSLangevinIntegrator's constraints solve from the
    # unconstrained midpoint of its two drifts)
    "mts_langevin_frictionless": lambda p, x: (
        lambda mod: _mts_langevin(mod) if mod is omm else _mts(mod)),
    "amd": lambda p, x: _amd("amd", p, x),
    "amd_group": lambda p, x: _amd("amd_group", p, x),
    "dual_amd": lambda p, x: _amd("dual_amd", p, x),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_trajectory_matches_jax_reference(droplet, name):
    params, pos, vel = droplet
    params = dict(params, force_groups={"bond": 1})
    make = CASES[name](params, pos)
    jint = make(mm)
    jctx = mm.Context(jax_system(params), jint,
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    jint.step(STEPS)
    jst = jctx.getState(getPositions=True, getEnergy=True)
    want = np.asarray(jst.getPositions(asNumpy=True)._value)
    integ = make(omm)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    integ.step(STEPS)
    st = ctx.getState(getPositions=True, getEnergy=True)
    got = plain(st.getPositions(asNumpy=True))
    assert np.abs(want - start).max() > 1e-3       # the atoms did move
    assert np.abs(got - want).max() < 1e-9
    assert np.array_equal(got[-ANCHORS:], start[-ANCHORS:])
    ke = jst.getKineticEnergy()._value
    assert abs(plain(st.getKineticEnergy()) - ke) < 1e-9 * abs(ke)
    if name.startswith("amd") or name == "dual_amd":
        # the boost was active: the effective energy exceeds the plain one
        energy = plain(st.getPotentialEnergy())
        if name == "amd_group":
            boosted = plain(integ.getEffectiveEnergy(
                energy, plain(ctx.getState(getEnergy=True, groups={0})
                .getPotentialEnergy())))
        elif name == "dual_amd":
            boosted = plain(integ.getEffectiveEnergy(
                energy, plain(ctx.getState(getEnergy=True, groups={1})
                .getPotentialEnergy())))
        else:
            boosted = plain(integ.getEffectiveEnergy(energy))
        assert boosted > energy


SWITCHED = {"mts": _mts, "velocity_verlet": velocity_verlet}


@pytest.mark.parametrize("name", sorted(SWITCHED))
def test_compound_switch_matches_jax_reference(droplet, name):
    """A CompoundIntegrator of a program and Verlet, switched twice,
    follows the JAX "Reference" Context: the forces the program cached
    before a switch are not read after Verlet moved the positions."""
    params, pos, vel = droplet
    params = dict(params, force_groups={"bond": 1})

    def make(mod):
        integ = mod.CompoundIntegrator()
        integ.addIntegrator(SWITCHED[name](mod))
        integ.addIntegrator(mod.VerletIntegrator(0.001))
        return integ

    jint, integ = make(mm), make(omm)
    jctx = mm.Context(jax_system(params), jint,
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    for member, steps in ((0, 8), (1, 8), (0, 9)):
        for i in (jint, integ):
            i.setCurrentIntegrator(member)
            i.step(steps)
    # the JAX Context's kinetic energy of a compound with a custom member
    # raises (ROADMAP, notes on the reference): take it from its velocities
    jst = jctx.getState(getPositions=True, getVelocities=True)
    want = np.asarray(jst.getPositions(asNumpy=True)._value)
    jvel = np.asarray(jst.getVelocities(asNumpy=True)._value)
    st = ctx.getState(getPositions=True, getVelocities=True, getEnergy=True)
    assert np.abs(want - start).max() > 1e-3
    assert np.abs(plain(st.getPositions(asNumpy=True)) - want).max() < 1e-9
    assert np.abs(plain(st.getVelocities(asNumpy=True)) - jvel).max() < 1e-9
    ke = 0.5 * np.sum(params["masses"][:, None] * jvel * jvel)
    assert abs(plain(st.getKineticEnergy()) - ke) < 1e-9 * abs(ke)


def _pairs(mod):
    """12 pairs of masses 16 and 1 on bonds of 0.1 nm (group 1) with a
    softer bond between neighbouring pairs (group 0): no constraints."""
    system = mod.System()
    stiff, soft = mod.HarmonicBondForce(), mod.HarmonicBondForce()
    stiff.setForceGroup(1)
    for i in range(12):
        a, b = system.addParticle(16.0), system.addParticle(1.0)
        stiff.addBond(a, b, 0.1, 20000.0)
        if i:
            soft.addBond(a - 2, a, 0.5, 500.0)
    system.addForce(stiff)
    system.addForce(soft)
    pos = np.zeros((24, 3))
    pos[0::2, 0] = 0.5 * np.arange(12)
    pos[1::2, 0] = 0.5 * np.arange(12) + 0.1
    rng = np.random.RandomState(6)
    masses = np.tile([16.0, 1.0], 12)
    vel = rng.randn(24, 3) * np.sqrt(omm.BOLTZ * 300.0 / masses)[:, None]
    return system, pos, vel


def test_mts_langevin_without_constraints_matches_jax_reference():
    """Without constraints the constraint reference plays no part: the
    port's frictionless MTSLangevinIntegrator follows the JAX one."""
    jsys, pos, vel = _pairs(mm)
    jint = _mts_langevin(mm)
    jctx = mm.Context(jsys, jint, mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.setVelocities(vel)
    jint.step(STEPS)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)
    integ = _mts_langevin(omm)
    ctx = omm.Context(_pairs(omm)[0], integ, "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    integ.step(STEPS)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(want - pos).max() > 1e-3
    assert np.abs(got - want).max() < 1e-9


def _mean_temperature(integ, params, pos):
    integ.setRandomNumberSeed(5)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    integ.step(200)
    temps = []
    for _ in range(60):
        integ.step(10)
        temps.append(ctx.temperature())
    return np.mean(temps)


def test_baoab_thermostats_as_langevin_middle_under_constraints(droplet):
    """A program that drifts twice before it constrains (BAOAB written as
    MTSLangevinIntegrator with one group) holds the rigid waters at
    LangevinMiddle's temperature (within 10 %): its constraints solve from
    the last constrained configuration. (From the midpoint of its drifts,
    the JAX package's reference, it runs ~20 % cold.)"""
    params, pos, _ = droplet
    middle = _mean_temperature(omm.LangevinMiddleIntegrator(300.0, 5.0,
                                                            0.002),
                               params, pos)
    baoab = _mean_temperature(omm.MTSLangevinIntegrator(300.0, 5.0, 0.002,
                                                        [(0, 1)]),
                              params, pos)
    assert abs(baoab - middle) < 0.1 * middle, (baoab, middle)


def _one_particle():
    system = omm.System()
    system.addParticle(1.0)
    return system


def _run(integ, steps, system=None):
    ctx = omm.Context(system or _one_particle(), integ, "CPU")
    ctx.setPositions(np.zeros((ctx._n, 3)))
    integ.step(steps)
    return ctx


def test_if_block():
    integ = omm.CustomIntegrator(0.001)
    integ.addGlobalVariable("a", 0.0)
    integ.addGlobalVariable("b", 0.0)
    integ.beginIfBlock("a < 5")
    integ.addComputeGlobal("b", "b+1")
    integ.endBlock()
    integ.addComputeGlobal("a", "a+1")
    _run(integ, 10)
    assert integ.getGlobalVariableByName("a") == 10.0
    assert integ.getGlobalVariableByName("b") == 5.0


def test_while_block():
    integ = omm.CustomIntegrator(0.001)
    integ.addGlobalVariable("total", 0.0)
    integ.addGlobalVariable("i", 0.0)
    integ.addComputeGlobal("i", "0")
    integ.beginWhileBlock("i < 4")
    integ.addComputeGlobal("total", "total+i")
    integ.addComputeGlobal("i", "i+1")
    integ.endBlock()
    _run(integ, 2)
    # each step adds 0 + 1 + 2 + 3
    assert integ.getGlobalVariableByName("total") == 12.0


def test_if_nested_in_while():
    integ = omm.CustomIntegrator(0.001)
    for name in ("i", "odd", "even"):
        integ.addGlobalVariable(name, 0.0)
    integ.addComputeGlobal("i", "0")
    integ.beginWhileBlock("i < 7")
    integ.addComputeGlobal("i", "i+1")
    integ.beginIfBlock("i/2 = floor(i/2)")
    integ.addComputeGlobal("even", "even+1")
    integ.endBlock()
    integ.beginIfBlock("i/2 != floor(i/2)")
    integ.addComputeGlobal("odd", "odd+1")
    integ.endBlock()
    integ.endBlock()
    _run(integ, 3)
    assert integ.getGlobalVariableByName("odd") == 12.0     # 1 3 5 7
    assert integ.getGlobalVariableByName("even") == 9.0     # 2 4 6


def test_compute_sum_is_the_kinetic_energy(droplet):
    params, pos, vel = droplet
    integ = velocity_verlet(omm)
    integ.addGlobalVariable("ke", 0.0)
    integ.addComputeSum("ke", "m*v*v/2")
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    integ.step(5)
    ke = integ.getGlobalVariableByName("ke")
    assert ke == pytest.approx(ctx.kinetic_energy(), rel=1e-12)
    assert ke == pytest.approx(plain(ctx.getState(getEnergy=True)
                               .getKineticEnergy()), rel=1e-12)


def test_variables_set_and_read_back(droplet):
    params, pos, vel = droplet
    n = len(params["masses"])
    integ = omm.CustomIntegrator(0.001)
    integ.addGlobalVariable("g", 1.5)
    integ.addGlobalVariable("h", 0.0)
    integ.addPerDofVariable("p", 2.0)
    integ.addPerDofVariable("q", 0.0)
    custom = np.arange(3 * n, dtype=np.float64).reshape(n, 3)
    integ.setPerDofVariableByName("q", custom)
    assert np.array_equal(integ.getPerDofVariableByName("q"), custom)
    integ.addComputeGlobal("h", "g*2")
    integ.addComputePerDof("p", "p + q + x")
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    assert integ.getGlobalVariableByName("g") == 1.5
    assert np.all(integ.getPerDofVariableByName("p") == 2.0)
    integ.setGlobalVariableByName("g", 4.0)
    integ.step(2)
    assert integ.getGlobalVariable(1) == 8.0
    want = np.full((n, 3), 2.0)
    for _ in range(2):
        want = want + custom + pos
    np.testing.assert_array_equal(integ.getPerDofVariable(0), want)
    integ.setPerDofVariableByName("p", np.ones((n, 3)))
    assert np.all(integ.getPerDofVariableByName("p") == 1.0)
    assert (integ.getNumGlobalVariables(), integ.getNumPerDofVariables(),
            integ.getNumComputations()) == (2, 2, 2)
    with pytest.raises(ValueError, match="unknown"):
        integ.getGlobalVariableByName("nope")


def test_compute_global_writes_a_context_parameter(droplet):
    params, pos, vel = droplet
    params = dict(params, andersen_temperature=300.0, andersen_frequency=0.0)
    integ = velocity_verlet(omm)
    integ.addComputeGlobal("AndersenTemperature", "AndersenTemperature+1")
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx.setPositions(pos)
    integ.step(5)
    assert ctx.getParameter("AndersenTemperature") == 305.0


def test_unsupported_programs_raise(droplet):
    params, pos, _ = droplet
    bad = omm.CustomIntegrator(0.001)
    bad.addComputePerDof("v", "v + frobnicate(x)")
    with pytest.raises(NotImplementedError, match="frobnicate"):
        omm.Context(omm.from_numpy(params), bad, "CPU")
    drawing = omm.CustomIntegrator(0.001)
    drawing.addGlobalVariable("i", 0.0)
    drawing.beginWhileBlock("i < 2")
    drawing.addComputePerDof("v", "v + gaussian")
    drawing.addComputeGlobal("i", "i+1")
    drawing.endBlock()
    # a draw inside a while block is in the port now
    # (test_torch_lifted_refusals.py): the Context builds
    omm.Context(omm.from_numpy(params), drawing, "CPU")
    unknown = omm.CustomIntegrator(0.001)
    unknown.addComputePerDof("v", "v + w")
    with pytest.raises(ValueError, match="unknown variable"):
        omm.Context(omm.from_numpy(params), unknown, "CPU")


def blocks_program(dt=0.001):
    """A velocity Verlet with a step counter, a kinetic-energy sum every
    4th step, a loop of three passes with an if inside, and random numbers
    drawn at the top and inside the if."""
    integ = velocity_verlet(omm, dt)
    for name in ("n", "k", "ke", "j", "loops", "noise"):
        integ.addGlobalVariable(name, 0.0)
    integ.addPerDofVariable("kick", 0.0)
    integ.addComputeGlobal("n", "n+1")
    integ.addComputeGlobal("k", "k+1")
    integ.addComputePerDof("kick", "1e-6*gaussian")
    integ.addComputePerDof("v", "v+kick")
    integ.beginIfBlock("k >= 4")
    integ.addComputeSum("ke", "m*v*v/2")
    integ.addComputeGlobal("k", "0")
    integ.addComputeGlobal("noise", "noise + uniform")
    integ.addComputePerDof("v", "v+0.5*dt*f/m-0.5*dt*f/m")
    integ.endBlock()
    integ.addComputeGlobal("j", "0")
    integ.beginWhileBlock("j < 3")
    integ.addComputeGlobal("j", "j+1")
    integ.beginIfBlock("energy < 1e9")
    integ.addComputeGlobal("loops", "loops+1")
    integ.endBlock()
    integ.endBlock()
    return integ


PROGRAMS = {
    "blocks": blocks_program,
    "mts": lambda: omm.MTSLangevinIntegrator(300.0, 5.0, 0.002,
                                             [(0, 1), (1, 2)]),
    "amd": lambda: omm.AMDIntegrator(0.001, 1000.0, 1e6),
}


def _box_context(make, eager):
    system, positions = tip3p_water_box(216)
    params = dict(omm.to_numpy(system), force_groups={"nonbonded": 1})
    integ = make()
    integ.setRandomNumberSeed(17)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx._nonbonded.capacity_scale = 0.3
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
    (ctx._step_eager if eager else integ.step)(12)
    return ctx


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_eager_loop_bitwise(name):
    """Both start with a candidate state too small for the box: the first
    chunk overflows and is undone (the integrator's state with it) and
    run again at a grown capacity."""
    graph, eager = (_box_context(PROGRAMS[name], e) for e in (False, True))
    assert graph._programs and graph.escalation_count >= 1
    assert graph.escalation_count == eager.escalation_count
    assert graph.rebuild_count == eager.rebuild_count
    for key in ("positions", "velocities"):
        assert torch.equal(graph._state[key], eager._state[key])
    for a, b in zip(graph._step_tensors(), eager._step_tensors()):
        assert torch.equal(a, b)
    assert plain(graph.getTime()) == plain(eager.getTime()) > 0
    integ = graph.getIntegrator()
    if name == "blocks":
        assert integ.getGlobalVariableByName("n") == 12.0
        assert integ.getGlobalVariableByName("loops") == 36.0
        assert integ.getGlobalVariableByName("noise") > 0.0


def test_step_body_reads_nothing_from_the_device():
    """The custom program's step on fake tensors, every block run (the
    warm-up before a capture): no host read; the CPU's own gates read
    their predicates."""
    ctx = _box_context(blocks_program, False)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)
    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(DataDependentOutputException):
            program.body(program.gate_host)


def test_forces_are_evaluated_once_a_position():
    """MTS evaluates its slow group once a step: at the step's end, which
    the next step's start reuses; the fast group once a substep."""
    params, pos, vel = anchored_droplet()
    params = dict(params, force_groups={"bond": 1})
    integ = omm.MTSIntegrator(0.002, [(0, 1), (1, 2)])
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    masks = []
    evaluate = ctx._evaluate

    def counting(p, box, tiles, groups=-1):
        masks.append(groups)
        return evaluate(p, box, tiles, groups)

    ctx._evaluate = counting
    integ.step(4)
    assert masks.count(1) == 4 + 1          # the first step's start too
    assert masks.count(2) == 4 * 2 + 1
