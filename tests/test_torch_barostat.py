"""The Monte Carlo barostats (openmm_tpu_torch/forces/barostats.py) and the
Context pieces they stand on, against the JAX package.

The oracle is the JAX package on its "Reference" platform (float64). No
JAX test runs a barostat under a Context, so the JAX attempt is called
directly: the barostat's update hook, jitted, on the JAX Context's state
at frequency 1 (every call attempts). Its uniforms are replayed from its
key as openmm_tpu/forces/barostats.py draws them (jax.random.split, then
randint for the slot and uniform for the volume change and the
Metropolis test) and handed to the port's attempt, which takes its
uniforms as an argument: the slot's draw u0 = (slot + 0.5) / choices
picks the same slot. The port's attempt runs on a "double" Context with
the same System (carried across by system_params), on a 216-water TIP3P
box (648 atoms, PME at 0.9 nm). Both evaluate the same formulas in
float64, and the scaled positions do not depend on the energies, so box
and positions must agree to 1e-10 nm, acceptance and statistics exactly.

Also: the molecules against JAX getMolecules (the water box and the
cropped POPC bilayer); scale_molecules against the JAX _scale_molecules
(1e-12 nm); twelve attempts in a row, whose tenth retunes the width; w of
the float32 path within 0.05 kT of the float64 oracle's on the cropped
bilayer (the energies of the JAX "Reference" platform); the step
program's body against the eager loop bit for bit with a barostat and a
CMMotionRemover; an overflowing chunk that restores the box and the
statistics before it runs again; the body on fake tensors (no host read
in an attempt); setPeriodicBoxVectors, setState, setParameter and
getState(enforcePeriodicBox=True) against the JAX Context; and
chip_smoke.py's NPT phases at a small size.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import openmm_tpu as mm
from openmm_tpu.forces import barostats as jb
from openmm_tpu.models import tip3p_water_box as jax_water_box

import openmm_tpu_torch as omm
from openmm_tpu_torch.forces.barostats import (PRESSURE_UNIT_FACTOR,
                                               scale_molecules)
from torch_port_helpers import (barostat_params, cropped_bilayer,
                                system_params)
from openmm_tpu_torch.unit import plain

N_WATERS = 216

# kind -> (JAX barostat, the slots u0 picks among, or 0: no slot draw)
CASES = {
    "iso": (lambda: jb.MonteCarloBarostat(1.0, 300.0, 1), 0),
    "aniso_all": (lambda: jb.MonteCarloAnisotropicBarostat(
        (1.0, 50.0, -20.0), 300.0, True, True, True, 1), 3),
    "aniso_one": (lambda: jb.MonteCarloAnisotropicBarostat(
        (1.0, 1.0, 1.0), 300.0, False, True, False, 1), 1),
    "membrane_zfree": (lambda: jb.MonteCarloMembraneBarostat(
        1.0, 20.0, 300.0, jb.MonteCarloMembraneBarostat.XYIsotropic,
        jb.MonteCarloMembraneBarostat.ZFree, 1), 2),
    "membrane_zfixed": (lambda: jb.MonteCarloMembraneBarostat(
        1.0, -40.0, 300.0, jb.MonteCarloMembraneBarostat.XYIsotropic,
        jb.MonteCarloMembraneBarostat.ZFixed, 1), 2),
    "membrane_constant_volume": (lambda: jb.MonteCarloMembraneBarostat(
        1.0, 30.0, 300.0, jb.MonteCarloMembraneBarostat.XYAnisotropic,
        jb.MonteCarloMembraneBarostat.ConstantVolume, 1), 2),
}
# the JAX key of each case (the integrator's seed), and whether its first
# attempt is accepted with that key: both outcomes occur among the cases
SEEDS = {"iso": (1, True), "aniso_all": (3, False), "aniso_one": (4, True),
         "membrane_zfree": (2, True), "membrane_zfixed": (3, False),
         "membrane_constant_volume": (3, True)}


@pytest.fixture(scope="module")
def water():
    """(JAX System, positions, from_numpy dict) of the water box."""
    jsys, jpos = jax_water_box(n_waters=N_WATERS)
    return (jsys, np.array([[p.x, p.y, p.z] for p in jpos]),
            system_params(jsys))


@pytest.fixture(scope="module")
def bilayer():
    """(JAX System, positions, from_numpy dict, JAX "Reference" Context)
    of the cropped bilayer."""
    jsys, pos, _ = cropped_bilayer()
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    return jsys, pos, system_params(jsys), jctx


def _jax_barostat_context(jsys, pos, barostat, seed):
    """A JAX "Reference" Context of jsys with `barostat` added, and its
    barostat hook (jitted) and module index."""
    jsys.addForce(barostat)
    jint = mm.LangevinMiddleIntegrator(300.0, 1.0, 0.001)
    jint.setRandomNumberSeed(seed)
    jctx = mm.Context(jsys, jint, mm.Platform.getPlatformByName("Reference"))
    jsys.removeForce(jsys.getNumForces() - 1)
    jctx.setPositions(pos)
    (hook, i), = [(h, i) for h, i in jctx._deps.update_hooks
                  if isinstance(jctx._module_force[i], jb._BarostatBase)]
    return jctx, jax.jit(hook), str(i)


def _jax_uniforms(state, choices):
    """The uniforms of the JAX attempt from its state's key, as the port's
    attempt takes them."""
    dtype = state["positions"].dtype
    if not choices:
        _, k1, k2 = jax.random.split(state["key"], 3)
        return [float(jax.random.uniform(k, dtype=dtype)) for k in (k1, k2)]
    _, k0, k1, k2 = jax.random.split(state["key"], 4)
    pick = int(jax.random.randint(k0, (), 0, choices))
    return [(pick + 0.5) / choices] + [
        float(jax.random.uniform(k, dtype=dtype)) for k in (k1, k2)]


def _port_context(params, pos, precision="double", barostat=None):
    """A "CPU" Context of the from_numpy dict `params`, with the JAX
    `barostat` carried across."""
    if barostat is not None:
        params = dict(params, **barostat_params(barostat))
    ctx = omm.Context(omm.from_numpy(params),
                      omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002),
                      "CPU", {"Precision": precision})
    ctx.setPositions(pos)
    return ctx


def _port_attempt(ctx, u):
    baro = ctx._barostats[0]
    out = baro.attempt(ctx._state["positions"], ctx._box,
                       torch.tensor(u, dtype=torch.float64), ctx._gp,
                       ctx._trial_energy)
    return out


def _stats(aux):
    return [np.atleast_1d(np.asarray(aux[k])).tolist()
            for k in ("volumeScale", "numAttempted", "numAccepted")]


@pytest.mark.parametrize("system", ["water", "bilayer"])
def test_molecules_match_jax(water, bilayer, system):
    if system == "water":
        jsys, pos, params = water
        jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                          mm.Platform.getPlatformByName("Reference"))
    else:
        _, pos, params, jctx = bilayer
    ctx = _port_context(params, pos)
    assert ctx.getMolecules() == jctx.getMolecules()
    if system == "bilayer":
        sizes = sorted({len(m) for m in ctx.getMolecules()})
        assert sizes == [3, 134]        # waters and lipids


def test_scale_molecules_matches_jax(bilayer):
    _, pos, params, jctx = bilayer
    ctx = _port_context(params, pos, barostat=jb.MonteCarloBarostat(
        1.0, 300.0, 25))
    scale = np.array([1.013, 0.991, 1.027])
    b = ctx._barostats[0]
    got = scale_molecules(torch.as_tensor(pos), b.molecules, b.masses,
                          b.molecule_mass, torch.as_tensor(scale))
    want = jb._scale_molecules(
        jax.numpy.asarray(pos), jctx._molecule_id_dev, jctx._n_molecules,
        jctx._masses_dev, jax.numpy.asarray(scale))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-12
    assert np.abs(got.numpy() - pos).max() > 1e-2      # it moved them


@pytest.mark.parametrize("case", sorted(CASES))
def test_attempt_matches_jax(water, case):
    make, choices = CASES[case]
    seed, accepted = SEEDS[case]
    jsys, pos, params = water
    barostat = make()
    jctx, hook, i = _jax_barostat_context(jsys, pos, barostat, seed)
    u = _jax_uniforms(jctx._state, choices)
    new = hook(jctx._state, jctx._params)
    ctx = _port_context(params, pos, barostat=barostat)
    out = _port_attempt(ctx, u)
    assert bool(out["accept"]) == accepted
    assert np.abs(out["box"].numpy() - np.asarray(new["box"])).max() < 1e-10
    assert np.abs(out["positions"].numpy()
                  - np.asarray(new["positions"])).max() < 1e-10
    got = [out[k].tolist() for k in ("volume_scale", "num_attempted",
                                     "num_accepted")]
    assert got == _stats(new["faux"][i])


def test_twelve_attempts_retune_like_jax(water):
    """Twelve isotropic attempts in a row from the same state: the tenth
    retunes the width (acceptance outside 25-75 %), as the JAX attempts
    do; the positions follow the JAX ones attempt by attempt."""
    jsys, pos, params = water
    barostat = jb.MonteCarloBarostat(1.0, 300.0, 1)
    jctx, hook, i = _jax_barostat_context(jsys, pos, barostat, 2)
    ctx = _port_context(params, pos, barostat=barostat)
    state = jctx._state
    scales = []
    for _ in range(12):
        u = _jax_uniforms(state, 0)
        state = hook(state, jctx._params)
        out = _port_attempt(ctx, u)
        ctx._box.copy_(out["box"])
        ctx._barostats[0].store(out)
        ctx._set_position_tensor(out["positions"])
        assert np.abs(out["positions"].numpy()
                      - np.asarray(state["positions"])).max() < 1e-10
        assert [out[k].tolist() for k in (
            "volume_scale", "num_attempted", "num_accepted")] \
            == _stats(state["faux"][i])
        scales.append(float(out["volume_scale"][0]))
    # the tenth retuned: 9 of 10 accepted, so the width grew by 1.1
    assert scales[9] == pytest.approx(1.1 * scales[8], rel=1e-15)


# the uniforms of a membrane attempt: an xy move that grows the area, a
# z move that shrinks the box
W_MOVES = {"xy": [0.25, 0.9, 0.5], "z": [0.75, 0.2, 0.5]}


@pytest.mark.parametrize("move", sorted(W_MOVES))
def test_float32_w_within_a_twentieth_of_kt_of_float64(bilayer, move):
    """w = e1 - e0 + P dV - gamma dA - N kT ln(V'/V) of one membrane
    attempt on the cropped bilayer, from the float32 ("mixed") path,
    against the same w from the JAX "Reference" platform's float64
    energies at the same two configurations. The float32 path sums the
    reciprocal energy in float32."""
    _, pos, params, jctx = bilayer
    barostat = jb.MonteCarloMembraneBarostat(
        1.0, 15.0, 303.15, 0, jb.MonteCarloMembraneBarostat.ZFree, 1)
    u = W_MOVES[move]
    outs = {}
    for precision in ("mixed", "double"):
        ctx = _port_context(params, pos, precision, barostat)
        outs[precision] = _port_attempt(ctx, u)
    box = ctx._box.numpy()
    b = ctx._barostats[0]
    trial_box = outs["double"]["trial_box"].numpy()
    trial = scale_molecules(torch.as_tensor(pos), b.molecules, b.masses,
                            b.molecule_mass,
                            torch.as_tensor(np.diag(trial_box)
                                            / np.diag(box)))
    energy = jax.jit(jctx._deps.energy_fn)
    e0 = float(energy(jax.numpy.asarray(pos), jax.numpy.asarray(box),
                      jctx._params, jctx._state["gp"]))
    e1 = float(energy(jax.numpy.asarray(trial.numpy()),
                      jax.numpy.asarray(trial_box), jctx._params,
                      jctx._state["gp"]))
    vol, new_vol = np.prod(np.diag(box)), np.prod(np.diag(trial_box))
    kt = omm.BOLTZ * 303.15
    w = (e1 - e0 + PRESSURE_UNIT_FACTOR * (new_vol - vol)
         - 15.0 * PRESSURE_UNIT_FACTOR
         * (trial_box[0, 0] * trial_box[1, 1] - box[0, 0] * box[1, 1])
         - b.n_molecules * kt * np.log(new_vol / vol))
    assert abs(float(outs["double"]["w"]) - w) < 1e-6 * kt
    assert abs(float(outs["mixed"]["w"]) - w) < 0.05 * kt
    assert abs(e1 - e0) > kt                  # the move does change E


def _npt_context(params, frequency, scale=1.0):
    """A "CPU" (mixed) Context of the water box under an isotropic
    barostat of `frequency` and a CMMotionRemover of frequency 2, at 300
    K, its capacity scaled by `scale`."""
    jsys, jpos = jax_water_box(n_waters=N_WATERS)
    params = dict(params, barostat_kind="iso", barostat_pressure=1.0,
                  barostat_temperature=300.0, barostat_frequency=frequency,
                  cmm_frequency=2)
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(21)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx._nonbonded.capacity_scale = scale
    ctx.setPositions(np.array([[p.x, p.y, p.z] for p in jpos]))
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=6)
    return ctx, integ


def _npt_state(ctx):
    s = ctx._state
    return ([s["positions"], s["velocities"], ctx._box.clone()]
            + [t.clone() for t in ctx._barostats[0].statistics()],
            [s["step"], ctx.rebuild_count, ctx.escalation_count])


def test_program_matches_eager_loop_with_a_barostat(water):
    """9 steps with an attempt every 3 (steps 2, 5, 8) and the remover
    every 2: the step program's body and the eager loop give the same
    bits, box, statistics and rebuilds; a move changed the box. (The
    bilayer's membrane barostat runs the same way in
    test_chip_smoke_npt_phases_on_cpu.)"""
    runs = []
    for eager in (False, True):
        ctx, integ = _npt_context(water[2], 3)
        box0 = ctx._box.clone()
        (ctx._step_eager if eager else integ.step)(9)
        runs.append(_npt_state(ctx))
    (prog, prog_counts), (eager, eager_counts) = runs
    for got, want in zip(prog, eager):
        assert torch.equal(got, want)
    assert prog_counts == eager_counts
    assert int(prog[4].sum()) == 3                  # three attempts
    assert not torch.equal(prog[2], box0)           # and a move accepted


@pytest.mark.parametrize("frequency", [1, 2, 3, 25])
def test_attempts_in_counts_the_firing_steps(water, frequency):
    """attempts_in(first, steps), which the step program adds the
    attempts' launches by, against a count of the steps s in first, ...,
    first + steps - 1 with s % frequency == frequency - 1 (the steps
    completed before each), on a grid of windows that start and end on
    and off the firing steps (frequency 25 with 24 steps among them)."""
    baro = _npt_context(water[2], frequency)[0]._barostats[0]
    for first in range(0, 2 * frequency + 3):
        for steps in range(0, 2 * frequency + 3):
            want = sum(s % frequency == frequency - 1
                       for s in range(first, first + steps))
            assert baro.attempts_in(first, steps) == want, (first, steps)
            assert want == sum(baro.fires_at(s)
                               for s in range(first, first + steps))


def test_overflow_restores_box_and_statistics(water):
    """From a capacity too small for the box, the first chunk overflows:
    it is undone (box and statistics too) and runs again at a grown
    capacity, in the program as in the eager loop; with an attempt every
    step, six steps count six attempts, not the twelve of a chunk kept."""
    runs = []
    for eager in (False, True):
        ctx, integ = _npt_context(water[2], 1, scale=0.3)
        (ctx._step_eager if eager else integ.step)(6)
        runs.append(_npt_state(ctx))
        assert ctx.escalation_count >= 1
        assert int(ctx._barostats[0].num_attempted.sum()) == 6
    (prog, prog_counts), (eager, eager_counts) = runs
    for got, want in zip(prog, eager):
        assert torch.equal(got, want)
    assert prog_counts == eager_counts


def test_attempt_body_reads_nothing_from_the_device(water):
    """The step body with a barostat on fake tensors, the attempt and the
    build run (as the warm-up before a capture runs them): no host read."""
    ctx, integ = _npt_context(water[2], 3)
    integ.step(1)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)


def test_set_box_matches_jax_reference(water):
    """setPeriodicBoxVectors then getState: energy and forces of the
    float64 path against a JAX "Reference" Context given the same box
    (PME's alpha and grid stay those of the default box in both)."""
    jsys, pos, params = water
    box = np.diag(np.diag(jsys._box_array()) * [1.012, 0.995, 1.021])
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPeriodicBoxVectors(*box)
    jctx.setPositions(pos)
    jst = jctx.getState(getEnergy=True, getForces=True)
    e_ref = jst.getPotentialEnergy()._value
    f_ref = np.asarray(jst.getForces(asNumpy=True)._value)
    ctx = _port_context(params, pos)
    e_old = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    ctx.setPeriodicBoxVectors(*box)
    st = ctx.getState(getEnergy=True, getForces=True)
    assert np.array_equal(plain(st.getPeriodicBoxVectors(asNumpy=True)), box)
    assert abs(plain(st.getPotentialEnergy()) - e_ref) < 1e-10 * abs(e_ref)
    f = plain(st.getForces(asNumpy=True))
    assert np.abs(f - f_ref).max() < 1e-10 * np.abs(f_ref).max()
    assert abs(e_old - e_ref) > 1.0             # the box did matter
    with pytest.raises(ValueError):
        ctx.setPeriodicBoxVectors([1.0, 0, 0], [0, 2.5, 0], [0, 0, 2.5])


def test_set_state_and_parameters_round_trip(water):
    ctx, integ = _npt_context(water[2], 3)
    integ.step(6)
    ctx.setParameter("MonteCarloPressure", 5.0)
    assert ctx.getParameter("MonteCarloPressure") == 5.0
    assert ctx.getParameters() == {"MonteCarloPressure": 5.0,
                                   "MonteCarloTemperature": 300.0}
    with pytest.raises(ValueError, match="invalid parameter name"):
        ctx.getParameter("nope")
    with pytest.raises(ValueError, match="invalid parameter name"):
        ctx.setParameter("nope", 1.0)
    ctx.setTime(1.25)
    assert plain(ctx.getTime()) == 1.25
    st = ctx.getState(getPositions=True, getVelocities=True,
                      getParameters=True)
    assert st.getDataTypes() == (omm.State.Positions | omm.State.Velocities
                                 | omm.State.Parameters)
    other, _ = _npt_context(water[2], 3)
    other.setState(st)
    st2 = other.getState(getPositions=True, getVelocities=True,
                         getParameters=True, getEnergy=True)
    assert np.array_equal(plain(st2.getPositions(asNumpy=True)),
                          plain(st.getPositions(asNumpy=True)))
    assert np.array_equal(plain(st2.getVelocities(asNumpy=True)),
                          plain(st.getVelocities(asNumpy=True)))
    assert np.array_equal(plain(st2.getPeriodicBoxVectors(asNumpy=True)),
                          plain(st.getPeriodicBoxVectors(asNumpy=True)))
    assert st2.getParameters() == st.getParameters()
    assert (plain(st2.getTime()), st2.getStepCount()) == (1.25, 6)
    # float32 forces through another candidate state: other rounding
    assert plain(st2.getPotentialEnergy()) == pytest.approx(
        plain(ctx.getState(getEnergy=True).getPotentialEnergy()), rel=1e-6)
    other.setStepCount(11)
    assert other.getStepCount() == 11


def test_enforce_periodic_box_matches_jax(bilayer):
    """getState(enforcePeriodicBox=True) on the cropped bilayer with its
    molecules shifted by whole and half box vectors: each molecule wrapped
    whole as the JAX _wrap_positions wraps it."""
    jsys, pos, params, jctx = bilayer
    ctx = _port_context(params, pos)
    box = jsys._box_array()
    rng = np.random.RandomState(2)
    shift = rng.randint(-2, 3, size=(len(ctx.getMolecules()), 3)) * 0.5
    moved = pos + (shift @ box)[ctx._molecule_id]
    ctx.setPositions(moved)
    got = plain(ctx.getState(getPositions=True,
                       enforcePeriodicBox=True).getPositions(asNumpy=True))
    want = jctx._wrap_positions(moved, box)
    assert np.abs(got - want).max() < 1e-12
    assert np.abs(got - moved).max() > 1.0          # something wrapped
    raw = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.array_equal(raw, moved)


def test_chip_smoke_npt_phases_on_cpu(water, bilayer):
    """chip_smoke.py's NPT phases at a small size: the water box (relaxed
    by a short main path, as tests/test_torch_step_program.py runs it)
    under the isotropic and the anisotropic barostat, and the cropped
    bilayer under the membrane barostat: every gate holds on the CPU,
    where the program and the eager loop give the same bits."""
    import chip_smoke
    dev = torch.device("cpu")
    main = chip_smoke.phase_main_path(
        dev, n_waters=N_WATERS,
        relax=((0.0005, 50.0, 80), (0.001, 50.0, 60)), steps=2,
        energy_every=2)
    iso, aniso = chip_smoke.phase_npt_water(
        dev, main, steps=8, replay=4, frequency=2, aniso_steps=4,
        aniso_frequency=1)
    assert (iso["attempts"], aniso["attempts"]) == (4, 4)
    # the crop's unminimized start (a minimization costs a minute on the
    # CPU) heats over its first steps beyond the 360 K that the chip's
    # run, from the minimized patch, is held to
    _, pos, params, _ = bilayer
    # the NVT Context that the NPT run is timed against in turns: built
    # on the System before the phase adds the barostat to it, which must
    # not reach this Context's step program
    system = omm.from_numpy(params)
    integ = omm.LangevinMiddleIntegrator(303.15, 1.0, 0.002)
    nvt = omm.Context(system, integ, "CPU")
    nvt.setPositions(pos)
    nvt.setVelocitiesToTemperature(303.15, randomSeed=2)
    npt = chip_smoke.phase_npt_bilayer(
        dev, {"system": system, "minimized_positions": pos, "ns_day": 1.0,
              "context": nvt, "step": integ.step}, steps=4, replay=2, frequency=1,
        t_range=(250.0, 450.0), turn_steps=1, turns=("nvt", "npt", "nvt"))
    assert npt["attempts"] == 4 and npt["accepted"] >= 1
    assert [len(npt["turns"]["ms"][k]) for k in ("nvt", "npt")] == [2, 1]
    assert nvt.getStepCount() == 2 and not nvt._barostats
    for run in (iso, aniso, npt):
        assert run["graph"]["energies"] == run["eager"]["energies"]
        # CPU tensors take the plain versions: no kernel launched
        assert set(run["launches"].values()) == {0}


@pytest.mark.parametrize("case", ["iso", "aniso_one", "membrane_zfixed"])
def test_system_round_trip_keeps_the_barostat(water, case):
    """system_params carries a JAX barostat's settings across, and
    to_numpy(from_numpy(...)) gives them back with its force group."""
    jsys, _, params = water
    barostat = CASES[case][0]()
    barostat.setForceGroup(3)
    jsys.addForce(barostat)
    try:
        want = system_params(jsys)
    finally:
        jsys.removeForce(jsys.getNumForces() - 1)
    got = omm.to_numpy(omm.from_numpy(want))
    keys = [k for k in want if k.startswith("barostat_")]
    assert keys and got["force_groups"]["barostat"] == 3
    for key in keys:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key]))
