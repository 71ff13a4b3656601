"""The step program (openmm_tpu_torch/step_program.py) on the CPU, on the
343-water box of tests/test_torch_slice.py (1,029 atoms).

On the CPU the program's step body runs eagerly, with the plain kernel
versions and the rebuild predicate read on the host: the very function
that a card captures into a CUDA graph. It must give the bits of the
eager loop it replaced (Context._step_eager): the same operations on the
same numbers in the same order, the same rebuild steps and the same draws
from the generator. At zero friction it must match the JAX package's
"CPU" platform as tests/test_torch_slice.py's
test_zero_friction_trajectory_matches_jax does, over a run with rebuilds
(the bar and its reasoning are that test's: 1e-5 nm after 20 steps). And
the step body must read nothing back from the device: run on fake tensors
it raises at any .item(), bool(), .tolist() or data-dependent shape. The
same holds on the cropped POPC bilayer of tests/test_torch_bilayer.py
(2,296 atoms), whose step adds the bonded forces, SHAKE, CCMA and a
CMMotionRemover."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                          FakeTensorMode)

import openmm_tpu as mm
from openmm_tpu.models import tip3p_water_box as jax_water_box

import chip_smoke
import openmm_tpu_torch as omm
from openmm_tpu_torch import step_program
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import cropped_bilayer, system_params
from openmm_tpu_torch.unit import plain

N_WATERS = 343


def _hot_start(scale=1.0, friction=1.0, dt=0.002):
    """A Context on the lattice start with Maxwell-Boltzmann velocities,
    its capacity scaled by `scale` before the first step."""
    system, positions = tip3p_water_box(N_WATERS)
    integ = omm.LangevinMiddleIntegrator(300.0, friction, dt)
    integ.setRandomNumberSeed(11)
    ctx = omm.Context(system, integ, "CPU")
    ctx._nonbonded.capacity_scale = scale
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
    return ctx, integ


def _dynamic_state(ctx):
    s = ctx._state
    return (s["positions"], s["velocities"], ctx._generator.get_state(),
            s["time"], s["step"], ctx.rebuild_count, ctx.escalation_count)


# (capacity scale, [(steps, step size, friction, temperature)] a call each)
CASES = {
    # 60 steps at 2 fs and 1/ps from the hot lattice start
    "friction": (1.0, [(25, 0.002, 1.0, 300.0), (35, 0.002, 1.0, 300.0)]),
    # a capacity too small for the box: the first chunk overflows, is
    # undone and runs again at a grown capacity
    "overflow": (0.3, [(30, 0.002, 1.0, 300.0)]),
    # setStepSize, setFriction and setTemperature between calls
    "parameters": (1.0, [(15, 0.001, 5.0, 300.0), (15, 0.002, 1.0, 300.0),
                         (15, 0.0015, 0.5, 350.0)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_matches_eager_loop_bitwise(case):
    scale, calls = CASES[case]
    runs = []
    for eager in (False, True):
        ctx, integ = _hot_start(scale)
        rebuilds = []
        for steps, dt, friction, temperature in calls:
            integ.setStepSize(dt)
            integ.setFriction(friction)
            integ.setTemperature(temperature)
            if eager:
                ctx._step_eager(steps)
            else:
                integ.step(steps)
            rebuilds.append(ctx.rebuild_count)
        if not eager:
            assert ctx._programs, "step() did not go through the program"
        runs.append((_dynamic_state(ctx), rebuilds))
    (prog, prog_rebuilds), (eager, eager_rebuilds) = runs
    for got, want in zip(prog, eager):
        if torch.is_tensor(got):
            assert torch.equal(got, want)
        else:
            assert got == want
    assert prog_rebuilds == eager_rebuilds
    assert prog[5] >= 3                 # the first build and two rebuilds
    if case == "overflow":
        assert prog[6] > 0
    else:
        assert prog[6] == 0


def test_zero_friction_program_matches_jax_across_rebuilds():
    jsys, jpos = jax_water_box(n_waters=N_WATERS)
    pos = np.array([[p.x, p.y, p.z] for p in jpos])
    system = omm.from_numpy(system_params(jsys))
    rng = np.random.RandomState(5)
    masses = omm.to_numpy(system)["masses"]
    vel = rng.randn(*pos.shape) * np.sqrt(omm.BOLTZ * 300.0 / masses)[:, None]

    jint = mm.LangevinMiddleIntegrator(300.0, 0.0, 0.002)
    jctx = mm.Context(jsys, jint, mm.Platform.getPlatformByName("CPU"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    jint.step(20)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)

    integ = omm.LangevinMiddleIntegrator(300.0, 0.0, 0.002)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    integ.step(20)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert len(ctx._programs) == 1
    assert ctx.rebuild_count >= 3       # the first build and two rebuilds
    assert np.abs(want - start).max() > 1e-1       # the atoms did move
    assert np.abs(got - want).max() < 1e-5


def test_step_body_reads_nothing_from_the_device():
    """The body on fake tensors, with the build run (as the warm-up before
    a capture runs it): any host read of tensor data raises there."""
    ctx, integ = _hot_start()
    integ.step(1)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)
    # the check has teeth: the CPU's own gate reads the predicate
    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(DataDependentOutputException):
            program.body(program.gate_host)


def test_cpu_program_has_no_graph_and_counts_no_launches():
    ctx, integ = _hot_start()
    integ.step(2)
    (program,) = ctx._programs.values()
    assert program.graph is None and program.launches == []
    assert step_program.GATING.startswith("(a)")
    # the counters are the only data the host reads a chunk, and they
    # count the chunk's rebuilds
    assert program.counters.tolist() == [0, ctx.rebuild_count]


def test_chip_smoke_step_program_phase_on_cpu():
    main = chip_smoke.phase_main_path(
        torch.device("cpu"), n_waters=216,
        relax=((0.0005, 50.0, 80), (0.001, 50.0, 60)), steps=10,
        energy_every=5)
    out = chip_smoke.phase_step_program(
        torch.device("cpu"), main, rebuild_steps=16, escalation_scale=0.1,
        escalation_steps=4, double_waters=64, double_steps=3)
    assert out["gating"] == step_program.GATING
    assert out["graph"]["energies"] == out["eager"]["energies"]
    assert out["escalations"] >= 1
    assert out["rebuild_steps"]              # some step rebuilt
    assert out["double_err"] == 0.0          # the CPU adds in one order
    # CPU tensors take the plain versions: no kernel launched
    assert set(out["graph"]["launches"].values()) == {0}


def _bilayer_context(cmm_frequency=3):
    """A Context ("CPU", mixed) on the cropped POPC bilayer of
    tests/test_torch_bilayer.py with every part of the bilayer's step and
    CCMA besides: four heavy-atom bonds of the first lipid become
    constraints too, which takes their carbons' hydrogens out of SHAKE
    into CCMA. Constrained positions, velocities at 300 K."""
    jsys, pos, _ = cropped_bilayer()
    params = dict(system_params(jsys), cmm_frequency=cmm_frequency)
    heavy = params["masses"] > 2.0
    bonds, lengths = params["bond_pairs"], params["bond_params"][:, 0]
    pick = np.nonzero(heavy[bonds].all(axis=1) & (bonds < 134).all(
        axis=1))[0][:4]
    params["constraint_pairs"] = np.concatenate(
        [params["constraint_pairs"], bonds[pick]])
    params["constraint_distances"] = np.concatenate(
        [params["constraint_distances"], lengths[pick]])
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(17)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    settle, shake, ccma = ctx.constraint_split
    assert settle > 0 and shake > 0 and ccma > 4
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=4)
    return ctx, integ


def test_bilayer_program_matches_eager_loop_bitwise():
    """The bonded forces, SETTLE, SHAKE, CCMA and a CMMotionRemover of
    frequency 3 on the cropped bilayer: 8 steps in one call through the
    program, through the eager loop, and one a call through the program
    (the device step counter set from the host each call), give the same
    bits; the remover fires inside the chunk on steps 0, 3 and 6, so a
    counter frozen in the chunk would change them."""
    runs = []
    for mode in ("program", "eager", "one a call"):
        ctx, integ = _bilayer_context()
        if mode == "program":
            integ.step(8)
        elif mode == "eager":
            ctx._step_eager(8)
        else:
            for _ in range(8):
                integ.step(1)
        assert int(ctx._deps.step) == ctx.getStepCount() == 8
        runs.append(_dynamic_state(ctx))
    for other in runs[1:]:
        for got, want in zip(runs[0], other):
            if torch.is_tensor(got):
                assert torch.equal(got, want)
            else:
                assert got == want


def test_bilayer_step_body_reads_nothing_from_the_device():
    """The step body of the cropped bilayer with CCMA and the remover on
    fake tensors (the build run, as before a capture): no host read."""
    ctx, integ = _bilayer_context()
    integ.step(1)
    program = ctx._program()
    assert ctx._deps.update_hooks and ctx._ccma is not None
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)
