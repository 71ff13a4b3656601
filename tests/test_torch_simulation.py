"""The port's Simulation and its four reporters against the JAX package's:
a 216-water TIP3P box under Verlet for 20 steps, the port on its "CPU"
platform in double precision, the JAX package on "Reference", with a
StateDataReporter, a DCDReporter and a PDBReporter every 5 steps.

- the StateDataReporter's header is the JAX one and its rows agree to
  1e-6 relative (the speed and elapsed-time columns aside, which read the
  wall clock);
- the DCD files are equal byte for byte but for the date in the header;
- the PDB trajectories are equal;
- a checkpoint that CheckpointReporter writes mid-run, loaded into a new
  Simulation, continues bit for bit;
- the paths through XmlSerializer run: a System and an Integrator from
  XML files, state=, saveState/loadState (also across the packages, both
  ways), CheckpointReporter(writeState=True), runForClockTime(stateFile=);
  the default platform without a card raises."""
import gc
import io
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu.models import tip3p_water_box as jax_water_box

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import port_topology
from openmm_tpu_torch.unit import plain

WATERS = 216
STEPS = 20
INTERVAL = 5
COLUMNS = dict(step=True, time=True, potentialEnergy=True,
               kineticEnergy=True, totalEnergy=True, temperature=True,
               volume=True, density=True, speed=True, elapsedTime=True)
# the columns that read the wall clock
CLOCK = ("Speed (ns/day)", "Elapsed Time (s)")
# where DCDFile writes the date (the second 80-byte title record)
DATE = slice(180, 260)


def _water_topology(n, box):
    from openmm_tpu import unit as ju
    from openmm_tpu.vec3 import Vec3
    top = japp.Topology()
    chain = top.addChain()
    O, H = japp.Element.getBySymbol("O"), japp.Element.getBySymbol("H")
    for _ in range(n):
        res = top.addResidue("HOH", chain)
        o = top.addAtom("O", O, res)
        top.addBond(o, top.addAtom("H1", H, res))
        top.addBond(o, top.addAtom("H2", H, res))
    top.setPeriodicBoxVectors(ju.Quantity(
        tuple(Vec3(*row) for row in box), ju.nanometer))
    return top


def _port_simulation(top, system, pos):
    sim = papp.Simulation(top, system,
                          omm.VerletIntegrator(0.001 * pu.picoseconds),
                          omm.Platform.getPlatformByName("CPU"),
                          {"Precision": "double"})
    sim.context.setPositions(pos * pu.nanometer)
    return sim


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same run through both packages: {package: {"log", "dcd",
    "pdb", "positions"}}."""
    tmp = tmp_path_factory.mktemp("sim")
    jsys, jpos = jax_water_box(WATERS)
    psys, ppos = tip3p_water_box(WATERS)
    np.testing.assert_array_equal(np.asarray(jpos, np.float64), ppos)
    jtop = _water_topology(WATERS, plain(psys.getDefaultPeriodicBoxVectors()))
    jsim = japp.Simulation(jtop, jsys, mm.VerletIntegrator(0.001),
                           mm.Platform.getPlatformByName("Reference"))
    jsim.context.setPositions(jpos)
    psim = _port_simulation(port_topology(jtop), psys, ppos)
    out = {}
    for name, sim, app in (("jax", jsim, japp), ("port", psim, papp)):
        log = io.StringIO()
        dcd, pdb = str(tmp / (name + ".dcd")), str(tmp / (name + ".pdb"))
        sim.reporters += [app.StateDataReporter(log, INTERVAL, **COLUMNS),
                          app.DCDReporter(dcd, INTERVAL),
                          app.PDBReporter(pdb, INTERVAL)]
        sim.step(STEPS)
        pos = plain(sim.context.getState(getPositions=True).getPositions(
            asNumpy=True))
        sim.reporters.clear()
        gc.collect()    # the reporters close their files when collected
        with open(dcd, "rb") as f:
            dcd_bytes = f.read()
        with open(pdb) as f:
            pdb_text = f.read()
        out[name] = {"log": log.getvalue(), "dcd": dcd_bytes,
                     "pdb": pdb_text, "steps": sim.currentStep,
                     "positions": np.asarray(getattr(pos, "_value", pos),
                                             np.float64)}
    return out


def test_state_data_rows_match_jax(runs):
    jlines = runs["jax"]["log"].splitlines()
    plines = runs["port"]["log"].splitlines()
    assert plines[0] == jlines[0]
    header = [h.strip('"') for h in jlines[0][2:].split('","')]
    assert len(plines) == len(jlines) == 1 + STEPS // INTERVAL
    for pl, jl in zip(plines[1:], jlines[1:]):
        for name, p, j in zip(header, pl.split(","), jl.split(",")):
            if name in CLOCK:
                continue
            assert abs(float(p) - float(j)) <= 1e-6 * abs(float(j)), name
    assert runs["port"]["steps"] == runs["jax"]["steps"] == STEPS


def test_dcd_matches_jax_but_for_the_date(runs):
    j, p = runs["jax"]["dcd"], runs["port"]["dcd"]
    assert len(p) == len(j)
    assert p[:DATE.start] == j[:DATE.start]
    assert p[DATE.stop:] == j[DATE.stop:]
    assert struct.unpack("<i", p[8:12])[0] == STEPS // INTERVAL


def test_pdb_trajectory_matches_jax(runs):
    assert runs["port"]["pdb"] == runs["jax"]["pdb"]
    assert runs["port"]["pdb"].count("MODEL") == STEPS // INTERVAL


def test_checkpoint_continues_bitwise(tmp_path):
    system, pos = tip3p_water_box(27)
    jtop = _water_topology(27, plain(system.getDefaultPeriodicBoxVectors()))
    top = port_topology(jtop)
    sim = _port_simulation(top, system, pos)
    sim.context.setVelocitiesToTemperature(300 * pu.kelvin, 7)
    path = str(tmp_path / "run.chk")
    sim.reporters.append(papp.CheckpointReporter(path, 10))
    sim.step(10)
    shutil.copy(path, str(tmp_path / "mid.chk"))
    sim.step(10)
    want = sim.context.getState(getPositions=True,
                                getVelocities=True)
    again = _port_simulation(top, system, pos)
    again.loadCheckpoint(str(tmp_path / "mid.chk"))
    assert again.currentStep == 10
    again.step(10)
    got = again.context.getState(getPositions=True, getVelocities=True)
    np.testing.assert_array_equal(plain(got.getPositions(asNumpy=True)),
                                  plain(want.getPositions(asNumpy=True)))
    np.testing.assert_array_equal(plain(got.getVelocities(asNumpy=True)),
                                  plain(want.getVelocities(asNumpy=True)))
    assert again.currentStep == sim.currentStep == 20


def test_refusals(tmp_path):
    """The XmlSerializer paths that raised before the port had a
    serializer now run: a System and an Integrator given as files, state=,
    saveState and loadState (the run continues bit for bit from the
    State), CheckpointReporter(writeState=True); the default platform
    without a card still raises, and the Drude force fields load."""
    system, pos = tip3p_water_box(27)
    top = port_topology(_water_topology(
        27, plain(system.getDefaultPeriodicBoxVectors())))
    cpu = omm.Platform.getPlatformByName("CPU")
    for name, obj in (("system.xml", system),
                      ("integrator.xml", omm.VerletIntegrator(0.001))):
        with open(str(tmp_path / name), "w") as f:
            f.write(omm.XmlSerializer.serialize(obj))
    sim = _port_simulation(top, system, pos)
    sim.context.setVelocitiesToTemperature(300 * pu.kelvin, 3)
    sim.step(5)
    state = str(tmp_path / "state.xml")
    sim.saveState(state)
    again = papp.Simulation(top, str(tmp_path / "system.xml"),
                            str(tmp_path / "integrator.xml"), cpu,
                            {"Precision": "double"}, state=state)
    assert type(again.integrator) is omm.VerletIntegrator
    assert again.system.getNumParticles() == system.getNumParticles()
    assert again.context.getStepCount() == 5
    # a State set drops the candidate state, which the next step builds
    # anew: the run compared sets its own State too
    sim.loadState(state)
    for run in (sim, again):
        run.step(5)
    got, want = (r.context.getState(getPositions=True, getVelocities=True)
                 for r in (again, sim))
    np.testing.assert_array_equal(plain(got.getPositions(asNumpy=True)),
                                  plain(want.getPositions(asNumpy=True)))
    np.testing.assert_array_equal(plain(got.getVelocities(asNumpy=True)),
                                  plain(want.getVelocities(asNumpy=True)))
    sim.loadState(state)
    assert sim.currentStep == 5 and sim.context.getStepCount() == 5
    sim.reporters.append(papp.CheckpointReporter(
        str(tmp_path / "reported.xml"), 1, writeState=True))
    sim.step(1)
    with open(str(tmp_path / "reported.xml")) as f:
        reported = omm.XmlSerializer.deserialize(f.read())
    assert reported.getStepCount() == 6
    # the Drude force fields load since the Drude slice
    drude = os.path.join(os.path.dirname(japp.__file__), "data",
                         "swm4ndp.json")
    assert any(type(g).__name__ == "DrudeGenerator"
               for g in papp.ForceField(drude)._generators)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            papp.Simulation(top, system, omm.VerletIntegrator(0.001))


def _jax_simulation(jtop, jsys, jpos):
    sim = japp.Simulation(jtop, jsys, mm.VerletIntegrator(0.001),
                          mm.Platform.getPlatformByName("Reference"))
    sim.context.setPositions(jpos)
    return sim


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_files_cross_between_packages(tmp_path, direction):
    """A saveState of one package's Simulation loads with the other's
    loadState: the same step count, time, positions and velocities, bit
    for bit, and the integrator's parameters."""
    jsys, jpos = jax_water_box(27)
    psys, ppos = tip3p_water_box(27)
    jtop = _water_topology(27, plain(psys.getDefaultPeriodicBoxVectors()))
    sims = {"jax": _jax_simulation(jtop, jsys, jpos),
            "port": _port_simulation(port_topology(jtop), psys, ppos)}
    source, target = direction.split("_to_")
    sims[source].step(7)
    path = str(tmp_path / "state.xml")
    sims[source].saveState(path)
    sims[target].loadState(path)
    assert sims[target].currentStep == 7
    states = {k: s.context.getState(getPositions=True, getVelocities=True,
                                    getIntegratorParameters=True)
              for k, s in sims.items()}
    assert states["port"].getStepCount() == states["jax"].getStepCount() == 7
    assert plain(states["port"].getTime()) == float(
        states["jax"].getTime()._value)
    for getter in ("getPositions", "getVelocities"):
        np.testing.assert_array_equal(
            plain(getattr(states["port"], getter)(asNumpy=True)),
            np.asarray(getattr(states["jax"], getter)(asNumpy=True)._value,
                       np.float64))
    assert states["port"].getIntegratorParameters() == {
        k: float(v) for k, v in
        states["jax"].getIntegratorParameters().items()}


def test_checkpoint_reporter_writes_states(tmp_path):
    """CheckpointReporter(writeState=True) every 4 steps: the file holds
    the State of the last report, and a new Simulation that loads it
    gives the bits of the run that loads it at that step."""
    system, pos = tip3p_water_box(27)
    top = port_topology(_water_topology(
        27, plain(system.getDefaultPeriodicBoxVectors())))
    sim = _port_simulation(top, system, pos)
    sim.context.setVelocitiesToTemperature(300 * pu.kelvin, 9)
    path = str(tmp_path / "run.xml")
    sim.reporters.append(papp.CheckpointReporter(path, 4, writeState=True))
    sim.step(10)
    with open(path) as f:
        text = f.read()
    assert omm.XmlSerializer.deserialize(text).getStepCount() == 8
    # the run compared sets the State at step 8 too (a State set drops the
    # candidate state, which the next step builds anew)
    sim.reporters.clear()
    sim.loadState(io.StringIO(text))
    sim.step(2)
    want = sim.context.getState(getPositions=True, getVelocities=True)
    again = _port_simulation(top, system, pos)
    again.loadState(io.StringIO(text))
    assert again.currentStep == 8
    again.step(2)
    got = again.context.getState(getPositions=True, getVelocities=True)
    np.testing.assert_array_equal(plain(got.getPositions(asNumpy=True)),
                                  plain(want.getPositions(asNumpy=True)))
    np.testing.assert_array_equal(plain(got.getVelocities(asNumpy=True)),
                                  plain(want.getVelocities(asNumpy=True)))


def test_run_for_clock_time_saves_states(tmp_path):
    """runForClockTime(stateFile=) leaves a State of its last step."""
    system, pos = tip3p_water_box(27)
    top = port_topology(_water_topology(
        27, plain(system.getDefaultPeriodicBoxVectors())))
    sim = _port_simulation(top, system, pos)
    path = str(tmp_path / "clock.xml")
    sim.runForClockTime(0.3 * pu.seconds, stateFile=path,
                        checkpointInterval=0.1)
    with open(path) as f:
        state = omm.XmlSerializer.deserialize(f.read())
    assert state.getStepCount() == sim.currentStep > 0
    np.testing.assert_array_equal(
        plain(state.getPositions(asNumpy=True)),
        plain(sim.context.getState(getPositions=True).getPositions(
            asNumpy=True)))


def test_run_for_clock_time_saves_checkpoints(tmp_path):
    """runForClockTime steps until its wall-clock limit, in chunks of 10
    steps, and leaves a checkpoint that loads back to its step count."""
    system, pos = tip3p_water_box(27)
    top = port_topology(_water_topology(
        27, plain(system.getDefaultPeriodicBoxVectors())))
    sim = _port_simulation(top, system, pos)
    path = str(tmp_path / "clock.chk")
    sim.runForClockTime(0.5 * pu.seconds, checkpointFile=path,
                        checkpointInterval=0.2)
    assert sim.currentStep > 0 and sim.currentStep % 10 == 0
    again = _port_simulation(top, system, pos)
    again.loadCheckpoint(path)
    assert again.currentStep == sim.currentStep
