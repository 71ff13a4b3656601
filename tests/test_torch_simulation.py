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
- the paths through XmlSerializer and the default platform without a card
  raise, and so does a force field with a Drude section."""
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
    jtop = _water_topology(WATERS, psys.getDefaultPeriodicBoxVectors())
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
        pos = sim.context.getState(getPositions=True).getPositions()
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
    jtop = _water_topology(27, system.getDefaultPeriodicBoxVectors())
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
    np.testing.assert_array_equal(got.getPositions(), want.getPositions())
    np.testing.assert_array_equal(got.getVelocities(),
                                  want.getVelocities())
    assert again.currentStep == sim.currentStep == 20


def test_refusals(tmp_path):
    system, pos = tip3p_water_box(27)
    top = port_topology(_water_topology(
        27, system.getDefaultPeriodicBoxVectors()))
    cpu = omm.Platform.getPlatformByName("CPU")
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        papp.Simulation(top, "system.xml", omm.VerletIntegrator(0.001),
                        cpu)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        papp.Simulation(top, system, omm.VerletIntegrator(0.001), cpu,
                        state="state.xml")
    sim = _port_simulation(top, system, pos)
    for call in (sim.saveState, sim.loadState):
        with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
            call(str(tmp_path / "state.xml"))
    sim.reporters.append(papp.CheckpointReporter(
        str(tmp_path / "state.xml"), 1, writeState=True))
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        sim.step(1)
    drude = os.path.join(os.path.dirname(japp.__file__), "data",
                         "swm4ndp.json")
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        papp.ForceField(drude)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            papp.Simulation(top, system, omm.VerletIntegrator(0.001))



def test_run_for_clock_time_saves_checkpoints(tmp_path):
    """runForClockTime steps until its wall-clock limit, in chunks of 10
    steps, and leaves a checkpoint that loads back to its step count."""
    system, pos = tip3p_water_box(27)
    top = port_topology(_water_topology(
        27, system.getDefaultPeriodicBoxVectors()))
    sim = _port_simulation(top, system, pos)
    path = str(tmp_path / "clock.chk")
    sim.runForClockTime(0.5 * pu.seconds, checkpointFile=path,
                        checkpointInterval=0.2)
    assert sim.currentStep > 0 and sim.currentStep % 10 == 0
    again = _port_simulation(top, system, pos)
    again.loadCheckpoint(path)
    assert again.currentStep == sim.currentStep
