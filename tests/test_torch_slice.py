"""The slice as a whole: openmm_tpu_torch's Context on the "CPU" platform
against openmm_tpu's "CPU" (float32 tiles) and "Reference" (float64,
dense) platforms on a 343-water PME box (1,029 atoms, 20^3 grid).

Tolerances: the port's float32 path stays within the accuracy class the
JAX float32 path reaches (median relative force error <= 1e-5 against the
float64 oracle); energies within 1e-5 relative of Reference and 5e-5 of the
JAX "CPU" platform (both float32, different summation orders). The port's
float64 path evaluates the same formulas as Reference: 1e-10. At zero
friction LangevinMiddle is deterministic, so 20 steps from the same
positions and velocities must give the same positions; the two float32
force paths differ by ~1e-6 relative each step, which a hot lattice start
grows to a few 1e-6 nm over 20 steps, so the bar is 1e-5 nm against moves
of ~1e-2 nm."""
import math

import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu.models import tip3p_water_box as jax_water_box

import chip_smoke
import openmm_tpu_torch as omm
from torch_port_helpers import median_relative_error, system_params


@pytest.fixture(scope="module")
def box343():
    jsys, jpos = jax_water_box(n_waters=343)
    pos = np.array([[p.x, p.y, p.z] for p in jpos])
    return jsys, pos, omm.from_numpy(system_params(jsys))


def _jax_state(jsys, pos, platform, **kw):
    ctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    st = ctx.getState(**kw)
    return st.getPotentialEnergy()._value, \
        np.asarray(st.getForces(asNumpy=True)._value)


def _port_state(system, pos, precision):
    ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": precision})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return st.getPotentialEnergy(), st.getForces()


def test_energy_and_forces_match_jax_platforms(box343):
    jsys, pos, system = box343
    e_ref, f_ref = _jax_state(jsys, pos, "Reference", getEnergy=True,
                              getForces=True)
    e_cpu, f_cpu = _jax_state(jsys, pos, "CPU", getEnergy=True,
                              getForces=True)
    e, f = _port_state(system, pos, "mixed")
    assert abs(e - e_ref) < 1e-5 * abs(e_ref)
    assert abs(e - e_cpu) < 5e-5 * abs(e_cpu)
    assert median_relative_error(f, f_ref) <= 1e-5
    assert median_relative_error(f, f_cpu) <= 1e-5
    e64, f64 = _port_state(system, pos, "double")
    assert abs(e64 - e_ref) < 1e-10 * abs(e_ref)
    assert np.abs(f64 - f_ref).max() < 1e-10 * np.abs(f_ref).max()


def test_zero_friction_trajectory_matches_jax(box343):
    jsys, pos, system = box343
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
    got = ctx.getState(getPositions=True).getPositions()
    assert np.abs(want - start).max() > 1e-3       # the atoms did move
    assert np.abs(got - want).max() < 1e-5


@pytest.fixture(scope="module")
def main_path():
    torch.manual_seed(0)
    return chip_smoke.phase_main_path(
        torch.device("cpu"), n_waters=343,
        relax=((0.0005, 50.0, 80), (0.001, 50.0, 60)), steps=20,
        energy_every=10)


def test_chip_smoke_main_path_phase_on_cpu(main_path):
    result = main_path
    assert result["force_err"] <= chip_smoke.FORCE_ERR_BAR
    assert len(result["energies"]) == 3
    assert result["rebuilds"] > 0 and result["escalations"] == 0


def test_chip_smoke_method_phases_on_cpu(main_path):
    """The phases of the other NonbondedForce methods from the rehearsed
    main path: the relaxed box at the rf settings (kernel 1 in MODE_RF on
    its candidate state), droplets of it at NoCutoff and
    CutoffNonPeriodic (every pair), and an Ewald box."""
    cpu = torch.device("cpu")
    rf = chip_smoke.phase_rf_water(cpu, main_path, steps=8, replay=4)
    assert rf["tiled"] and rf["force_err"] <= chip_smoke.FORCE_ERR_BAR
    record = rf["record"]
    assert record["name"] == "nonbonded_tiles_rf"
    assert record["bound_ms"] > 0 and record["ms"] is None
    # CPU tensors take the plain versions: no kernel launched
    assert rf["launches"]["nonbonded_tiles"] == 0
    droplets = chip_smoke.phase_nonperiodic(cpu, main_path, radius=0.8,
                                            steps=3, replay=2)
    assert [d["tiled"] for d in droplets] == [False, False]
    assert all(d["force_err"] <= chip_smoke.FORCE_ERR_BAR for d in droplets)
    ewald = chip_smoke.phase_ewald(cpu, n_waters=343, steps=3, replay=2)
    assert ewald["tiled"] and ewald["force_err"] <= chip_smoke.FORCE_ERR_BAR


def test_chip_smoke_integrator_phase_on_cpu(main_path):
    """phase_integrators from the rehearsed main path, a few steps of
    each integrator: its readings, the eager loop's bits, the constraint
    error. Its statistical gates (the NVE drift, the thermostat's mean
    temperature) need the card's run lengths and are open here."""
    out = chip_smoke.phase_integrators(
        torch.device("cpu"), main_path, verlet_steps=20, drift_every=5,
        andersen_steps=10, andersen_every=5, langevin_steps=6,
        brownian_steps=4, replay=3, drift_gate=math.inf,
        andersen_range=(0.0, math.inf))
    assert sorted(out) == ["andersen", "brownian", "langevin", "verlet"]
    assert len(out["verlet"]["readings"]) == 5
    shifted, unshifted = out["verlet"]["kinetic"]
    assert shifted != unshifted
    # CPU tensors take the plain versions: no kernel launched
    assert all(v == 0 for r in out.values()
               for v in r["launches"].values())


def test_chip_smoke_custom_and_stateful_phases_on_cpu(main_path):
    """The phases of the CustomIntegrator velocity Verlet (its if and
    while blocks), Nose-Hoover, the variable-step pair and the
    CompoundIntegrator from the rehearsed main path, a few steps each:
    their readings and counters, the clock against the step sizes, the
    eager loop's bits with the integrators' state and the clock. The
    statistical gates need the card's run lengths and are open here."""
    cpu = torch.device("cpu")
    custom = chip_smoke.phase_custom(cpu, main_path, steps=20, every=5,
                                     replay=3, drift_gate=math.inf)
    assert len(custom["readings"]) == 5 and custom["ke_err"] <= 1e-9
    nh = chip_smoke.phase_nose_hoover(cpu, main_path, steps=6, every=3,
                                      replay=2, drift_gate=math.inf,
                                      t_range=(0.0, math.inf))
    assert len(nh["readings"]) == 3
    variable = chip_smoke.phase_variable(cpu, main_path, steps=4, replay=2,
                                         energy_bar=math.inf)
    assert all(r["mean_dt"] > 0 for r in variable.values())
    compound = chip_smoke.phase_compound(cpu, main_path, steps=3,
                                         switches=1, replay=4)
    assert compound["clock"] == pytest.approx(
        3 * (chip_smoke.DT_PS + chip_smoke.VERLET_DT))
    # CPU tensors take the plain versions: no kernel launched
    for r in (custom, nh, *variable.values(), compound):
        assert set(r["launches"].values()) == {0}
