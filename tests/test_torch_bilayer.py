"""The POPC bilayer (openmm_tpu_torch.models.popc_bilayer) against the JAX
package.

Its data: the templates in models/data/popc_bilayer.npz equal what the
JAX ForceField (amber14-lipid + amber14-tip3p, PME at 0.9 nm, HBonds)
gives today, the coordinates are the JAX package's patch's, and the full
System has the counts of the JAX ForceField's System on the full patch.

Its physics, on a corner of the patch (tests/torch_port_helpers.py
cropped_bilayer: ~2,300 atoms, 5 lipids, a 2.1 x 2.2 x 7.3 nm box, so the
port takes its candidate-state engine and the JAX package its n >= 1024
neighbour engine) built by the JAX ForceField and carried across with
system_params:
- float64 energy and forces of each force group against the JAX
  "Reference" platform: both evaluate the same formulas in float64, 1e-9
  relative (forces: of the largest component);
- the mixed path (float32 nonbonded) against "Reference" and "CPU":
  median force error <= 1e-5 (the port's accuracy bar), energy within
  1e-5 relative;
- 10 LangevinMiddle steps at 0 K (no noise) with HBonds (SETTLE and
  SHAKE) and the CMMotionRemover firing every step, from a start with a
  centre-of-mass drift, against the JAX "Reference" Context: 1e-9 nm;
- a CMMotionRemover of frequency 10 fires on the steps the JAX one fires
  on (a drift added before every step is removed on steps 0 and 10
  only).
"""
import os

import numpy as np
import pytest

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import builders, popc_bilayer
from openmm_tpu_torch.ops.constraints import (partition_constraints,
                                              partition_shake_clusters)
from torch_port_helpers import (BILAYER_DATA, bilayer_templates,
                                cropped_bilayer, median_relative_error,
                                system_params)

# force groups of the comparison: bonds, angles, torsions, nonbonded, the
# remover (no energy)
GROUPS = {"HarmonicBondForce": 1, "HarmonicAngleForce": 2,
          "PeriodicTorsionForce": 3, "NonbondedForce": 0,
          "CMMotionRemover": 4}
DRIFT = np.array([0.4, -0.3, 0.2])     # nm/ps


@pytest.fixture(scope="module")
def bilayer():
    jsys, pos, layout = cropped_bilayer()
    for force in jsys.getForces():
        force.setForceGroup(GROUPS[type(force).__name__])
    return jsys, pos, layout, system_params(jsys)


def _jax_context(jsys, platform, integrator=None):
    return mm.Context(jsys, integrator or mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName(platform))


def _port_context(params, precision, integrator=None):
    return omm.Context(omm.from_numpy(params),
                       integrator or omm.LangevinMiddleIntegrator(
                           0.0, 1.0, 0.002),
                       "CPU", {"Precision": precision})


def _jax_array(quantity):
    return np.asarray(quantity._value, np.float64)


def test_templates_equal_the_forcefield():
    with np.load(BILAYER_DATA) as f:
        data = {k: f[k] for k in f.files}
    fresh = bilayer_templates()
    for key, value in fresh.items():
        np.testing.assert_array_equal(data[key], value, err_msg=key)
    patch = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "openmm_tpu", "app", "data", "POPC.npz"))
    np.testing.assert_array_equal(data["positions"], patch["positions"])
    np.testing.assert_array_equal(data["box"], patch["box_nm"])
    names = patch["resnames"][patch["res_idx"]]
    starts = np.concatenate([[True], patch["resid"][1:]
                             != patch["resid"][:-1]])
    np.testing.assert_array_equal(data["residue_template"],
                                  names[starts] == "HOH")


def test_full_bilayer_has_the_forcefield_counts():
    """The counts the JAX ForceField gives on the full patch."""
    system, pos = popc_bilayer()
    assert system.getNumParticles() == pos.shape[0] == 32512
    counts = {type(f).__name__: f for f in system.getForces()}
    assert counts["HarmonicBondForce"].getNumBonds() == 6528
    assert counts["HarmonicAngleForce"].getNumAngles() == 32768
    assert counts["PeriodicTorsionForce"].getNumTorsions() == 62336
    assert counts["NonbondedForce"].getNumExceptions() == 110720
    assert counts["CMMotionRemover"].getFrequency() == 1
    assert system.getNumConstraints() == 25856
    masses = [system.getParticleMass(i) for i in range(32512)]
    cons = [system.getConstraintParameters(i) for i in range(25856)]
    settle, rest = partition_constraints(cons, masses)
    shake, ccma = partition_shake_clusters(rest, masses)
    assert (len(settle), len(shake), len(ccma)) == (5120, 5120, 0)
    # the molecules are whole: no bond longer than 0.2 nm
    bonds = omm.to_numpy(system)["bond_pairs"]
    assert np.linalg.norm(pos[bonds[:, 0]] - pos[bonds[:, 1]],
                          axis=1).max() < 0.2


def test_replicated_templates_equal_the_forcefield_system(bilayer):
    """The templates replicated over the cropped patch's residues give the
    JAX ForceField's System of that crop: the same per-atom arrays, and
    the same terms (in another order)."""
    _, _, layout, want = bilayer
    with np.load(BILAYER_DATA) as f:
        got = builders.replicate_templates({k: f[k] for k in f.files},
                                           layout)
    for key in ("masses", "charges", "sigma", "epsilon"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for atoms, par in (("exception_pairs", "exception_params"),
                       ("constraint_pairs", "constraint_distances"),
                       ("bond_pairs", "bond_params"),
                       ("angle_triples", "angle_params"),
                       ("torsion_quads", "torsion_params")):
        def rows(p):
            r = np.concatenate([p[atoms].astype(np.float64),
                                p[par].reshape(len(p[atoms]), -1)], axis=1)
            return r[np.lexsort(r.T[::-1])]
        np.testing.assert_array_equal(rows(got), rows(want), err_msg=atoms)
    for key in ("cutoff", "method", "ewald_tolerance",
                "dispersion_correction", "switch_distance", "cmm_frequency"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("group", ["all", 0, 1, 2, 3])
def test_double_energy_and_forces_by_group_match_reference(bilayer, group):
    jsys, pos, _, params = bilayer
    groups = -1 if group == "all" else {group}
    jctx = _jax_context(jsys, "Reference")
    jctx.setPositions(pos)
    ref = jctx.getState(getEnergy=True, getForces=True, groups=groups)
    e_ref = ref.getPotentialEnergy()._value
    f_ref = _jax_array(ref.getForces(asNumpy=True))
    ctx = _port_context(params, "double")
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True, groups=groups)
    assert abs(st.getPotentialEnergy() - e_ref) <= 1e-9 * abs(e_ref)
    assert np.abs(st.getForces() - f_ref).max() <= \
        1e-9 * np.abs(f_ref).max()


def test_mixed_forces_match_reference_and_cpu(bilayer):
    jsys, pos, _, params = bilayer
    ctx = _port_context(params, "mixed")
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    for platform in ("Reference", "CPU"):
        jctx = _jax_context(jsys, platform)
        jctx.setPositions(pos)
        ref = jctx.getState(getEnergy=True, getForces=True)
        e_ref = ref.getPotentialEnergy()._value
        err = median_relative_error(st.getForces(),
                                    _jax_array(ref.getForces(asNumpy=True)))
        assert err <= 1e-5, (platform, err)
        assert abs(st.getPotentialEnergy() - e_ref) <= 1e-5 * abs(e_ref)


def _start(jsys, pos, params):
    """Constrained positions and velocities (300 K plus DRIFT) from the
    JAX "Reference" Context."""
    rng = np.random.RandomState(5)
    vel = rng.randn(*pos.shape) * np.sqrt(
        omm.BOLTZ * 300.0 / params["masses"])[:, None] + DRIFT
    jctx = _jax_context(jsys, "Reference")
    jctx.setPositions(pos)
    jctx.applyConstraints()
    jctx.setVelocities(vel)
    jctx.applyVelocityConstraints()
    st = jctx.getState(getPositions=True, getVelocities=True)
    return (_jax_array(st.getPositions(asNumpy=True)),
            _jax_array(st.getVelocities(asNumpy=True)))


def test_ten_steps_at_zero_kelvin_match_reference(bilayer):
    jsys, pos, _, params = bilayer
    start, vel = _start(jsys, pos, params)
    jint = mm.LangevinMiddleIntegrator(0.0, 1.0, 0.002)
    jctx = _jax_context(jsys, "Reference", jint)
    jctx.setPositions(start)
    jctx.setVelocities(vel)
    jint.step(10)
    want = _jax_array(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True))
    integ = omm.LangevinMiddleIntegrator(0.0, 1.0, 0.002)
    ctx = _port_context(params, "double", integ)
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    integ.step(10)
    got = ctx.getState(getPositions=True).getPositions()
    assert len(ctx._programs) == 1
    assert np.abs(want - start).max() > 5e-2           # the atoms moved
    assert np.abs(got - want).max() <= 1e-9


def _centre_velocity(vel, masses):
    return (masses[:, None] * vel).sum(axis=0) / masses.sum()


def test_cm_motion_remover_fires_on_the_jax_steps(bilayer):
    """Frequency 10, 11 steps one a call, DRIFT added before each: the
    centre of mass stops on steps 0 and 10 in both packages, and the
    velocities agree to 1e-9 nm/ps after every step."""
    jsys, pos, _, params = bilayer
    start, vel = _start(jsys, pos, params)
    (jcmm,) = [f for f in jsys.getForces()
               if isinstance(f, mm.CMMotionRemover)]
    jcmm.setFrequency(10)
    try:
        jint = mm.LangevinMiddleIntegrator(0.0, 1.0, 0.002)
        jctx = _jax_context(jsys, "Reference", jint)
    finally:
        jcmm.setFrequency(1)
    integ = omm.LangevinMiddleIntegrator(0.0, 1.0, 0.002)
    ctx = _port_context(dict(params, cmm_frequency=10), "double", integ)
    masses = params["masses"]
    readers = {
        "jax": (jctx, jint.step, lambda: _jax_array(jctx.getState(
            getVelocities=True).getVelocities(asNumpy=True))),
        "port": (ctx, integ.step, lambda: ctx.getState(
            getVelocities=True).getVelocities())}
    fired = {"jax": [], "port": []}
    for c, _, _ in readers.values():
        c.setPositions(start)
        c.setVelocities(vel)
    for _ in range(11):
        out = {}
        for name, (c, step, velocities) in readers.items():
            c.setVelocities(velocities() + DRIFT)
            step(1)
            out[name] = velocities()
            speed = np.linalg.norm(_centre_velocity(out[name], masses))
            fired[name].append(bool(speed < 1e-2))
        assert np.abs(out["port"] - out["jax"]).max() <= 1e-9
    assert fired["port"] == fired["jax"] == [
        i % 10 == 0 for i in range(11)]


def test_temperature_counts_the_removed_degrees(bilayer):
    """With a CMMotionRemover the temperature divides by 3n - constraints
    - 3 (StateDataReporter's count), without it by 3n - constraints."""
    _, pos, _, params = bilayer
    n, n_cons = len(pos), len(params["constraint_distances"])
    vel = np.random.RandomState(2).randn(*pos.shape)
    for with_cmm in (True, False):
        p = dict(params)
        if not with_cmm:
            del p["cmm_frequency"]
            p["force_groups"] = {k: g for k, g in p["force_groups"].items()
                                 if k != "cmm"}
        ctx = _port_context(p, "mixed")
        ctx.setPositions(pos)
        ctx.setVelocities(vel)
        dof = 3 * n - n_cons - (3 if with_cmm else 0)
        assert ctx.temperature() == pytest.approx(
            2.0 * ctx.kinetic_energy() / (dof * omm.BOLTZ), rel=1e-15)


def test_chip_smoke_bilayer_phase_on_cpu(bilayer):
    """chip_smoke.py's bilayer phase, rehearsed on the cropped bilayer
    with a short minimization and 2 + 2 steps: every gate holds on the
    CPU, where the program and the eager loop give the same bits."""
    import torch

    import chip_smoke
    _, pos, _, params = bilayer
    out = chip_smoke.phase_bilayer(
        torch.device("cpu"), bilayer=(omm.from_numpy(params), pos),
        steps=2, production=2, energy_every=1, minimize_iterations=2)
    assert out["split"] == (542, 200, 0)
    assert out["graph"]["energies"] == out["eager"]["energies"]
    assert out["minimized"][1] < out["minimized"][0]
    # CPU tensors take the plain versions: no kernel launched
    assert set(out["launches"].values()) == {0}


def test_chip_smoke_rf_bilayer_phase_on_cpu(bilayer):
    """chip_smoke.py's rf bilayer phase (CutoffPeriodic at 1.0 nm, kernel
    1 in MODE_RF on the candidate state), rehearsed on the cropped
    bilayer with 2 + 2 steps: the forces and each group's energy against
    float64, the program against the eager loop in bits."""
    import torch

    import chip_smoke
    _, pos, _, params = bilayer
    out = chip_smoke.phase_rf_bilayer(
        torch.device("cpu"), pos, bilayer=(omm.from_numpy(params), pos),
        steps=4, replay=2, energy_every=1)
    assert out["tiled"] and out["force_err"] <= chip_smoke.FORCE_ERR_BAR
    assert sorted(out["energies"]) == [0, 1, 2, 3, 4]
    assert out["graph"]["energies"] == out["eager"]["energies"]
    assert set(out["launches"].values()) == {0}


def test_chip_smoke_mts_and_amd_bilayer_phases_on_cpu(bilayer):
    """chip_smoke.py's MTS and aMD phases on the cropped bilayer, 2 steps
    each from a hot start: the temperatures, the aMD boost at every
    reading, the eager loop's bits with the variables and the clock."""
    import math

    import torch

    import chip_smoke
    _, pos, _, params = bilayer
    system = omm.from_numpy(params)
    for force in system.getForces():
        force.setForceGroup(chip_smoke.BILAYER_GROUPS[type(force).__name__])
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(chip_smoke.BILAYER_TEMPERATURE,
                                   randomSeed=4)
    state = {"system": system, "context": ctx,
             "graph": {"wall_ms_per_step": 0.0}}
    cpu = torch.device("cpu")
    mts = chip_smoke.phase_mts_bilayer(cpu, state, steps=2, replay=2,
                                       t_range=(0.0, math.inf))
    assert mts["tiles"] == 0
    assert [f.getForceGroup() for f in system.getForces()] == [
        chip_smoke.BILAYER_GROUPS[type(f).__name__]
        for f in system.getForces()]
    amd = chip_smoke.phase_amd_bilayer(cpu, state, steps=2, every=1,
                                       replay=2, t_range=(0.0, math.inf))
    assert amd["effective"] > amd["total"]
