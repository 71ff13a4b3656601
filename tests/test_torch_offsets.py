"""NonbondedForce's global parameters and parameter offsets, the parameter
setters with updateParametersInContext, and the reciprocal space in a
force group of its own, in openmm_tpu_torch against the JAX package.

Every system is a small TIP3P box (64 waters) whose first waters' charges
and epsilons follow a global parameter `lambda` through particle offsets
(zero at lambda = 0, the full parameters at 1), as an alchemical
free-energy run decouples a solute; a few exceptions follow it too. The
energies and forces are held against the JAX "Reference" platform (float64,
dense) at 1e-9 relative in float64 and against the JAX "CPU" platform.
"""
import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import jax_system, median_relative_error
from openmm_tpu_torch.unit import plain

N_WATERS = 64
DECOUPLED = 4           # waters whose parameters follow lambda
TOL64 = 1e-9            # float64 against the JAX "Reference" platform
FORCE_TOL32 = 1e-5      # median relative force error of float32
ENERGY_TOL32 = 2e-3     # kJ/mol, float32 against the JAX "CPU" platform


def _alchemical(method=omm.NonbondedForce.PME, n_waters=N_WATERS):
    """(from_numpy dict, positions): the box with lambda offsets on its
    first DECOUPLED waters (base charge and epsilon 0, offsets of the
    full values) and on three exceptions (chargeProd and epsilon)."""
    system, pos = tip3p_water_box(n_waters, nonbonded_method=method)
    params = omm.to_numpy(system)
    q, eps = params["charges"].copy(), params["epsilon"].copy()
    atoms = np.arange(3 * DECOUPLED)
    params["charges"][atoms] = 0.0
    params["epsilon"][atoms] = 0.0
    params["global_parameters"] = [("lambda", 1.0), ("mu", 0.25)]
    params["particle_offsets"] = [("lambda", int(i), float(q[i]), 0.0,
                                   float(eps[i])) for i in atoms]
    # an offset of sigma too, on one oxygen, driven by the second parameter
    params["particle_offsets"].append(("mu", 3 * DECOUPLED, 0.0, 0.02, 0.0))
    params["exception_offsets"] = [("lambda", 3 * k, 0.05, 0.0, 0.1)
                                   for k in range(3)]
    params["exception_params"][[0, 3, 6], 1] = 0.08
    return params, pos


def _jax_state(params, pos, platform="Reference", values=None,
               groups=-1, update=None):
    jsys = jax_system(params)
    ctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    for name, value in (values or {}).items():
        ctx.setParameter(name, value)
    if update is not None:
        update(jsys, ctx)
    st = ctx.getState(getEnergy=True, getForces=True, groups=groups)
    return (float(u.strip(st.getPotentialEnergy())),
            np.asarray(u.strip(st.getForces(asNumpy=True))))


def _torch_state(context, groups=-1):
    st = context.getState(getEnergy=True, getForces=True, groups=groups)
    return plain(st.getPotentialEnergy()), plain(st.getForces(asNumpy=True))


def _context(params, pos, precision="double", integrator=None):
    props = {"Precision": "double"} if precision == "double" else None
    ctx = omm.Context(omm.from_numpy(params),
                      integrator or omm.VerletIntegrator(0.001), "CPU",
                      props)
    ctx.setPositions(pos)
    return ctx


def _close(e, f, e_ref, f_ref, tol=TOL64):
    assert abs(e - e_ref) <= tol * abs(e_ref), (e, e_ref)
    scale = np.abs(f_ref).max()
    assert np.abs(f - f_ref).max() <= tol * 1e2 * scale


@pytest.mark.parametrize("method", ["PME", "LJPME", "CutoffPeriodic",
                                    "NoCutoff"])
def test_offsets_at_several_lambdas_against_jax_reference(method):
    params, pos = _alchemical(getattr(omm.NonbondedForce, method))
    ctx = _context(params, pos)
    for lam in (1.0, 0.5, 0.0):
        ctx.setParameter("lambda", lam)
        e, f = _torch_state(ctx)
        e_ref, f_ref = _jax_state(params, pos, values={"lambda": lam})
        _close(e, f, e_ref, f_ref)


def test_offsets_against_jax_cpu_platform_in_float32():
    params, pos = _alchemical()
    ctx = _context(params, pos, precision="mixed")
    ctx.setParameter("lambda", 0.5)
    ctx.setParameter("mu", 1.0)
    e, f = _torch_state(ctx)
    e_ref, f_ref = _jax_state(params, pos, "CPU",
                              values={"lambda": 0.5, "mu": 1.0})
    # both in float32: a total of ~-47 kJ/mol from pair terms of ~2e3
    # kJ/mol in all, each sum rounded at ~1e-7 of its terms
    assert abs(e - e_ref) <= ENERGY_TOL32
    assert median_relative_error(f, f_ref) <= FORCE_TOL32


def test_offsets_equal_a_context_with_the_parameters_built_in():
    """At lambda = 0.5 the offsets give what a System whose parameters
    hold the same effective values gives (float64, 1e-12). lambda's
    default is 0.5 here: the dispersion correction takes the offsets at
    the defaults (as the JAX package and OpenMM take it), not at the
    Context's current values."""
    params, pos = _alchemical()
    params["global_parameters"] = [("lambda", 0.5), ("mu", 0.25)]
    ctx = _context(params, pos)
    built = {k: v for k, v in params.items()
             if k not in ("global_parameters", "particle_offsets",
                          "exception_offsets")}
    built["charges"] = params["charges"].copy()
    built["epsilon"] = params["epsilon"].copy()
    built["sigma"] = params["sigma"].copy()
    built["exception_params"] = params["exception_params"].copy()
    values = {"lambda": 0.5, "mu": 0.25}
    for name, i, cs, ss, es in params["particle_offsets"]:
        built["charges"][i] += values[name] * cs
        built["sigma"][i] += values[name] * ss
        built["epsilon"][i] += values[name] * es
    for name, k, cs, ss, es in params["exception_offsets"]:
        built["exception_params"][k] += values[name] * np.array([cs, ss, es])
    e, f = _torch_state(ctx)
    e_ref, f_ref = _torch_state(_context(built, pos))
    _close(e, f, e_ref, f_ref, tol=1e-12)


def test_set_parameter_in_the_step_program_needs_no_new_program():
    """Steps at lambda 1, 0.5 and 0 through one step program; each chunk
    gives the eager loop's bits from the same snapshot."""
    params, pos = _alchemical()
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(3)
    ctx = _context(params, pos, "mixed", integ)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=4)
    for lam in (1.0, 0.5, 0.0):
        ctx.setParameter("lambda", lam)
        start = ctx._snapshot()
        integ.step(5)
        graph = (ctx._state["positions"].clone(),
                 ctx._state["velocities"].clone())
        ctx._restore(start)
        ctx._step_eager(5)
        assert np.array_equal(graph[0].numpy(),
                              ctx._state["positions"].numpy())
        assert np.array_equal(graph[1].numpy(),
                              ctx._state["velocities"].numpy())
    assert len(ctx._programs) == 1


def _plain(values):
    """A getter's values as plain numbers (both packages' carry units:
    the port's strip through plain, the JAX package's through u.strip)."""
    return [v if isinstance(v, int) else float(u.strip(v))
            for v in plain(values)]


def _update_nonbonded(force):
    for i in range(3 * DECOUPLED, 3 * DECOUPLED + 6):
        q, s, e = _plain(force.getParticleParameters(i))
        force.setParticleParameters(i, 0.5 * q, s, 1.5 * e)
    p1, p2, cp, s, e = _plain(force.getExceptionParameters(1))
    force.setExceptionParameters(1, p1, p2, cp + 0.02, s, e + 0.05)


@pytest.mark.parametrize("method", ["PME", "LJPME", "NoCutoff"])
def test_update_nonbonded_parameters_in_context(method):
    """updateParametersInContext gives a fresh Context's energy and forces
    and the JAX package's after its own update, without a new program."""
    params, pos = _alchemical(getattr(omm.NonbondedForce, method))
    system = omm.from_numpy(params)
    integ = omm.VerletIntegrator(0.001)
    ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    integ.step(2)
    programs = len(ctx._programs)
    ctx.setPositions(pos)
    (nb,) = [f for f in system.getForces()
             if isinstance(f, omm.NonbondedForce)]
    _update_nonbonded(nb)
    nb.updateParametersInContext(ctx)
    e, f = _torch_state(ctx)
    fresh = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                        {"Precision": "double"})
    fresh.setPositions(pos)
    e_fresh, f_fresh = _torch_state(fresh)
    _close(e, f, e_fresh, f_fresh, tol=1e-12)

    def jax_update(jsys, jctx):
        (jnb,) = [g for g in jsys.getForces()
                  if isinstance(g, mm.NonbondedForce)]
        _update_nonbonded(jnb)
        jnb.updateParametersInContext(jctx)

    e_ref, f_ref = _jax_state(params, pos, update=jax_update)
    _close(e, f, e_ref, f_ref)
    integ.step(2)
    assert len(ctx._programs) == programs


def _bonded_params():
    """A small chain molecule in a box: bonds, angles, torsions, RB
    torsions, exceptions and a GBSAOBCForce (NoCutoff)."""
    rng = np.random.RandomState(11)
    n = 8
    pos = np.cumsum(rng.uniform(0.1, 0.15, (n, 3)) * [1, 0.5, 0.3], axis=0)
    pos += rng.uniform(-0.02, 0.02, pos.shape)
    params = {
        "masses": np.full(n, 12.0), "charges": rng.uniform(-0.5, 0.5, n),
        "sigma": np.full(n, 0.3), "epsilon": np.full(n, 0.4),
        "exception_pairs": np.stack([np.arange(n - 1), np.arange(1, n)], 1),
        "exception_params": np.tile([[0.0, 1.0, 0.0]], (n - 1, 1)),
        "constraint_pairs": np.zeros((0, 2), np.int64),
        "constraint_distances": np.zeros(0), "box": np.diag([3.0] * 3),
        "cutoff": 1.0, "method": "NoCutoff", "ewald_tolerance": 5e-4,
        "dispersion_correction": False, "switch_distance": -1.0,
        "bond_pairs": np.stack([np.arange(n - 1), np.arange(1, n)], 1),
        "bond_params": np.tile([[0.15, 3e5]], (n - 1, 1)),
        "angle_triples": np.stack([np.arange(n - 2), np.arange(1, n - 1),
                                   np.arange(2, n)], 1),
        "angle_params": np.tile([[1.9, 400.0]], (n - 2, 1)),
        "torsion_quads": np.stack([np.arange(k, n - 3 + k)
                                   for k in range(4)], 1),
        "torsion_params": np.tile([[3.0, 0.0, 1.5]], (n - 3, 1)),
        "rb_quads": np.stack([np.arange(k, n - 3 + k) for k in range(4)], 1),
        "rb_params": np.tile([[1.0, 0.5, -0.3, 0.2, 0.1, 0.05]],
                             (n - 3, 1)),
        "gb_charges": rng.uniform(-0.5, 0.5, n),
        "gb_radii": np.full(n, 0.17), "gb_scales": np.full(n, 0.8),
        "gb_method": "NoCutoff", "gb_cutoff": 1.0,
        "gb_solute_dielectric": 1.0, "gb_solvent_dielectric": 78.5,
        "gb_surface_energy": 2.25936,
    }
    return params, pos


_CHANGES = {
    "HarmonicBondForce": lambda f: f.setBondParameters(
        2, *plain(f.getBondParameters(2))[:2], 0.16, 2.5e5),
    "HarmonicAngleForce": lambda f: f.setAngleParameters(
        1, *plain(f.getAngleParameters(1))[:3], 2.0, 300.0),
    "PeriodicTorsionForce": lambda f: f.setTorsionParameters(
        0, *plain(f.getTorsionParameters(0))[:4], 2, 0.3, 2.0),
    "RBTorsionForce": lambda f: f.setTorsionParameters(
        1, *plain(f.getTorsionParameters(1))[:4], 0.5, 0.1, 0.2, -0.1,
        0.0, 0.3),
    "GBSAOBCForce": lambda f: f.setParticleParameters(
        3, _plain(f.getParticleParameters(3))[0] * 0.5, 0.15, 0.7),
}


@pytest.mark.parametrize("kind", sorted(_CHANGES))
def test_update_bonded_and_gbsa_parameters_in_context(kind):
    params, pos = _bonded_params()
    system = omm.from_numpy(params)
    ctx = _context(params, pos)
    before = _torch_state(ctx)[0]
    (force,) = [f for f in system.getForces() if type(f).__name__ == kind]
    ctx2 = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                       {"Precision": "double"})
    ctx2.setPositions(pos)
    _CHANGES[kind](force)
    force.updateParametersInContext(ctx2)
    e, f = _torch_state(ctx2)
    fresh = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                        {"Precision": "double"})
    fresh.setPositions(pos)
    _close(e, f, *_torch_state(fresh), tol=1e-12)
    assert abs(e - before) > 1e-6

    def jax_update(jsys, jctx):
        (jf,) = [g for g in jsys.getForces() if type(g).__name__ == kind]
        _CHANGES[kind](jf)
        jf.updateParametersInContext(jctx)

    e_ref, f_ref = _jax_state(params, pos, update=jax_update)
    _close(e, f, e_ref, f_ref)


def test_update_refuses_changed_exceptions_and_terms():
    params, pos = _bonded_params()
    system = omm.from_numpy(params)
    ctx = _context(params, pos)
    ctx2 = omm.Context(system, omm.VerletIntegrator(0.001), "CPU")
    (nb,) = [f for f in system.getForces()
             if isinstance(f, omm.NonbondedForce)]
    p1, p2, cp, s, e = plain(nb.getExceptionParameters(0))
    nb.setExceptionParameters(0, p1, p2 + 2, cp, s, e)
    with pytest.raises(ValueError, match="exceptions"):
        nb.updateParametersInContext(ctx2)
    (bond,) = [f for f in system.getForces()
               if isinstance(f, omm.HarmonicBondForce)]
    bond.addBond(0, 5, 0.3, 1e3)
    with pytest.raises(ValueError, match="terms"):
        bond.updateParametersInContext(ctx2)
    with pytest.raises(ValueError, match="not part"):
        omm.HarmonicBondForce().updateParametersInContext(ctx)


@pytest.mark.parametrize("method,recip_group,include_direct", [
    ("PME", 1, True), ("LJPME", 2, True), ("PME", -1, False),
    ("LJPME", 1, False), ("Ewald", 3, True)])
def test_reciprocal_group_and_direct_space_against_jax(method, recip_group,
                                                       include_direct):
    """getState(groups=...) of every group, and of all, against the JAX
    package's split (nonbonded.py:674-708)."""
    params, pos = _alchemical(getattr(omm.NonbondedForce, method))
    if method == "Ewald":
        params, pos = _alchemical(omm.NonbondedForce.Ewald, 27)
    params["reciprocal_group"] = recip_group
    params["include_direct"] = include_direct
    ctx = _context(params, pos)
    for groups in ({0}, {max(recip_group, 0)}, -1):
        e, f = _torch_state(ctx, groups)
        e_ref, f_ref = _jax_state(params, pos, groups=groups)
        _close(e, f, e_ref, f_ref)


def test_pme_parameters_in_context():
    params, pos = _alchemical(omm.NonbondedForce.LJPME)
    system = omm.from_numpy(params)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU")
    (nb,) = [f for f in system.getForces()
             if isinstance(f, omm.NonbondedForce)]
    jsys = jax_system(params)
    (jnb,) = [f for f in jsys.getForces() if isinstance(f, mm.NonbondedForce)]
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    alpha, *grid = nb.getPMEParametersInContext(ctx)
    want = jnb._resolved_pme_params(jsys)
    assert alpha == pytest.approx(want[0], rel=1e-15)
    assert tuple(grid) == tuple(want[1])
    lj = jnb._resolved_ljpme_params(jsys)
    assert nb.getLJPMEParametersInContext(ctx) == pytest.approx(
        (lj[0], *lj[1]), rel=1e-15)
    del jctx
    # explicit parameters are taken, the grid made FFT-friendly
    params["pme_parameters"] = (3.0, 13, 14, 15)
    params["ljpme_parameters"] = (2.5, 11, 11, 11)
    ctx = _context(params, pos)
    (nb,) = [f for f in ctx.getSystem().getForces()
             if isinstance(f, omm.NonbondedForce)]
    assert nb.getPMEParametersInContext(ctx) == (3.0, 14, 14, 15)
    assert nb.getLJPMEParametersInContext(ctx) == (2.5, 12, 12, 12)
    e, f = _torch_state(ctx)
    e_ref, f_ref = _jax_state(params, pos)
    _close(e, f, e_ref, f_ref)


def test_chip_smoke_offsets_and_checkpoint_phases_on_cpu():
    """chip_smoke.phase_offsets and phase_checkpoint rehearsed on a
    216-water box at a few steps (no capture on the CPU)."""
    import torch
    import chip_smoke
    cpu = torch.device("cpu")
    system, pos = tip3p_water_box(216)
    integ = omm.LangevinMiddleIntegrator(300.0, 50.0, 0.0005)
    integ.setRandomNumberSeed(1)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    integ.step(20)
    offsets = chip_smoke.phase_offsets(cpu, {"context": ctx}, waters=8,
                                       chunk=4)
    assert [r[0] for r in offsets["rows"]] == list(chip_smoke.OFFSET_LAMBDAS)
    out = chip_smoke.phase_checkpoint(cpu, offsets, steps=6)
    assert out["bytes"] > 0
