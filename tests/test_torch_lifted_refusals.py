"""Three things the port refused until now, each against the JAX package:

- a System with more than one NonbondedForce (each its own module; the
  periodic ones' candidate states built together, openmm_tpu_torch/
  forces/nonbonded.py CandidateSet): energies and forces per group
  against the JAX "Reference" platform (1e-10), the step program against
  the eager loop in bits, through a capacity escalation too;
- virtual sites whose parents include a site of an earlier family (the
  JAX updater's order: ops/vsites.py): positions against
  make_vsite_updater (1e-14 nm), forces against jax.grad through the
  update (1e-10 of the largest);
- random numbers inside a CustomIntegrator while block (a seed a step
  from the generator, counter-hashed numbers inside the block): the step
  program against the eager loop in bits, every pass new numbers, and the
  statistics of the uniforms and gaussians.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import unit as u
from openmm_tpu.ops.vsites import make_vsite_updater

import openmm_tpu_torch as omm
from openmm_tpu_torch.integrators.custom import _hashed
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import jax_system

TOL = 1e-10


def _jax_context(params, pos):
    ctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    return ctx


def _context(params, pos, integrator=None, precision="double"):
    props = {"Precision": "double"} if precision == "double" else None
    ctx = omm.Context(omm.from_numpy(params),
                      integrator or omm.VerletIntegrator(0.001), "CPU",
                      props)
    ctx.setPositions(pos)
    return ctx


def _two_nonbonded(method, waters=64):
    """A PME water box of `waters` with a second NonbondedForce (group 2) of
    `method` over the same particles: charges and epsilons scaled, its own
    exceptions (the waters' exclusions), a cutoff of 0.55 nm."""
    system, pos = tip3p_water_box(waters)
    params = omm.to_numpy(system)
    second = {k: params[k] for k in (
        "charges", "sigma", "epsilon", "exception_pairs", "exception_params",
        "ewald_tolerance", "dispersion_correction", "switch_distance")}
    second.update(charges=0.3 * params["charges"],
                  epsilon=0.5 * params["epsilon"], sigma=params["sigma"] * 1.1,
                  method=method, cutoff=0.55, group=2)
    params["extra_nonbonded"] = [second]
    return params, pos


@pytest.mark.parametrize("method", ["PME", "CutoffPeriodic", "NoCutoff"])
def test_two_nonbonded_forces_against_jax_reference(method):
    params, pos = _two_nonbonded(method)
    jctx = _jax_context(params, pos)
    ctx = _context(params, pos)
    for groups in ({0}, {2}, {0, 2}):
        st = jctx.getState(getEnergy=True, getForces=True, groups=groups)
        e_ref = float(u.strip(st.getPotentialEnergy()))
        f_ref = np.asarray(u.strip(st.getForces(asNumpy=True)))
        got = ctx.getState(getEnergy=True, getForces=True, groups=groups)
        assert abs(got.getPotentialEnergy() - e_ref) <= TOL * abs(e_ref)
        assert np.abs(got.getForces() - f_ref).max() <= \
            TOL * np.abs(f_ref).max()


def test_two_nonbonded_forces_step_program_and_escalation():
    """Two PME forces keep one CandidateSet: the step program against the
    eager loop in bits, from a capacity so small that both escalate."""
    params, pos = _two_nonbonded("PME", waters=125)
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(4)
    ctx = _context(params, pos, integ, precision="mixed")
    assert len(ctx._candidates.modules) == 2
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    ctx._candidates.capacity_scale = 0.05
    snap = ctx._snapshot()
    integ.step(8)
    a = ctx.getState(getPositions=True, getVelocities=True)
    scale, escalations = ctx._candidates.capacity_scale, ctx.escalation_count
    assert escalations > 0
    ctx._restore(snap)
    ctx._step_eager(8)
    b = ctx.getState(getPositions=True, getVelocities=True)
    assert np.array_equal(a.getPositions(), b.getPositions())
    assert np.array_equal(a.getVelocities(), b.getVelocities())
    assert ctx._candidates.capacity_scale == scale
    assert all(m.capacity_scale == scale for m in ctx._candidates.modules)
    e = ctx.getState(getEnergy=True).getPotentialEnergy()
    assert np.isfinite(e)


def _chained_sites():
    """Twelve waters (NoCutoff) with sites on sites: a two-particle average
    on an oxygen and a hydrogen; a three-particle average on that site and
    two atoms; an out-of-plane site on the three-particle site; a local
    site on the out-of-plane site and two atoms; and one plain site of
    each family besides. Returns (from_numpy dict, positions)."""
    rng = np.random.RandomState(4)
    system, pos = tip3p_water_box(27)
    params = omm.to_numpy(system)
    n = 36
    for key in ("masses", "charges", "sigma", "epsilon"):
        params[key] = params[key][:n]
    for pairs, values in (("exception_pairs", "exception_params"),
                          ("constraint_pairs", "constraint_distances")):
        keep = (params[pairs] < n).all(axis=1)
        params[pairs] = params[pairs][keep]
        params[values] = params[values][keep]
    params["method"] = "NoCutoff"
    sites = [
        ("average2", (0, 1), (0.7, 0.3)),                         # 36
        ("average3", (36, 3, 4), (0.5, 0.3, 0.2)),                # 37
        ("outofplane", (37, 6, 7), (0.2, 0.3, 5.0)),              # 38
        ("local", (38, 9, 10), (0.5, 0.25, 0.25, -1.0, 1.0, 0.0,
                                -1.0, 0.0, 1.0, 0.02, 0.03, 0.04)),
        ("average2", (12, 13), (0.4, 0.6)),                       # 40
        ("local", (36, 40, 15), (1.0, 0.0, 0.0, -1.0, 0.5, 0.5,
                                 0.0, -1.0, 1.0, -0.03, 0.0, 0.05)),
        ("outofplane", (18, 20, 19), (-0.1, 0.4, -4.0)),          # 42
    ]
    entries = []
    for k, (kind, parents, weights) in enumerate(sites):
        index = n + k
        entries.append((index, kind, parents, weights))
        params["masses"] = np.append(params["masses"], 0.0)
        params["charges"] = np.append(params["charges"],
                                      rng.uniform(-0.6, 0.6))
        params["sigma"] = np.append(params["sigma"], 0.2)
        params["epsilon"] = np.append(params["epsilon"], 0.1)
        excluded = {p for p in parents if p < n} | {
            q for p in parents if p >= n
            for q in entries[p - n][2] if q < n}
        new = [[p, index] for p in sorted(excluded)]
        new += [[p, index] for p in parents if p >= n]
        params["exception_pairs"] = np.concatenate(
            [params["exception_pairs"], new])
        params["exception_params"] = np.concatenate(
            [params["exception_params"], [[0.0, 1.0, 0.0]] * len(new)])
    params["vsites"] = entries
    return params, np.concatenate([pos[:n], np.zeros((len(sites), 3))])


def test_sites_on_sites_against_jax():
    params, pos = _chained_sites()
    shaken = pos + np.random.RandomState(1).uniform(-0.03, 0.03, pos.shape)
    want = np.asarray(make_vsite_updater(jax_system(params), jnp.float64)(
        jnp.asarray(shaken)))
    ctx = _context(params, shaken)
    got = ctx.getState(getPositions=True).getPositions()
    assert np.abs(got - want).max() <= 1e-14
    st = _jax_context(params, want).getState(getEnergy=True, getForces=True)
    e_ref = float(u.strip(st.getPotentialEnergy()))
    f_ref = np.asarray(u.strip(st.getForces(asNumpy=True)))
    out = ctx.getState(getEnergy=True, getForces=True)
    assert abs(out.getPotentialEnergy() - e_ref) <= TOL * abs(e_ref)
    assert np.abs(out.getForces() - f_ref).max() <= TOL * np.abs(f_ref).max()
    assert not out.getForces()[params["masses"] == 0].any()


def test_a_site_on_a_later_family_is_refused():
    params, pos = _chained_sites()
    # a two-particle average on the three-particle site: the JAX order
    # computes the parent after it
    params["vsites"] = params["vsites"] + []
    index, _, _, _ = params["vsites"][4]
    params["vsites"][4] = (index, "average2", (37, 12), (0.5, 0.5))
    with pytest.raises(NotImplementedError, match="computes after"):
        _context(params, pos)


def _drawing_program(passes=3):
    """Velocity Verlet with a while block of `passes` passes that draws a
    per-DOF gaussian and a global uniform each pass, keeping the last
    pass's and their sums."""
    integ = omm.CustomIntegrator(0.001)
    for name in ("i", "u", "usum"):
        integ.addGlobalVariable(name, 0.0)
    for name in ("x1", "g", "gsum", "g2sum"):
        integ.addPerDofVariable(name, 0.0)
    integ.addUpdateContextState()
    integ.addComputePerDof("v", "v+0.5*dt*f/m")
    integ.addComputePerDof("x", "x+dt*v")
    integ.addComputePerDof("x1", "x")
    integ.addConstrainPositions()
    integ.addComputePerDof("v", "v+0.5*dt*f/m+(x-x1)/dt")
    integ.addConstrainVelocities()
    integ.addComputeGlobal("i", "0")
    integ.beginWhileBlock("i < %d" % passes)
    integ.addComputePerDof("g", "gaussian")
    integ.addComputePerDof("gsum", "gsum + g")
    integ.addComputePerDof("g2sum", "g2sum + g*g")
    integ.addComputeGlobal("u", "uniform")
    integ.addComputeGlobal("usum", "usum + u")
    integ.addComputeGlobal("i", "i+1")
    integ.endBlock()
    return integ


def test_draws_inside_a_while_block():
    system, pos = tip3p_water_box(27)
    integ = _drawing_program()
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=1)
    snap = ctx._snapshot()
    integ.step(40)
    a = ctx.getState(getPositions=True, getVelocities=True)
    sums = [integ.getPerDofVariableByName(k) for k in ("gsum", "g2sum")]
    usum = integ.getGlobalVariableByName("usum")
    ctx._restore(snap)
    ctx._step_eager(40)
    b = ctx.getState(getPositions=True, getVelocities=True)
    assert np.array_equal(a.getPositions(), b.getPositions())
    assert np.array_equal(a.getVelocities(), b.getVelocities())
    assert integ.getGlobalVariableByName("usum") == usum
    assert np.array_equal(integ.getPerDofVariableByName("gsum"), sums[0])
    draws = 40 * 3
    gsum, g2sum = (np.asarray(s) for s in sums)
    # per DOF: the mean of 120 gaussians ~ N(0, 1/120)
    means = gsum / draws
    assert abs(means.mean()) < 4.0 / np.sqrt(draws * means.size)
    assert abs(means.std() * np.sqrt(draws) - 1.0) < 0.1
    assert abs((g2sum / draws).mean() - 1.0) < 0.05
    assert abs(usum / draws - 0.5) < 4.0 * np.sqrt(1.0 / 12.0 / draws)


def test_hashed_numbers_statistics():
    """The counter hash alone: 10^5 uniforms in [0, 1) with the moments
    and the spread over deciles of a uniform, gaussians with those of a
    normal, and new numbers for a new counter or seed."""
    import torch
    seed = torch.tensor(12345, dtype=torch.int64)
    one = torch.tensor(1, dtype=torch.int64)
    u1 = _hashed(seed, one, (100000,), False, "cpu").numpy()
    assert u1.min() >= 0.0 and u1.max() < 1.0
    assert abs(u1.mean() - 0.5) < 0.005
    assert abs(u1.var() - 1.0 / 12.0) < 0.002
    counts = np.histogram(u1, bins=10, range=(0.0, 1.0))[0]
    assert np.abs(counts - 10000).max() < 500
    g = _hashed(seed, one, (100000,), True, "cpu").numpy()
    assert abs(g.mean()) < 0.02 and abs(g.std() - 1.0) < 0.02
    assert abs((g ** 4).mean() - 3.0) < 0.1
    u2 = _hashed(seed, one + 1, (100000,), False, "cpu").numpy()
    u3 = _hashed(seed + 1, one, (100000,), False, "cpu").numpy()
    assert abs(np.corrcoef(u1, u2)[0, 1]) < 0.02
    assert abs(np.corrcoef(u1, u3)[0, 1]) < 0.02


def test_step_bodies_read_nothing_from_the_device():
    """The step bodies of two NonbondedForces and of the program that
    draws inside a while block on fake tensors, the build run as before a
    capture: no host read of tensor data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    params, pos = _two_nonbonded("PME")
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    ctx = _context(params, pos, integ, precision="mixed")
    system, water = tip3p_water_box(27)
    drawing = _drawing_program()
    ctx2 = omm.Context(system, drawing, "CPU")
    ctx2.setPositions(water)
    for c, i in ((ctx, integ), (ctx2, drawing)):
        i.step(1)
        program = c._program()
        with FakeTensorMode(allow_non_fake_inputs=True):
            program.body(program.gate_always)
