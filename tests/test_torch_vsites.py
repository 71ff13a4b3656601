"""Virtual sites in openmm_tpu_torch against the JAX package: the four site
types' positions (make_vsite_updater), the hand-written spread of their
forces onto their parents (the JAX package takes it from jax.grad), the
TIP4P-Ew builder against ForceField("tip4pew.json"), ten steps of a
TIP4P-Ew box, the molecules, and the Context's checks.

Tolerances: positions of the sites 1e-14 nm (the same arithmetic in
float64); energies 1e-10 relative and forces 1e-10 of the largest force in
float64 against the JAX "Reference" platform; ten steps at 0 K within 1e-9
nm; the float32 step against float64 at the median relative force error
bar of 1e-5.
"""
import numpy as np
import pytest
import jax.numpy as jnp

import openmm_tpu as mm
from openmm_tpu import app
from openmm_tpu import unit as u
from openmm_tpu.app import Modeller
from openmm_tpu.ops.vsites import make_vsite_updater
from openmm_tpu.vec3 import Vec3

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import builders, tip4pew_water_box
from torch_port_helpers import jax_system, median_relative_error, system_params
from openmm_tpu_torch.unit import plain

TOL = 1e-10


def _sites_system():
    """Twelve waters in a 2.4 nm box, eight of them carrying a massless
    charged site each, two of every type (the local-coordinate sites on
    three parents, as TIP5P-like lone pairs); NoCutoff. Returns (from_numpy
    dict, positions with the sites computed)."""
    rng = np.random.RandomState(4)
    system, pos = omm.models.tip3p_water_box(27)
    params = omm.to_numpy(system)
    waters = 12
    n = 3 * waters
    keep = np.arange(n)
    params = {k: (v[keep] if k in ("masses", "charges", "sigma", "epsilon")
                  else v) for k, v in params.items()}
    exc = params["exception_pairs"] < n
    rows = exc.all(axis=1)
    params["exception_pairs"] = params["exception_pairs"][rows]
    params["exception_params"] = params["exception_params"][rows]
    cons = (params["constraint_pairs"] < n).all(axis=1)
    params["constraint_pairs"] = params["constraint_pairs"][cons]
    params["constraint_distances"] = params["constraint_distances"][cons]
    params["method"] = "NoCutoff"
    pos = pos[:n]
    sites = [
        ("average2", (0, 1), (0.7, 0.3)),
        ("average2", (3, 5), (0.4, 0.6)),
        ("average3", (6, 7, 8), (0.786646558, 0.106676721, 0.106676721)),
        ("average3", (9, 10, 11), (0.5, 0.3, 0.2)),
        ("outofplane", (12, 13, 14), (0.2, 0.3, 5.0)),
        ("outofplane", (15, 17, 16), (-0.1, 0.4, -4.0)),
        ("local", (18, 19, 20), (0.5, 0.25, 0.25, -1.0, 1.0, 0.0,
                                 -1.0, 0.0, 1.0, 0.02, 0.03, 0.04)),
        ("local", (21, 22, 23), (1.0, 0.0, 0.0, -1.0, 0.5, 0.5,
                                 0.0, -1.0, 1.0, -0.03, 0.0, 0.05)),
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
        new = [[p, index] for p in parents]
        params["exception_pairs"] = np.concatenate(
            [params["exception_pairs"], new])
        params["exception_params"] = np.concatenate(
            [params["exception_params"], [[0.0, 1.0, 0.0]] * len(parents)])
    params["vsites"] = entries
    system = omm.from_numpy(params)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(np.concatenate([pos, np.zeros((len(sites), 3))]))
    return params, plain(ctx.getState(getPositions=True).getPositions(
        asNumpy=True))


@pytest.fixture(scope="module")
def sites():
    return _sites_system()


def test_site_positions_match_make_vsite_updater(sites):
    params, pos = sites
    jsys = jax_system(params)
    update = make_vsite_updater(jsys, jnp.float64)
    shaken = pos + np.random.RandomState(1).uniform(-0.05, 0.05, pos.shape)
    want = np.asarray(update(jnp.asarray(shaken)))
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(shaken)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(got - want).max() <= 1e-14
    # the parents stay where they were put
    parents = np.asarray(params["masses"]) > 0
    assert np.array_equal(got[parents], shaken[parents])


def _jax_reference(params, pos, integrator=None):
    ctx = mm.Context(jax_system(params),
                     integrator or mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    return ctx


def test_force_spread_matches_jax_grad(sites):
    """The hand-written chain rule of the four types against JAX's
    jax.grad through the site update (forces on the sites are zero in
    both)."""
    params, pos = sites
    st = _jax_reference(params, pos).getState(getEnergy=True,
                                              getForces=True)
    e_ref = float(u.strip(st.getPotentialEnergy()))
    f_ref = np.asarray(u.strip(st.getForces(asNumpy=True)))
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    got = ctx.getState(getEnergy=True, getForces=True)
    assert abs(plain(got.getPotentialEnergy()) - e_ref) <= TOL * abs(e_ref)
    assert np.abs(plain(got.getForces(asNumpy=True)) - f_ref).max() <= \
        TOL * np.abs(f_ref).max()
    sites_rows = np.asarray(params["masses"]) == 0
    assert not plain(got.getForces(asNumpy=True))[sites_rows].any()
    # and in float32 (mixed), the median relative error bar
    ctx32 = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                        "CPU")
    ctx32.setPositions(pos)
    f32 = plain(ctx32.getState(getForces=True).getForces(asNumpy=True))
    parents = ~sites_rows
    assert median_relative_error(f32[parents], f_ref[parents]) <= 1e-5


def _jax_tip4pew_system(waters=3):
    """JAX ForceField("tip4pew.json") on a topology of `waters` waters
    made by Modeller.convertWater("tip4pew") (as tests/test_membrane.py
    builds one), rigid, PME at 0.9 nm in a 3 nm box."""
    top = app.Topology()
    chain = top.addChain("A")
    pos = []
    for i in range(waters):
        r = top.addResidue("HOH", chain, str(i + 1))
        o = top.addAtom("O", app.element.oxygen, r)
        h1 = top.addAtom("H1", app.element.hydrogen, r)
        h2 = top.addAtom("H2", app.element.hydrogen, r)
        top.addBond(o, h1)
        top.addBond(o, h2)
        base = np.array([i * 0.5, 0.0, 0.0])
        pos += [Vec3(*base), Vec3(*(base + [0.09572, 0, 0])),
                Vec3(*(base + [-0.024, 0.0927, 0]))]
    m = Modeller(top, u.Quantity(pos, u.nanometer))
    m.convertWater("tip4pew")
    m.topology.setPeriodicBoxVectors(u.Quantity(
        (Vec3(3, 0, 0), Vec3(0, 3, 0), Vec3(0, 0, 3)), u.nanometer))
    ff = app.ForceField("tip4pew.json")
    return ff.createSystem(m.topology, nonbondedMethod=app.PME,
                           nonbondedCutoff=0.9 * u.nanometer,
                           constraints=app.HBonds, rigidWater=True)


def test_tip4pew_builder_matches_the_forcefield():
    """Per water: masses, nonbonded parameters, the M site, the exceptions
    and the constraints of the JAX ForceField's System, and the site's
    weights in the builder's geometry."""
    jsys = _jax_tip4pew_system(3)
    want = system_params(jsys)
    system, pos = tip4pew_water_box(8)
    got = omm.to_numpy(system)
    n = 12
    for key in ("masses", "charges", "sigma", "epsilon"):
        np.testing.assert_array_equal(got[key][:n], want[key], err_msg=key)
    np.testing.assert_array_equal(got["exception_pairs"][:18],
                                  want["exception_pairs"])
    np.testing.assert_array_equal(got["exception_params"][:18],
                                  want["exception_params"])
    assert got["vsites"][:3] == want["vsites"]

    def per_water(pairs, dist):
        return sorted((tuple(sorted(p)), d) for p, d in zip(pairs, dist))

    np.testing.assert_allclose(
        [d for _, d in per_water(got["constraint_pairs"][:9],
                                 got["constraint_distances"][:9])],
        [d for _, d in per_water(want["constraint_pairs"],
                                 want["constraint_distances"])],
        rtol=1e-15)
    assert [p for p, _ in per_water(got["constraint_pairs"][:9],
                                    got["constraint_distances"][:9])] == \
        [p for p, _ in per_water(want["constraint_pairs"],
                                 want["constraint_distances"])]
    water = pos[:4]
    np.testing.assert_allclose(
        water[3], np.dot(builders.TIP4PEW_M_WEIGHTS, water[:3]), atol=1e-15)
    # the lattice and stream of the TIP3P builder
    _, pos3 = omm.models.tip3p_water_box(8)
    assert np.array_equal(pos.reshape(-1, 4, 3)[:, :3],
                          pos3.reshape(-1, 3, 3))


def test_ten_steps_of_tip4pew_match_jax_reference():
    """64 TIP4P-Ew waters (PME, rigid) from constrained positions and
    velocities: ten LangevinMiddle steps at 0 K and no friction in both
    packages, float64; the sites stay on their parents."""
    system, pos = tip4pew_water_box(64)
    params = omm.to_numpy(system)
    jctx = _jax_reference(params, pos, mm.LangevinMiddleIntegrator(
        0.0, 0.0, 0.002))
    jctx.applyConstraints()
    rng = np.random.RandomState(3)
    vel = rng.randn(*pos.shape) * 0.5 * (params["masses"] > 0)[:, None]
    jctx.setVelocities(vel)
    jctx.applyVelocityConstraints()
    st = jctx.getState(getPositions=True, getVelocities=True)
    start = np.asarray(u.strip(st.getPositions(asNumpy=True)))
    vel = np.asarray(u.strip(st.getVelocities(asNumpy=True)))
    jctx.getIntegrator().step(10)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    integ = omm.LangevinMiddleIntegrator(0.0, 0.0, 0.002)
    ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    integ.step(10)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(want - start).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-9
    w = got.reshape(-1, 4, 3)
    m = np.einsum("k,wkd->wd", builders.TIP4PEW_M_WEIGHTS, w[:, :3])
    assert np.abs(w[:, 3] - m).max() <= 1e-12


def test_every_integrator_keeps_the_sites_on_their_parents():
    """Five steps of each integrator on 27 TIP4P-Ew waters: every site
    within 1e-12 nm of its weighted parents afterwards."""
    system, pos = tip4pew_water_box(27)
    integrators = [
        omm.LangevinMiddleIntegrator(300, 1, 0.002),
        omm.LangevinIntegrator(300, 1, 0.002),
        omm.BrownianIntegrator(300, 100, 0.0005),
        omm.VerletIntegrator(0.001),
        omm.NoseHooverIntegrator(300, 10, 0.001),
        omm.VariableVerletIntegrator(1e-3),
        omm.MTSLangevinIntegrator(300, 1, 0.002, [(0, 1)]),
    ]
    for integ in integrators:
        integ.setRandomNumberSeed(2)
        ctx = omm.Context(system, integ, "CPU")
        ctx.setPositions(pos)
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(300, randomSeed=1)
        integ.step(5)
        w = plain(ctx.getState(getPositions=True).getPositions(
            asNumpy=True)).reshape(-1, 4, 3)
        m = np.einsum("k,wkd->wd", builders.TIP4PEW_M_WEIGHTS, w[:, :3])
        assert np.abs(w[:, 3] - m).max() <= 1e-12, type(integ).__name__


def test_molecules_and_degrees_of_freedom_count_sites_right():
    system, pos = tip4pew_water_box(8)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU")
    molecules = ctx.getMolecules()
    assert molecules == [[4 * w + k for k in range(4)] for w in range(8)]
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300, randomSeed=1)
    vel = plain(ctx.getState(getVelocities=True).getVelocities(asNumpy=True))
    assert not vel[3::4].any()
    # 8 waters: 3 massive particles less 3 constraints each
    ke = ctx.kinetic_energy()
    assert ctx.temperature() == pytest.approx(
        2 * ke / ((3 * 24 - 24) * omm.BOLTZ), rel=1e-12)


def test_context_refuses_a_massive_site_and_chained_sites():
    system, _ = tip4pew_water_box(8)
    system.setParticleMass(3, 1.0)
    with pytest.raises(ValueError, match="mass 0"):
        omm.Context(system, omm.VerletIntegrator(0.001), "CPU")
    system, _ = tip4pew_water_box(8)
    system.setVirtualSite(7, omm.TwoParticleAverageSite(3, 4, 0.5, 0.5))
    with pytest.raises(NotImplementedError, match="virtual site"):
        omm.Context(system, omm.VerletIntegrator(0.001), "CPU")


def test_minimizer_spreads_site_forces_through_autograd(sites):
    """The minimizer's objective, composed with the site positions: its
    gradient is the JAX Reference's (1e-10), the sites' rows zero."""
    params, pos = sites
    jfn = _jax_reference(params, pos)._make_position_energy_fn()
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    fn = ctx._make_position_energy_fn()
    e, f = fn(pos)
    je, jf = jfn(pos)
    jf = np.asarray(jf)
    assert abs(e - je) <= TOL * abs(je)
    assert np.abs(f - jf).max() <= TOL * np.abs(jf).max()


def test_chip_smoke_tip4pew_phases_on_cpu():
    """chip_smoke.phase_tip4pew and phase_mts_tip4pew rehearsed on 216
    waters at a few steps: the gates on the sites, the forces against
    float64, the eager loop's bits and MTS's evaluations by group."""
    import torch
    import chip_smoke
    cpu = torch.device("cpu")
    out = chip_smoke.phase_tip4pew(cpu, n_waters=216, steps=8, replay=4,
                                   relax=((0.0005, 50.0, 80),
                                          (0.001, 50.0, 60)))
    assert out["site_err"] <= chip_smoke.SITE_BAR
    assert out["force_err"] <= chip_smoke.FORCE_ERR_BAR
    mts = chip_smoke.phase_mts_tip4pew(cpu, out, steps=4, replay=2,
                                       t_range=(100.0, 600.0))
    assert mts["after"] <= chip_smoke.SITE_BAR
