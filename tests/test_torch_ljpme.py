"""LJPME in openmm_tpu_torch against the JAX package: kernel 1's plain
MODE_LJPME, the dispersion grid through the z-slab path (the plain versions
of kernels 2 and 3 with c6 weights) and the dense differentiable energy,
the dispersion self energy, the whole force on a 512-water box and on the
cropped POPC bilayer, a short minimization and ten steps.

Tolerances: float64 against the JAX "Reference" platform and the JAX
functions in float64, 1e-10 relative in energy and 1e-10 of the largest
force (both evaluate the same formulas). float32 against float64: energy
within 1e-5 relative, the median relative force error at most 1e-5; kernel 1's plain float32 MODE_LJPME against float64 on
the same candidate state within 1e-5 of the largest force. The JAX package
has no LJPME test of its own, so one check is independent of it: in TIP3P
water only the oxygens carry Lennard-Jones, all alike, so Lorentz-Berthelot
and geometric mixing coincide, and LJPME's energy without its shifts at the
cutoff must be the Lennard-Jones lattice sum within the grid's error
(2e-3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u
from openmm_tpu.ops import pme as jpme

import openmm_tpu_torch as omm
from openmm_tpu_torch.forces.nonbonded import NonbondedModule
from openmm_tpu_torch.models import tip3p_water_box
from openmm_tpu_torch.ops import pme as pme_mod
from openmm_tpu_torch.ops import pme_zslab, tile_pairs
from torch_port_helpers import (cropped_bilayer, jax_system,
                                median_relative_error, system_params)
from openmm_tpu_torch.unit import plain

LJPME = omm.NonbondedForce.LJPME
TOL64 = 1e-10
TOL32 = 1e-5


def _jax_state(jsys, pos, platform="Reference"):
    ctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return (float(u.strip(st.getPotentialEnergy())),
            np.asarray(u.strip(st.getForces(asNumpy=True))))


def _state(system, pos, precision):
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": precision})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return plain(st.getPotentialEnergy()), plain(st.getForces(asNumpy=True))


@pytest.fixture(scope="module")
def box512():
    system, pos = tip3p_water_box(512, nonbonded_method=LJPME)
    return system, pos, omm.to_numpy(system)


def test_dispersion_grid_matches_jax(box512):
    """The z-slab dispersion path (plain kernels 2 and 3, the dispersion
    convolution) and the dense energy with its autograd against JAX's
    pme_reciprocal_energy(coulomb=False) and its jax.grad, float64."""
    system, pos, _ = box512
    box = np.asarray(plain(system.getDefaultPeriodicBoxVectors()))
    (nb,) = system.getForces()
    module = NonbondedModule(nb, box, "cpu", "double")
    alpha, grid = module.lj_alpha, module.lj_grid
    c6 = 2.0 * np.sqrt(module.epsilon.numpy()) * module.sigma.numpy() ** 3
    md = jpme.make_pme_recip_data(grid, 5)

    def jax_energy(x):
        return jpme.pme_reciprocal_energy(
            x, jnp.zeros(len(c6)), jnp.asarray(box), grid, 5, alpha,
            *(jnp.asarray(md[k]) for k in ("bsq_x", "bsq_y", "bsq_z")),
            jnp.float64, coulomb=False, c6s=jnp.asarray(c6))

    # tests/conftest.py turns JAX's float64 on
    e_ref, g_ref = jax.value_and_grad(jax_energy)(jnp.asarray(pos))
    e_ref, f_ref = float(e_ref), -np.asarray(g_ref)
    post = torch.as_tensor(pos)
    boxt = torch.as_tensor(box)
    c6t = torch.as_tensor(c6)
    bsq = (module.bsq_x_lj, module.bsq_y_lj, module.bsq_z_lj)
    e, f = pme_zslab.pme_recip_ef(post, c6t, boxt, grid, alpha, bsq,
                                  plain=True, dispersion=True)
    assert abs(float(e) - e_ref) <= TOL64 * abs(e_ref)
    assert np.abs(f.numpy() - f_ref).max() <= TOL64 * np.abs(f_ref).max()
    x = post.clone().requires_grad_(True)
    e_dense = pme_mod.pme_reciprocal_energy(
        x, c6t, boxt, grid, 5, alpha, *bsq, plain=True, coulomb=False)
    (g,) = torch.autograd.grad(e_dense, x)
    assert abs(float(e_dense.detach()) - e_ref) <= TOL64 * abs(e_ref)
    assert np.abs(-g.numpy() - f_ref).max() <= TOL64 * np.abs(f_ref).max()
    self_ref = float(jpme.dispersion_self_energy(jnp.asarray(c6), alpha,
                                                 jnp.float64))
    assert pme_mod.dispersion_self_energy(c6, alpha) == pytest.approx(
        self_ref, rel=1e-14)


def _jax_direct_ljpme(pos, box, charge, sigma, eps, excluded, cutoff,
                      alpha, lj_alpha):
    """Every pair's direct-space energy and forces by the JAX package's
    formulas (nonbonded.py lj_coulomb_ef, LJPME block) in numpy float64
    with the exact erfc and 1 - e^-x (1 + x + x^2/2) taken directly: an
    all-pairs reference for kernel 1's MODE_LJPME."""
    from scipy.special import erfc
    n = len(pos)
    d = pos[:, None] - pos[None]
    widths = np.diag(box)
    d -= np.round(d / widths) * widths
    r2 = (d * d).sum(-1)
    ok = (r2 < cutoff * cutoff) & ~np.eye(n, dtype=bool)
    for i, j in excluded:
        ok[i, j] = ok[j, i] = False
    r2 = np.where(ok, r2, 1.0)
    r = np.sqrt(r2)
    sig = 0.5 * (sigma[:, None] + sigma[None])
    eps4 = 4.0 * np.sqrt(eps[:, None] * eps[None])
    s6 = (sig * sig / r2) ** 3
    e_lj = eps4 * s6 * (s6 - 1.0)
    de = -3.0 * eps4 * s6 * (2.0 * s6 - 1.0) / r2
    c6g = eps4 * (sigma[:, None] * sigma[None]) ** 3
    x = lj_alpha ** 2 * r2
    ex = np.exp(-x)
    p = 1.0 + x + 0.5 * x * x
    coef = c6g / r2 ** 3
    e_lj += coef * (1.0 - ex * p)
    de += -3.0 * coef * (1.0 - ex * (p + x ** 3 / 6.0)) / r2
    dar2c = (lj_alpha * cutoff) ** 2
    shift = -(1.0 - math.exp(-dar2c) * (1.0 + dar2c + 0.5 * dar2c ** 2)) \
        / cutoff ** 6
    sig6c = sig ** 6 / cutoff ** 6
    e_lj += eps4 * sig6c * (1.0 - sig6c) + shift * c6g
    qq = omm.ONE_4PI_EPS0 * charge[:, None] * charge[None]
    e_c = qq / r * erfc(alpha * r)
    de += -qq * (erfc(alpha * r) / r2 + 2.0 / math.sqrt(math.pi) * alpha
                 * np.exp(-alpha * alpha * r2) / r) * 0.5 / r
    e = np.where(ok, e_lj + e_c, 0.0)
    de = np.where(ok, de, 0.0)
    return 0.5 * e.sum(), (-2.0 * de[..., None] * d).sum(axis=1)


def test_kernel1_plain_ljpme_mode(box512):
    """Kernel 1's plain MODE_LJPME on the candidate state: float64 against
    the all-pairs formulas of the JAX package, float32 against float64."""
    system, pos, params = box512
    box = np.asarray(plain(system.getDefaultPeriodicBoxVectors()))
    (nb,) = system.getForces()
    out = {}
    for precision in ("double", "mixed"):
        module = NonbondedModule(nb, box, "cpu", precision)
        dt = module.dtype
        post, boxt = torch.as_tensor(pos, dtype=dt), torch.as_tensor(box)
        st = module.build_state(post, boxt)
        assert int(st["overflow"]) == 0
        consts = tile_pairs.tile_consts(boxt.to(dt), module.tile_scalars)
        out[precision] = tile_pairs.tile_energy_forces(
            post, boxt.to(dt), st, consts, tile_pairs.MODE_LJPME, False,
            plain=True)
    e_ref, f_ref = _jax_direct_ljpme(
        pos, box, params["charges"], params["sigma"], params["epsilon"],
        params["exception_pairs"], plain(nb.getCutoffDistance()), module.alpha,
        module.lj_alpha)
    e64, f64 = (float(out["double"][0]), out["double"][1].numpy())
    assert abs(e64 - e_ref) <= TOL64 * abs(e_ref)
    assert np.abs(f64 - f_ref).max() <= TOL64 * np.abs(f_ref).max()
    e32, f32 = (float(out["mixed"][0]), out["mixed"][1].double().numpy())
    assert abs(e32 - e64) <= TOL32 * abs(e64)
    assert np.abs(f32 - f64).max() <= TOL32 * np.abs(f64).max()


def test_dispersion_complement_float32():
    """The direct form 1 - e^-x (1 + x + x^2/2) (and h) in float32 within
    3e-7 of float64 absolutely, from x = 1e-3 to 20: the cancellation at
    small x costs relative accuracy of g, not more than float32's rounding
    of 1, which is what the c6 / r^6 g term's error can afford (the
    Lennard-Jones terms beside it round at the same level). The float64
    form is the JAX package's."""
    from openmm_tpu_torch.ops.pairs import dispersion_complement
    x = torch.logspace(-3, math.log10(20.0), 400, dtype=torch.float64)
    g, h = dispersion_complement(x)
    ex = torch.exp(-x)
    p = 1.0 + x + 0.5 * x * x
    assert torch.equal(g, 1.0 - ex * p)
    assert torch.allclose(h, 1.0 - ex * (p + x ** 3 / 6.0), rtol=1e-15,
                          atol=1e-15)
    g32, h32 = dispersion_complement(x.float())
    assert (g32.double() - g).abs().max() <= 3e-7
    assert (h32.double() - h).abs().max() <= 3e-7


def test_whole_force_on_512_waters_against_jax(box512):
    system, pos, params = box512
    jsys = jax_system(params)
    e_ref, f_ref = _jax_state(jsys, pos)
    e, f = _state(system, pos, "double")
    assert abs(e - e_ref) <= TOL64 * abs(e_ref)
    assert np.abs(f - f_ref).max() <= TOL64 * np.abs(f_ref).max()
    e32, f32 = _state(system, pos, "mixed")
    e_cpu, f_cpu = _jax_state(jsys, pos, "CPU")
    for e_want, f_want in ((e_ref, f_ref), (e_cpu, f_cpu)):
        assert abs(e32 - e_want) <= TOL32 * abs(e_want)
        assert median_relative_error(f32, f_want) <= TOL32


@pytest.fixture(scope="module")
def bilayer():
    jsys, pos, _ = cropped_bilayer()
    params = system_params(jsys)
    params["method"] = "LJPME"
    return jax_system(params), pos, params


def test_whole_force_on_cropped_bilayer_against_jax(bilayer):
    jsys, pos, params = bilayer
    system = omm.from_numpy(params)
    e_ref, f_ref = _jax_state(jsys, pos)
    e, f = _state(system, pos, "double")
    assert abs(e - e_ref) <= TOL64 * abs(e_ref)
    assert np.abs(f - f_ref).max() <= TOL64 * np.abs(f_ref).max()
    e32, f32 = _state(system, pos, "mixed")
    e_cpu, f_cpu = _jax_state(jsys, pos, "CPU")
    for e_want, f_want in ((e_ref, f_ref), (e_cpu, f_cpu)):
        assert abs(e32 - e_want) <= TOL32 * abs(e_want)
        assert median_relative_error(f32, f_want) <= TOL32


def test_minimization_and_steps_against_jax_reference():
    """On 125 waters, five L-BFGS iterations a stage from the lattice
    start, then ten steps at zero friction (LangevinMiddle at 0 K and
    0/ps), float64 on both sides: positions within 1e-9 nm."""
    system, pos = tip3p_water_box(125, nonbonded_method=LJPME)
    params = omm.to_numpy(system)
    jsys = jax_system(params)
    jctx = mm.Context(jsys, mm.LangevinMiddleIntegrator(0.0, 0.0, 0.002),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    mm.LocalEnergyMinimizer.minimize(jctx, 10.0, 5)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    integ = omm.LangevinMiddleIntegrator(0.0, 0.0, 0.002)
    ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    omm.LocalEnergyMinimizer.minimize(ctx, 10.0, 5)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(got - want).max() <= 1e-9
    vel = np.random.RandomState(2).randn(*pos.shape) * 0.3
    jctx.setVelocities(vel)
    jctx.applyVelocityConstraints()
    vel = np.asarray(u.strip(jctx.getState(getVelocities=True)
                             .getVelocities(asNumpy=True)))
    ctx.setVelocities(vel)
    jctx.getIntegrator().step(10)
    integ.step(10)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(want - pos).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-9


def test_dispersion_energy_matches_a_direct_lattice_sum():
    """Independent of the JAX package: in TIP3P water only the oxygens
    carry Lennard-Jones, all alike, so the grid's geometric mixing is
    exact, and LJPME's energy of the NonbondedForce with the charges off,
    less its energy-only shifts at the cutoff (each pair inside the cutoff
    shifted by -V(rc)), is the full Lennard-Jones lattice sum: here a
    direct sum over the images within 3.7 nm plus the analytic r^-6 tail
    beyond, within 2e-3 (measured 7.8e-4 at the default alpha and grid of
    tolerance 5e-4), where PME without its dispersion correction misses
    by more than 5 %."""
    system, pos = tip3p_water_box(512, nonbonded_method=LJPME)
    params = omm.to_numpy(system)
    params["charges"] = np.zeros_like(params["charges"])
    params["dispersion_correction"] = False
    rc = params["cutoff"]
    sigma, eps = params["sigma"][0], params["epsilon"][0]
    ox = pos[0::3]
    width = params["box"][0, 0]
    total, reach = 0.0, 3.7
    for shift in np.ndindex(5, 5, 5):
        d = ox[:, None] - ox[None] + (np.asarray(shift) - 2) * width
        r2 = (d * d).sum(-1)
        inside = (r2 < reach * reach) & (r2 > 0.0)
        sr6 = (sigma * sigma / np.where(inside, r2, 1.0)) ** 3
        total += 0.5 * np.where(inside, 4.0 * eps * sr6 * (sr6 - 1.0),
                                0.0).sum()
    rho = len(ox) / width ** 3
    total -= len(ox) * 0.5 * rho * 4.0 * math.pi * 4.0 * eps * sigma ** 6 \
        / (3.0 * reach ** 3)
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    energy = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    d = ox[:, None] - ox[None]
    d -= np.round(d / width) * width
    pairs = (np.count_nonzero((d * d).sum(-1) < rc * rc) - len(ox)) / 2
    x = (ctx._nonbonded.lj_alpha * rc) ** 2
    g = 1.0 - math.exp(-x) * (1.0 + x + 0.5 * x * x)
    v_rc = 4.0 * eps * ((sigma / rc) ** 12 - (sigma / rc) ** 6) \
        + 4.0 * eps * sigma ** 6 * g / rc ** 6
    assert abs(energy + pairs * v_rc - total) <= 2e-3 * abs(total)
    pme = _state(omm.from_numpy(dict(params, method="PME")), pos,
                 "double")[0]
    assert abs(pme - total) > 5e-2 * abs(total)


def test_method_constants():
    """The dispersion grid is half as fine as the Coulomb grid (JAX
    pme_grid_size(lj=True)); no dispersion correction under LJPME."""
    system, _ = tip3p_water_box(512, nonbonded_method=LJPME)
    (nb,) = system.getForces()
    widths = np.diag(plain(system.getDefaultPeriodicBoxVectors()))
    alpha = pme_mod.ewald_alpha(0.9, 5e-4)
    assert pme_mod.pme_grid_size(widths, alpha, 5e-4, lj=True) == \
        jpme.pme_grid_size(widths, alpha, 5e-4, lj=True)
    module = NonbondedModule(nb, plain(system.getDefaultPeriodicBoxVectors()),
                             "cpu")
    assert float(module.disp_coeff) == 0.0
    assert module.mode == tile_pairs.MODE_LJPME


def test_chip_smoke_ljpme_bilayer_phase_on_cpu():
    """chip_smoke.phase_ljpme_bilayer rehearsed on a 216-water PME box in
    the bilayer's place (a few steps and minimizer iterations; the
    lattice start, so a wide temperature band): the group energies (the
    reciprocal space in a group of its own) and forces against float64,
    the eager loop's bits; the System's settings restored."""
    import chip_smoke
    system, pos = tip3p_water_box(216)
    out = chip_smoke.phase_ljpme_bilayer(
        torch.device("cpu"), {"system": system, "minimized_positions": pos},
        steps=4, replay=2, iterations=2, t_range=(0.0, 2000.0))
    assert out["force_err"] <= chip_smoke.FORCE_ERR_BAR
    assert chip_smoke.LJPME_RECIP_GROUP in out["energies"]
    (nb,) = system.getForces()
    assert nb.getNonbondedMethod() == omm.NonbondedForce.PME
    assert nb.getReciprocalSpaceForceGroup() == -1
