"""The NonbondedForce methods other than PME in openmm_tpu_torch against
openmm_tpu: reaction field with periodic boundaries (CutoffPeriodic) and
without (CutoffNonPeriodic), plain Coulomb over every pair (NoCutoff) and
the exact Ewald sum (Ewald).

Systems, from the port's builders (seeded numpy): the 512-water box
(1,536 atoms, so the JAX package takes its neighbour engine, as the port
takes its candidate state at every size) for the periodic methods, with four exceptions that
join waters across the box's faces (so that exceptions with and without
periodic images differ); a droplet of ~100 waters cut from that box and
relaxed by a few float64 minimizer iterations for the non-periodic ones
(every pair, on both sides). The JAX package gets the same numbers
through the JAX System built here.

Bars, those of tests/test_torch_slice.py: the port's float32 path within
1e-5 relative of the JAX "Reference" energy and a median relative force
error <= 1e-5 against the "Reference" and "CPU" platforms; its float64
path the same formulas as "Reference": 1e-10 relative in energy, 1e-10 of
the largest force. The pieces alone (the k-sum, the all-pairs function)
run float64 on both sides: 1e-12 relative in energy, 1e-10 of the largest
force. Trajectories at zero friction and the minimizer keep the bars of
tests/test_torch_slice.py and tests/test_torch_minimize.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu.constants import ONE_4PI_EPS0
from openmm_tpu.ops import pairs as jpairs
from openmm_tpu.ops import pme as jpme

import openmm_tpu_torch as omm
from openmm_tpu_torch.forces.nonbonded import NonbondedModule
from openmm_tpu_torch.models import tip3p_water_box, water_droplet
from openmm_tpu_torch.ops import pairs as tpairs
from openmm_tpu_torch.ops import pme as tpme
from openmm_tpu_torch.ops import tile_pairs
from torch_port_helpers import median_relative_error
from openmm_tpu_torch.unit import plain

NB = omm.NonbondedForce
# (system, method, cutoff nm, switching distance (negative: none),
#  exceptions with periodic images)
CASES = {
    "rf_periodic": ("box", "CutoffPeriodic", 1.0, -1.0, False),
    "rf_periodic_switch_pbc_exceptions": ("box", "CutoffPeriodic", 1.0, 0.8,
                                          True),
    "ewald": ("box", "Ewald", 0.9, -1.0, False),
    "rf_nonperiodic": ("droplet", "CutoffNonPeriodic", 1.2, -1.0, False),
    "rf_nonperiodic_switch": ("droplet", "CutoffNonPeriodic", 1.2, 1.0,
                              False),
    "nocutoff": ("droplet", "NoCutoff", 2.0, -1.0, False),
}


def jax_system(params):
    """The JAX System of a from_numpy dict with a NonbondedForce and
    constraints only."""
    system = mm.System()
    for m in params["masses"]:
        system.addParticle(float(m))
    for (i, j), d in zip(params["constraint_pairs"],
                         params["constraint_distances"]):
        system.addConstraint(int(i), int(j), float(d))
    box = np.asarray(params["box"], np.float64)
    system.setDefaultPeriodicBoxVectors(*(mm.Vec3(*row) for row in box))
    nb = mm.NonbondedForce()
    nb.setNonbondedMethod(getattr(mm.NonbondedForce, params["method"]))
    nb.setCutoffDistance(params["cutoff"])
    nb.setEwaldErrorTolerance(params["ewald_tolerance"])
    nb.setUseDispersionCorrection(params["dispersion_correction"])
    if params["switch_distance"] >= 0:
        nb.setUseSwitchingFunction(True)
        nb.setSwitchingDistance(params["switch_distance"])
    nb.setReactionFieldDielectric(params.get("rf_dielectric", 78.3))
    nb.setExceptionsUsePeriodicBoundaryConditions(
        bool(params.get("exceptions_use_pbc", False)))
    for q, s, e in zip(params["charges"], params["sigma"],
                       params["epsilon"]):
        nb.addParticle(float(q), float(s), float(e))
    for (i, j), (cp, s, e) in zip(params["exception_pairs"],
                                  params["exception_params"]):
        nb.addException(int(i), int(j), float(cp), float(s), float(e))
    system.addForce(nb)
    return system


def _across_faces(pos, box, count=4):
    """`count` pairs of oxygens of different waters that are within 0.5 nm
    of each other through a face of the box but farther than half the box
    apart in the plain coordinates."""
    o = pos[::3]
    widths = np.diag(box)
    d = o[:, None] - o[None]
    img = d - widths * np.round(d / widths)
    near = np.linalg.norm(img, axis=-1) < 0.5
    far = np.linalg.norm(d, axis=-1) > 0.5 * widths.min()
    i, j = np.nonzero(np.triu(near & far, 1))
    return [(3 * a, 3 * b) for a, b in list(zip(i, j))[:count]]


@pytest.fixture(scope="module")
def systems():
    """{"box": (params, positions), "droplet": (params, positions)} at
    PME; each case sets its method."""
    box_sys, box_pos = tip3p_water_box(512)
    params = omm.to_numpy(box_sys)
    pairs = _across_faces(box_pos, params["box"])
    assert len(pairs) == 4
    params["exception_pairs"] = np.concatenate(
        [params["exception_pairs"], np.asarray(pairs, np.int64)])
    params["exception_params"] = np.concatenate(
        [params["exception_params"], np.tile([[-0.25, 0.32, 0.4]], (4, 1))])
    drop_sys, drop_pos = water_droplet(box_pos, params["box"], radius=0.9,
                                       nonbonded_method=NB.NoCutoff)
    ctx = omm.Context(drop_sys, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(drop_pos)
    omm.LocalEnergyMinimizer.minimize(ctx, 10.0, 20)
    drop_pos = plain(ctx.getState(getPositions=True).getPositions(
        asNumpy=True))
    small_sys, small_pos = tip3p_water_box(216)
    return {"box": (params, box_pos),
            "droplet": (omm.to_numpy(drop_sys), drop_pos),
            "small_box": (omm.to_numpy(small_sys), small_pos)}


def _case(systems, name, cases=CASES):
    kind, method, cutoff, switch, exc_pbc = cases[name]
    params, pos = systems[kind]
    params = dict(params, method=method, cutoff=cutoff,
                  switch_distance=switch)
    if exc_pbc:
        params["exceptions_use_pbc"] = True
    return params, pos


def _jax_state(params, pos, platform):
    ctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return st.getPotentialEnergy()._value, \
        np.asarray(st.getForces(asNumpy=True)._value)


def _port_context(params, pos, precision, integ=None):
    ctx = omm.Context(omm.from_numpy(params),
                      integ or omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": precision})
    ctx.setPositions(pos)
    return ctx


def _port_state(params, pos, precision):
    ctx = _port_context(params, pos, precision)
    st = ctx.getState(getEnergy=True, getForces=True)
    return plain(st.getPotentialEnergy()), plain(st.getForces(
        asNumpy=True)), ctx


@pytest.mark.parametrize("name", sorted(CASES))
def test_energy_and_forces_match_jax_platforms(systems, name):
    params, pos = _case(systems, name)
    e_ref, f_ref = _jax_state(params, pos, "Reference")
    e_cpu, f_cpu = _jax_state(params, pos, "CPU")
    e, f, ctx = _port_state(params, pos, "mixed")
    # the periodic methods keep a candidate state, the others take every
    # pair
    assert (ctx._candidates is not None) == (CASES[name][0] == "box")
    assert abs(e - e_ref) < 1e-5 * abs(e_ref)
    assert median_relative_error(f, f_ref) <= 1e-5
    assert median_relative_error(f, f_cpu) <= 1e-5
    e64, f64, _ = _port_state(params, pos, "double")
    assert abs(e64 - e_ref) < 1e-10 * abs(e_ref)
    assert np.abs(f64 - f_ref).max() < 1e-10 * np.abs(f_ref).max()


def test_exceptions_with_periodic_images_differ(systems):
    """The four exceptions across the box's faces change the energy when
    they take minimum images (so the cases above test both settings)."""
    e = [_port_state(_case(systems, name)[0] | {"switch_distance": -1.0},
                     systems["box"][1], "double")[0]
         for name in ("rf_periodic", "rf_periodic_switch_pbc_exceptions")]
    assert abs(e[0] - e[1]) > 1.0


def test_ewald_ksum_matches_jax():
    rng = np.random.RandomState(8)
    n = 40
    box = np.array([[2.1, 0, 0], [0.4, 2.3, 0], [-0.3, 0.5, 2.5]])
    pos = rng.uniform(0, 2.2, (n, 3))
    q = rng.uniform(-1, 1, n)
    q -= q.mean()
    kmax, alpha = [5, 6, 7], 3.0

    def jax_energy(x):
        return jpme.ewald_reciprocal_energy(x, jnp.asarray(q),
                                            jnp.asarray(box), kmax, alpha,
                                            jnp.float64)

    je, jg = jax.value_and_grad(jax_energy)(jnp.asarray(pos))
    m = torch.as_tensor(tpme.ewald_m_vectors(kmax))
    e, f = tpme.ewald_reciprocal_ef(torch.as_tensor(pos),
                                    torch.as_tensor(q),
                                    torch.as_tensor(box), m, alpha)
    assert abs(float(e) - float(je)) < 1e-12 * abs(float(je))
    jf = -np.asarray(jg)
    assert np.abs(f.numpy() - jf).max() < 1e-10 * np.abs(jf).max()
    # the differentiable form: the same energy, autograd gives the forces
    x = torch.as_tensor(pos).requires_grad_()
    e2 = tpme.ewald_reciprocal_energy(x, torch.as_tensor(q),
                                      torch.as_tensor(box), m, alpha)
    (g,) = torch.autograd.grad(e2, x)
    assert float(e2.detach()) == float(e)
    assert torch.equal(-g, f)
    assert tpme.ewald_kmax([2.484] * 3, 2.9203, 5e-4) == \
        jpme.ewald_kmax([2.484] * 3, 2.9203, 5e-4)


def _jax_pair_fn(terms):
    """The JAX package's direct-space pair energy (lj_and_coulomb of
    openmm_tpu/forces/nonbonded.py) for `terms`, float64."""
    def pair_fn(r2, pi, pj):
        inv_r2 = 1.0 / r2
        r = jnp.sqrt(r2)
        sig = 0.5 * (pi["sigma"][:, None] + pj["sigma"][None, :])
        eps4 = 4.0 * jnp.sqrt(pi["epsilon"][:, None] * pj["epsilon"][None])
        s6 = (sig * sig * inv_r2) ** 3
        e = eps4 * s6 * (s6 - 1.0)
        if terms.switch is not None:
            rs = terms.switch[0]
            t = jnp.clip(r - rs, 0.0, None) / (terms.cutoff - rs)
            e = e * (1.0 - t * t * t * (10.0 - 15.0 * t + 6.0 * t * t))
        qq = ONE_4PI_EPS0 * pi["charge"][:, None] * pj["charge"][None, :]
        if terms.coulomb == "rf":
            e = e + qq * (1.0 / r + terms.krf * r2 - terms.crf)
        else:
            e = e + qq / r
        if terms.cutoff is not None:
            e = jnp.where(r2 < terms.cutoff ** 2, e, 0.0)
        return e
    return pair_fn


N2_TERMS = {
    "plain": tpairs.PairTerms("plain"),
    "rf": tpairs.PairTerms("rf", cutoff=0.8, krf=0.9, crf=1.7),
    "rf_switch": tpairs.PairTerms("rf", cutoff=0.8, krf=0.9, crf=1.7,
                                  switch=(0.6, 1.0 / 0.2)),
}


@pytest.mark.parametrize("name", sorted(N2_TERMS))
def test_all_pairs_match_jax_pair_energy_n2(name):
    terms = N2_TERMS[name]
    rng = np.random.RandomState(3)
    n = 150
    box = np.diag([1.9, 2.0, 2.1])
    pos = rng.uniform(0, 1.9, (n, 3))
    charge = rng.uniform(-0.8, 0.8, n)
    sigma = rng.uniform(0.05, 0.15, n)
    eps = rng.uniform(0.1, 0.9, n)
    pairs = [(i, i + 1) for i in range(0, n - 1, 2)] + [(0, 7), (3, 90)]
    excl = jpairs.build_exclusion_table(n, pairs)
    n_pad = jpairs.pad_to_block(n, 64)
    pad = n_pad - n

    def jax_energy(x):
        per_atom = {"charge": jnp.pad(jnp.asarray(charge), (0, pad)),
                    "sigma": jnp.pad(jnp.asarray(sigma), (0, pad),
                                     constant_values=1.0),
                    "epsilon": jnp.pad(jnp.asarray(eps), (0, pad))}
        return jpairs.pair_energy_n2(
            jnp.pad(x, ((0, pad), (0, 0))), jnp.asarray(box),
            _jax_pair_fn(terms), per_atom,
            jnp.asarray(np.pad(excl, ((0, pad), (0, 0)),
                               constant_values=-1)), n, block=64,
            periodic=False, accum_dtype=jnp.float64)

    je, jg = jax.value_and_grad(jax_energy)(jnp.asarray(pos))
    args = [torch.as_tensor(a) for a in (pos, charge, sigma, eps)]
    e, f = tpairs.pair_energy_forces_n2(*args, torch.as_tensor(excl), terms)
    assert abs(float(e) - float(je)) < 1e-12 * abs(float(je))
    jf = -np.asarray(jg)
    assert np.abs(f.numpy() - jf).max() < 1e-10 * np.abs(jf).max()
    x = args[0].clone().requires_grad_()
    e2 = tpairs.AnalyticEnergy.apply(tpairs.pair_energy_forces_n2, x,
                                     *args[1:], torch.as_tensor(excl), terms)
    (g,) = torch.autograd.grad(e2, x)
    assert float(e2.detach()) == float(e) and torch.equal(-g, f)


@pytest.mark.parametrize("precision", ["mixed", "double"])
def test_cutoff_reaction_field(precision):
    """tests/test_nonbonded.py:test_cutoff_reaction_field on the port."""
    eps_solv, cutoff = 78.3, 2.9
    system = omm.System()
    nb = omm.NonbondedForce()
    for _ in range(2):
        system.addParticle(1.0)
        nb.addParticle(1.0, 1.0, 0.0)
    nb.setNonbondedMethod(NB.CutoffNonPeriodic)
    nb.setCutoffDistance(cutoff)
    system.addForce(nb)
    assert nb.getReactionFieldDielectric() == eps_solv
    assert not system.usesPeriodicBoundaryConditions()
    ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": precision})
    ctx.setPositions([[0, 0, 0], [2, 0, 0]])
    krf = (1.0 / cutoff ** 3) * (eps_solv - 1) / (2 * eps_solv + 1)
    crf = (1.0 / cutoff) * 3 * eps_solv / (2 * eps_solv + 1)
    expected = ONE_4PI_EPS0 * (0.5 + krf * 4.0 - crf)
    st = ctx.getState(getEnergy=True, getForces=True)
    assert abs(plain(st.getPotentialEnergy()) - expected) < 1e-5 * abs(
        expected)
    force = ONE_4PI_EPS0 * (1.0 / 4.0 - 2.0 * krf * 2.0)
    assert abs(plain(st.getForces(asNumpy=True))[1,
                                                 0] - force) < 1e-5 * abs(
                                                     force)
    ctx.setPositions([[0, 0, 0], [3.5, 0, 0]])
    assert abs(plain(ctx.getState(
        getEnergy=True).getPotentialEnergy())) < 1e-10


def _zero_friction_run(params, pos, steps, jax_ctx_platform="Reference"):
    rng = np.random.RandomState(5)
    vel = rng.randn(*pos.shape) * np.sqrt(
        omm.BOLTZ * 300.0 / params["masses"])[:, None]
    jint = mm.LangevinMiddleIntegrator(300.0, 0.0, 0.002)
    jctx = mm.Context(jax_system(params), jint,
                      mm.Platform.getPlatformByName(jax_ctx_platform))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    jint.step(steps)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)
    integ = omm.LangevinMiddleIntegrator(300.0, 0.0, 0.002)
    ctx = _port_context(params, start, "mixed", integ)
    ctx.setVelocities(vel)
    integ.step(steps)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    return start, want, got


@pytest.mark.parametrize("name", ["rf_periodic", "nocutoff"])
def test_zero_friction_trajectory_matches_jax_reference(systems, name):
    params, pos = _case(systems, name)
    start, want, got = _zero_friction_run(params, pos, 10)
    assert np.abs(want - start).max() > 1e-3       # the atoms did move
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("name", ["rf_periodic", "rf_nonperiodic"])
def test_program_matches_eager_loop_bitwise(systems, name):
    """The step program (no graph on the CPU) against the eager loop, with
    and without a candidate state."""
    params, pos = _case(systems, name)
    runs = []
    for eager in (False, True):
        integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
        integ.setRandomNumberSeed(11)
        ctx = _port_context(params, pos, "mixed", integ)
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
        (ctx._step_eager if eager else integ.step)(12)
        (program,) = ctx._programs.values() if not eager else (None,)
        if program is not None:
            assert program.graph is None
            assert (program.tiles is None) == (name == "rf_nonperiodic")
        s = ctx._state
        runs.append((s["positions"], s["velocities"], ctx.rebuild_count))
    (p0, v0, r0), (p1, v1, r1) = runs
    assert torch.equal(p0, p1) and torch.equal(v0, v1) and r0 == r1
    assert (r0 > 0) == (name == "rf_periodic")


# the minimizer's cases: the periodic ones on a 216-water box (648 atoms,
# 1.86 nm), whose objective goes through the candidate state as the
# 512-water box's does, at a fifth of its cost
MINIMIZE_CASES = {
    "rf_nonperiodic": CASES["rf_nonperiodic"],
    "rf_periodic": ("small_box", "CutoffPeriodic", 0.8, -1.0, False),
    "ewald": ("small_box", "Ewald", 0.8, -1.0, False),
}


@pytest.mark.parametrize("name", sorted(MINIMIZE_CASES))
def test_minimize_matches_jax_reference_at_rf(systems, name):
    """Five L-BFGS iterations a penalty stage, float64 on both sides, from
    the positions shaken by up to 0.02 nm: on the droplet at
    CutoffNonPeriodic (the reaction field over every pair), and on a water
    box at CutoffPeriodic and at Ewald (the candidate state's objective,
    with the k-sum and the exclusion correction for Ewald)."""
    params, pos = _case(systems, name, MINIMIZE_CASES)
    pos = pos + np.random.RandomState(6).uniform(-0.02, 0.02, pos.shape)
    jctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    mm.LocalEnergyMinimizer.minimize(jctx, 10.0, 5)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)
    e_want = jctx.getState(getEnergy=True).getPotentialEnergy()._value
    ctx = _port_context(params, pos, "double")
    omm.LocalEnergyMinimizer.minimize(ctx, 10.0, 5)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    e_got = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    assert np.abs(got - want).max() < 1e-10
    assert abs(e_got - e_want) < 1e-10 * abs(e_want)


def test_method_bookkeeping(systems):
    """An LJPME Context builds, is periodic and has no dispersion
    correction; the dispersion correction and the wrap of
    getState(enforcePeriodicBox=True) need periodic boundaries; the new
    settings round-trip through to_numpy and from_numpy."""
    params, pos = _case(systems, "nocutoff")
    system = omm.from_numpy(dict(params, method="LJPME", cutoff=0.9))
    ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU")
    assert system.usesPeriodicBoundaryConditions()
    assert ctx._nonbonded.periodic and ctx._candidates is ctx._nonbonded
    assert float(ctx._nonbonded.disp_coeff) == 0.0
    for method, periodic in (("NoCutoff", False),
                             ("CutoffNonPeriodic", False),
                             ("CutoffPeriodic", True), ("Ewald", True)):
        system = omm.from_numpy(dict(params, method=method, cutoff=0.9))
        (nb,) = system.getForces()
        assert system.usesPeriodicBoundaryConditions() == periodic
        assert (nb.dispersion_coefficient() != 0.0) == periodic
    far = pos + 10.0                   # every molecule out of the box
    ctx = _port_context(params, far, "double")
    got = plain(ctx.getState(getPositions=True,
                       enforcePeriodicBox=True).getPositions(asNumpy=True))
    assert np.array_equal(got, far)
    extra = dict(params, rf_dielectric=5.0, exceptions_use_pbc=True)
    back = omm.to_numpy(omm.from_numpy(extra))
    assert back["rf_dielectric"] == 5.0 and back["exceptions_use_pbc"]
    assert "rf_dielectric" not in omm.to_numpy(omm.from_numpy(params))


def test_module_dispatch():
    """Which direct space, reciprocal space and candidate state each
    method takes, and that a non-periodic cutoff ignores the box."""
    system, _ = tip3p_water_box(27)
    (nb,) = system.getForces()
    box = plain(system.getDefaultPeriodicBoxVectors())
    # (all-pairs Coulomb or None: the candidate state, kernel 1's mode,
    #  reciprocal space)
    expect = {NB.NoCutoff: ("plain", None, None),
              NB.CutoffNonPeriodic: ("rf", None, None),
              NB.CutoffPeriodic: (None, tile_pairs.MODE_RF, None),
              NB.Ewald: (None, tile_pairs.MODE_EWALD, "ewald_m"),
              NB.PME: (None, tile_pairs.MODE_EWALD, "bsq_x")}
    for method, (coulomb, mode, recip) in expect.items():
        nb.setNonbondedMethod(method)
        nb.setCutoffDistance(0.4)
        m = NonbondedModule(nb, box, torch.device("cpu"))
        # 81 atoms: the periodic methods keep the candidate state at any
        # size
        assert m.periodic == (coulomb is None)
        assert coulomb is None or m.terms.coulomb == coulomb
        assert coulomb is not None or m.mode == mode
        assert recip is None or hasattr(m, recip)
    nb.setNonbondedMethod(NB.CutoffNonPeriodic)
    nb.setCutoffDistance(5.0)                    # beyond half the box
    NonbondedModule(nb, box, torch.device("cpu"))
    nb.setNonbondedMethod(NB.CutoffPeriodic)
    with pytest.raises(ValueError, match="half the box"):
        NonbondedModule(nb, box, torch.device("cpu"))


def test_tile_budget_holds_at_1nm():
    """At the rf settings' 1.0 nm cutoff (and PME's 0.9 nm) the candidate
    state of the full POPC bilayer and of the 24,000-atom water box's
    lattice start fits the budget calibrated at 0.9 nm, at capacity scale
    1 (the bilayer's fullest row brick at 1.0 nm fills 323 of its 332
    slots); an overflow later in a run grows the capacity through the
    Context's escalation."""
    from openmm_tpu_torch.models import popc_bilayer
    for system, pos in (popc_bilayer(), tip3p_water_box(8000)):
        (nb,) = [f for f in system.getForces()
                 if isinstance(f, omm.NonbondedForce)]
        box = torch.as_tensor(plain(system.getDefaultPeriodicBoxVectors()),
                              dtype=torch.float32)
        for method, cutoff in ((NB.CutoffPeriodic, 1.0), (NB.PME, 0.9)):
            nb.setNonbondedMethod(method)
            nb.setCutoffDistance(cutoff)
            m = NonbondedModule(nb, box.numpy(), torch.device("cpu"))
            st = m.build_state(torch.as_tensor(pos, dtype=torch.float32),
                               box)
            assert int(st["overflow"]) == 0
            assert int(st["count"].max()) <= m.budget()["max_bricks"]
