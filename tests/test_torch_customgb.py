"""CustomGBForce and the Amber GB recipes of openmm_tpu_torch
(forces/customgb.py, app/gbforces.py) against the JAX package.

On the 3-lipid POPC cluster of tests/test_torch_gbsa.py
(popc_obc_cluster(3), 402 atoms) with
110 ions of charge +-0.5 around it (512 particles: a multiple of the JAX
"Reference" platform's pair block, whose padded sweep gives NaN forces
under jax.grad where a padding particle's radius 0 meets 1/or), in
float64: each of the five recipes (HCT, OBC1, OBC2, GBn, GBn2), without
salt or the ACE term and with both, built by the port's build_gb_force
and by the JAX package's from the same charges and per-atom parameters,
held against the JAX "Reference" platform: energy within 1e-10
(relative), forces within 1e-9 of the largest. A hand-built force whose
values read earlier values (a ParticlePair value, a SingleParticle value
of it, a ParticlePair value of both) with exclusions, a global parameter
whose derivative is requested, and both kinds of energy terms, at each of
the three methods: energy 1e-10, forces 1e-9, dE/dparameter 1e-9
(relative). The hand-written chain rule against torch.autograd of the
same energy: 1e-12 of the largest force. updateParametersInContext, ten
steps at 0 K against the JAX "Reference" Context (1e-9 nm), the step body
on fake tensors, the recipes' parameter rules against the cluster's
stored OBC2 radii and screens and, for all five models, against the JAX
standard_gb_parameters of a Topology (exact), and chip_smoke.py's
phase_customgb rehearsed on the CPU.
"""
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u
from openmm_tpu.app import gbforces as jax_gb

import openmm_tpu_torch as omm
from openmm_tpu_torch.app import gbforces
from openmm_tpu_torch.models import builders, popc_obc_cluster
from torch_port_helpers import jax_custom_force, jax_system

E_TOL = 1e-10
F_TOL = 1e-9
D_TOL = 1e-9
AUTOGRAD_TOL = 1e-12
POS_TOL = 1e-9
LIPIDS = 3
IONS = 110
GB_GROUP = 1


def _with_ions(params, pos):
    """IONS ions (22.99 amu, charges +-0.5, sigma 0.3 nm, epsilon 0.1)
    at seeded places within 1.2 nm of the cluster's centre, none nearer
    than 0.3 nm to another particle."""
    rng = np.random.RandomState(11)
    centre = pos.mean(axis=0)
    placed = list(pos)
    while len(placed) < len(pos) + IONS:
        x = centre + rng.uniform(-1.2, 1.2, 3)
        if np.min(np.linalg.norm(np.asarray(placed) - x, axis=1)) > 0.3:
            placed.append(x)
    out = dict(params)
    signs = np.where(np.arange(IONS) % 2 == 0, 0.5, -0.5)
    for key, add in (("masses", np.full(IONS, 22.99)), ("charges", signs),
                     ("sigma", np.full(IONS, 0.3)),
                     ("epsilon", np.full(IONS, 0.1))):
        out[key] = np.concatenate([params[key], add])
    return out, np.asarray(placed)


@pytest.fixture(scope="module")
def cluster():
    """(from_numpy dict without the GB force, positions, elements,
    bonded partners) of the 3-lipid cluster with its ions."""
    system, pos = popc_obc_cluster(LIPIDS)
    params = omm.to_numpy(system)
    for key in [k for k in params if k.startswith("gb_")]:
        del params[key]
    params.pop("force_groups", None)
    params, pos = _with_ions(params, pos)
    data = dict(np.load(builders.BILAYER_DATA))
    elements, partners = builders.lipid_elements(data)
    return (params, pos, elements * LIPIDS + ["Na"] * IONS,
            partners * LIPIDS + [None] * IONS)


def _contexts(params, pos, port_force, jax_force, integrators=None):
    port_force.setForceGroup(GB_GROUP)
    jax_force.setForceGroup(GB_GROUP)
    system = omm.from_numpy(params)
    system.addForce(port_force)
    jsystem = jax_system(params)
    jsystem.addForce(jax_force)
    integ, jinteg = integrators or (omm.VerletIntegrator(0.001),
                                    mm.VerletIntegrator(0.001))
    ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
    jctx = mm.Context(jsystem, jinteg,
                      mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    jctx.setPositions(pos)
    return ctx, jctx


def _readings(ctx, jctx, groups=(GB_GROUP,)):
    st = ctx.getState(getEnergy=True, getForces=True,
                      getParameterDerivatives=True, groups=set(groups))
    jst = jctx.getState(getEnergy=True, getForces=True,
                        getParameterDerivatives=True, groups=set(groups))
    return ((st.getPotentialEnergy(), st.getForces(),
             st.getEnergyParameterDerivatives()),
            (float(u.strip(jst.getPotentialEnergy())),
             np.asarray(u.strip(jst.getForces(asNumpy=True))),
             {k: float(v) for k, v in
              jst.getEnergyParameterDerivatives().items()}))


def _close(got, want):
    e, f, d = got
    e_ref, f_ref, d_ref = want
    assert abs(e - e_ref) <= E_TOL * abs(e_ref), (e, e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL * np.abs(f_ref).max()
    assert set(d) == set(d_ref)
    for name, value in d_ref.items():
        assert abs(d[name] - value) <= D_TOL * max(abs(value), 1e-12)


def _recipe_args(cluster, model, salted):
    params, _, elements, partners = cluster
    gb = gbforces.gb_parameters(model, elements, partners)
    kw = dict(solventDielectric=78.5, soluteDielectric=1.0,
              SA="ACE" if salted else None,
              kappa=gbforces.compute_kappa(0.15) if salted else 0.0)
    return params["charges"], gb, kw


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salt_ace"])
@pytest.mark.parametrize("model", gbforces.MODELS)
def test_recipe_against_jax_reference(cluster, model, salted):
    params, pos = cluster[:2]
    charges, gb, kw = _recipe_args(cluster, model, salted)
    ours = gbforces.build_gb_force(model, charges, gb, **kw)
    theirs = jax_gb.build_gb_force(model, list(charges), gb, **kw)
    ctx, jctx = _contexts(params, pos, ours, theirs)
    got, want = _readings(ctx, jctx)
    assert abs(want[0]) > 1.0
    _close(got, want)


def test_recipe_parameters_match_the_stored_obc_radii(cluster):
    """gb_parameters' OBC2 radii and screens from the elements and their
    bonded partners are those the JAX package's standard_gb_parameters
    gave the lipid template (data/popc_bilayer.npz), and the recipes'
    constants are the JAX package's."""
    data = dict(np.load(builders.BILAYER_DATA))
    elements, partners = builders.lipid_elements(data)
    gb = np.asarray(gbforces.gb_parameters("OBC2", elements, partners))
    assert np.array_equal(gb[:, 0], data["lipid_gb_radius"])
    assert np.array_equal(gb[:, 1], data["lipid_gb_screen"])
    assert gbforces._SCREEN == jax_gb._SCREEN
    assert gbforces._GBN2_ABG == jax_gb._GBN2_ABG
    assert (gbforces.GB_OFFSET, gbforces.GBN2_OFFSET) == (
        jax_gb.GB_OFFSET, jax_gb.GBN2_OFFSET)
    assert gbforces._neck_tables([0.1, 0.13, 0.2], 0.009) == \
        jax_gb._neck_tables([0.1, 0.13, 0.2], 0.009)


# residues beside the lipid that reach the rules a lipid does not: (name,
# [(atom name, element, index of its bonded partner in the residue or
# None)]): an arginine's HE and HH hydrogens (mbondi3), hydrogens on
# sulfur and oxygen (mbondi), a nucleic acid's elements (GBn2's nucleic
# table) and an ion of an element no table lists
_OTHER_RESIDUES = (
    ("ARG", [("N", "N", None), ("H", "H", 0), ("CA", "C", 0),
             ("HA", "H", 2), ("NE", "N", 2), ("HE", "H", 4),
             ("NH1", "N", 4), ("HH11", "H", 6), ("HH12", "H", 6),
             ("SG", "S", 2), ("HG", "H", 9), ("OH", "O", 2),
             ("HO", "H", 11)]),
    ("DA", [("P", "P", None), ("OP1", "O", 0), ("C1'", "C", 1),
            ("H1'", "H", 2), ("N9", "N", 2), ("H9", "H", 4),
            ("S1", "S", 2)]),
    ("NA", [("NA", "Na", None)]))


def _topology_and_rules():
    """A JAX Topology of one lipid of the cluster's template (its elements
    and its bonds and constraints) and _OTHER_RESIDUES, and the
    arguments of the port's gb_parameters for the same atoms: elements,
    first bonded partners' elements, nucleic flags, arginine HE/HH
    indices."""
    from openmm_tpu.app import Element, Topology
    data = dict(np.load(builders.BILAYER_DATA))
    elements, partners = builders.lipid_elements(data)
    top = Topology()
    chain = top.addChain()
    residue = top.addResidue("POP", chain)
    atoms = [top.addAtom("A%d" % i, Element.getBySymbol(e), residue)
             for i, e in enumerate(elements)]
    for a, b in np.concatenate([data["lipid_bond_pairs"],
                                data["lipid_constraint_pairs"]]):
        top.addBond(atoms[a], atoms[b])
    nucleic = [False] * len(elements)
    arg_hydrogens = []
    for name, members in _OTHER_RESIDUES:
        residue = top.addResidue(name, chain)
        first = len(elements)
        for atom_name, symbol, partner in members:
            if name == "ARG" and atom_name.startswith(("HE", "HH")):
                arg_hydrogens.append(len(elements))
            atoms.append(top.addAtom(atom_name, Element.getBySymbol(symbol),
                                     residue))
            elements.append(symbol)
            partners.append(None if partner is None
                            else members[partner][1])
            nucleic.append(name == "DA")
            if partner is not None:
                top.addBond(atoms[first + partner], atoms[-1])
    return top, (elements, partners, nucleic, arg_hydrogens)


@pytest.mark.parametrize("model", gbforces.MODELS)
def test_recipe_parameters_match_jax_standard_gb_parameters(model):
    """gb_parameters' per-atom radius, screen and (GBn2) alpha, beta and
    gamma for a lipid, an arginine, a nucleotide and an ion equal the JAX
    package's standard_gb_parameters of the same Topology (exact)."""
    top, (elements, partners, nucleic, arg_hydrogens) = _topology_and_rules()
    ours = gbforces.gb_parameters(model, elements, partners, nucleic,
                                  arg_hydrogens)
    assert ours == jax_gb.standard_gb_parameters(model, top)
    if model == "GBn2":
        assert sum(row[0] == 0.117 for row in ours) == len(arg_hydrogens)


def _staged_spec(n, charges, method):
    """A CustomGBForce spec whose values read earlier values, with
    exclusions, a global parameter (its derivative requested) and both
    kinds of energy terms."""
    rng = np.random.RandomState(4)
    return {
        "kind": "CustomGBForce", "energy": "", "group": GB_GROUP,
        "globals": [("s", 0.7)], "derivatives": ["s"], "functions": [],
        "periodic": method == 2,
        "parameters": ["q", "a"],
        "terms": [((), [float(q), float(a)]) for q, a in
                  zip(charges, 0.1 + 0.05 * rng.rand(n))],
        "values": [
            ("I", "exp(-r^2/(a1+a2))*(1+0.1*a2)",
             mm.CustomGBForce.ParticlePair),
            ("B", "a/(1+s*I)*(1+0.02*sin(x)*cos(z))",
             mm.CustomGBForce.SingleParticle),
            ("C", "B2*exp(-r/0.5)+0.0005*I1*I2*exp(-r)",
             mm.CustomGBForce.ParticlePairNoExclusions)],
        "energy_terms": [
            ("-s*q^2/B + 0.001*C*I", mm.CustomGBForce.SingleParticle),
            ("q1*q2/sqrt(r^2+B1*B2*exp(-r^2/(4*B1*B2))) + 0.01*s*C1*C2",
             mm.CustomGBForce.ParticlePair)],
        "exclusions": [(i, i + 1) for i in range(0, n - 1, 3)],
        "method": method, "cutoff": 1.2}


@pytest.mark.parametrize("method", [0, 1, 2],
                         ids=["NoCutoff", "CutoffNonPeriodic",
                              "CutoffPeriodic"])
def test_staged_values_and_methods_against_jax_reference(cluster, method):
    params, pos = dict(cluster[0]), cluster[1]
    if method == 2:
        params["box"] = np.diag([4.0, 4.0, 4.0])
        pos = pos - pos.mean(axis=0) + 2.0
    spec = _staged_spec(len(pos), params["charges"], method)
    ctx, jctx = _contexts(params, pos, omm.system.custom_force(spec),
                          jax_custom_force(spec))
    got, want = _readings(ctx, jctx)
    _close(got, want)
    for value in (0.3, 1.4):
        ctx.setParameter("s", value)
        jctx.setParameter("s", value)
        _close(*_readings(ctx, jctx))


@pytest.mark.parametrize("which", ["GBn2_salt_ace", "staged"])
def test_chain_rule_against_autograd(cluster, which):
    """The analytic forces of ef against torch.autograd of the same
    energy (its forward pass differentiated) in float64."""
    params, pos = cluster[:2]
    if which == "staged":
        force = omm.system.custom_force(_staged_spec(
            len(pos), params["charges"], 1))
    else:
        charges, gb, kw = _recipe_args(cluster, "GBn2", True)
        force = gbforces.build_gb_force("GBn2", charges, gb, cutoff=2.0,
                                        **kw)
        force.setNonbondedMethod(omm.CustomGBForce.CutoffNonPeriodic)
        force.setCutoffDistance(2.0)
    system = omm.from_numpy(params)
    system.addForce(force)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    (module,) = ctx._custom
    x = torch.as_tensor(pos, dtype=torch.float64).requires_grad_(True)
    box = ctx._box
    energy, forces, _ = module._compute(x, box, False)
    (grad,) = torch.autograd.grad(energy, x)
    scale = forces.detach().abs().max()
    assert float((forces.detach() + grad).abs().max()) <= (
        AUTOGRAD_TOL * float(scale))


def test_update_parameters_in_context(cluster):
    params, pos = cluster[:2]
    charges, gb, kw = _recipe_args(cluster, "OBC1", True)
    ours = gbforces.build_gb_force("OBC1", charges, gb, **kw)
    theirs = jax_gb.build_gb_force("OBC1", list(charges), gb, **kw)
    integ = omm.VerletIntegrator(0.001)
    ctx, jctx = _contexts(params, pos, ours, theirs,
                          (integ, mm.VerletIntegrator(0.001)))
    integ.step(1)
    programs = dict(ctx._programs)
    ctx.setPositions(pos)
    for c, force in ((ctx, ours), (jctx, theirs)):
        for i in range(0, force.getNumParticles(), 5):
            p = list(force.getParticleParameters(i))
            p[0] = -0.5 * p[0] + 0.1
            force.setParticleParameters(i, p)
        force.updateParametersInContext(c)
    _close(*_readings(ctx, jctx))
    assert ctx._programs == programs


def test_ten_steps_at_zero_kelvin_match_jax_reference(cluster):
    """Ten LangevinMiddle steps at 0 K and no friction under every force
    with the GBn2 recipe, from constrained positions and seeded
    velocities, in both packages."""
    params, pos = cluster[:2]
    charges, gb, kw = _recipe_args(cluster, "GBn2", True)
    ctx, jctx = _contexts(
        params, pos, gbforces.build_gb_force("GBn2", charges, gb, **kw),
        jax_gb.build_gb_force("GBn2", list(charges), gb, **kw),
        (omm.LangevinMiddleIntegrator(0.0, 0.0, 0.002),
         mm.LangevinMiddleIntegrator(0.0, 0.0, 0.002)))
    jctx.applyConstraints()
    vel = np.random.RandomState(3).randn(*pos.shape) * 0.3
    jctx.setVelocities(vel)
    jctx.applyVelocityConstraints()
    st = jctx.getState(getPositions=True, getVelocities=True)
    start = np.asarray(u.strip(st.getPositions(asNumpy=True)))
    ctx.setPositions(start)
    ctx.setVelocities(np.asarray(u.strip(st.getVelocities(asNumpy=True))))
    jctx.getIntegrator().step(10)
    ctx.getIntegrator().step(10)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    got = ctx.getState(getPositions=True).getPositions()
    assert np.abs(want - start).max() > 1e-3
    assert np.abs(got - want).max() <= POS_TOL


def test_step_body_reads_nothing_from_the_device(cluster):
    """The step body with the salted GBn2 recipe (its Discrete2D neck
    tables and three pair sweeps) on fake tensors, as before a capture."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    params, pos = cluster[:2]
    charges, gb, kw = _recipe_args(cluster, "GBn2", True)
    force = gbforces.build_gb_force("GBn2", charges, gb,
                                    cutoff=builders.OBC_CUTOFF, **kw)
    force.setNonbondedMethod(omm.CustomGBForce.CutoffNonPeriodic)
    force.setCutoffDistance(builders.OBC_CUTOFF)
    system = omm.from_numpy(params)
    system.addForce(force)
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    integ.step(1)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)


def test_popc_gb_cluster_builder():
    system, pos = builders.popc_gb_cluster("GBn2", 2)
    kinds = [type(f).__name__ for f in system.getForces()]
    assert kinds[-1] == "CustomGBForce" and "GBSAOBCForce" not in kinds
    gb = system.getForces()[-1]
    assert gb.getNumPerParticleParameters() == 7
    assert gb.getNonbondedMethod() == omm.CustomGBForce.CutoffNonPeriodic
    assert len(pos) == system.getNumParticles() == 268


def test_from_numpy_round_trip(cluster):
    params, pos = cluster[:2]
    charges, gb, kw = _recipe_args(cluster, "GBn2", True)
    force = gbforces.build_gb_force("GBn2", charges, gb, **kw)
    system = omm.from_numpy(params)
    system.addForce(force)
    (spec,) = omm.to_numpy(system)["custom_forces"]
    again = omm.system.custom_force(spec)
    assert again._values == force._values
    assert again._energy_terms == force._energy_terms
    assert again._particles == force._particles
    assert [n for n, _ in again._functions] == ["getd0", "getm0"]
    theirs = jax_custom_force(spec)
    assert theirs._values == force._values


def test_chip_smoke_customgb_phase_on_cpu():
    """chip_smoke.py's phase_customgb rehearsed on a 2-lipid cluster (4
    steps, 2 replayed): every gate holds on the CPU."""
    import math

    import chip_smoke
    out = chip_smoke.phase_customgb(torch.device("cpu"), lipids=2, steps=4,
                                    replay=2, iterations=2,
                                    t_range=(0.0, math.inf))
    assert max(out["recipe_err"]) <= chip_smoke.RECIPE_BAR
    assert out["minimized"][1] < out["minimized"][0]
