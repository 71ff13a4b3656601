"""DrudeForce, its ForceField generator and the r -> 0 limits of
openmm_tpu_torch against openmm_tpu.

- DrudeForce (springs with and without anisotropy, Thole-screened pairs,
  with and without periodic boundaries) against the JAX "Reference"
  Context: energy 1e-9 relative, forces 1e-8 of the largest, float64;
  updateParametersInContext.
- The limits at r = 0 (a Drude particle on its parent): the Ewald
  exclusion correction -qq 2 alpha / sqrt(pi) with no force, LJPME's
  dispersion complement c6 alpha^6 / 6, an exclusion's exception term 0,
  the offsets' dE/dlambda, the all-pairs direct space, the minimizer's
  autograd objective and kernel 1's plain version all finite; at r =
  1e-6 nm the values approach the limits.
- ForceField("swm4ndp.json") through Modeller.addSolvent and
  addExtraParticles, and an NTER-(ALA)3-CTER peptide of
  charmm_polar_2019.json: finite energies with every Drude particle on
  its parent; with the Drude particles 1e-3 nm off, energy and forces
  against the JAX twin (torch_port_helpers.drude_twin: the JAX System
  with each Drude particle's exclusions and 1-4 pairs added by hand,
  which its createSystem leaves out).
"""
import math

import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import app as japp

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.forces import nonbonded as pnb
from openmm_tpu_torch.unit import plain
from torch_port_helpers import drude_twin, jax_topology

E_TOL, F_TOL = 1e-9, 1e-8


def _drude_system(mod, periodic):
    system = mod.System()
    for _ in range(10):
        system.addParticle(10.0)
    f = mod.DrudeForce()
    f.addParticle(1, 0, 2, 3, 4, -1.2, 0.0012, 1.3, 0.8)
    f.addParticle(6, 5, -1, -1, -1, -1.5, 0.0009, 1.0, 1.0)
    f.addParticle(8, 7, 9, -1, -1, 1.1, 0.001, 1.2, 1.0)
    f.addScreenedPair(0, 1, 2.6)
    f.addScreenedPair(1, 2, 2.1)
    f.setUsesPeriodicBoundaryConditions(periodic)
    system.addForce(f)
    system.setDefaultPeriodicBoxVectors([1.2, 0, 0], [0, 1.2, 0],
                                        [0, 0, 1.2])
    return system


def _positions(seed=3):
    rng = np.random.RandomState(seed)
    pos = rng.rand(10, 3)
    for d, p in ((1, 0), (6, 5), (8, 7)):
        pos[d] = pos[p] + 0.01 * rng.standard_normal(3)
    return pos


def _compare(psys, jsys, pos, e_tol=E_TOL, f_tol=F_TOL, groups=-1):
    ctx = omm.Context(psys, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True, groups=groups)
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in pos])
    jst = jctx.getState(getEnergy=True, getForces=True, groups=groups)
    e, je = plain(st.getPotentialEnergy()), jst.getPotentialEnergy()._value
    f = plain(st.getForces(asNumpy=True))
    jf = np.asarray(jst.getForces(asNumpy=True)._value)
    assert abs(e - je) <= e_tol * abs(je), (e, je)
    assert np.abs(f - jf).max() <= f_tol * np.abs(jf).max(), \
        np.abs(f - jf).max() / np.abs(jf).max()
    return e, f


@pytest.mark.parametrize("periodic", [False, True])
def test_drude_force_matches_jax_reference(periodic):
    _compare(_drude_system(omm, periodic), _drude_system(mm, periodic),
             _positions())


def test_isotropic_spring_and_update_parameters():
    """E = k r^2 / 2 with k = k_e q^2 / alpha (tests/test_drude.py), and
    new parameters through updateParametersInContext."""
    system = omm.System()
    system.addParticle(1.0)
    system.addParticle(1.0)
    f = omm.DrudeForce()
    f.addParticle(1, 0, -1, -1, -1, 1.5, 0.001, 1, 1)
    system.addForce(f)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    r = 0.01
    ctx.setPositions([[0, 0, 0], [r, 0, 0]])

    def energy():
        return plain(ctx.getState(getEnergy=True).getPotentialEnergy())

    assert abs(energy() - 0.5 * omm.ONE_4PI_EPS0 * 1.5 ** 2 / 0.001 * r * r) \
        < 1e-9 * energy()
    f.setParticleParameters(0, 1, 0, -1, -1, -1, 1.0, 0.002, 1, 1)
    f.updateParametersInContext(ctx)
    assert abs(energy() - 0.5 * omm.ONE_4PI_EPS0 / 0.002 * r * r) \
        < 1e-9 * energy()
    f.setParticleParameters(0, 0, 1, -1, -1, -1, 1.0, 0.002, 1, 1)
    with pytest.raises(ValueError, match="changed"):
        f.updateParametersInContext(ctx)
    jf = mm.DrudeForce()
    jf.addParticle(0, 1, -1, -1, -1, 1.0, 0.002, 1, 1)
    assert f.getParticleParameters(0) == jf.getParticleParameters(0)


# -- the limits at r = 0 ------------------------------------------------
ALPHA = 3.12


def test_exclusion_correction_limit():
    qq = torch.tensor([7.0], dtype=torch.float64)
    box = torch.eye(3, dtype=torch.float64) * 2.0
    idx = torch.tensor([[0, 1]])
    want = -7.0 * 2.0 * ALPHA / math.sqrt(math.pi)
    for r, tol in ((0.0, 0.0), (1e-6, 1e-9)):
        pos = torch.tensor([[0.3, 0.3, 0.3], [0.3 + r, 0.3, 0.3]],
                           dtype=torch.float64)
        e, dedr2, _ = pnb._exclusion_terms(pos, box, idx, qq, ALPHA)
        assert torch.isfinite(dedr2).all()
        assert abs(float(e[0]) - want) <= tol * abs(want), (r, float(e[0]))
        if r == 0.0:
            assert float(dedr2[0]) == 0.0
    # LJPME's complement: c6 alpha^6 / 6 at r = 0
    a2 = 2.5 ** 2
    c6 = torch.tensor([0.004], dtype=torch.float64)
    want6 = a2 ** 3 / 6.0
    for r, tol in ((0.0, 0.0), (1e-6, 1e-9)):
        r2 = torch.tensor([r * r], dtype=torch.float64)
        g6, h8 = pnb.complement_over_r6(a2, r2)
        assert abs(float(g6[0]) - want6) <= tol * want6
        assert torch.isfinite(h8).all()
        pos = torch.tensor([[0.3, 0.3, 0.3], [0.3 + r, 0.3, 0.3]],
                           dtype=torch.float64)
        e, dedr2, _ = pnb._exclusion_terms(pos, box, idx, qq, ALPHA, c6, a2)
        assert torch.isfinite(e).all() and torch.isfinite(dedr2).all()
    # the series meets the direct form where they hand over
    x = pnb.COMPLEMENT_SMALL_X
    r2 = torch.tensor([x / a2 * (1 - 1e-9), x / a2 * (1 + 1e-9)],
                      dtype=torch.float64)
    g6 = pnb.complement_over_r6(a2, r2)[0]
    assert abs(float(g6[0] - g6[1])) < 1e-8 * float(g6[0])


def test_exception_term_of_an_exclusion_at_zero():
    pos = torch.zeros((2, 3), dtype=torch.float64)
    idx = torch.tensor([[0, 1]])
    zero = torch.zeros(1, dtype=torch.float64)
    e, dedr2, _ = pnb._exception_terms(pos, idx, zero, zero + 1.0, zero)
    assert float(e[0]) == 0.0 and float(dedr2[0]) == 0.0


def _pair_system(method, drude_on_parent=True, offsets=False):
    """Two waters' worth of charges with one particle on another and the
    pair excluded, in a 2 nm box."""
    system = omm.System()
    nb = omm.NonbondedForce()
    nb.setNonbondedMethod(method)
    nb.setCutoffDistance(0.8)
    charges = [1.7, -1.7, 0.5, -0.5]
    for i, q in enumerate(charges):
        system.addParticle(15.0 if i % 2 == 0 else 0.4)
        nb.addParticle(q, 0.3 if i % 2 == 0 else 1.0,
                       0.6 if i % 2 == 0 else 0.0)
    nb.addException(0, 1, 0.0, 1.0, 0.0)
    nb.addException(2, 3, 0.0, 1.0, 0.0)
    if offsets:
        nb.addGlobalParameter("lam", 1.0)
        nb.addParticleParameterOffset("lam", 1, -0.1, 0.0, 0.0)
    system.addForce(nb)
    system.setDefaultPeriodicBoxVectors([2, 0, 0], [0, 2, 0], [0, 0, 2])
    pos = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [1.2, 0.9, 0.8],
                    [1.2, 0.9, 0.8]])
    if not drude_on_parent:
        pos[1, 0] += 1e-6
        pos[3, 1] += 1e-6
    return system, pos


@pytest.mark.parametrize("method", ["PME", "LJPME", "NoCutoff", "Ewald"])
def test_particle_on_its_parent_is_finite(method):
    """Energy, forces, the minimizer's objective and its gradient are
    finite with two particles each on its excluded partner; at 1e-6 nm
    apart the energy is within 1e-9 of k_e q^2 / nm of it."""
    m = getattr(omm.NonbondedForce, method)
    out = []
    for on in (True, False):
        system, pos = _pair_system(m, on)
        ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                          {"Precision": "double"})
        ctx.setPositions(pos)
        st = ctx.getState(getEnergy=True, getForces=True)
        e = plain(st.getPotentialEnergy())
        f = plain(st.getForces(asNumpy=True))
        assert np.isfinite(e) and np.isfinite(f).all()
        objective_e, grad = ctx._make_position_energy_fn()(pos)
        assert np.isfinite(objective_e) and np.isfinite(grad).all()
        assert abs(objective_e - e) < 1e-9 * abs(e)
        out.append(e)
    # the pairs' own terms are ~k_e q^2 / nm each and cancel to ~0.004
    assert abs(out[0] - out[1]) < 1e-9 * omm.ONE_4PI_EPS0 * 1.7 ** 2


def test_offsets_derivative_at_zero():
    system, pos = _pair_system(omm.NonbondedForce.PME, offsets=True)
    # a custom force requests dE/dlam, which the offsets read too
    ext = omm.CustomExternalForce("0*lam*x")
    ext.addGlobalParameter("lam", 1.0)
    ext.addEnergyParameterDerivative("lam")
    ext.addParticle(0, [])
    system.addForce(ext)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    d = ctx.getState(getParameterDerivatives=True) \
        .getEnergyParameterDerivatives()["lam"]
    assert np.isfinite(d)


def test_plain_kernel_one_at_zero():
    """Kernel 1's plain version skips the excluded pair by its bit and
    clamps r^2: finite at r = 0, in float32 and float64."""
    system, pos = _pair_system(omm.NonbondedForce.PME)
    for precision in ("mixed", "double"):
        ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                          {"Precision": precision})
        ctx.setPositions(pos)
        f = plain(ctx.getState(getForces=True).getForces(asNumpy=True))
        assert np.isfinite(f).all()


# -- the force fields -------------------------------------------------------
def _offset_drudes(system, pos, scale=1e-3, seed=2):
    drude = [f for f in system.getForces()
             if isinstance(f, omm.DrudeForce)][0]
    rng = np.random.RandomState(seed)
    pos = pos.copy()
    for i in range(drude.getNumParticles()):
        d, p = drude.getParticleParameters(i)[:2]
        step = rng.standard_normal(3)
        pos[d] = pos[p] + scale * step / np.linalg.norm(step)
    return pos


@pytest.fixture(scope="module")
def swm4():
    """216 SWM4-NDP waters from Modeller.addSolvent + addExtraParticles,
    PME 0.9 nm, rigid: (port System, topology, positions, JAX twin)."""
    ff = papp.ForceField("swm4ndp.json")
    modeller = papp.Modeller(papp.Topology(), [])
    modeller.addSolvent(ff, model="tip3p",
                        boxSize=omm.Vec3(1.9, 1.9, 1.9) * pu.nanometer)
    modeller.addExtraParticles(ff)
    kw = dict(nonbondedCutoff=0.9, rigidWater=True)
    system = ff.createSystem(modeller.topology, nonbondedMethod=papp.PME,
                             **kw)
    jsys = japp.ForceField("swm4ndp.json").createSystem(
        jax_topology(modeller.topology), nonbondedMethod=japp.PME, **kw)
    return (system, modeller.topology, plain(modeller.positions),
            drude_twin(jsys, 0.833333, 0.5))


def test_swm4ndp_box(swm4):
    system, top, pos, jsys = swm4
    assert system.getNumParticles() == 5 * 216 == top.getNumAtoms()
    drude = [f for f in system.getForces()
             if isinstance(f, omm.DrudeForce)][0]
    assert drude.getNumParticles() == 216
    nb = [f for f in system.getForces()
          if isinstance(f, omm.NonbondedForce)][0]
    # every pair within a water is excluded: 10 a water
    assert nb.getNumExceptions() == 10 * 216
    d, p = drude.getParticleParameters(0)[:2]
    assert np.array_equal(pos[d], pos[p])
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    assert np.isfinite(plain(st.getPotentialEnergy()))
    assert np.isfinite(plain(st.getForces(asNumpy=True))).all()
    # the twin's energy at 1e-3 nm off, group by group
    _compare(system, jsys, _offset_drudes(system, pos))


def _h_positions(center, neighbours, count, bond=0.1):
    """`count` hydrogens on `center` away from its heavy neighbours:
    along the bisector for one, on a cone of 109.5 degrees for three."""
    axis = sum(center - n for n in neighbours)
    axis = axis / np.linalg.norm(axis)
    if count == 1:
        return [center + bond * axis]
    v = np.cross(axis, [1.0, 0.0, 0.0] if abs(axis[0]) < 0.9
                 else [0.0, 1.0, 0.0])
    v /= np.linalg.norm(v)
    w = np.cross(axis, v)
    c, s = math.cos(math.radians(70.5)), math.sin(math.radians(70.5))
    return [center + bond * (c * axis + s * (math.cos(t) * v
                                             + math.sin(t) * w))
            for t in (0.0, 2.0 * math.pi / 3.0, 4.0 * math.pi / 3.0)]


def alanine_tripeptide(ff):
    """NTER-ALA-ALA-ALA-CTER with every atom of charmm_polar_2019's
    patched templates (Drude particles on their parents, lone pairs on
    their oxygens: the System's virtual sites place them), its backbone
    from chip_smoke.helix_residues: (port Topology, positions nm)."""
    import chip_smoke
    residues = chip_smoke.helix_residues(3)
    heavy = [{name: xyz for name, _, xyz in atoms}
             for _, atoms in residues]
    top = papp.Topology()
    chain = top.addChain()
    pos, made = [], []
    for k in range(3):
        h = heavy[k + 1]
        res = top.addResidue("ALA", chain)
        at = {}

        def add(name, symbol, xyz):
            el = papp.Element.getBySymbol(symbol) if symbol else None
            at[name] = top.addAtom(name, el, res)
            pos.append(np.asarray(xyz, float))

        back = heavy[k]["C"]            # the previous C (ACE's for k = 0)
        nxt = heavy[k + 2]["N"]         # the next N (NME's for k = 2)
        add("N", "N", h["N"])
        if k == 0:
            for i, x in enumerate(_h_positions(h["N"], [h["CA"]], 3)):
                add("HT%d" % (i + 1), "H", x)
        else:
            add("HN", "H", _h_positions(h["N"], [h["CA"], back], 1)[0])
        add("CA", "C", h["CA"])
        add("HA", "H", _h_positions(h["CA"], [h["N"], h["C"], h["CB"]],
                                    1)[0])
        add("CB", "C", h["CB"])
        for i, x in enumerate(_h_positions(h["CB"], [h["CA"]], 3)):
            add("HB%d" % (i + 1), "H", x)
        add("C", "C", h["C"])
        oxygens = (["O"] if k < 2 else ["OT1", "OT2"])
        add(oxygens[0], "O", h["O"])
        if k == 2:
            d = nxt - h["C"]
            add("OT2", "O", h["C"] + 0.125 * d / np.linalg.norm(d))
        # the extra particles in their patched template's order (as
        # Modeller.addExtraParticles adds them), which the JAX package's
        # matcher needs: it maps them in the order they come
        lps = (["LPOA", "LPOB"] if k < 2
               else ["LPT1", "LPT2", "LPT3", "LPT4"])
        extras = ([("DN", "N"), ("DCA", "CA"), ("DC", "C")]
                  + ([("DO", "O")] + [(lp, "O") for lp in lps]
                     + [("DCB", "CB")] if k < 2 else
                     [("DCB", "CB"), ("DOT1", "OT1"), ("DOT2", "OT2")]
                     + [(lp, "OT1") for lp in lps]))
        for name, parent in extras:
            add(name, None, pos[at[parent].index])
        bonds = [("N", "CA"), ("CA", "C"), ("CA", "HA"), ("CA", "CB"),
                 ("CB", "HB1"), ("CB", "HB2"), ("CB", "HB3")]
        bonds += ([("N", "HT1"), ("N", "HT2"), ("N", "HT3")] if k == 0
                  else [("N", "HN")])
        bonds += [("C", o) for o in oxygens]
        for a, b in bonds:
            top.addBond(at[a], at[b])
        if made:
            top.addBond(made[-1]["C"], at["N"])
        made.append(at)
    return top, np.asarray(pos)


def _with_terminal_patches(ff):
    """charmm_polar_2019.json lists no residue its NTER and CTER patches
    apply to (no AllowPatch), so neither package patches a terminal ALA
    by itself: register them, in either package."""
    ff.registerTemplatePatch("ALA", "NTER", 0)
    ff.registerTemplatePatch("ALA", "CTER", 0)
    return ff


def test_charmm_polar_peptide():
    ff = _with_terminal_patches(papp.ForceField("charmm_polar_2019.json"))
    top, pos = alanine_tripeptide(ff)
    system = ff.createSystem(top, nonbondedMethod=papp.NoCutoff)
    drude = [f for f in system.getForces()
             if isinstance(f, omm.DrudeForce)][0]
    assert drude.getNumParticles() == 3 * 5 + 1
    assert drude.getNumScreenedPairs() > 0
    names = [a.name for a in top.atoms()]
    for i in range(drude.getNumParticles()):
        d, p = drude.getParticleParameters(i)[:2]
        assert names[d] == "D" + names[p]
    assert sum(system.isVirtualSite(i) for i in range(len(names))) == 8
    # the lone pairs from their parents; every Drude on its parent
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True, getPositions=True)
    assert np.isfinite(plain(st.getPotentialEnergy()))
    assert np.isfinite(plain(st.getForces(asNumpy=True))).all()
    pos = _offset_drudes(system, plain(st.getPositions(asNumpy=True)))
    jff = _with_terminal_patches(japp.ForceField("charmm_polar_2019.json"))
    jtop = jax_topology(top)
    jsys = drude_twin(jff.createSystem(jtop, nonbondedMethod=japp.NoCutoff),
                      1.0, 1.0, jff, jtop)
    assert sorted(tuple(sorted(drude.getScreenedPairParameters(i)[:2]))
                  for i in range(drude.getNumScreenedPairs())) == sorted(
        tuple(sorted(jd.getScreenedPairParameters(i)[:2]))
        for jd in [f for f in jsys.getForces()
                   if type(f).__name__ == "DrudeForce"]
        for i in range(jd.getNumScreenedPairs()))
    masses = [plain(system.getParticleMass(i))
              for i in range(system.getNumParticles())]
    assert masses == [jsys.getParticleMass(i)._value
                      for i in range(jsys.getNumParticles())]
    _compare(system, jsys, pos)


def test_drude_section_parses(tmp_path):
    """A <DrudeForce> section of an XML force field builds a DrudeForce
    (the port raised on it before the Drude slice)."""
    xml = """<ForceField>
 <AtomTypes>
  <Type name="A" class="A" element="O" mass="15.6"/>
  <Type name="D" class="D" mass="0.4"/>
 </AtomTypes>
 <Residues>
  <Residue name="AD"><Atom name="A" type="A"/><Atom name="D" type="D"/>
  </Residue>
 </Residues>
 <NonbondedForce coulomb14scale="0.5" lj14scale="0.5">
  <Atom type="A" charge="1.0" sigma="0.3" epsilon="0.5"/>
  <Atom type="D" charge="-1.0" sigma="1.0" epsilon="0.0"/>
 </NonbondedForce>
 <DrudeForce>
  <Particle type1="D" type2="A" charge="-1.0" polarizability="0.001"
   thole="1.3"/>
 </DrudeForce>
</ForceField>"""
    path = tmp_path / "ad.xml"
    path.write_text(xml)
    top = papp.Topology()
    res = top.addResidue("AD", top.addChain())
    top.addAtom("A", papp.Element.getBySymbol("O"), res)
    top.addAtom("D", None, res)
    system = papp.ForceField(str(path)).createSystem(top)
    drude = [f for f in system.getForces()
             if isinstance(f, omm.DrudeForce)][0]
    assert drude.getParticleParameters(0)[:2] == (1, 0)
    nb = [f for f in system.getForces()
          if isinstance(f, omm.NonbondedForce)][0]
    assert nb.getNumExceptions() == 1
    assert plain(system.getParticleMass(1)) == 0.4


def test_kernel_one_on_float32_pairs():
    """Kernel 1's plain version on the positions as float32 pairs
    (sorted_positions_fine, what a Context of a System with Drude
    particles runs) against the float64 sweep: on an SWM4-NDP box moved 3
    nm from the origin, where float32 coordinates round the Drudes'
    0.005 nm dipoles, its median force error is under a third of that of
    float32 coordinates; the same pairs, the same bits without low
    parts."""
    from openmm_tpu_torch.ops import tile_pairs as tp
    ff = papp.ForceField("swm4ndp.json")
    modeller = papp.Modeller(papp.Topology(), [])
    modeller.addSolvent(ff, model="tip3p",
                        boxSize=omm.Vec3(1.9, 1.9, 1.9) * pu.nanometer)
    modeller.addExtraParticles(ff)
    system = ff.createSystem(modeller.topology, nonbondedMethod=papp.PME,
                             nonbondedCutoff=0.9, rigidWater=True)
    pos = _offset_drudes(system, plain(modeller.positions), 0.005) + 3.0
    nb = [f for f in system.getForces()
          if isinstance(f, omm.NonbondedForce)][0]
    box64 = torch.as_tensor(plain(system.getDefaultPeriodicBoxVectors()),
                            dtype=torch.float64)
    pos64 = torch.as_tensor(pos, dtype=torch.float64)
    forces = {}
    for dtype in (torch.float64, torch.float32):
        module = pnb.NonbondedModule(nb, box64.numpy(), torch.device("cpu"),
                                     "double" if dtype == torch.float64
                                     else "mixed")
        st = module.build_state(pos64, box64)
        consts = tp.tile_consts(box64.to(dtype), module.tile_scalars)
        args = (st["par4"], st["cand"], st["count"], st["words"], consts,
                module.mode, module.use_switch)
        if dtype == torch.float64:
            want = tp.nonbonded_tiles_plain(
                tp.sorted_positions(pos64, box64, st), *args)
            continue
        coarse = tp.sorted_positions(pos64.float(), box64.float(), st)
        hi, lo = tp.sorted_positions_fine(pos64, box64, st)
        forces["coarse"] = tp.nonbonded_tiles(coarse, *args)
        forces["fine"] = tp.nonbonded_tiles(hi, *args, lo)
        assert torch.equal(tp.nonbonded_tiles(coarse, *args),
                           tp.nonbonded_tiles(coarse, *args, None))
    ref = want[:, :3].numpy()
    errors = {k: float(np.median(np.linalg.norm(f[:, :3].double().numpy()
                                                - ref, axis=1)
                                 / np.maximum(np.linalg.norm(ref, axis=1),
                                              1e-30)))
              for k, f in forces.items()}
    assert errors["fine"] < errors["coarse"] / 3.0, errors
