"""Modeller of openmm_tpu_torch against openmm_tpu's on the same inputs.

add, delete, deleteWater, addSolvent (with neutralize and ionicStrength:
both packages draw the waters from RandomState(59173) and the ions from
RandomState(81733)), convertWater (tip4pew, tip5p) and addExtraParticles
give the same topology (names, residues, bonds, box) with positions
within 1e-12 nm. addHydrogens on ACE-ALA-ALA-ALA-NME (an ideal helix's
heavy atoms, chip_smoke.helix_pdb_text) gives the same atoms and
variants; its relaxation (60 L-BFGS iterations on the new hydrogens,
heavy atoms massless) runs in float64 on both sides (the JAX "Reference"
platform, the port's "CPU" platform at Precision double) and ends within
the 1e-10 nm of tests/test_torch_minimize.py.
"""
import io

import numpy as np
import pytest

import chip_smoke
import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu import unit as ju
from openmm_tpu.vec3 import Vec3 as JVec3

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.unit import plain
from openmm_tpu_torch.vec3 import Vec3 as PVec3
from torch_port_helpers import port_topology

FF_FILES = ("amber14-all.json", "amber14-tip3p.json")
POS_TOL = 1e-12      # nm


def structure(top):
    """Everything a Topology holds, as plain values in order."""
    atoms = [(a.name, a.element.symbol if a.element else None,
              a.residue.index) for a in top.atoms()]
    residues = [(r.name, r.chain.index) for r in top.residues()]
    bonds = [(b[0].index, b[1].index) for b in top.bonds()]
    box = top.getPeriodicBoxVectors()
    if box is not None:
        box = np.asarray([tuple(v) for v in box._value], np.float64)
    return atoms, residues, bonds, box


def assert_same_model(port, jax):
    """The same structure, and positions within POS_TOL nm."""
    got, want = structure(port.topology), structure(jax.topology)
    for g, w in zip(got[:3], want[:3]):
        assert g == w
    if want[3] is None:
        assert got[3] is None
    else:
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=POS_TOL)
    p = np.asarray(plain(port.getPositions()), np.float64).reshape(-1, 3)
    j = np.asarray([tuple(v) for v in ju.strip(jax.getPositions(),
                                               ju.nanometer)],
                   np.float64).reshape(-1, 3)
    assert p.shape == j.shape
    if len(j):
        assert np.abs(p - j).max() <= POS_TOL


def water_topologies(n, spacing=0.31, box=None, seed=3):
    """(JAX Topology, port Topology, positions (3n, 3) nm) of n TIP3P
    waters on a line of `spacing` nm, turned at random from a seed."""
    rng = np.random.RandomState(seed)
    ref = np.array([[0.0, 0.0, 0.0], [0.09572, 0.0, 0.0],
                    [-0.02399, 0.09266, 0.0]])
    top = japp.Topology()
    chain = top.addChain("W")
    pos = []
    for i in range(n):
        res = top.addResidue("HOH", chain, str(i + 1))
        o = top.addAtom("O", japp.Element.getBySymbol("O"), res)
        for name in ("H1", "H2"):
            h = top.addAtom(name, japp.Element.getBySymbol("H"), res)
            top.addBond(o, h)
        q, _ = np.linalg.qr(rng.randn(3, 3))
        pos.extend(ref @ q.T + [i * spacing, 0.1 * i % 0.7, 0.2])
    if box is not None:
        top.setPeriodicBoxVectors(ju.Quantity(
            (JVec3(box, 0, 0), JVec3(0, box, 0), JVec3(0, 0, box)),
            ju.nanometer))
    return top, port_topology(top), np.asarray(pos, np.float64)


def pair(jtop, ptop, pos):
    """The two packages' Modellers of the same model."""
    jm = japp.Modeller(jtop, ju.Quantity([JVec3(*p) for p in pos],
                                         ju.nanometer))
    pm = papp.Modeller(ptop, pu.Quantity([PVec3(*p) for p in pos],
                                         pu.nanometer))
    return pm, jm


def test_add_delete_and_delete_water_match_jax():
    pm, jm = pair(*water_topologies(4, box=3.0))
    jt2, pt2, pos2 = water_topologies(3, seed=5)
    pos2 = pos2 + [0.0, 1.0, 1.0]
    jm.add(jt2, ju.Quantity([JVec3(*p) for p in pos2], ju.nanometer))
    pm.add(pt2, pu.Quantity([PVec3(*p) for p in pos2], pu.nanometer))
    assert_same_model(pm, jm)
    assert pm.topology.getNumAtoms() == 21
    # a residue, an atom and a bond go
    for m in (pm, jm):
        residues = list(m.topology.residues())
        atoms = list(m.topology.atoms())
        bonds = list(m.topology.bonds())
        m.delete([residues[1], atoms[14], bonds[0]])
    assert_same_model(pm, jm)
    assert pm.topology.getNumAtoms() == 17
    for m in (pm, jm):
        m.deleteWater()
    assert_same_model(pm, jm)
    assert pm.topology.getNumAtoms() == 0


def ion_solute():
    """(JAX Topology, port Topology, positions): one Na+ in no box."""
    top = japp.Topology()
    res = top.addResidue("NA", top.addChain("I"))
    top.addAtom("NA", japp.Element.getBySymbol("Na"), res)
    return top, port_topology(top), np.zeros((1, 3))


@pytest.mark.parametrize("neutralize,ionic", [(False, 0.0), (True, 0.0),
                                              (True, 0.5)])
def test_add_solvent_matches_jax(neutralize, ionic):
    """The same waters and ions: the Na+ solute's charge is neutralized
    by one Cl-, and 0.5 M adds pairs."""
    pm, jm = pair(*ion_solute())
    jff, pff = japp.ForceField(*FF_FILES), papp.ForceField(*FF_FILES)
    jm.addSolvent(jff, boxSize=JVec3(2.2, 2.2, 2.2), neutralize=neutralize,
                  ionicStrength=ionic * ju.molar)
    pm.addSolvent(pff, boxSize=PVec3(2.2, 2.2, 2.2), neutralize=neutralize,
                  ionicStrength=ionic * pu.molar)
    assert_same_model(pm, jm)
    names = [r.name for r in pm.topology.residues()]
    waters = names.count("HOH")
    pairs = int(round(ionic * waters / 55.4)) if ionic else 0
    assert waters > 300
    assert names.count("CL") == pairs + (1 if neutralize else 0)
    assert names.count("NA") == 1 + pairs


def test_add_solvent_by_padding_matches_jax():
    pm, jm = pair(*water_topologies(2))
    jm.addSolvent(padding=0.6 * ju.nanometer)
    pm.addSolvent(padding=0.6 * pu.nanometer)
    assert_same_model(pm, jm)


@pytest.mark.parametrize("model,sites", [("tip4pew", 4), ("tip5p", 5),
                                         ("spce", 3)])
def test_convert_water_matches_jax(model, sites):
    pm, jm = pair(*water_topologies(3, box=2.0))
    jm.convertWater(model)
    pm.convertWater(model)
    assert_same_model(pm, jm)
    assert pm.topology.getNumAtoms() == 3 * sites


def test_add_extra_particles_matches_jax():
    """TIP4P-Ew's template has a virtual site M: each 3-site water gains
    it at its average of O, H1 and H2."""
    files = ("amber14-all.json", "amber14-tip4pew.json")
    pm, jm = pair(*water_topologies(3, box=2.0))
    jm.addExtraParticles(japp.ForceField(*files))
    pm.addExtraParticles(papp.ForceField(*files))
    assert_same_model(pm, jm)
    assert pm.topology.getNumAtoms() == 12


@pytest.fixture(scope="module")
def peptide_text():
    """ACE-ALA-ALA-ALA-NME, an ideal alpha helix's heavy atoms."""
    return chip_smoke.helix_pdb_text(3)


def _double_relaxation(monkeypatch):
    """Both relaxations in float64: the JAX Context on "Reference", the
    port's "CPU" platform at Precision double."""
    reference = mm.Platform.getPlatformByName("Reference")
    monkeypatch.setattr(mm.Platform, "findPlatform",
                        staticmethod(lambda *a, **k: reference))
    cpu = omm.Platform.getPlatformByName("CPU")
    monkeypatch.setitem(cpu._defaults, "Precision", "double")
    return cpu


@pytest.mark.parametrize("variants", [None, [None, None, None, None, None]])
def test_add_hydrogens_matches_jax(peptide_text, monkeypatch, variants):
    cpu = _double_relaxation(monkeypatch)
    jpdb = japp.PDBFile(io.StringIO(peptide_text))
    ppdb = papp.PDBFile(io.StringIO(peptide_text))
    jm = japp.Modeller(jpdb.topology, jpdb.positions)
    pm = papp.Modeller(ppdb.topology, ppdb.positions)
    # the heavy atoms as written: the same model before the hydrogens
    assert_same_model(pm, jm)
    before = plain(pm.getPositions())
    got = pm.addHydrogens(papp.ForceField(*FF_FILES), variants=variants,
                          platform=cpu)
    want = jm.addHydrogens(japp.ForceField(*FF_FILES), variants=variants)
    assert got == want
    gs, ws = structure(pm.topology), structure(jm.topology)
    assert gs[:3] == ws[:3]
    h = [a.index for a in pm.topology.atoms() if a.element.symbol == "H"]
    assert len(h) == 3 + 3 * 5 + 4
    p = plain(pm.getPositions())
    j = np.asarray([tuple(v) for v in ju.strip(jm.getPositions(),
                                               ju.nanometer)])
    assert np.abs(p - j).max() < 1e-10
    # the heavy atoms are massless in the relaxation and do not move
    heavy = [a.index for a in pm.topology.atoms() if a.element.symbol != "H"]
    assert np.array_equal(p[heavy], before)
    # each hydrogen sits a bond's length from its parent
    for b in pm.topology.bonds():
        if "H" in (b[0].element.symbol, b[1].element.symbol):
            assert 0.09 < np.linalg.norm(p[b[0].index] - p[b[1].index]) \
                < 0.12


def test_add_hydrogens_protonation_variants_match_jax(monkeypatch):
    """pH picks the variants of ASP, GLU, LYS and HIS as in the JAX
    package (no force field: no relaxation)."""
    top = japp.Topology()
    chain = top.addChain("A")
    for name in ("ACE", "ASP", "GLU", "LYS", "HIS", "NME"):
        top.addResidue(name, chain)
    ptop = port_topology(top)
    for ph in (2.0, 7.0, 11.0):
        got = papp.Modeller(ptop, pu.Quantity([], pu.nanometer)) \
            .addHydrogens(pH=ph)
        want = japp.Modeller(top, ju.Quantity([], ju.nanometer)) \
            .addHydrogens(pH=ph)
        assert got == want
