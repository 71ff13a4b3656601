"""The port's Element, Topology (createStandardBonds), PDBFile and
membrane patch loader against the JAX package's, on the cropped POPC
bilayer (tests/torch_port_helpers.py _cropped_patch) and a capped peptide
built from amber14's templates.

PDBFile.writeFile writes the JAX package's text line for line, and then
CONECT records for the bonds the reader's standard-bond table cannot give
back (the lipids'): the JAX writer writes none, so a lipid read back from
its file has lost its bonds. The port's round trip keeps every bond."""
import io

import numpy as np
import pytest

from openmm_tpu import app as japp
from openmm_tpu import unit as ju
from openmm_tpu.app.modeller import _load_membrane_patch as jax_patch

from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.app.modeller import _load_membrane_patch as port_patch
from test_torch_forcefield import PEPTIDE
from torch_port_helpers import _cropped_patch, port_topology, \
    template_topology


def _structure(top):
    """Everything a Topology holds, as plain values in order."""
    atoms = [(a.name, a.element.symbol if a.element else None, a.id,
              a.residue.index) for a in top.atoms()]
    residues = [(r.name, r.id, r.insertionCode, r.chain.index)
                for r in top.residues()]
    chains = [c.id for c in top.chains()]
    bonds = [(b[0].index, b[1].index) for b in top.bonds()]
    box = top.getPeriodicBoxVectors()
    box = None if box is None else np.asarray(
        [list(v) for v in box._value], np.float64)
    return chains, residues, atoms, bonds, box


def _assert_same_topology(got, want):
    g, w = _structure(got), _structure(want)
    for name, a, b in zip(("chains", "residues", "atoms", "bonds"), g, w):
        assert a == b, name
    assert (g[4] is None) == (w[4] is None)
    if w[4] is not None:
        np.testing.assert_array_equal(g[4], w[4])


@pytest.fixture(scope="module")
def cropped():
    top, pos, _ = _cropped_patch(0.33)
    return top, pos


def _jax_text(top, pos):
    buf = io.StringIO()
    japp.PDBFile.writeFile(top, ju.Quantity(pos, ju.nanometer), buf)
    return buf.getvalue()


def _port_text(top, pos):
    buf = io.StringIO()
    papp.PDBFile.writeFile(top, pu.Quantity(pos, pu.nanometer), buf)
    return buf.getvalue()


@pytest.mark.parametrize("symbol", ["H", "C", "N", "O", "P", "S", "Na",
                                    "Cl", "K", "Mg", "Ca", "Zn", "Fe"])
def test_elements_match_jax(symbol):
    j, p = japp.Element.getBySymbol(symbol), papp.Element.getBySymbol(symbol)
    assert (p.symbol, p.name, p.atomic_number) == \
        (j.symbol, j.name, j.atomic_number)
    assert p.mass.value_in_unit(pu.dalton) == j.mass.value_in_unit(ju.dalton)
    assert papp.Element.getByAtomicNumber(j.atomic_number) is p


def test_membrane_patch_matches_jax():
    jtop, jpos, jbox = jax_patch("POPC")
    ptop, ppos, pbox = port_patch("POPC")
    _assert_same_topology(ptop, jtop)
    np.testing.assert_array_equal(ppos, jpos)
    np.testing.assert_array_equal(pbox, jbox)
    assert ptop.getNumAtoms() == 32512


def test_create_standard_bonds_matches_jax():
    """The bonds createStandardBonds infers from the residue table, on a
    capped peptide and waters with no bonds of their own."""
    ff = japp.ForceField("amber14-all.json", "amber14-tip3p.json")
    full = template_topology(ff, [PEPTIDE] + [["HOH"]] * 3, 3.0)
    bare = japp.Topology()
    for chain in full.chains():
        c = bare.addChain(chain.id)
        for res in chain.residues():
            r = bare.addResidue(res.name, c, res.id)
            for a in res.atoms():
                bare.addAtom(a.name, a.element, r)
    port = port_topology(bare)
    bare.createStandardBonds()
    port.createStandardBonds()
    _assert_same_topology(port, bare)
    assert len(list(port.bonds())) > 100


def test_reads_jax_text_as_jax_does(cropped):
    top, pos = cropped
    text = _jax_text(top, pos)
    jpdb = japp.PDBFile(io.StringIO(text))
    ppdb = papp.PDBFile(io.StringIO(text))
    _assert_same_topology(ppdb.topology, jpdb.topology)
    np.testing.assert_array_equal(
        np.asarray(ppdb.getPositions(asNumpy=True).value_in_unit(
            pu.nanometer)),
        np.asarray(jpdb.getPositions(asNumpy=True).value_in_unit(
            ju.nanometer)))


def test_write_file_is_the_jax_text_with_conect_records(cropped):
    top, pos = cropped
    want = _jax_text(top, pos).splitlines()
    got = _port_text(port_topology(top), pos).splitlines()
    assert [line for line in got if not line.startswith("CONECT")] == want
    conect = [line for line in got if line.startswith("CONECT")]
    serial = {}
    for line in got:
        if line.startswith(("ATOM", "HETATM")):
            serial[line[6:11].strip()] = len(serial)
    listed = set()
    for line in conect:
        fields = [line[k:k + 5].strip() for k in range(6, len(line), 5)]
        a = serial[fields[0]]
        listed.update((min(a, serial[f]), max(a, serial[f]))
                      for f in fields[1:])
    lipid_bonds = {(min(b[0].index, b[1].index), max(b[0].index, b[1].index))
                   for b in top.bonds() if b[0].residue.name != "HOH"}
    assert listed == lipid_bonds and lipid_bonds


def test_round_trip_keeps_structure_and_positions(cropped):
    top, pos = cropped
    ptop = port_topology(top)
    pdb = papp.PDBFile(io.StringIO(_port_text(ptop, pos)))
    back = pdb.topology
    g, w = _structure(back), _structure(ptop)
    assert [a[:2] for a in g[2]] == [a[:2] for a in w[2]]
    assert [r[0] for r in g[1]] == [r[0] for r in w[1]]
    assert {tuple(sorted(b)) for b in g[3]} == {tuple(sorted(b))
                                                for b in w[3]}
    np.testing.assert_allclose(g[4], w[4], atol=5e-4)
    got = np.asarray(pdb.getPositions(asNumpy=True).value_in_unit(
        pu.nanometer))
    assert np.abs(got - pos).max() <= 5.0001e-5     # 1e-3 A rounding
