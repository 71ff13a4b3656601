"""Modeller.addMembrane of openmm_tpu_torch against openmm_tpu's, and the
seven shipped lipid patches.

ACE-ALA-NME (chip_smoke.helix_pdb_text(1), its hydrogens added by the
JAX Modeller) is embedded in a corner of the POPC patch
(torch_port_helpers._cropped_patch, ~2,300 atoms, 5 lipids of which the
overlap removal and the leaflet balance keep 3) at 0.15 M by both
packages. The tiling, the overlap removal, the leaflet balance and the
ions' waters (RandomState 81733) keep the same residues exactly. With
_relax_iterations=0 the relaxation is the minimization alone (30 L-BFGS
iterations of the lipids and waters, the protein's particles
massless): in float64 on both sides (the JAX "Reference" platform, the
port's "CPU" platform at Precision double) the positions agree within
the 1e-10 nm of tests/test_torch_minimize.py's minimizations. With
dynamics the Langevin draws differ between the packages, so the port
alone is held to finite energies and both leaflets populated.
"""
import io
import types

import numpy as np
import pytest

import chip_smoke
import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu import unit as ju
from openmm_tpu.app.modeller import _load_membrane_patch as jax_patch

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.app.modeller import _load_membrane_patch as port_patch
from openmm_tpu_torch.unit import plain
from openmm_tpu_torch.vec3 import Vec3 as PVec3
from test_torch_modeller import structure
from torch_port_helpers import _cropped_patch, port_topology

FF_FILES = ("amber14-all.json", "amber14-tip3p.json")
PATCHES = ("DLPC", "DLPE", "DMPC", "DOPC", "DPPC", "POPC", "POPE")
PADDING = 0.3       # nm: one cropped tile holds the helix
IONIC = 0.15        # molar


@pytest.mark.parametrize("name", PATCHES)
def test_shipped_lipid_patch_loads_as_jax(name):
    """Each patch: the JAX loader's topology and positions, finite, both
    leaflets populated (tests/test_membrane.py's checks)."""
    ptop, ppos, pbox = port_patch(name)
    jtop, jpos, jbox = jax_patch(name)
    got, want = structure(ptop), structure(port_topology(jtop))
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    assert np.array_equal(ppos, jpos) and np.array_equal(pbox, jbox)
    assert ptop.getNumAtoms() == len(ppos)
    assert np.isfinite(ppos).all()
    assert ptop.getNumBonds() > ptop.getNumAtoms() // 2
    lipids = [r for r in ptop.residues() if r.name != "HOH"]
    assert len(lipids) >= 30
    z = np.asarray([ppos[[a.index for a in r.atoms()]].mean(axis=0)[2]
                    for r in lipids])
    mid = np.median(z)
    assert (z < mid - 0.3).any() and (z > mid + 0.3).any()


@pytest.fixture(scope="module")
def inputs():
    """(JAX helix Modeller's topology and positions (n, 3) nm with its
    hydrogens, the JAX cropped patch, the port's, both ForceFields)."""
    jff = japp.ForceField(*FF_FILES)
    pdb = japp.PDBFile(io.StringIO(chip_smoke.helix_pdb_text(1)))
    helix = japp.Modeller(pdb.topology, pdb.positions)
    helix.addHydrogens()
    hpos = np.asarray([tuple(v) for v in ju.strip(helix.getPositions(),
                                                  ju.nanometer)])
    top, pos, _ = _cropped_patch(0.33)
    jpatch = types.SimpleNamespace(
        topology=top, positions=ju.Quantity(pos, ju.nanometer))
    ppatch = types.SimpleNamespace(
        topology=port_topology(top),
        positions=pu.Quantity(pos, pu.nanometer))
    return (helix.topology, hpos, jpatch, ppatch, jff,
            papp.ForceField(*FF_FILES))


def _modellers(inputs):
    htop, hpos, _, _, _, _ = inputs
    jm = japp.Modeller(htop, ju.Quantity(hpos, ju.nanometer))
    pm = papp.Modeller(port_topology(htop),
                       pu.Quantity([PVec3(*p) for p in hpos], pu.nanometer))
    return pm, jm


def test_add_membrane_without_dynamics_matches_jax(inputs, monkeypatch):
    """The same kept residues and ions; the helix where it was, the
    membrane where both float64 minimizations left it."""
    _, _, jpatch, ppatch, jff, pff = inputs
    reference = mm.Platform.getPlatformByName("Reference")
    monkeypatch.setattr(mm.Platform, "findPlatform",
                        staticmethod(lambda *a, **k: reference))
    cpu = omm.Platform.getPlatformByName("CPU")
    monkeypatch.setitem(cpu._defaults, "Precision", "double")
    pm, jm = _modellers(inputs)
    n_helix = pm.topology.getNumAtoms()
    jm.addMembrane(jff, lipidType=jpatch, minimumPadding=PADDING,
                   ionicStrength=IONIC * ju.molar, _relax_iterations=0)
    pm.addMembrane(pff, lipidType=ppatch, minimumPadding=PADDING,
                   ionicStrength=IONIC * pu.molar, _relax_iterations=0,
                   platform=cpu)
    got, want = structure(pm.topology), structure(jm.topology)
    assert got[:3] == want[:3]          # the same kept residues
    np.testing.assert_array_equal(got[3], want[3])
    names = [r.name for r in pm.topology.residues()]
    assert names.count("POP") >= 2 and names.count("HOH") > 300
    assert names.count("NA") == names.count("CL") >= 1
    p = plain(pm.getPositions())
    j = np.asarray([tuple(v) for v in ju.strip(jm.getPositions(),
                                               ju.nanometer)])
    assert np.array_equal(p[:n_helix], j[:n_helix])
    assert np.abs(p - j).max() < 1e-10


def test_add_membrane_with_dynamics_relaxes(inputs):
    """A relaxation round (setPositions, 20 Langevin steps) on the port
    alone: finite energies of the merged model and both leaflets (about
    the membrane's centre, z = 0) populated."""
    _, _, _, ppatch, _, pff = inputs
    pm, _ = _modellers(inputs)
    cpu = omm.Platform.getPlatformByName("CPU")
    pm.addMembrane(pff, lipidType=ppatch, minimumPadding=PADDING,
                   neutralize=False, _relax_iterations=1, platform=cpu)
    pos = plain(pm.getPositions())
    assert np.isfinite(pos).all()
    lipid_z = np.asarray([pos[[a.index for a in r.atoms()]].mean(axis=0)[2]
                          for r in pm.topology.residues()
                          if r.name == "POP"])
    assert (lipid_z < -0.3).any() and (lipid_z > 0.3).any()
    system = pff.createSystem(pm.topology, nonbondedMethod=papp.PME,
                              nonbondedCutoff=0.9 * pu.nanometer,
                              constraints=papp.HBonds)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), cpu)
    ctx.setPositions(pos)
    energy = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    assert np.isfinite(energy)
