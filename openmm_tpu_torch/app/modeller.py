"""Modeller: edit topologies -- add and delete atoms, solvate with ions,
convert water, add hydrogens and extra particles, embed in a membrane.

The port's copy of openmm_tpu/app/modeller.py (after OpenMM's
wrappers/python/openmm/app/modeller.py). addSolvent draws its waters from
np.random.RandomState(59173) and its ions from RandomState(81733), the JAX
package's streams, so both place the same waters and ions. The
relaxations of addHydrogens and addMembrane run on the port's Context, on
the default Platform (the card) unless the caller passes `platform`.
Membrane patches are data/<name>.npz, the port's own copies (DLPC, DLPE,
DMPC, DOPC, DPPC, POPC, POPE; POPC: 128 lipids and 5,120 TIP3P waters,
32,512 atoms); hydrogen templates are data/hydrogen_defs.json.
"""
from __future__ import annotations

import math
import os

import numpy as np

from .. import unit as u
from ..vec3 import Vec3
from .element import Element
from .topology import Topology

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load_membrane_patch(name):
    """(Topology, positions (n, 3) in nm, box widths (3,) in nm) of a
    pre-equilibrated membrane patch: its residues and atoms, the waters'
    bonds from the standard bond table and the lipids' from the file."""
    path = os.path.join(_DATA, name + ".npz")
    if not os.path.exists(path):
        raise ValueError(
            "Unsupported lipid type: %s (ship a patch .npz or pass an "
            "object with topology/positions)" % name)
    d = np.load(path)
    names = d["names"][d["name_idx"]]
    resnames = d["resnames"][d["res_idx"]]
    elements = d["elements"][d["elem_idx"]]
    resid = d["resid"]
    chain_ids = d["chain"]
    top = Topology()
    box = d["box_nm"]
    top.setPeriodicBoxVectors(u.Quantity(
        (Vec3(box[0], 0, 0), Vec3(0, box[1], 0), Vec3(0, 0, box[2])),
        u.nanometer))
    atoms = []
    cur_chain = None
    cur_chain_id = None
    cur_res = None
    cur_res_key = None
    for i in range(len(names)):
        if chain_ids[i] != cur_chain_id:
            cur_chain = top.addChain(str(chain_ids[i]))
            cur_chain_id = chain_ids[i]
            cur_res_key = None
        key = (chain_ids[i], resid[i], resnames[i])
        if key != cur_res_key:
            cur_res = top.addResidue(str(resnames[i]), cur_chain,
                                     str(resid[i]))
            cur_res_key = key
        try:
            el = Element.getBySymbol(str(elements[i]))
        except Exception:
            el = None
        atoms.append(top.addAtom(str(names[i]), el, cur_res))
    # waters carry no CONECT records; standard bonds fill them in
    top.createStandardBonds()
    have = set((min(b[0].index, b[1].index), max(b[0].index, b[1].index))
               for b in top.bonds())
    for a, b in d["bonds"]:
        if (int(a), int(b)) not in have:
            top.addBond(atoms[int(a)], atoms[int(b)])
    return top, np.asarray(d["positions"], float), box


def _within(points, ref, cutoff):
    """(n,) bool: whether each of `points` lies closer than `cutoff` to
    one of `ref`, |p - q|^2 summed in x, y, z order as the JAX package's
    cell search does (the same pairs, the same floats), over the points
    in ref's box grown by the cutoff, in blocks of about 4M pairs."""
    out = np.zeros(len(points), bool)
    if not len(ref) or not len(points):
        return out
    lo = ref.min(axis=0) - cutoff
    hi = ref.max(axis=0) + cutoff
    cand = np.nonzero(np.all((points > lo) & (points < hi), axis=1))[0]
    block = max(1, (1 << 22) // len(ref))
    for start in range(0, len(cand), block):
        k = cand[start:start + block]
        d = points[k][:, None, :] - ref[None, :, :]
        out[k] = ((d ** 2).sum(axis=-1) < cutoff * cutoff).any(axis=1)
    return out


class Modeller(object):
    def __init__(self, topology, positions):
        self.topology = topology
        if not u.is_quantity(positions):
            positions = u.Quantity(positions, u.nanometer)
        self.positions = positions

    def getTopology(self):
        return self.topology

    def getPositions(self):
        return self.positions

    def add(self, addTopology, addPositions):
        """Merge another topology+positions into the model (modeller.py add)."""
        new_top = Topology()
        new_top.setPeriodicBoxVectors(self.topology.getPeriodicBoxVectors())
        new_pos = []
        atom_map = {}
        for top, pos in ((self.topology, u.strip(self.positions, u.nanometer)),
                         (addTopology, u.strip(addPositions, u.nanometer))):
            for chain in top.chains():
                nc = new_top.addChain(chain.id)
                for res in chain.residues():
                    nr = new_top.addResidue(res.name, nc, res.id,
                                            res.insertionCode)
                    for atom in res.atoms():
                        na = new_top.addAtom(atom.name, atom.element, nr,
                                             atom.id)
                        atom_map[atom] = na
                        new_pos.append(Vec3(*pos[atom.index]))
            for bond in top.bonds():
                new_top.addBond(atom_map[bond[0]], atom_map[bond[1]],
                                bond.type, bond.order)
        self.topology = new_top
        self.positions = u.Quantity(new_pos, u.nanometer)

    def delete(self, toDelete):
        """Delete atoms/residues/chains/bonds (modeller.py delete)."""
        delete_set = set(toDelete)
        new_top = Topology()
        new_top.setPeriodicBoxVectors(self.topology.getPeriodicBoxVectors())
        pos = u.strip(self.positions, u.nanometer)
        new_pos = []
        atom_map = {}
        for chain in self.topology.chains():
            if chain in delete_set:
                continue
            kept_res = [res for res in chain.residues()
                        if res not in delete_set]
            kept = []
            for res in kept_res:
                atoms = [a for a in res.atoms() if a not in delete_set]
                if atoms:
                    kept.append((res, atoms))
            if not kept:
                continue
            nc = new_top.addChain(chain.id)
            for res, atoms in kept:
                nr = new_top.addResidue(res.name, nc, res.id, res.insertionCode)
                for atom in atoms:
                    na = new_top.addAtom(atom.name, atom.element, nr, atom.id)
                    atom_map[atom] = na
                    new_pos.append(Vec3(*pos[atom.index]))
        for bond in self.topology.bonds():
            if bond in delete_set:
                continue
            if bond[0] in atom_map and bond[1] in atom_map:
                new_top.addBond(atom_map[bond[0]], atom_map[bond[1]],
                                bond.type, bond.order)
        self.topology = new_top
        self.positions = u.Quantity(new_pos, u.nanometer)

    def deleteWater(self):
        self.delete([res for res in self.topology.residues()
                     if res.name in ("HOH", "WAT", "H2O", "SOL")])

    def addSolvent(self, forcefield=None, model="tip3p", boxSize=None,
                   boxVectors=None, padding=None, numAdded=None,
                   neutralize=False, positiveIon="Na+", negativeIon="Cl-",
                   ionicStrength=0.0):
        """Fill the periodic box with water (modeller.py:378 addSolvent,
        lattice-fill variant): place waters on a jittered lattice at liquid
        density, prune any within 0.24 nm vdW distance of existing atoms."""
        pos = np.asarray(u.strip(self.positions, u.nanometer), float)
        if len(pos) == 0:
            pos = np.zeros((0, 3))
        if boxVectors is not None:
            box = np.asarray(u.strip(boxVectors, u.nanometer), float)
        elif boxSize is not None:
            d = u.strip(boxSize, u.nanometer)
            box = np.diag([d[0], d[1], d[2]])
        elif padding is not None:
            pad = float(u.strip(padding, u.nanometer))
            if len(pos):
                extent = pos.max(axis=0) - pos.min(axis=0)
            else:
                extent = np.zeros(3)
            side = float(max(extent)) + 2 * pad
            box = np.eye(3) * side
        elif self.topology.getPeriodicBoxVectors() is not None:
            box = np.asarray(u.strip(self.topology.getPeriodicBoxVectors(),
                                     u.nanometer), float)
        else:
            raise ValueError("must specify boxSize, boxVectors, or padding")
        self.topology.setPeriodicBoxVectors(u.Quantity(
            (Vec3(*box[0]), Vec3(*box[1]), Vec3(*box[2])), u.nanometer))

        # center solute in the box
        if len(pos):
            center_shift = 0.5 * (box[0] + box[1] + box[2]) \
                - 0.5 * (pos.max(axis=0) + pos.min(axis=0))
            pos = pos + center_shift
            self.positions = u.Quantity([Vec3(*p) for p in pos], u.nanometer)

        density = 33.37
        lx, ly, lz = box[0][0], box[1][1], box[2][2]
        nx = max(1, int(lx * density ** (1 / 3)))
        ny = max(1, int(ly * density ** (1 / 3)))
        nz = max(1, int(lz * density ** (1 / 3)))
        rng = np.random.RandomState(59173)
        d_oh = 0.09572
        theta = 104.52 * math.pi / 180
        ref = np.array([[0, 0, 0], [d_oh, 0, 0],
                        [d_oh * math.cos(theta), d_oh * math.sin(theta), 0]])
        # cell list over existing atoms for overlap pruning
        cut = 0.24
        occupied = {}
        inv_cut = 1.0 / cut
        for p in pos:
            key = tuple((p * inv_cut).astype(int))
            occupied.setdefault(key, []).append(p)

        def clash(center):
            key0 = (center * inv_cut).astype(int)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        for q in occupied.get((key0[0] + dx, key0[1] + dy,
                                               key0[2] + dz), ()):
                            if np.sum((center - q) ** 2) < cut * cut:
                                return True
            return False

        water_top = Topology()
        chain = water_top.addChain()
        new_waters = []
        o_el = Element.getBySymbol("O")
        h_el = Element.getBySymbol("H")
        count = 0
        for ix in range(nx):
            for iy in range(ny):
                for iz in range(nz):
                    if numAdded is not None and count >= numAdded:
                        break
                    center = np.array([(ix + 0.5) * lx / nx,
                                       (iy + 0.5) * ly / ny,
                                       (iz + 0.5) * lz / nz]) \
                        + (rng.rand(3) - 0.5) * 0.02
                    if clash(center):
                        continue
                    ang = rng.rand() * 2 * math.pi
                    axis = rng.randn(3)
                    axis /= np.linalg.norm(axis)
                    K = np.array([[0, -axis[2], axis[1]],
                                  [axis[2], 0, -axis[0]],
                                  [-axis[1], axis[0], 0]])
                    R = np.eye(3) + math.sin(ang) * K \
                        + (1 - math.cos(ang)) * (K @ K)
                    pts = ref @ R.T + center
                    res = water_top.addResidue("HOH", chain)
                    o = water_top.addAtom("O", o_el, res)
                    h1 = water_top.addAtom("H1", h_el, res)
                    h2 = water_top.addAtom("H2", h_el, res)
                    water_top.addBond(o, h1)
                    water_top.addBond(o, h2)
                    for row in pts:
                        new_waters.append(Vec3(*row))
                    count += 1
        self.add(water_top, u.Quantity(new_waters, u.nanometer))

        # ---- ions: neutralize + ionic strength (modeller.py addSolvent) ----
        n_waters = count
        n_ionic = int(round(
            float(u.strip(ionicStrength, u.mole / u.liter))
            * n_waters / 55.4))
        solute_charge = 0.0
        if neutralize and forcefield is not None:
            try:
                system = forcefield.createSystem(self.topology)
                for f in system.getForces():
                    if hasattr(f, "getNumParticles") \
                            and hasattr(f, "getParticleParameters") \
                            and type(f).__name__ == "NonbondedForce":
                        solute_charge = sum(
                            u.strip(f.getParticleParameters(i)[0])
                            for i in range(f.getNumParticles()))
            except Exception:
                solute_charge = 0.0
        n_pos = n_ionic
        n_neg = n_ionic
        q = int(round(solute_charge))
        if q > 0:
            n_neg += q
        elif q < 0:
            n_pos += -q
        if n_pos or n_neg:
            self._replace_waters_with_ions(n_pos, positiveIon,
                                           n_neg, negativeIon)

    _ION_ELEMENTS = {"Na+": ("NA", "Na"), "K+": ("K", "K"),
                     "Li+": ("LI", "Li"), "Rb+": ("RB", "Rb"),
                     "Cs+": ("CS", "Cs"), "Cl-": ("CL", "Cl"),
                     "Br-": ("BR", "Br"), "F-": ("F", "F"),
                     "I-": ("IOD", "I")}

    def _replace_waters_with_ions(self, n_pos, positiveIon, n_neg,
                                  negativeIon):
        """Swap randomly chosen waters for monatomic ions (the reference
        places ions at water oxygen sites)."""
        waters = [res for res in self.topology.residues()
                  if res.name in ("HOH", "WAT", "H2O")]
        rng = np.random.RandomState(81733)
        picks = rng.choice(len(waters), size=n_pos + n_neg, replace=False)
        pos = u.strip(self.positions, u.nanometer)
        pos = [np.array([p.x, p.y, p.z]) if isinstance(p, Vec3)
               else np.asarray(p, float) for p in pos]
        ion_top = Topology()
        chain = ion_top.addChain()
        ion_pos = []
        doomed = []
        for k, wi in enumerate(picks):
            name, symbol = self._ION_ELEMENTS[
                positiveIon if k < n_pos else negativeIon]
            water = waters[wi]
            o_atom = next(a for a in water.atoms() if a.name == "O")
            res = ion_top.addResidue(name, chain)
            ion_top.addAtom(symbol.upper(), Element.getBySymbol(symbol), res)
            ion_pos.append(Vec3(*pos[o_atom.index]))
            doomed.append(water)
        self.delete(doomed)
        self.add(ion_top, u.Quantity(ion_pos, u.nanometer))

    def convertWater(self, model="tip3p"):
        """Convert waters to another model, adding 4/5-site virtual
        particles with the reference's geometric coefficients
        (modeller.py:189-258 convertWater)."""
        if model in ("tip3p", "spce"):
            sites = 3
        elif model == "tip4pew":
            sites = 4
        elif model == "tip5p":
            sites = 5
        else:
            raise ValueError("Unknown water model: %s" % model)
        if sites == 3:
            return
        new_top = Topology()
        new_top.setPeriodicBoxVectors(self.topology.getPeriodicBoxVectors())
        pos = np.asarray(u.strip(self.positions, u.nanometer), float)
        new_pos = []
        atom_map = {}
        for chain in self.topology.chains():
            nc = new_top.addChain(chain.id)
            for res in chain.residues():
                nr = new_top.addResidue(res.name, nc, res.id,
                                        res.insertionCode)
                if res.name == "HOH":
                    oatom = [a for a in res.atoms()
                             if a.element is not None
                             and a.element.symbol == "O"]
                    hatoms = [a for a in res.atoms()
                              if a.element is not None
                              and a.element.symbol == "H"]
                    if len(oatom) != 1 or len(hatoms) != 2:
                        raise ValueError(
                            "Illegal water molecule (residue %d)" % res.index)
                    for a in (oatom[0], hatoms[0], hatoms[1]):
                        atom_map[a] = new_top.addAtom(a.name, a.element, nr)
                        new_pos.append(pos[a.index].copy())
                    po = pos[oatom[0].index]
                    ph1 = pos[hatoms[0].index]
                    ph2 = pos[hatoms[1].index]
                    if sites == 4:
                        new_top.addAtom("M", None, nr)
                        new_pos.append(0.786646558 * po + 0.106676721 * ph1
                                       + 0.106676721 * ph2)
                    else:
                        new_top.addAtom("M1", None, nr)
                        new_top.addAtom("M2", None, nr)
                        v1 = ph1 - po
                        v2 = ph2 - po
                        cr = np.cross(v1, v2)
                        new_pos.append(po - (0.34490826 * v1
                                             - 0.34490826 * v2
                                             - 6.4437903 * cr))
                        new_pos.append(po - (0.34490826 * v1
                                             - 0.34490826 * v2
                                             + 6.4437903 * cr))
                else:
                    for a in res.atoms():
                        atom_map[a] = new_top.addAtom(a.name, a.element, nr,
                                                      a.id)
                        new_pos.append(pos[a.index].copy())
        for bond in self.topology.bonds():
            if bond[0] in atom_map and bond[1] in atom_map:
                new_top.addBond(atom_map[bond[0]], atom_map[bond[1]])
        self.topology = new_top
        self.positions = u.Quantity([Vec3(*p) for p in new_pos], u.nanometer)

    def addMembrane(self, forcefield, lipidType="POPC", membraneCenterZ=0.0,
                    minimumPadding=1.0, positiveIon="Na+", negativeIon="Cl-",
                    ionicStrength=0.0, neutralize=True,
                    _relax_iterations=50, platform=None):
        """Add a lipid membrane (plus its solvating water) around the model.

        The Wolf et al. scheme of the reference (modeller.py:1189
        addMembrane): tile a pre-equilibrated membrane patch over the XY
        plane, scale the protein to half size in XY, delete lipids/waters
        overlapping it (balancing the two leaflets), then run short
        dynamics while rescaling the protein back up. Shipped patches:
        DLPC, DLPE, DMPC, DOPC, DPPC, POPC, POPE (app/data/*.npz,
        converted coordinate data — the reference's app/data/*.pdb set);
        other lipids can be passed as any object with `topology` and
        `positions`. The relaxation runs on `platform` (the default
        Platform, the card, unless the caller names another).
        """
        membraneCenterZ = float(u.strip(membraneCenterZ, u.nanometer))
        minimumPadding = float(u.strip(minimumPadding, u.nanometer))
        if hasattr(lipidType, "topology") and hasattr(lipidType, "positions"):
            patch_top, patch_pos, patch_box = (
                lipidType.topology,
                np.asarray(u.strip(lipidType.positions, u.nanometer), float),
                np.asarray(u.strip(
                    lipidType.topology.getPeriodicBoxVectors(),
                    u.nanometer), float).diagonal())
        else:
            patch_top, patch_pos, patch_box = _load_membrane_patch(
                str(lipidType).upper())

        pos = np.asarray(u.strip(self.positions, u.nanometer), float)
        pmin, pmax = pos.min(axis=0), pos.max(axis=0)
        psize = pmax - pmin
        pcenter = 0.5 * (pmin + pmax)
        pcenter = np.array([pcenter[0], pcenter[1], membraneCenterZ])
        patch_min = patch_pos.min(axis=0)
        patch_max = patch_pos.max(axis=0)
        patch_center = 0.5 * (patch_min + patch_max)
        nx = int(math.ceil((psize[0] + 2 * minimumPadding) / patch_box[0]))
        ny = int(math.ceil((psize[1] + 2 * minimumPadding) / patch_box[1]))

        # leaflet of each lipid (mean z vs membrane mean z)
        res_atoms = {}
        res_mean_z = {}
        mean_z_num = 0.0
        mean_z_den = 0
        for res in patch_top.residues():
            idx = np.array([a.index for a in res.atoms()])
            res_atoms[res] = idx
            if res.name != "HOH":
                res_mean_z[res] = float(patch_pos[idx, 2].mean())
                mean_z_num += float(patch_pos[idx, 2].sum())
                mean_z_den += len(idx)
        membrane_mean_z = mean_z_num / max(mean_z_den, 1)
        leaf = {res: (0 if z < membrane_mean_z else 1)
                for res, z in res_mean_z.items()}

        scaled = pos - pcenter
        scaled[:, 0] *= 0.5
        scaled[:, 1] *= 0.5
        scaled = scaled + pcenter

        box_z = patch_box[2]
        if self.topology.getPeriodicBoxVectors() is not None:
            bv = np.asarray(u.strip(self.topology.getPeriodicBoxVectors(),
                                    u.nanometer), float)
            box_z = max(box_z, bv[2][2] + 2 * minimumPadding)
        else:
            box_z = max(box_z, psize[2] + 2 * minimumPadding)
        mem_box = (nx * patch_box[0], ny * patch_box[1], box_z)

        cutoff = 0.22

        def make_cells(points):
            cells = {}
            inv = 1.0 / cutoff
            for i, p in enumerate(points):
                cells.setdefault(tuple((p * inv).astype(int)), []).append(i)
            return cells

        cells_scaled = make_cells(scaled)

        added_water = []
        added_lipids = []
        removed_from_leaf = [0, 0]
        for tx in range(nx):
            for ty in range(ny):
                off = (pcenter - patch_center
                       + np.array([(tx - 0.5 * (nx - 1)) * patch_box[0],
                                   (ty - 0.5 * (ny - 1)) * patch_box[1],
                                   0.0]))
                tile = patch_pos + off
                near_full = _within(tile, pos, cutoff)
                near_scaled = _within(tile, scaled, cutoff)
                for res in patch_top.residues():
                    idx = res_atoms[res]
                    rp = tile[idx]
                    if res.name == "HOH":
                        bad = near_full[idx].any() or near_scaled[idx].any()
                        if not bad:
                            added_water.append((res, rp))
                    else:
                        bad = near_scaled[idx].any()
                        if bad:
                            removed_from_leaf[leaf[res]] += 1
                        else:
                            added_lipids.append((res, rp))
        skip = [max(removed_from_leaf) - removed_from_leaf[i] for i in (0, 1)]

        mem_top = Topology()
        mem_top.setPeriodicBoxVectors(u.Quantity(
            (Vec3(mem_box[0], 0, 0), Vec3(0, mem_box[1], 0),
             Vec3(0, 0, mem_box[2])), u.nanometer))
        mem_pos = []
        atom_map = {}
        res_bonds = {}
        for bond in patch_top.bonds():
            res_bonds.setdefault(bond[0].residue, []).append(bond)
        lipid_chain = mem_top.addChain()
        rnum = 1
        for res, rp in added_lipids:
            if skip[leaf[res]] > 0:
                skip[leaf[res]] -= 1
                continue
            nr = mem_top.addResidue(res.name, lipid_chain, str(rnum),
                                    res.insertionCode)
            rnum += 1
            for a in res.atoms():
                atom_map[a] = mem_top.addAtom(a.name, a.element, nr, a.id)
            mem_pos.extend(rp)
            for bond in res_bonds.get(res, ()):
                mem_top.addBond(atom_map[bond[0]], atom_map[bond[1]])
        water_chain = mem_top.addChain()
        for res, rp in added_water:
            nr = mem_top.addResidue(res.name, water_chain, res.id,
                                    res.insertionCode)
            for a in res.atoms():
                atom_map[a] = mem_top.addAtom(a.name, a.element, nr, a.id)
            mem_pos.extend(rp)
            for bond in res_bonds.get(res, ()):
                mem_top.addBond(atom_map[bond[0]], atom_map[bond[1]])
        mem_pos = np.asarray(mem_pos, float)

        # relax: lipid system + frozen protein particles with overlap
        # exceptions, short low-T dynamics while the protein scales back up
        from .forcefield import CutoffPeriodic, CutoffNonPeriodic
        from ..context import Context
        from ..forces import NonbondedForce
        from ..integrators import LangevinIntegrator
        from ..minimize import LocalEnergyMinimizer
        system = forcefield.createSystem(mem_top,
                                         nonbondedMethod=CutoffPeriodic)
        protein_system = forcefield.createSystem(
            self.topology, nonbondedMethod=CutoffNonPeriodic)
        n_mem = system.getNumParticles()
        n_prot = protein_system.getNumParticles()
        for i in range(n_prot):
            system.addParticle(0.0)
        nb_mem = None
        nb_prot = None
        for f in system.getForces():
            if isinstance(f, NonbondedForce):
                nb_mem = f
        for f in protein_system.getForces():
            if isinstance(f, NonbondedForce):
                nb_prot = f
        if nb_mem is None or nb_prot is None:
            raise ValueError("The ForceField does not specify a "
                             "NonbondedForce")
        for i in range(n_prot):
            c, s, e = nb_prot.getParticleParameters(i)
            nb_mem.addParticle(c, s, e)
        # protein-protein interactions are frozen anyway; exclude close pairs
        for i in range(n_prot):
            k0 = (scaled[i] / cutoff).astype(int)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        for j in cells_scaled.get(
                                (k0[0] + dx, k0[1] + dy, k0[2] + dz), ()):
                            if j < i:
                                nb_mem.addException(
                                    i + n_mem, j + n_mem, 0.0, 1.0, 0.0,
                                    True)

        integ = LangevinIntegrator(10.0, 50.0, 0.001)
        ctx = Context(system, integ, platform)
        merged = np.concatenate([mem_pos, scaled])
        ctx.setPositions(merged)
        LocalEnergyMinimizer.minimize(ctx, 10.0, 30)
        for i in range(_relax_iterations):
            w1 = i / max(_relax_iterations - 1.0, 1.0)
            w2 = 1.0 - w1
            cur = np.asarray(ctx.getState(getPositions=True)
                             .getPositions(asNumpy=True)
                             .value_in_unit(u.nanometer))
            cur[n_mem:] = w1 * pos + w2 * scaled
            ctx.setPositions(cur)
            integ.step(20)
        final = np.asarray(ctx.getState(getPositions=True)
                           .getPositions(asNumpy=True)
                           .value_in_unit(u.nanometer))

        self.add(mem_top, u.Quantity(
            [Vec3(*p) for p in final[:n_mem]], u.nanometer))
        self.topology.setPeriodicBoxVectors(mem_top.getPeriodicBoxVectors())

        if neutralize or ionicStrength:
            n_waters = sum(1 for r in self.topology.residues()
                           if r.name == "HOH")
            self._add_membrane_ions(forcefield, n_waters, positiveIon,
                                    negativeIon, ionicStrength, neutralize)

    def _add_membrane_ions(self, forcefield, n_waters, positiveIon,
                           negativeIon, ionicStrength, neutralize):
        """Ion placement by water substitution (shared with addSolvent)."""
        try:
            from .forcefield import NoCutoff
            system = forcefield.createSystem(self.topology,
                                             nonbondedMethod=NoCutoff)
        except Exception:
            return
        from ..forces import NonbondedForce
        total = 0.0
        for f in system.getForces():
            if isinstance(f, NonbondedForce):
                for i in range(f.getNumParticles()):
                    total += float(u.strip(f.getParticleParameters(i)[0],
                                           u.elementary_charge))
        n_pos = n_neg = 0
        if neutralize:
            q = int(round(total))
            if q > 0:
                n_neg += q
            else:
                n_pos += -q
        conc = float(u.strip(ionicStrength, u.molar))
        n_ionic = int(round(conc * n_waters / 55.4))
        n_pos += n_ionic
        n_neg += n_ionic
        if n_pos or n_neg:
            self._replace_waters_with_ions(n_pos, positiveIon, n_neg,
                                           negativeIon)

    def addExtraParticles(self, forcefield):
        """Add extra particles (virtual sites / Drude) required by the force
        field's templates (modeller.py:986 addExtraParticles): residues are
        matched against each template's real-atom subgraph; missing
        element-less template atoms are appended with positions computed
        from their virtual-site definitions."""
        new_top = Topology()
        new_top.setPeriodicBoxVectors(self.topology.getPeriodicBoxVectors())
        pos = u.strip(self.positions, u.nanometer)
        pos = [np.array([p.x, p.y, p.z]) if isinstance(p, Vec3)
               else np.asarray(p, float) for p in pos]
        new_pos = []
        atom_map = {}
        for chain in self.topology.chains():
            nc = new_top.addChain(chain.id)
            for res in chain.residues():
                nr = new_top.addResidue(res.name, nc, res.id,
                                        res.insertionCode)
                atoms = list(res.atoms())
                template = self._match_extra_template(forcefield, res)
                by_name = {}
                for atom in atoms:
                    na = new_top.addAtom(atom.name, atom.element, nr)
                    atom_map[atom] = na
                    by_name[atom.name] = len(new_pos)
                    new_pos.append(pos[atom.index].copy())
                if template is None:
                    continue
                have = {a.name for a in atoms}
                for ta in template.atoms:
                    if ta.element is not None or ta.name in have:
                        continue
                    p = self._extra_site_position(template, ta, by_name,
                                                  new_pos, forcefield)
                    new_top.addAtom(ta.name, None, nr)
                    new_pos.append(p)
        for bond in self.topology.bonds():
            new_top.addBond(atom_map[bond[0]], atom_map[bond[1]],
                            bond.type, bond.order)
        self.topology = new_top
        self.positions = u.Quantity([Vec3(*p) for p in new_pos], u.nanometer)

    @staticmethod
    def _match_extra_template(forcefield, res):
        """Find a template whose real (element-bearing) atoms match this
        residue by element multiset; None if the residue already matches a
        template exactly or nothing fits."""
        res_els = sorted(a.element.symbol if a.element else ""
                         for a in res.atoms())
        best = None
        for template in forcefield._templates.values():
            real = [a for a in template.atoms if a.element is not None]
            extra = [a for a in template.atoms if a.element is None]
            if not extra:
                continue
            t_els = sorted(a.element.symbol for a in real)
            if t_els == res_els:
                best = template
                break
        return best

    @staticmethod
    def _extra_site_position(template, ta, by_name, new_pos, forcefield):
        """Position of an extra particle from its VirtualSite definition,
        whose atoms are named (atomName<k>) or template indices (atom<k>,
        as OpenMM's swm4ndp.xml has them); a Drude particle, which has
        none, on its parent (the atom whose type its DrudeForce section
        names); else on the template's first real atom."""
        for vs in template.virtualSites:
            site = vs.get("siteName")
            if site is None and "index" in vs:
                site = template.atoms[int(vs["index"])].name
            if site != ta.name:
                continue
            names = []
            i = 1
            while ("atomName%d" % i) in vs or ("atom%d" % i) in vs:
                names.append(vs["atomName%d" % i] if ("atomName%d" % i) in vs
                             else template.atoms[int(vs["atom%d" % i])].name)
                i += 1
            try:
                pts = [new_pos[by_name[nm]] for nm in names]
            except KeyError:
                break
            t = vs["type"]
            if t == "average2":
                w1, w2 = float(vs["weight1"]), float(vs["weight2"])
                return w1 * pts[0] + w2 * pts[1]
            if t == "average3":
                w = [float(vs["weight%d" % k]) for k in (1, 2, 3)]
                return w[0] * pts[0] + w[1] * pts[1] + w[2] * pts[2]
            if t == "outOfPlane":
                w12, w13 = float(vs["weight12"]), float(vs["weight13"])
                wc = float(vs["weightCross"])
                r12 = pts[1] - pts[0]
                r13 = pts[2] - pts[0]
                return pts[0] + w12 * r12 + w13 * r13 + wc * np.cross(r12, r13)
            if t == "localCoords":
                po = [float(vs["pos%d" % k]) for k in (1, 2, 3)]
                wo = [float(vs.get("wo%d" % k, 0)) for k in
                      range(1, len(pts) + 1)]
                wx = [float(vs.get("wx%d" % k, 0)) for k in
                      range(1, len(pts) + 1)]
                wy = [float(vs.get("wy%d" % k, 0)) for k in
                      range(1, len(pts) + 1)]
                origin = sum(w * p for w, p in zip(wo, pts))
                xdir = sum(w * p for w, p in zip(wx, pts))
                ydir = sum(w * p for w, p in zip(wy, pts))
                z = np.cross(xdir, ydir)
                x = xdir / max(np.linalg.norm(xdir), 1e-10)
                zn = z / max(np.linalg.norm(z), 1e-10)
                y = np.cross(zn, x)
                return origin + po[0] * x + po[1] * y + po[2] * zn
        parent = Modeller._drude_parent(template, ta, forcefield)
        if parent is None or parent.name not in by_name:
            # fallback: on the first real atom of the template's residue
            parent = next(a for a in template.atoms if a.element is not None)
        return new_pos[by_name[parent.name]].copy()

    @staticmethod
    def _drude_parent(template, ta, forcefield):
        """The template atom that is the parent of the Drude particle ta
        (its type in a DrudeForce section of `forcefield`), or None."""
        from .ffgenerators import DrudeGenerator
        for gen in forcefield._generators:
            if isinstance(gen, DrudeGenerator) and ta.type in gen.typeMap:
                parents = gen.typeMap[ta.type][0]
                return next((a for a in template.atoms
                             if a.type in parents), None)
        return None

    # -------------------------------------------------------- addHydrogens
    _hydrogen_defs = None

    @classmethod
    def _load_hydrogen_defs(cls):
        if cls._hydrogen_defs is None:
            import json
            path = os.path.join(_DATA, "hydrogen_defs.json")
            with open(path) as f:
                cls._hydrogen_defs = json.load(f)
        return cls._hydrogen_defs

    @staticmethod
    def _pick_variant(res, pH, is_nterm, is_cterm, bonded):
        """Protonation variant by pKa (modeller.py addHydrogens pH rules)."""
        name = res.name
        if name == "ASP":
            return "ASH" if pH < 3.9 else "ASP"
        if name == "GLU":
            return "GLH" if pH < 4.4 else "GLU"
        if name == "LYS":
            return "LYN" if pH > 10.4 else "LYS"
        if name == "HIS":
            if pH < 6.5:
                return "HIP"
            return "HIE"
        if name == "CYS":
            for a in res.atoms():
                if a.name == "SG":
                    for b in bonded.get(a, []):
                        if b.residue is not res and b.name == "SG":
                            return "CYX"
            return "CYS"
        return name

    def addHydrogens(self, forcefield=None, pH=7.0, variants=None,
                     platform=None):
        """Add missing hydrogens (modeller.py:841 addHydrogens): choose a
        protonation variant per residue (pKa rules / explicit `variants`),
        strip existing hydrogens of standard residues, re-add the template
        set with geometric placement, then relax only the new hydrogens with
        the force field (heavy atoms frozen by zero inverse mass)."""
        defs = self._load_hydrogen_defs()
        bonded = {}
        for b in self.topology.bonds():
            bonded.setdefault(b[0], []).append(b[1])
            bonded.setdefault(b[1], []).append(b[0])
        residues = list(self.topology.residues())
        actual_variants = [None] * len(residues)

        new_top = Topology()
        new_top.setPeriodicBoxVectors(self.topology.getPeriodicBoxVectors())
        pos = u.strip(self.positions, u.nanometer)
        pos = [np.asarray([p[0], p[1], p[2]], float) if not isinstance(p, Vec3)
               else np.array([p.x, p.y, p.z]) for p in pos]
        new_pos = []
        atom_map = {}
        new_h = []    # indices of added hydrogens in the new topology
        rng = np.random.RandomState(9157)

        for chain in self.topology.chains():
            nc = new_top.addChain(chain.id)
            chain_res = list(chain.residues())
            for ri, res in enumerate(chain_res):
                is_nterm = res is chain_res[0]
                is_cterm = res is chain_res[-1]
                key = None
                if res.name in defs or any(
                        p + res.name in defs for p in ("N", "C")):
                    if variants is not None \
                            and variants[residues.index(res)] is not None:
                        key = variants[residues.index(res)]
                    else:
                        key = self._pick_variant(res, pH, is_nterm, is_cterm,
                                                 bonded)
                    actual_variants[residues.index(res)] = \
                        key if key != res.name else None
                    if is_nterm and ("N" + key) in defs:
                        key = "N" + key
                    elif is_cterm and ("C" + key) in defs:
                        key = "C" + key
                    if key not in defs:
                        key = None
                nr = new_top.addResidue(res.name, nc, res.id,
                                        res.insertionCode)
                heavy_by_name = {}
                for atom in res.atoms():
                    is_h = atom.element is not None \
                        and atom.element.symbol == "H"
                    if is_h and key is not None:
                        continue    # hydrogens are rebuilt from the template
                    na = new_top.addAtom(atom.name, atom.element, nr)
                    atom_map[atom] = na
                    new_pos.append(pos[atom.index].copy())
                    if not is_h:
                        heavy_by_name[atom.name] = (na, pos[atom.index])
                if key is None:
                    continue
                for hname, pname in defs[key]:
                    if pname not in heavy_by_name or \
                            any(a.name == hname for a in nr.atoms()):
                        continue
                    parent, ppos = heavy_by_name[pname]
                    # direction away from the parent's other neighbors
                    orig_parent = next(a for a in res.atoms()
                                       if a.name == pname)
                    dirs = []
                    for nbat in bonded.get(orig_parent, []):
                        if nbat.element is not None \
                                and nbat.element.symbol == "H":
                            continue
                        v = pos[nbat.index] - ppos
                        n = np.linalg.norm(v)
                        if n > 1e-6:
                            dirs.append(v / n)
                    if dirs:
                        d = -np.sum(dirs, axis=0)
                        n = np.linalg.norm(d)
                        d = d / n if n > 1e-6 else rng.randn(3)
                    else:
                        d = rng.randn(3)
                    d = d / np.linalg.norm(d) + 0.25 * rng.randn(3)
                    d /= np.linalg.norm(d)
                    ha = new_top.addAtom(hname, Element.getBySymbol("H"), nr)
                    new_top.addBond(parent, ha)
                    new_h.append(len(new_pos))
                    new_pos.append(ppos + 0.10 * d)
        for bond in self.topology.bonds():
            if bond[0] in atom_map and bond[1] in atom_map:
                new_top.addBond(atom_map[bond[0]], atom_map[bond[1]],
                                bond.type, bond.order)
        self.topology = new_top
        self.positions = u.Quantity([Vec3(*p) for p in new_pos], u.nanometer)

        if forcefield is not None and new_h:
            self._relax_hydrogens(forcefield, new_h, platform)
        return actual_variants

    def _relax_hydrogens(self, forcefield, h_indices, platform=None):
        """Energy-minimize only the newly placed hydrogens, on `platform`
        (the default Platform, the card, unless the caller names
        another): the heavy atoms are fixed by a mass of 0."""
        from ..context import Context
        from ..integrators import VerletIntegrator
        from ..minimize import LocalEnergyMinimizer
        system = forcefield.createSystem(self.topology)
        h_set = set(h_indices)
        for i in range(system.getNumParticles()):
            if i not in h_set:
                system.setParticleMass(i, 0.0)
        ctx = Context(system, VerletIntegrator(0.001), platform)
        ctx.setPositions(self.positions)
        LocalEnergyMinimizer.minimize(ctx, 10.0, 60)
        self.positions = ctx.getState(getPositions=True).getPositions()
