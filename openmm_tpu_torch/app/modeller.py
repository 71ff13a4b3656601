"""The membrane patches that Modeller.addMembrane places.

Only the patch loader of openmm_tpu/app/modeller.py (_load_membrane_patch,
:19-70) is ported so far; the Modeller class waits for the next slice of
the app layer (ROADMAP item 9). A patch is data/<name>.npz, the port's own
copy (POPC: 128 POPC lipids and 5,120 TIP3P waters, 32,512 atoms).
"""
from __future__ import annotations

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
