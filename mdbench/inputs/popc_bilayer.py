"""The pre-equilibrated 32,512-atom POPC bilayer (128 POPC lipids, 5,120
TIP3P waters) with amber14-lipid and amber14-tip3p parameters: the tables
(numpy arrays) from which the benchmark builds the program's System and its
reference.

popc_bilayer.npz beside this file is a frozen copy of the port's
models/data/popc_bilayer.npz: the patch's coordinates (molecules whole) and
box, the template of each residue, and one template a molecule (masses,
nonbonded parameters, exceptions, constraints at HBonds, bonds, angles,
torsions). The System is the templates replicated over the residues, as
the port's models/builders.py:replicate_templates does. The coordinates
are the same for every seed; the seed draws the velocities and the noise.
"""
from __future__ import annotations

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "popc_bilayer.npz")
TEMPLATES = ("lipid", "water")
RESIDUE_NAMES = ("POP", "HOH")
ATOM_KEYS = ("masses", "charges", "sigma", "epsilon")
# (template atoms key, template parameters key, table prefix)
TERM_KEYS = (("exception_pairs", "exception_params", "exception"),
             ("constraint_pairs", "constraint_distances", "constraint"),
             ("bond_pairs", "bond_params", "bond"),
             ("angle_triples", "angle_params", "angle"),
             ("torsion_quads", "torsion_params", "torsion"))


def load() -> dict:
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


def replicate(data, layout) -> dict:
    """Atom arrays and term lists of the residues whose templates (indices
    into TEMPLATES) `layout` lists in order: each residue's atoms follow the
    last residue's, its terms are its template's moved to its first atom,
    in the order of the residues."""
    layout = np.asarray(layout, np.int64)
    sizes = np.asarray([len(data[t + "_masses"]) for t in TEMPLATES])
    offsets = np.concatenate([[0], np.cumsum(sizes[layout])[:-1]])
    out = {key: np.concatenate([data[TEMPLATES[t] + "_" + key]
                                for t in layout]) for key in ATOM_KEYS}
    for atoms_key, par_key, prefix in TERM_KEYS:
        atoms, pars, owner = [], [], []
        for t, name in enumerate(TEMPLATES):
            res = np.nonzero(layout == t)[0]
            tmpl = data[name + "_" + atoms_key]
            par = data[name + "_" + par_key]
            atoms.append((tmpl[None] + offsets[res, None, None])
                         .reshape(-1, tmpl.shape[1]))
            pars.append(np.tile(par, (len(res),) + (1,) * (par.ndim - 1)))
            owner.append(np.repeat(res, len(tmpl)))
        order = np.argsort(np.concatenate(owner), kind="stable")
        out[prefix + ("_pairs" if prefix in ("exception", "constraint")
                      else "_atoms")] = np.concatenate(atoms)[order]
        out[prefix + ("_distances" if prefix == "constraint"
                      else "_params")] = np.concatenate(pars)[order]
    runs = []
    for t in layout:
        if runs and runs[-1][0] == RESIDUE_NAMES[t]:
            runs[-1][2] += 1
        else:
            runs.append([RESIDUE_NAMES[t], int(sizes[t]), 1])
    out["molecules"] = [tuple(r) for r in runs]
    return out


def build(config: dict, seed: int) -> dict:
    """The patch's tables at the configuration's nonbonded settings
    (`seed` does not enter: the coordinates are the patch's). With
    config["crop"] = [lipids, waters], only the patch's first lipids and
    waters, in its box (a size for tests on the CPU)."""
    data = load()
    layout = data["residue_template"]
    positions = data["positions"].astype(np.float64)
    if "crop" in config:
        lipids, waters = config["crop"]
        size = len(data["lipid_masses"])
        first_water = int(np.count_nonzero(layout == 0)) * size
        positions = np.concatenate([positions[:lipids * size], positions[
            first_water:first_water + 3 * waters]])
        layout = np.array([0] * lipids + [1] * waters)
    out = replicate(data, layout)
    out.update({
        "box": np.diag(data["box"].astype(np.float64)),
        "positions": positions,
        "cutoff": float(config["cutoff_nm"]),
        "ewald_tolerance": float(config["ewald_tolerance"]),
        "dispersion_correction": bool(config["dispersion_correction"]),
        "cmm_frequency": int(config["cmm_frequency"]),
    })
    return out
