"""Canonical PDB atom naming (the port's copy of openmm_tpu/app/pdbnames.py,
in the role of data/pdbNames.xml in OpenMM's
wrappers/python/openmm/app/pdbfile.py:118-136): historic PDB files use many
alternate atom names (O1P vs OP1, C5* vs C5', OT1 vs O, NME's methyl as C or
CA...). Normalizing on load lets bond templates and force-field matching use
one canonical vocabulary. Hydrogen alternates mostly don't matter here —
topology hydrogens bond by proximity — but the common ones are included so
written files use modern names."""
from __future__ import annotations

_PROTEIN = {
    "HN": "H", "1H": "H1", "2H": "H2", "3H": "H3",
    "HN1": "H1", "HN2": "H2", "HN3": "H3",
    "HT1": "H1", "HT2": "H2", "HT3": "H3",
    "O1": "O", "OT1": "O", "OCT1": "O", "OC1": "O",
    "O2": "OXT", "OT2": "OXT", "OCT2": "OXT", "OC2": "OXT", "OT": "OXT",
}

_NUCLEIC = {
    "O1P": "OP1", "O2P": "OP2", "O3P": "OP3",
    "H3T": "HO3'", "H5T": "HO5'",
}

_PER_RESIDUE = {
    "ILE": {"CD": "CD1", "HD1": "HD11", "HD2": "HD12", "HD3": "HD13"},
    "NME": {"C": "CH3", "CA": "CH3", "CT": "CH3",
            "H1": "HH31", "H2": "HH32", "H3": "HH33",
            "HA1": "HH31", "HA2": "HH32", "HA3": "HH33"},
    "ACE": {"CA": "CH3", "CT": "CH3", "HA1": "HH31", "HA2": "HH32",
            "HA3": "HH33", "H1": "HH31", "H2": "HH32", "H3": "HH33"},
    "HOH": {"OW": "O", "OH2": "O", "HW1": "H1", "HW2": "H2",
            "1H": "H1", "2H": "H2", "H": "H1"},
}

_PROTEIN_RESIDUES = frozenset([
    "ALA", "ARG", "ASN", "ASP", "ASH", "CYS", "CYX", "CYM", "GLN", "GLU",
    "GLH", "GLY", "HIS", "HID", "HIE", "HIP", "ILE", "LEU", "LYS", "LYN",
    "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL", "ACE", "NME",
])
_NUCLEIC_RESIDUES = frozenset([
    "A", "G", "C", "U", "I", "DA", "DG", "DC", "DT", "DI",
    "A3", "A5", "G3", "G5", "C3", "C5", "U3", "U5",
    "DA3", "DA5", "DG3", "DG5", "DC3", "DC5", "DT3", "DT5",
])
_WATER_RESIDUES = frozenset(["HOH", "WAT", "H2O", "TIP3", "SOL"])


def canonical_atom_name(res_name, atom_name):
    name = atom_name
    # 1HB3 -> HB31 style: leading digit rotates to the end
    if name[:1].isdigit() and len(name) > 1:
        name = name[1:] + name[0]
    name = name.replace("*", "'")
    if res_name in _WATER_RESIDUES:
        return _PER_RESIDUE["HOH"].get(name, name)
    per = _PER_RESIDUE.get(res_name)
    if per and name in per:
        return per[name]
    if res_name in _PROTEIN_RESIDUES and name in _PROTEIN:
        return _PROTEIN[name]
    if res_name in _NUCLEIC_RESIDUES and name in _NUCLEIC:
        return _NUCLEIC[name]
    return name
