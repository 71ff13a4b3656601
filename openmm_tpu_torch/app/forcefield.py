"""ForceField: force-field files -> System.

The port's copy of openmm_tpu/app/forcefield.py (after OpenMM's
wrappers/python/openmm/app/forcefield.py): the same XML schema (AtomTypes,
Residues with Atom/Bond/ExternalBond/VirtualSite, Patches, one section a
force) and the compact JSON format openmm-tpu-ff-1 of the files under
data/, the port's own copies. A name is looked up there and nowhere else.
Every topology residue is matched to a template by graph isomorphism
(_match_residue, one Python matcher: the JAX package tries a C helper
first), and residues with the same name, atoms and bonds share one match
(the cache of createSystem). createSystem then builds the System's forces
(the bonded forces, NonbondedForce with its exceptions from the bond
graph, GBSAOBCForce) and runs the registered generators of the other
sections (ffgenerators.py, ffgenerators_amoeba.py). The NonbondedForce's
exceptions are made after the generators' forces, so that a Drude
particle shares its parent's (OpenMM's order).

Numbers go into the System in MD units: a Quantity argument is stripped
(unit.strip), a plain number is taken as already in MD units.
"""
from __future__ import annotations

import itertools
import math
import os
import xml.etree.ElementTree as etree
from collections import defaultdict

from .. import forces as mmforces
from .. import unit as u
from ..exceptions import OpenMMException
from ..system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                      ThreeParticleAverageSite, TwoParticleAverageSite)
from ..vec3 import Vec3
from .element import Element


# -- app-layer singleton options (app/internal/singleton.py pattern) ---------
class _Singleton(object):
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return type(self).__name__


class NoCutoff(_Singleton):
    pass


class CutoffNonPeriodic(_Singleton):
    pass


class CutoffPeriodic(_Singleton):
    pass


class Ewald(_Singleton):
    pass


class PME(_Singleton):
    pass


class LJPME(_Singleton):
    pass


class HBonds(_Singleton):
    pass


class AllBonds(_Singleton):
    pass


class HAngles(_Singleton):
    pass


class HCT(_Singleton):
    pass


class OBC1(_Singleton):
    pass


class OBC2(_Singleton):
    pass


class GBn(_Singleton):
    pass


class GBn2(_Singleton):
    pass


HCT = HCT()
OBC1 = OBC1()
OBC2 = OBC2()
GBn = GBn()
GBn2 = GBn2()

NoCutoff = NoCutoff()
CutoffNonPeriodic = CutoffNonPeriodic()
CutoffPeriodic = CutoffPeriodic()
Ewald = Ewald()
PME = PME()
LJPME = LJPME()
HBonds = HBonds()
AllBonds = AllBonds()
HAngles = HAngles()

_METHOD_MAP = {
    NoCutoff: mmforces.NonbondedForce.NoCutoff,
    CutoffNonPeriodic: mmforces.NonbondedForce.CutoffNonPeriodic,
    CutoffPeriodic: mmforces.NonbondedForce.CutoffPeriodic,
    Ewald: mmforces.NonbondedForce.Ewald,
    PME: mmforces.NonbondedForce.PME,
    LJPME: mmforces.NonbondedForce.LJPME,
}

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _convert(value, unit):
    return float(u.strip(float(value), unit))


class _AtomType(object):
    __slots__ = ("name", "atomClass", "mass", "element")

    def __init__(self, name, atomClass, mass, element):
        self.name = name
        self.atomClass = atomClass
        self.mass = mass
        self.element = element


class _TemplateAtom(object):
    def __init__(self, name, type_name, element, params):
        self.name = name
        self.type = type_name
        self.element = element
        self.params = params  # extra attributes (e.g. charge)
        self.bondedTo = []
        self.externalBonds = 0


class _Template(object):
    def __init__(self, name):
        self.name = name
        self.atoms = []
        self.bonds = []            # (i, j)
        self.externalBonds = []    # atom indices
        self.virtualSites = []     # dicts

    def atom_index(self, name):
        for i, a in enumerate(self.atoms):
            if a.name == name:
                return i
        raise OpenMMException("residue template %s: unknown atom %s"
                              % (self.name, name))


class _Patch(object):
    """A residue-template modification (<Patch> sections, forcefield.py:475):
    add/change/remove atoms and bonds across one or more residue slots.
    Multi-residue patch atom names use the "slot:name" prefix."""

    def __init__(self, name, num_residues):
        self.name = name
        self.numResidues = num_residues
        self.addedAtoms = [[] for _ in range(num_residues)]     # (name, type, params)
        self.changedAtoms = [[] for _ in range(num_residues)]   # (name, type, params)
        self.deletedAtoms = []          # (slot, name)
        self.addedBonds = []            # ((slot, name), (slot, name))
        self.deletedBonds = []
        self.addedExternalBonds = []    # (slot, name)
        self.deletedExternalBonds = []
        self.virtualSites = [[] for _ in range(num_residues)]   # vs dicts

    @staticmethod
    def _slot_name(text):
        if ":" in text:
            slot, name = text.split(":", 1)
            return int(slot) - 1, name
        return 0, text

    def createPatchedTemplates(self, templates):
        """Apply this patch to one template per residue slot; cross-slot
        bonds become external bonds on both ends."""
        if len(templates) != self.numResidues:
            raise OpenMMException(
                "patch %s requires %d templates" % (self.name,
                                                    self.numResidues))
        out = []
        for slot, template in enumerate(templates):
            deleted = {name for (s, name) in self.deletedAtoms if s == slot}
            changed = {a[0]: a for a in self.changedAtoms[slot]}
            atoms = []
            for a in template.atoms:
                if a.name in deleted:
                    continue
                if a.name in changed:
                    _, tname, params, _el = changed[a.name]
                    na = _TemplateAtom(a.name, tname, a.element,
                                       dict(a.params, **params))
                else:
                    na = _TemplateAtom(a.name, a.type, a.element,
                                       dict(a.params))
                atoms.append(na)
            for (name, tname, params, el) in self.addedAtoms[slot]:
                atoms.append(_TemplateAtom(name, tname, el, dict(params)))
            index = {a.name: i for i, a in enumerate(atoms)}

            # bonds: survivors of the original + added intra-slot bonds
            del_bonds = set()
            for ((s1, n1), (s2, n2)) in self.deletedBonds:
                if s1 == slot and s2 == slot:
                    del_bonds.add(frozenset((n1, n2)))
            bonds = []
            for (i, j) in template.bonds:
                n1 = template.atoms[i].name
                n2 = template.atoms[j].name
                if n1 in deleted or n2 in deleted:
                    continue
                if frozenset((n1, n2)) in del_bonds:
                    continue
                bonds.append((index[n1], index[n2]))
            external = []
            for i in template.externalBonds:
                name = template.atoms[i].name
                if name in deleted:
                    continue
                if (slot, name) in self.deletedExternalBonds:
                    continue
                external.append(index[name])
            for ((s1, n1), (s2, n2)) in self.addedBonds:
                if s1 == slot and s2 == slot:
                    bonds.append((index[n1], index[n2]))
                elif s1 == slot:
                    external.append(index[n1])
                elif s2 == slot:
                    external.append(index[n2])
            for (s, name) in self.addedExternalBonds:
                if s == slot:
                    external.append(index[name])

            nt = _Template(template.name + "-" + self.name)
            nt.atoms = atoms
            for (i, j) in bonds:
                nt.bonds.append((i, j))
                atoms[i].bondedTo.append(j)
                atoms[j].bondedTo.append(i)
            for i in external:
                nt.externalBonds.append(i)
                atoms[i].externalBonds += 1
            # virtual sites: survivors (reindexed by name) + patch-added
            for vs in template.virtualSites:
                names = set()
                site = vs.get("siteName")
                if site is not None:
                    names.add(site)
                    k = 1
                    while ("atomName%d" % k) in vs:
                        names.add(vs["atomName%d" % k])
                        k += 1
                    if names & deleted:
                        continue
                nt.virtualSites.append(dict(vs))
            nt.virtualSites.extend(dict(vs)
                                   for vs in self.virtualSites[slot])
            out.append(nt)
        return out


class ForceField(object):
    def __init__(self, *files):
        self._atomTypes = {}
        self._templates = {}
        self._bond_gen = []
        self._angle_gen = []
        self._proper_gen = []
        self._improper_gen = []
        self._rb_gen = []
        self._nonbonded = None     # dict with coulomb14scale etc.
        self._nb_params = {}       # type -> (charge, sigma, epsilon)
        self._gbsa_params = {}     # type -> (charge?, radius, scale)
        self._gbsa_cfg = None
        self._scripts = []
        self._generators = []
        self._patches = {}            # name -> _Patch
        self._templatePatches = {}    # residue name -> {(patch, slot)}
        self._patched_cache = {}      # residue name -> [templates]
        self._templateGenerators = []
        self._wildcard = _AllTypesView(self)
        for f in files:
            self.loadFile(f)

    @property
    def _forces(self):
        """Registered generator objects (reference's ff._forces list)."""
        return self._generators

    def _findAtomTypes(self, attrib, num):
        """Per-slot sets of matching atom-type names; None marks an unknown
        type/class, the all-types view marks a wildcard (reference
        forcefield.py _findAtomTypes)."""
        types = []
        for i in range(num):
            suffix = "" if num == 1 else str(i + 1)
            class_attr = "class" + suffix
            type_attr = "type" + suffix
            if class_attr in attrib:
                if attrib[class_attr] == "":
                    types.append(self._wildcard)
                else:
                    matched = frozenset(self._class_types(attrib[class_attr]))
                    types.append(matched if matched else None)
            elif type_attr in attrib:
                val = attrib[type_attr]
                if val == "":
                    types.append(self._wildcard)
                elif val in self._atomTypes:
                    types.append(frozenset([val]))
                else:
                    types.append(None)
            else:
                types.append(None)
        return types

    def registerTemplateGenerator(self, generator):
        """Register a callback invoked when no template matches a residue:
        generator(forcefield, residue) -> bool; returning True means it
        registered a new template for the residue (reference
        forcefield.py registerTemplateGenerator)."""
        self._templateGenerators.append(generator)

    # ------------------------------------------------------------ parsing
    #: reference distribution names (wrappers/python/openmm/app/data, incl.
    #: the amber14/ and charmm36/ subdirectories) -> local converted JSONs,
    #: so ForceField('amber14/protein.ff14SB.xml', ...) works verbatim.
    _XML_ALIASES = {
        "amber14/DNA.OL15.xml": "amber14-dna.json",
        "amber14/DNA.bsc1.xml": "amber14-dna_bsc1.json",
        "amber14/RNA.OL3.xml": "amber14-rna.json",
        "amber14/lipid17.xml": "amber14-lipid.json",
        "amber14/protein.ff14SB.xml": "amber14-protein.json",
        "amber14/protein.ff15ipq.xml": "amber14-protein_ff15ipq.json",
        "amber14/spce.xml": "amber14-spce.json",
        "amber14/tip3p.xml": "amber14-tip3p.json",
        "amber14/tip3pfb.xml": "amber14-tip3pfb.json",
        "amber14/tip4pew.xml": "amber14-tip4pew.json",
        "amber14/tip4pfb.xml": "amber14-tip4pfb.json",
        "charmm36/spce.xml": "charmm36_spce.json",
        "charmm36/tip3p-pme-b.xml": "charmm36_tip3p_pme_b.json",
        "charmm36/tip3p-pme-f.xml": "charmm36_tip3p_pme_f.json",
        "charmm36/tip4p2005.xml": "charmm36_tip4p2005.json",
        "charmm36/tip4pew.xml": "charmm36_tip4pew.json",
        "charmm36/tip5p.xml": "charmm36_tip5p.json",
        "charmm36/tip5pew.xml": "charmm36_tip5pew.json",
        "charmm36/water.xml": "charmm36_water.json",
        "amber99_obc.xml": "amber99-obc.json",
    }

    def loadFile(self, file):
        if isinstance(file, str):
            path = file
            if not os.path.exists(path):
                alias = self._XML_ALIASES.get(file)
                if alias is None and file.endswith(".xml"):
                    stem = os.path.basename(file)[:-4] + ".json"
                    if os.path.exists(os.path.join(_DATA_DIR, stem)):
                        alias = stem
                candidate = os.path.join(_DATA_DIR, alias or file)
                if os.path.exists(candidate):
                    path = candidate
                else:
                    raise OpenMMException("force field file not found: " + file)
            if path.endswith(".json"):
                return self._load_json(path)
            tree = etree.parse(path)
        else:
            tree = etree.parse(file)
        root = tree.getroot()
        for include in root.findall("Include"):
            self.loadFile(include.attrib["file"])
        for types in root.findall("AtomTypes"):
            for t in types.findall("Type"):
                element = None
                if "element" in t.attrib:
                    element = Element.getBySymbol(t.attrib["element"])
                self._atomTypes[t.attrib["name"]] = _AtomType(
                    t.attrib["name"], t.attrib.get("class", t.attrib["name"]),
                    float(t.attrib["mass"]), element)
        for residues in root.findall("Residues"):
            for res in residues.findall("Residue"):
                self._parse_template(res)
        for patches in root.findall("Patches"):
            for pnode in patches.findall("Patch"):
                self._parse_patch(pnode)
        for section in root.findall("HarmonicBondForce"):
            for b in section.findall("Bond"):
                self._bond_gen.append((
                    self._types_or_classes(b, 2),
                    float(b.attrib["length"]), float(b.attrib["k"])))
        for section in root.findall("HarmonicAngleForce"):
            for a in section.findall("Angle"):
                self._angle_gen.append((
                    self._types_or_classes(a, 3),
                    float(a.attrib["angle"]), float(a.attrib["k"])))
        for section in root.findall("PeriodicTorsionForce"):
            ordering = section.attrib.get("ordering", "default")
            for t in section.findall("Proper"):
                terms = self._torsion_terms(t)
                self._proper_gen.append((self._types_or_classes(t, 4), terms))
            for t in section.findall("Improper"):
                terms = self._torsion_terms(t)
                self._improper_gen.append((self._types_or_classes(t, 4),
                                           terms, ordering))
        for section in root.findall("RBTorsionForce"):
            for t in section.findall("Proper"):
                cs = [float(t.attrib.get("c%d" % i, 0)) for i in range(6)]
                self._rb_gen.append((self._types_or_classes(t, 4), cs))
        for section in root.findall("NonbondedForce"):
            if self._nonbonded is None:
                self._nonbonded = {
                    "coulomb14scale": float(section.attrib.get("coulomb14scale", 0.833333)),
                    "lj14scale": float(section.attrib.get("lj14scale", 0.5)),
                    "useChargeFromResidue": False,
                }
            for a in section.findall("UseAttributeFromResidue"):
                if a.attrib["name"] == "charge":
                    self._nonbonded["useChargeFromResidue"] = True
            for a in section.findall("Atom"):
                key = a.attrib.get("type")
                keys = [key] if key is not None else self._class_types(a.attrib["class"])
                for k in keys:
                    self._nb_params[k] = (
                        float(a.attrib.get("charge", 0.0)),
                        float(a.attrib.get("sigma", 1.0)),
                        float(a.attrib.get("epsilon", 0.0)))
        for section in root.findall("GBSAOBCForce"):
            self._gbsa_cfg = {}
            for a in section.findall("Atom"):
                key = a.attrib.get("type")
                keys = [key] if key is not None else self._class_types(a.attrib["class"])
                for k in keys:
                    self._gbsa_params[k] = (float(a.attrib.get("charge", 0.0)),
                                            float(a.attrib["radius"]),
                                            float(a.attrib["scale"]))
        # registry-based generator sections (ffgenerators.py PARSERS:
        # CMAP, LennardJones/NBFIX, Custom*, Drude, AMOEBA family)
        from . import ffgenerators
        for child in root:
            ffgenerators.parse_section(child, self)

    def _load_json(self, path):
        """Load openmm-tpu's compact JSON parameter format (produced by
        tools/convert_ff.py from published force-field parameter sets)."""
        import json
        with open(path) as f:
            data = json.load(f)
        if data.get("format") != "openmm-tpu-ff-1":
            raise OpenMMException("unrecognised force field JSON: " + path)
        for name, cls, mass, element in data["atom_types"]:
            el = Element.getBySymbol(element) if element else None
            self._atomTypes[name] = _AtomType(name, cls, float(mass), el)

        def resolve(spec_list):
            out = []
            for spec in spec_list:
                if spec is None:
                    out.append(None)
                elif spec[0] == "type":
                    out.append(frozenset([spec[1]]))
                else:
                    out.append(frozenset(self._class_types(spec[1])))
            return out

        for name, r in data["residues"].items():
            template = _Template(name)
            for aname, tname, extra in r["atoms"]:
                at = self._atomTypes.get(tname)
                template.atoms.append(_TemplateAtom(
                    aname, tname, at.element if at else None,
                    {k: float(v) for k, v in extra.items()}))
            for i, j in r["bonds"]:
                template.bonds.append((i, j))
                template.atoms[i].bondedTo.append(j)
                template.atoms[j].bondedTo.append(i)
            for i in r["external"]:
                template.externalBonds.append(i)
                template.atoms[i].externalBonds += 1
            template.virtualSites = list(r.get("virtual_sites", []))
            self._templates[name] = template
        for spec, length, k in data["bonds"]:
            self._bond_gen.append((resolve(spec), length, k))
        for spec, angle, k in data["angles"]:
            self._angle_gen.append((resolve(spec), angle, k))
        for spec, terms in data["propers"]:
            self._proper_gen.append((resolve(spec),
                                     [tuple(t) for t in terms]))
        for spec, terms, ordering in data["impropers"]:
            self._improper_gen.append((resolve(spec),
                                       [tuple(t) for t in terms], ordering))
        for spec, cs in data.get("rb_torsions", []):
            self._rb_gen.append((resolve(spec), cs))
        nb = data.get("nonbonded")
        if nb is not None:
            if self._nonbonded is None:
                self._nonbonded = {
                    "coulomb14scale": nb["coulomb14scale"],
                    "lj14scale": nb["lj14scale"],
                    "useChargeFromResidue": nb["useChargeFromResidue"],
                }
            elif nb["useChargeFromResidue"]:
                self._nonbonded["useChargeFromResidue"] = True
            for kind, key, charge, sigma, eps in nb["atoms"]:
                keys = [key] if kind == "type" else self._class_types(key)
                for k in keys:
                    self._nb_params[k] = (charge, sigma, eps)
        gb = data.get("gbsa")
        if gb is not None:
            if self._gbsa_cfg is None:
                self._gbsa_cfg = {}
            for kind, key, charge, radius, scale in gb["atoms"]:
                keys = [key] if kind == "type" else self._class_types(key)
                for k in keys:
                    self._gbsa_params[k] = (charge, radius, scale)
        # serialized generator sections (CMAP, NBFIX, Custom*, Drude,
        # AMOEBA, Patches) -> same registry as the XML path
        if data.get("sections"):
            from . import ffgenerators
            for text in data["sections"]:
                child = etree.fromstring(text)
                if child.tag == "Patches":
                    for pnode in child.findall("Patch"):
                        self._parse_patch(pnode)
                else:
                    ffgenerators.parse_section(child, self)

    def _class_types(self, cls):
        return [t.name for t in self._atomTypes.values() if t.atomClass == cls]

    @staticmethod
    def _torsion_terms(node):
        terms = []
        i = 1
        while ("periodicity%d" % i) in node.attrib:
            terms.append((int(node.attrib["periodicity%d" % i]),
                          float(node.attrib["phase%d" % i]),
                          float(node.attrib["k%d" % i])))
            i += 1
        return terms

    def _types_or_classes(self, node, n):
        """Return per-slot sets of matching type names; None = wildcard."""
        out = []
        for i in range(1, n + 1):
            t = node.attrib.get("type%d" % i)
            c = node.attrib.get("class%d" % i)
            if t is not None:
                out.append(None if t == "" else frozenset([t]))
            elif c is not None:
                out.append(None if c == "" else
                           frozenset(self._class_types(c)))
            else:
                out.append(None)
        return out

    def _parse_patch(self, node):
        patch = _Patch(node.attrib["name"],
                       int(node.attrib.get("residues", "1")))
        sn = _Patch._slot_name
        for child in node:
            if child.tag == "AddAtom":
                slot, name = sn(child.attrib["name"])
                tname = child.attrib["type"]
                at = self._atomTypes.get(tname)
                params = {k: float(v) for k, v in child.attrib.items()
                          if k not in ("name", "type")}
                patch.addedAtoms[slot].append(
                    (name, tname, params, at.element if at else None))
            elif child.tag == "ChangeAtom":
                slot, name = sn(child.attrib["name"])
                params = {k: float(v) for k, v in child.attrib.items()
                          if k not in ("name", "type")}
                patch.changedAtoms[slot].append(
                    (name, child.attrib["type"], params, None))
            elif child.tag == "RemoveAtom":
                patch.deletedAtoms.append(sn(child.attrib["name"]))
            elif child.tag == "AddBond":
                patch.addedBonds.append((sn(child.attrib["atomName1"]),
                                         sn(child.attrib["atomName2"])))
            elif child.tag == "RemoveBond":
                patch.deletedBonds.append((sn(child.attrib["atomName1"]),
                                           sn(child.attrib["atomName2"])))
            elif child.tag == "AddExternalBond":
                patch.addedExternalBonds.append(sn(child.attrib["atomName"]))
            elif child.tag == "RemoveExternalBond":
                patch.deletedExternalBonds.append(
                    sn(child.attrib["atomName"]))
            elif child.tag == "ApplyToResidue":
                slot, resname = sn(child.attrib["name"])
                self._templatePatches.setdefault(resname, set()).add(
                    (patch.name, slot))
            elif child.tag == "VirtualSite":
                vs = dict(child.attrib)
                slot, site = sn(vs.get("siteName", vs.get("index", "0")))
                if "siteName" in vs:
                    vs["siteName"] = site
                patch.virtualSites[slot].append(vs)
        self._patches[patch.name] = patch
        self._patched_cache.clear()

    def registerPatch(self, patch):
        self._patches[patch.name] = patch
        self._patched_cache.clear()

    def registerTemplatePatch(self, residue, patch, patchResidueIndex=0):
        self._templatePatches.setdefault(residue, set()).add(
            (patch, patchResidueIndex))
        self._patched_cache.clear()

    def _patched_templates_for(self, resname):
        """Lazily build single-slot patched variants of every template that
        a patch declares applicable to `resname`."""
        if resname in self._patched_cache:
            return self._patched_cache[resname]
        out = []
        for (pname, slot) in sorted(self._templatePatches.get(resname, ())):
            patch = self._patches.get(pname)
            base = self._templates.get(resname)
            if patch is None or base is None:
                continue
            if patch.numResidues == 1:
                try:
                    out.extend(patch.createPatchedTemplates([base]))
                except Exception:
                    continue
            else:
                # single-slot view of a multi-residue patch: patch only this
                # slot; cross-slot bonds appear as external bonds
                templates = [base if s == slot else _Template("_other")
                             for s in range(patch.numResidues)]
                for s, t in enumerate(templates):
                    if s != slot:
                        t.atoms = []
                try:
                    out.append(
                        patch.createPatchedTemplates(templates)[slot])
                except Exception:
                    continue
        self._patched_cache[resname] = out
        return out

    def _parse_template(self, node):
        template = _Template(node.attrib["name"])
        for child in node:
            if child.tag == "Atom":
                type_name = child.attrib["type"]
                at = self._atomTypes.get(type_name)
                params = {k: float(v) for k, v in child.attrib.items()
                          if k not in ("name", "type")}
                template.atoms.append(_TemplateAtom(
                    child.attrib["name"], type_name,
                    at.element if at else None, params))
            elif child.tag == "Bond":
                if "atomName1" in child.attrib:
                    i = template.atom_index(child.attrib["atomName1"])
                    j = template.atom_index(child.attrib["atomName2"])
                else:
                    i = int(child.attrib["from"])
                    j = int(child.attrib["to"])
                template.bonds.append((i, j))
                template.atoms[i].bondedTo.append(j)
                template.atoms[j].bondedTo.append(i)
            elif child.tag == "ExternalBond":
                if "atomName" in child.attrib:
                    i = template.atom_index(child.attrib["atomName"])
                else:
                    i = int(child.attrib["from"])
                template.externalBonds.append(i)
                template.atoms[i].externalBonds += 1
            elif child.tag == "VirtualSite":
                template.virtualSites.append(dict(child.attrib))
            elif child.tag == "AllowPatch":
                slot, pname = _Patch._slot_name(child.attrib["name"])
                self._templatePatches.setdefault(template.name, set()).add(
                    (pname, slot))
        self._templates[template.name] = template
        self._patched_cache.clear()

    def getMatchingTemplates(self, topology):
        graphs = self._residue_graphs(topology)
        return [self._match_residue(res, graphs[res])[0]
                for res in topology.residues()]

    def registerGenerator(self, generator):
        self._generators.append(generator)

    def registerResidueTemplate(self, template):
        self._templates[template.name] = template

    # -------------------------------------------------------- template match
    @staticmethod
    def _residue_graphs(topology):
        """One pass over the topology's bonds -> {residue: (neigh, external)}
        with residue-local indices (avoids the per-residue bond rescan that
        is quadratic at water-box scale)."""
        local = {}
        info = {}
        for res in topology.residues():
            for i, a in enumerate(res.atoms()):
                local[a] = i
            info[res] = (defaultdict(list), defaultdict(int))
        for b in topology.bonds():
            r1, r2 = b[0].residue, b[1].residue
            if r1 is r2:
                neigh, _ = info[r1]
                i, j = local[b[0]], local[b[1]]
                neigh[i].append(j)
                neigh[j].append(i)
            else:
                info[r1][1][local[b[0]]] += 1
                info[r2][1][local[b[1]]] += 1
        return info

    @staticmethod
    def _template_spec(template):
        """(elements, external-bond counts, neighbour lists) of a template,
        cached on it: the graph _match_graphs takes."""
        spec = getattr(template, "_spec", None)
        if spec is None:
            spec = (
                tuple(a.element.atomic_number if a.element else -1
                      for a in template.atoms),
                tuple(a.externalBonds for a in template.atoms),
                tuple(tuple(a.bondedTo) for a in template.atoms),
                tuple(None if a.element else a.name
                      for a in template.atoms))
            template._spec = spec
        return spec

    @staticmethod
    def _residue_spec(res, graph):
        """The residue's graph in _template_spec's form, from the
        (neighbours, external bonds) of _residue_graphs."""
        neigh, external = graph
        atoms = list(res.atoms())
        return (tuple(a.element.atomic_number if a.element else -1
                      for a in atoms),
                tuple(external.get(i, 0) for i in range(len(atoms))),
                tuple(tuple(neigh.get(i, ())) for i in range(len(atoms))),
                tuple(None if a.element else a.name for a in atoms))

    def _match_residue(self, res, graph=None, _allow_generators=True):
        """(template, mapping) of a topology residue: the first template,
        patched ones last, whose graph is isomorphic to the residue's
        (forcefield.py:961 _matchResidue). mapping[i] is the template atom
        of the residue's atom i."""
        if graph is None:
            graph = self._residue_graphs(res.chain.topology)[res]
        res_spec = self._residue_spec(res, graph)
        n = len(res_spec[0])
        candidates = [t for t in self._templates.values()
                      if len(t.atoms) == n]
        patched = [t for t in self._patched_templates_for(res.name)
                   if len(t.atoms) == n] if self._patches else []
        for template in candidates + patched:
            mapping = _match_graphs(res_spec, self._template_spec(template))
            if mapping is not None:
                return template, mapping
        # user template generators get one chance to supply a template
        # (OpenMM's registerTemplateGenerator semantics)
        if _allow_generators:
            for gen in self._templateGenerators:
                if gen(self, res):
                    self._patched_cache.clear()
                    return self._match_residue(res, graph,
                                               _allow_generators=False)
        raise OpenMMException(
            "No template found for residue %d (%s).  %s" % (
                res.index + 1, res.name,
                "The set of atoms matches no template." if candidates
                else "No template has the right number of atoms."))

    # ------------------------------------------------------------ createSystem
    def createSystem(self, topology, nonbondedMethod=NoCutoff,
                     nonbondedCutoff=1.0 * u.nanometer, constraints=None,
                     rigidWater=None, removeCMMotion=True, hydrogenMass=None,
                     residueTemplates=None, ignoreExternalBonds=False,
                     switchDistance=None, flexibleConstraints=False,
                     ewaldErrorTolerance=5e-4, useDispersionCorrection=True,
                     soluteDielectric=1.0, solventDielectric=78.5, **kwargs):
        if rigidWater is None:
            rigidWater = constraints is not None
        sys = System()
        atoms = list(topology.atoms())
        n = len(atoms)

        # match templates, assign types
        atom_type = [None] * n
        template_info = []   # (residue, template, mapping)
        res_graphs = self._residue_graphs(topology)
        matches = {}     # (name, graph) -> (template, mapping)
        for res in topology.residues():
            key = (res.name, self._residue_spec(res, res_graphs[res]))
            if key not in matches:
                matches[key] = self._match_residue(res, res_graphs[res])
            template, mapping = matches[key]
            template_info.append((res, template, mapping))
            res_atoms = list(res.atoms())
            for local_i, a in enumerate(res_atoms):
                t_i = mapping[local_i]
                atom_type[a.index] = (template.atoms[t_i].type,
                                      template.atoms[t_i].params)

        # particles
        for a in atoms:
            tname, _ = atom_type[a.index]
            at = self._atomTypes[tname]
            sys.addParticle(at.mass)

        # virtual sites from templates; each site is excluded alongside its
        # first parent particle (the reference's excludeWith semantics), so
        # record a synthetic bond for exception generation
        vsite_bonds = []
        for (res, template, mapping) in template_info:
            res_atoms = list(res.atoms())
            local_of_template = {t: l for l, t in enumerate(mapping)}
            for vs in template.virtualSites:
                # attributes may be index-based (index/atom1...) or
                # name-based (siteName/atomName1...)
                if "index" in vs:
                    t_index = int(vs["index"])
                else:
                    t_index = template.atom_index(vs["siteName"])
                site_atom = res_atoms[local_of_template[t_index]].index

                def gat(key):
                    if key in vs:
                        return res_atoms[local_of_template[int(vs[key])]].index
                    name_key = key.replace("atom", "atomName")
                    return res_atoms[local_of_template[
                        template.atom_index(vs[name_key])]].index

                vsite_bonds.append((site_atom, gat("atom1")))
                if vs["type"] == "average2":
                    sys.setVirtualSite(site_atom, TwoParticleAverageSite(
                        gat("atom1"), gat("atom2"),
                        float(vs["weight1"]), float(vs["weight2"])))
                elif vs["type"] == "average3":
                    sys.setVirtualSite(site_atom, ThreeParticleAverageSite(
                        gat("atom1"), gat("atom2"), gat("atom3"),
                        float(vs["weight1"]), float(vs["weight2"]),
                        float(vs["weight3"])))
                elif vs["type"] == "outOfPlane":
                    sys.setVirtualSite(site_atom, OutOfPlaneSite(
                        gat("atom1"), gat("atom2"), gat("atom3"),
                        float(vs["weight12"]), float(vs["weight13"]),
                        float(vs["weightCross"])))
                elif vs["type"] == "localCoords":
                    n_p = 1
                    while ("atom%d" % (n_p + 1)) in vs \
                            or ("atomName%d" % (n_p + 1)) in vs:
                        n_p += 1
                    particles = [gat("atom%d" % (k + 1)) for k in range(n_p)]
                    ow = [float(vs["wo%d" % (k + 1)]) for k in range(n_p)]
                    wx = [float(vs["wx%d" % (k + 1)]) for k in range(n_p)]
                    wy = [float(vs["wy%d" % (k + 1)]) for k in range(n_p)]
                    lp = Vec3(float(vs["p1"]), float(vs["p2"]), float(vs["p3"]))
                    sys.setVirtualSite(site_atom, LocalCoordinatesSite(
                        particles, ow, wx, wy, lp))

        # box
        box = topology.getPeriodicBoxVectors()
        if box is not None:
            sys.setDefaultPeriodicBoxVectors(*box.value_in_unit(u.nanometer))

        # bond list
        bonds = [(b[0].index, b[1].index) for b in topology.bonds()]
        type_of = lambda i: atom_type[i][0]  # noqa: E731

        # identify waters for rigidWater
        is_water = [a.residue.name in ("HOH", "WAT", "H2O", "TIP3", "SOL")
                    for a in atoms]

        def is_h(i):
            el = atoms[i].element
            return el is not None and el.atomic_number == 1

        # angles from bond graph
        neigh = defaultdict(set)
        for (i, j) in bonds:
            neigh[i].add(j)
            neigh[j].add(i)
        angles = []
        for j in sorted(neigh):
            nb = sorted(neigh[j])
            for x in range(len(nb)):
                for y in range(x + 1, len(nb)):
                    angles.append((nb[x], j, nb[y]))

        # ---- constraints selection --------------------------------------
        constrained_bonds = set()

        def want_bond_constraint(i, j):
            if constraints is AllBonds or constraints is HAngles:
                return True
            if (constraints is HBonds) and (is_h(i) or is_h(j)):
                return True
            if rigidWater and is_water[i] and is_water[j]:
                return True
            return False

        # ---- harmonic bonds ------------------------------------------------
        bond_force = mmforces.HarmonicBondForce()
        bond_params = {}
        for (match, length, k) in self._bond_gen:
            bond_params[(match[0], match[1])] = (length, k)

        def lookup_pair(gen_list, t1, t2):
            for (match, *rest) in gen_list:
                s1, s2 = match
                if ((s1 is None or t1 in s1) and (s2 is None or t2 in s2)) or \
                   ((s1 is None or t2 in s1) and (s2 is None or t1 in s2)):
                    return rest
            return None

        bond_r0 = {}
        bond_found = {}         # each type pair looked up once
        for (i, j) in bonds:
            types = (type_of(i), type_of(j))
            if types not in bond_found:
                bond_found[types] = lookup_pair(self._bond_gen, *types)
            found = bond_found[types]
            if found is None:
                continue
            length, k = found
            bond_r0[(min(i, j), max(i, j))] = length
            if want_bond_constraint(i, j):
                sys.addConstraint(i, j, length)
                constrained_bonds.add((min(i, j), max(i, j)))
                if flexibleConstraints:
                    bond_force.addBond(i, j, length, k)
            else:
                bond_force.addBond(i, j, length, k)
        if bond_force.getNumBonds() > 0:
            sys.addForce(bond_force)

        # ---- angles ------------------------------------------------------------
        # the lookups below depend on the atoms' types only: each type
        # tuple is looked up once (a water box repeats a few thousandfold)
        angle_found = {}

        def angle_lookup(t1, t2, t3):
            for (match, theta0, kk) in self._angle_gen:
                s1, s2, s3 = match
                if (s2 is None or t2 in s2) and (
                        ((s1 is None or t1 in s1) and (s3 is None or t3 in s3))
                        or ((s1 is None or t3 in s1) and (s3 is None or t1 in s3))):
                    return (theta0, kk)
            return None

        angle_force = mmforces.HarmonicAngleForce()
        for (i, j, k_atom) in angles:
            key = (type_of(i), type_of(j), type_of(k_atom))
            if key not in angle_found:
                angle_found[key] = angle_lookup(*key)
            found = angle_found[key]
            if found is None:
                continue
            theta0, kk = found
            constrain_angle = (constraints is HAngles and is_h(i) and is_h(k_atom))
            water_angle = (rigidWater and is_water[i] and is_water[j]
                           and is_water[k_atom])
            if constrain_angle or water_angle:
                # constrain the 1-3 distance via law of cosines
                key1 = (min(i, j), max(i, j))
                key2 = (min(j, k_atom), max(j, k_atom))
                if key1 in bond_r0 and key2 in bond_r0:
                    l1, l2 = bond_r0[key1], bond_r0[key2]
                    d13 = math.sqrt(l1 * l1 + l2 * l2
                                    - 2 * l1 * l2 * math.cos(theta0))
                    sys.addConstraint(i, k_atom, d13)
                if not flexibleConstraints:
                    continue
            angle_force.addAngle(i, j, k_atom, theta0, kk)
        if angle_force.getNumAngles() > 0:
            sys.addForce(angle_force)

        # ---- torsions --------------------------------------------------------
        torsion_force = mmforces.PeriodicTorsionForce()
        propers = []
        for (i, j) in bonds:
            for a0 in neigh[i]:
                if a0 == j:
                    continue
                for b0 in neigh[j]:
                    if b0 == i or b0 == a0:
                        continue
                    propers.append((a0, i, j, b0))

        def match4(slots, ts):
            return all(s is None or t in s for s, t in zip(slots, ts))

        def proper_lookup(ts):
            best = None
            best_wild = 5
            for (slots, terms) in self._proper_gen:
                for cand in (ts, ts[::-1]):
                    if match4(slots, cand):
                        n_wild = sum(1 for s in slots if s is None)
                        if n_wild < best_wild:
                            best, best_wild = terms, n_wild
                        break
            return best

        proper_found = {}
        for quad in propers:
            ts = tuple(type_of(x) for x in quad)
            if ts not in proper_found:
                proper_found[ts] = proper_lookup(ts)
            best = proper_found[ts]
            if best:
                for (per, phase, kk) in best:
                    if kk != 0:
                        torsion_force.addTorsion(*quad, per, phase, kk)
        # impropers: central atom is the FIRST type slot; topology atoms are
        # the central atom j bonded to 3 others (forcefield.py improper logic)
        def improper_lookup(tj, tn):
            """(terms, positions in the neighbour list) of the first
            improper that matches a centre of type tj with neighbours of
            types tn, or None."""
            for (slots, terms, ordering) in self._improper_gen:
                s1 = slots[0]
                if s1 is not None and tj not in s1:
                    continue
                for perm in itertools.permutations(range(len(tn)), 3):
                    if match4(slots[1:], tuple(tn[x] for x in perm)):
                        return terms, perm
            return None

        improper_found = {}
        for j in sorted(neigh):
            nb = sorted(neigh[j])
            if len(nb) < 3:
                continue
            key = (type_of(j), tuple(type_of(x) for x in nb))
            if key not in improper_found:
                improper_found[key] = improper_lookup(*key)
            if improper_found[key] is not None:
                terms, perm = improper_found[key]
                a1, a2, a3 = (nb[x] for x in perm)
                for (per, phase, kk) in terms:
                    if kk != 0:
                        torsion_force.addTorsion(a1, a2, j, a3, per,
                                                 phase, kk)
        if torsion_force.getNumTorsions() > 0:
            sys.addForce(torsion_force)

        # ---- RB torsions -----------------------------------------------------
        if self._rb_gen:
            rb_force = mmforces.RBTorsionForce()
            rb_found = {}
            for quad in propers:
                ts = tuple(type_of(x) for x in quad)
                if ts not in rb_found:
                    rb_found[ts] = next(
                        (cs for (slots, cs) in self._rb_gen
                         if match4(slots, ts) or match4(slots, ts[::-1])),
                        None)
                if rb_found[ts] is not None:
                    rb_force.addTorsion(*quad, *rb_found[ts])
            if rb_force.getNumTorsions() > 0:
                sys.addForce(rb_force)

        # ---- nonbonded ----------------------------------------------------------
        if self._nonbonded is not None:
            nb = mmforces.NonbondedForce()
            method = _METHOD_MAP.get(nonbondedMethod, nonbondedMethod)
            nb.setNonbondedMethod(method)
            nb.setCutoffDistance(u.strip(nonbondedCutoff, u.nanometer))
            nb.setEwaldErrorTolerance(ewaldErrorTolerance)
            nb.setUseDispersionCorrection(useDispersionCorrection)
            if switchDistance is not None:
                nb.setUseSwitchingFunction(True)
                nb.setSwitchingDistance(u.strip(switchDistance, u.nanometer))
            for a in atoms:
                tname, tparams = atom_type[a.index]
                q, sigma, eps = self._nb_params.get(tname, (0.0, 1.0, 0.0))
                if self._nonbonded["useChargeFromResidue"]:
                    q = tparams.get("charge", 0.0)
                nb.addParticle(q, sigma, eps)
            sys.addForce(nb)

        # ---- GBSA-OBC -------------------------------------------------------------
        if self._gbsa_cfg is not None and self._gbsa_params:
            gb = mmforces.GBSAOBCForce()
            gb.setSoluteDielectric(soluteDielectric)
            gb.setSolventDielectric(solventDielectric)
            for a in atoms:
                tname, tparams = atom_type[a.index]
                q, radius, scale = self._gbsa_params.get(
                    tname, (0.0, 0.15, 0.8))
                if self._nonbonded and self._nonbonded["useChargeFromResidue"]:
                    q = tparams.get("charge", q)
                gb.addParticle(q, radius, scale)
            sys.addForce(gb)

        # ---- registered generators (parser sections + user callbacks) ----------
        data = _SystemData(atoms, atom_type, bonds, angles, propers,
                           template_info)
        data.atomBonds = [[] for _ in atoms]
        for (i, j) in bonds:
            b = _BondData(i, j)
            key = (min(i, j), max(i, j))
            b.isConstrained = (key in constrained_bonds
                               or want_bond_constraint(i, j))
            b.length = bond_r0.get(key, 0.0)
            data.atomBonds[i].append(len(data.bonds))
            data.atomBonds[j].append(len(data.bonds))
            data.bonds.append(b)
        data.bondedToAtom = neigh
        data.constrainedPairs = constrained_bonds   # dedup set, shared
        data.isAngleConstrained = [
            (constraints is HAngles and is_h(a) and is_h(c))
            or (rigidWater and is_water[a] and is_water[j]
                and is_water[c])
            for (a, j, c) in angles]
        args = dict(kwargs)
        args.setdefault("switchDistance",
                        None if switchDistance is None
                        else u.strip(switchDistance, u.nanometer))
        args.setdefault("flexibleConstraints", flexibleConstraints)
        cutoff_nm = u.strip(nonbondedCutoff, u.nanometer)
        postprocess = []
        for gen in self._generators:
            if hasattr(gen, "createForce"):
                gen.createForce(sys, data, nonbondedMethod, cutoff_nm, args)
                if hasattr(gen, "postprocessSystem"):
                    postprocess.append(gen)
            else:
                gen(sys, data, nonbondedMethod, nonbondedCutoff)
        # the NonbondedForce's exceptions once every generator has made its
        # force, as OpenMM's NonbondedGenerator.postprocessSystem makes
        # them: a Drude particle the DrudeForce's generator recorded as its
        # parent's child shares the parent's exclusions and 1-4 pairs
        if self._nonbonded is not None:
            from .ffgenerators import bonds_with_children
            nb.createExceptionsFromBonds(
                bonds_with_children(bonds + vsite_bonds,
                                    data.excludeAtomWith),
                self._nonbonded["coulomb14scale"],
                self._nonbonded["lj14scale"])
        for gen in postprocess:
            gen.postprocessSystem(sys, data, args)

        # ---- hydrogen mass repartitioning (forcefield.py createSystem) ---------
        if hydrogenMass is not None:
            h_mass = float(u.strip(hydrogenMass, u.dalton))
            for (i, j) in bonds:
                hi, hj = is_h(i), is_h(j)
                if hi == hj:
                    continue
                h, heavy = (i, j) if hi else (j, i)
                heavy_mass = u.strip(sys.getParticleMass(heavy), u.dalton)
                if heavy_mass <= h_mass:
                    continue
                transfer = h_mass - u.strip(sys.getParticleMass(h), u.dalton)
                if transfer != 0:
                    sys.setParticleMass(heavy, heavy_mass - transfer)
                    sys.setParticleMass(h, h_mass)

        if removeCMMotion:
            sys.addForce(mmforces.CMMotionRemover())
        return sys


def _match_graphs(res_spec, tpl_spec):
    """The isomorphism of a residue's graph onto a template's, as a list
    (residue atom -> template atom), or None. Both graphs are (elements,
    external-bond counts, neighbour lists); matched atoms agree in element,
    external bonds and degree, and every bond of the residue between
    matched atoms is a bond of the template. The residue's atoms are
    placed most constrained first (fewest atoms of the same element and
    degree, then highest degree, then index) and each tries the free
    template atoms in index order: the search of the JAX package's C
    matcher (openmm_tpu/_native/src/native.c match_residue), so both pick
    the same mapping where a residue has symmetric atoms. An extra
    particle (no element: a Drude particle, a lone pair, a water's M
    site), which has no bonds to tell it from the others, takes the
    template atom of its own name where the template has one (the JAX
    package maps them in the order they come, which gives a Drude
    particle or a lone pair another's parameters unless the residue
    lists them in the template's order)."""
    r_el, r_ext, r_nb, r_names = res_spec
    t_el, t_ext, t_nb, t_names = tpl_spec
    n = len(r_el)
    if n != len(t_el) or sorted(r_el) != sorted(t_el):
        return None
    r_deg = [len(x) for x in r_nb]
    t_deg = [len(x) for x in t_nb]
    cls = [(r_el[i], r_deg[i]) for i in range(n)]
    counts = {}
    for c in cls:
        counts[c] = counts.get(c, 0) + 1
    order = sorted(range(n), key=lambda i: (counts[cls[i]], -r_deg[i]))
    options = [[c for c in range(n) if t_el[c] == r_el[i]
                and t_deg[c] == r_deg[i] and t_ext[c] == r_ext[i]]
               for i in range(n)]
    extra_names = {name for name in t_names if name is not None}
    for i in range(n):
        if r_names[i] in extra_names:
            options[i] = [c for c in options[i] if t_names[c] == r_names[i]]
    if not all(options):
        return None
    t_sets = [frozenset(x) for x in t_nb]
    r2t = [-1] * n
    used = [False] * n

    def place(pos):
        if pos == n:
            return True
        ri = order[pos]
        for ci in options[ri]:
            if used[ci]:
                continue
            nbrs = t_sets[ci]
            if any(r2t[rn] >= 0 and r2t[rn] not in nbrs
                   for rn in r_nb[ri]):
                continue
            r2t[ri] = ci
            used[ci] = True
            if place(pos + 1):
                return True
            r2t[ri] = -1
            used[ci] = False
        return False

    return r2t if place(0) else None


class _AllTypesView(object):
    """Live set-view over every registered atom type: the wildcard match
    target (reference's ff._atomClasses[''])."""

    def __init__(self, ff):
        self._ff = ff

    def __contains__(self, t):
        return t in self._ff._atomTypes

    def __iter__(self):
        return iter(self._ff._atomTypes)

    def __len__(self):
        return len(self._ff._atomTypes)


class _BondData(object):
    """One topology bond with constraint bookkeeping (reference's
    SystemData bond entries)."""

    __slots__ = ("atom1", "atom2", "isConstrained", "length")

    def __init__(self, atom1, atom2):
        self.atom1 = atom1
        self.atom2 = atom2
        self.isConstrained = False
        self.length = 0.0


class _SystemData(object):
    """Bundle handed to registered generators, shaped like the reference's
    internal SystemData: atomType/atomParameters keyed by topology Atom,
    bonds as _BondData records, bondedToAtom adjacency."""

    def __init__(self, atoms, atom_type, bonds, angles, propers, templates):
        self.atoms = atoms
        # atom-object keyed views (reference semantics)
        self.atomType = {a: atom_type[a.index][0] for a in atoms}
        self.atomParameters = {a: atom_type[a.index][1] for a in atoms}
        self.angles = angles
        self.propers = propers
        self.templates = templates
        self.bonds = []                      # filled with _BondData records
        self.bondedToAtom = {}               # atom index -> neighbor set
        self.excludeAtomWith = defaultdict(list)
        self.virtualSites = {}
