"""The port's ForceField (openmm_tpu_torch.app.forcefield and
ffgenerators) against the JAX package's: for each force field and setting
the port's createSystem gives exactly the JAX ForceField's System (every
array of to_numpy equal to system_params of the JAX System, in the same
order), on the same topology: a capped peptide over the 20 standard
residues with waters, built from the force field's own templates (no
coordinates are needed to build a System), the cropped POPC bilayer, CHARMM
water with ions, and the generator sections of tests/test_ffgenerators.py
and more. The cropped bilayer's System then gives the JAX "Reference"
platform's energy and forces on the port's "CPU" platform in double
precision. A Drude or AMOEBA section raises instead of loading a file
without it."""
import functools
import os

import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu import unit as ju

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from test_ffgenerators import CMAP_XML, CUSTOM_XML
from torch_port_helpers import (_cropped_patch, assert_same_params,
                                port_topology, system_params,
                                template_topology)
from openmm_tpu_torch.unit import plain

PEPTIDE = ["ACE", "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY",
           "HIE", "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR",
           "TRP", "TYR", "VAL", "NME"]
BOX = 4.0   # nm

# a NonbondedForce for the XML fixtures that have none (to_numpy and
# system_params carry a System through its NonbondedForce)
NB_SECTION = """ <NonbondedForce coulomb14scale="0.8333" lj14scale="0.5">
  <Atom type="A" charge="0.1" sigma="0.3" epsilon="0.2"/>
 </NonbondedForce>
</ForceField>"""

# the custom generator sections test_ffgenerators.py does not cover
CUSTOM_ALL_XML = """<ForceField>
 <AtomTypes>
  <Type name="A" class="CA" element="C" mass="12.0"/>
  <Type name="B" class="CB" element="O" mass="16.0"/>
  <Type name="H" class="HC" element="H" mass="1.008"/>
 </AtomTypes>
 <Residues>
  <Residue name="QUA">
   <Atom name="C1" type="A" charge="-0.2"/>
   <Atom name="C2" type="A" charge="0.1"/>
   <Atom name="O3" type="B" charge="-0.3"/>
   <Atom name="H4" type="H" charge="0.4"/>
   <Bond atomName1="C1" atomName2="C2"/>
   <Bond atomName1="C2" atomName2="O3"/>
   <Bond atomName1="O3" atomName2="H4"/>
  </Residue>
 </Residues>
 <NonbondedForce coulomb14scale="0.8333" lj14scale="0.5">
  <UseAttributeFromResidue name="charge"/>
  <Atom type="A" sigma="0.34" epsilon="0.36"/>
  <Atom type="B" sigma="0.3" epsilon="0.7"/>
  <Atom type="H" sigma="0.1" epsilon="0.0"/>
 </NonbondedForce>
 <CustomAngleForce energy="0.5*ka*(theta-t0)^2">
  <PerAngleParameter name="t0"/>
  <PerAngleParameter name="ka"/>
  <Angle class1="CA" class2="CA" class3="CB" t0="1.9" ka="300.0"/>
  <Angle class1="CA" class2="CB" class3="HC" t0="1.8" ka="250.0"/>
 </CustomAngleForce>
 <CustomTorsionForce energy="kt*(1+cos(n*theta-p0))">
  <PerTorsionParameter name="kt"/>
  <PerTorsionParameter name="n"/>
  <PerTorsionParameter name="p0"/>
  <Proper class1="CA" class2="CA" class3="CB" class4="HC" kt="1.5" n="3"
          p0="0.0"/>
 </CustomTorsionForce>
 <CustomNonbondedForce energy="scale*eps1*eps2*(s/r)^6; s=0.5*(sig1+sig2)"
                       bondCutoff="2">
  <GlobalParameter name="scale" defaultValue="0.5"/>
  <PerParticleParameter name="sig"/>
  <PerParticleParameter name="eps"/>
  <Atom type="A" sig="0.3" eps="0.2"/>
  <Atom type="B" sig="0.28" eps="0.3"/>
  <Atom type="H" sig="0.1" eps="0.05"/>
 </CustomNonbondedForce>
 <CustomGBForce>
  <PerParticleParameter name="q"/>
  <PerParticleParameter name="radius"/>
  <UseAttributeFromResidue name="q"/>
  <Atom type="A" radius="0.17"/>
  <Atom type="B" radius="0.15"/>
  <Atom type="H" radius="0.12"/>
  <ComputedValue name="I" type="ParticlePairNoExclusions">step(r+radius2-radius1)*0.5/r</ComputedValue>
  <ComputedValue name="B" type="SingleParticle">1/(1/radius+I)</ComputedValue>
  <EnergyTerm type="SingleParticle">-69.4*q^2/B</EnergyTerm>
  <EnergyTerm type="ParticlePair">-138.9*q1*q2/sqrt(r^2+B1*B2)</EnergyTerm>
 </CustomGBForce>
 <CustomHbondForce energy="kh*(distance(d1,a1)-0.3)^2" bondCutoff="2"
                   particlesPerDonor="2" particlesPerAcceptor="1">
  <GlobalParameter name="kh" defaultValue="10.0"/>
  <Donor class1="CB" class2="HC"/>
  <Acceptor class1="CB"/>
 </CustomHbondForce>
 <CustomManyParticleForce particlesPerSet="3" permutationMode="SinglePermutation"
                          bondCutoff="3"
                          energy="c3*(1+3*cos(a1)*cos(a2)*cos(a3))/(r12*r13*r23)^3; a1=angle(p2,p1,p3); a2=angle(p1,p2,p3); a3=angle(p1,p3,p2); r12=distance(p1,p2); r13=distance(p1,p3); r23=distance(p2,p3)">
  <GlobalParameter name="c3" defaultValue="0.001"/>
  <Atom type="A" filterType="0"/>
  <Atom type="B" filterType="0"/>
  <Atom type="H" filterType="0"/>
 </CustomManyParticleForce>
</ForceField>"""


def _xml(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _chain_topology(ff, name, copies, box=None):
    return template_topology(ff, [[name] for _ in range(copies)], box)


_FORCEFIELDS = {}


def _forcefields(files):
    """(JAX ForceField, port ForceField) of `files`, loaded once per
    process (createSystem leaves a ForceField as it was)."""
    if files not in _FORCEFIELDS:
        _FORCEFIELDS[files] = (japp.ForceField(*files),
                               papp.ForceField(*files))
    return _FORCEFIELDS[files]


def _pair(files, jtop, **kw):
    """(port System, JAX System) of the same topology and settings."""
    jff, pff = _forcefields(tuple(files))
    jsys = jff.createSystem(jtop, **{k: _jax_arg(v) for k, v in kw.items()})
    psys = pff.createSystem(port_topology(jtop),
                            **{k: _port_arg(v) for k, v in kw.items()})
    return psys, jsys


def _jax_arg(v):
    if isinstance(v, str) and hasattr(japp, v):
        return getattr(japp, v)
    if isinstance(v, tuple):
        return v[0] * getattr(ju, v[1])
    return v


def _port_arg(v):
    if isinstance(v, str) and hasattr(papp, v):
        return getattr(papp, v)
    if isinstance(v, tuple):
        return v[0] * getattr(pu, v[1])
    return v


def _peptide_with_water(water_file, n_waters=4):
    ff = _forcefields(("amber14-all.json", water_file))[0]
    return template_topology(ff, [PEPTIDE] + [["HOH"]] * n_waters, BOX)


# (force-field files, topology builder, createSystem settings): a string
# value names the app singleton (or is itself where the app has no such
# name), a tuple (value, unit name) a Quantity
CASES = {
    "amber14_tip3p_pme_hbonds": (
        ("amber14-all.json", "amber14-tip3p.json"),
        lambda: _peptide_with_water("amber14-tip3p.json"),
        dict(nonbondedMethod="PME", nonbondedCutoff=(1.0, "nanometer"),
             constraints="HBonds")),
    "amber14_tip3pfb": (
        ("amber14-all.json", "amber14-tip3pfb.json"),
        lambda: _peptide_with_water("amber14-tip3pfb.json"),
        dict(nonbondedMethod="PME", constraints="HBonds")),
    "amber14_tip4pew": (
        ("amber14-all.json", "amber14-tip4pew.json"),
        lambda: _peptide_with_water("amber14-tip4pew.json"),
        dict(nonbondedMethod="PME", constraints="HBonds")),
    "amber14_spce": (
        ("amber14-all.json", "amber14-spce.json"),
        lambda: _peptide_with_water("amber14-spce.json"),
        dict(nonbondedMethod="PME", constraints="HBonds")),
    "amber99sbildn": (
        ("amber99sbildn.json",),
        lambda: template_topology(_forcefields(("amber99sbildn.json",))[0],
                                  [PEPTIDE]),
        dict(nonbondedMethod="NoCutoff", constraints="HBonds")),
    "amber99_obc": (
        ("amber99sbildn.json", "amber99-obc.json"),
        lambda: template_topology(_forcefields(("amber99sbildn.json",))[0],
                                  [PEPTIDE]),
        dict(nonbondedMethod="NoCutoff", soluteDielectric=2.0)),
    "charmm36_water_ub_nbfix": (
        ("charmm36_water.json",),
        lambda: template_topology(
            _forcefields(("charmm36_water.json",))[0],
            [["TIP3"]] * 6 + [["SOD"], ["CLA"], ["SOD"], ["CLA"]], BOX),
        dict(nonbondedMethod="CutoffPeriodic",
             nonbondedCutoff=(1.2, "nanometer"),
             switchDistance=(1.0, "nanometer"))),
    "hydrogen_mass": (
        ("amber14-all.json", "amber14-tip3p.json"),
        lambda: _peptide_with_water("amber14-tip3p.json"),
        dict(nonbondedMethod="PME", constraints="HBonds",
             hydrogenMass=(1.5, "amu"))),
    "flexible_no_cmm_switch": (
        ("amber14-all.json", "amber14-tip3p.json"),
        lambda: _peptide_with_water("amber14-tip3p.json"),
        dict(nonbondedMethod="CutoffPeriodic", constraints="AllBonds",
             flexibleConstraints=True, removeCMMotion=False,
             switchDistance=(0.8, "nanometer"),
             useDispersionCorrection=False, ewaldErrorTolerance=1e-4)),
}
for _method in ("NoCutoff", "CutoffNonPeriodic", "CutoffPeriodic", "Ewald",
                "PME", "LJPME"):
    CASES["method_" + _method] = (
        ("amber14-all.json", "amber14-tip3p.json"),
        lambda: _peptide_with_water("amber14-tip3p.json"),
        dict(nonbondedMethod=_method, nonbondedCutoff=(0.9, "nanometer")))
for _cons in (None, "HBonds", "AllBonds", "HAngles"):
    CASES["constraints_%s" % _cons] = (
        ("amber14-all.json", "amber14-tip3p.json"),
        lambda: _peptide_with_water("amber14-tip3p.json"),
        dict(nonbondedMethod="PME", constraints=_cons))


@pytest.mark.parametrize("case", sorted(CASES))
def test_create_system_matches_jax(case):
    files, make_topology, settings = CASES[case]
    psys, jsys = _pair(files, make_topology(), **settings)
    assert_same_params(omm.to_numpy(psys), system_params(jsys))


@pytest.fixture(scope="module")
def cropped():
    """(JAX topology, positions) of the cropped POPC bilayer."""
    top, pos, _ = _cropped_patch(0.33)
    return top, pos


def _bilayer_pair(cropped):
    top, _ = cropped
    return _pair(("amber14-lipid.json", "amber14-tip3p.json"), top,
                 nonbondedMethod="PME", nonbondedCutoff=(0.9, "nanometer"),
                 constraints="HBonds")


def test_cropped_bilayer_matches_jax(cropped):
    psys, jsys = _bilayer_pair(cropped)
    assert_same_params(omm.to_numpy(psys), system_params(jsys))


def test_cropped_bilayer_energy_and_forces_match_reference(cropped):
    """The port's own System on its "CPU" platform in double precision
    against the JAX System on "Reference": energy to 1e-10 relative,
    forces to 1e-9 of the largest component."""
    _, pos = cropped
    psys, jsys = _bilayer_pair(cropped)
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    ref = jctx.getState(getEnergy=True, getForces=True)
    e_ref = ref.getPotentialEnergy()._value
    f_ref = np.asarray(ref.getForces(asNumpy=True)._value, np.float64)
    ctx = omm.Context(psys, omm.VerletIntegrator(0.001 * pu.picosecond),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos * pu.nanometer)
    st = ctx.getState(getEnergy=True, getForces=True)
    assert abs(plain(st.getPotentialEnergy()) - e_ref) <= 1e-10 * abs(e_ref)
    assert np.abs(plain(st.getForces(asNumpy=True)) - f_ref).max() <= \
        1e-9 * np.abs(f_ref).max()


@pytest.mark.parametrize("fixture", ["custom_nbfix", "cmap", "custom_all"])
def test_generator_sections_match_jax(tmp_path, fixture):
    if fixture == "custom_nbfix":
        path = _xml(tmp_path, CUSTOM_XML, "custom.xml")
        names, copies = "DIM", 3
    elif fixture == "cmap":
        path = _xml(tmp_path, CMAP_XML.replace("</ForceField>", NB_SECTION),
                    "cmap.xml")
        names, copies = "CHN", 2
    else:
        path = _xml(tmp_path, CUSTOM_ALL_XML, "custom_all.xml")
        names, copies = "QUA", 3
    jtop = _chain_topology(japp.ForceField(path), names, copies, BOX)
    for method in ("NoCutoff", "CutoffPeriodic"):
        psys, jsys = _pair((path,), jtop, nonbondedMethod=method,
                           nonbondedCutoff=(1.0, "nanometer"))
        assert_same_params(omm.to_numpy(psys), system_params(jsys))


def test_registered_template_generator(tmp_path):
    """A template generator supplies the template no residue matched, as
    in tests/test_ffgenerators.py."""
    from openmm_tpu_torch.app.forcefield import _Template, _TemplateAtom
    ff = papp.ForceField(_xml(tmp_path, CUSTOM_XML, "custom.xml"))
    top = papp.Topology()
    carbon = papp.Element.getBySymbol("C")
    res = top.addResidue("UNK", top.addChain())
    atoms = [top.addAtom(n, carbon, res) for n in ("X1", "X2", "X3")]
    top.addBond(atoms[0], atoms[1])
    top.addBond(atoms[1], atoms[2])
    calls = []

    def generator(forcefield, residue):
        calls.append(residue.name)
        t = _Template("UNK")
        for name in ("X1", "X2", "X3"):
            t.atoms.append(_TemplateAtom(name, "A", carbon, {}))
        for i, j in ((0, 1), (1, 2)):
            t.bonds.append((i, j))
            t.atoms[i].bondedTo.append(j)
            t.atoms[j].bondedTo.append(i)
        forcefield.registerResidueTemplate(t)
        return True

    ff.registerTemplateGenerator(generator)
    assert ff.createSystem(top).getNumParticles() == 3
    assert calls == ["UNK"]


@pytest.mark.parametrize("name", ["charmm_polar_2019.json", "swm4ndp.json"])
def test_drude_files_are_the_ports(name):
    """The port ships its own copy of each Drude force field, equal to the
    JAX package's, and its Drude generator reads the same particle types
    from it as the JAX generator does."""
    from openmm_tpu.app.ffgenerators import DrudeGenerator as JaxDrude
    from openmm_tpu_torch.app.ffgenerators import DrudeGenerator
    ours = os.path.join(os.path.dirname(papp.__file__), "data", name)
    theirs = os.path.join(os.path.dirname(japp.__file__), "data", name)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = [g for g in papp.ForceField(name)._generators
           if isinstance(g, DrudeGenerator)][0].typeMap
    want = [g for g in japp.ForceField(name)._forces
            if isinstance(g, JaxDrude)][0].typeMap
    assert got == want and got


def test_drude_section_generator_builds_the_force(tmp_path):
    """A <DrudeForce> section beside the custom XML's NonbondedForce makes
    one Drude particle a matched atom (the section raised before the
    Drude slice)."""
    section = ('<DrudeForce><Particle type1="A" type2="A" charge="-1" '
               'polarizability="0.001" thole="1.3"/></DrudeForce>')
    text = CUSTOM_XML.replace("</ForceField>", section + "</ForceField>")
    ff = papp.ForceField(_xml(tmp_path, text, "later.xml"))
    generators = [g for g in ff._generators
                  if type(g).__name__ == "DrudeGenerator"]
    assert len(generators) == 1 and "A" in generators[0].typeMap


def test_standard_gb_parameters_match_jax(cropped):
    """gbforces.standard_gb_parameters from a Topology, for every model."""
    from openmm_tpu.app.gbforces import standard_gb_parameters as jgb
    from openmm_tpu_torch.app.gbforces import standard_gb_parameters as pgb
    jtop = _peptide_with_water("amber14-tip3p.json")
    for top in (jtop, cropped[0]):
        ptop = port_topology(top)
        for model in ("HCT", "OBC1", "OBC2", "GBn", "GBn2"):
            assert pgb(model, ptop) == jgb(model, top), model


PATCH_XML = """<ForceField>
 <AtomTypes>
  <Type name="A type" class="A class" element="O" mass="15.99943"/>
  <Type name="B type" class="B class" element="H" mass="1.007947"/>
  <Type name="C type" class="C class" element="H" mass="1.007947"/>
  <Type name="D type" class="D class" element="C" mass="12.01"/>
 </AtomTypes>
 <Residues>
  <Residue name="RES">
   <Atom name="A" type="A type"/>
   <Atom name="B" type="B type"/>
   <Atom name="C" type="C type"/>
   <Bond atomName1="A" atomName2="B"/>
   <Bond atomName1="B" atomName2="C"/>
  </Residue>
 </Residues>
 <Patches>
  <Patch name="Grow">
   <AddAtom name="D" type="D type"/>
   <ChangeAtom name="B" type="C type"/>
   <AddBond atomName1="C" atomName2="D"/>
   <ApplyToResidue name="RES"/>
  </Patch>
 </Patches>
 <HarmonicBondForce>
  <Bond class1="A class" class2="B class" length="0.1" k="1000.0"/>
  <Bond class1="A class" class2="C class" length="0.11" k="900.0"/>
  <Bond class1="B class" class2="C class" length="0.15" k="800.0"/>
  <Bond class1="C class" class2="C class" length="0.16" k="700.0"/>
  <Bond class1="C class" class2="D class" length="0.12" k="600.0"/>
 </HarmonicBondForce>
 <NonbondedForce coulomb14scale="0.8333" lj14scale="0.5">
  <Atom type="A type" charge="-0.4" sigma="0.3" epsilon="0.5"/>
  <Atom type="B type" charge="0.2" sigma="0.1" epsilon="0.0"/>
  <Atom type="C type" charge="0.2" sigma="0.1" epsilon="0.0"/>
  <Atom type="D type" charge="0.0" sigma="0.34" epsilon="0.3"/>
 </NonbondedForce>
</ForceField>"""


def test_patched_templates_match_jax(tmp_path):
    """A residue that only a patch's template matches (an added atom and
    bond, a changed type) beside one the base template matches."""
    path = _xml(tmp_path, PATCH_XML, "patch.xml")
    jtop = japp.Topology()
    chain = jtop.addChain()
    el = {s: japp.Element.getBySymbol(s) for s in ("O", "H", "C")}
    for names in (("A", "B", "C"), ("A", "B", "C", "D")):
        res = jtop.addResidue("RES", chain)
        atoms = [jtop.addAtom(n, el[{"A": "O", "D": "C"}.get(n, "H")], res)
                 for n in names]
        for a, b in zip(atoms, atoms[1:]):
            jtop.addBond(a, b)
    psys, jsys = _pair((path,), jtop, constraints="HBonds")
    assert psys.getNumParticles() == 7
    assert_same_params(omm.to_numpy(psys), system_params(jsys))


# ---------------------------------------------------------------- AMOEBA
def _amoeba_water_box(n_side=3, file="amoeba2013.json"):
    """(JAX Topology, positions): n_side^3 waters (residue HOH of `file`)
    on a jittered lattice at liquid density, in their periodic box."""
    from openmm_tpu_torch.models import hippo_water_cluster
    _, pos = hippo_water_cluster(n_side ** 3)
    edge = n_side * (1.0 / 33.37) ** (1.0 / 3.0)
    ff = japp.ForceField(file)
    # the cluster's waters are O, H, H: in the template's atom order
    symbols = [a.element.symbol for a in ff._templates["HOH"].atoms]
    order = [0 if s == "O" else 1 + symbols[:k].count("H")
             for k, s in enumerate(symbols)]
    pos = pos.reshape(-1, 3, 3)[:, order].reshape(-1, 3)
    return template_topology(ff, [["HOH"]] * n_side ** 3, edge), pos


@functools.lru_cache(maxsize=None)
def _amoeba_helix(n_ala=2):
    """(JAX Topology, positions) of ACE-(ALA)n-NME built by the port's
    Modeller (chip_smoke.helix_pdb_text, addHydrogens on the CPU), written
    as a PDB by the port and read by the JAX package."""
    import io
    import chip_smoke
    pdb = papp.PDBFile(io.StringIO(chip_smoke.helix_pdb_text(n_ala)))
    modeller = papp.Modeller(pdb.topology, pdb.positions)
    modeller.addHydrogens(papp.ForceField("amber14-all.json"),
                          platform=omm.Platform.getPlatformByName("CPU"))
    text = io.StringIO()
    papp.PDBFile.writeFile(modeller.topology, modeller.positions, text)
    # the JAX reader adds the standard bonds to the CONECT records' (so
    # each twice): it reads the file without them
    lines = [ln for ln in text.getvalue().splitlines()
             if not ln.startswith("CONECT")]
    jpdb = japp.PDBFile(io.StringIO("\n".join(lines) + "\n"))
    return jpdb.topology, plain(modeller.positions)


AMOEBA_CASES = {
    "water_pme": (("amoeba2013.json",), _amoeba_water_box,
                  dict(nonbondedMethod="PME",
                       nonbondedCutoff=(0.45, "nanometer"), vdwCutoff=0.45,
                       polarization="mutual",
                       mutualInducedTargetEpsilon=1e-5)),
    "helix_nocutoff_direct": (("amoeba2013.json",), _amoeba_helix,
                              dict(nonbondedMethod="NoCutoff",
                                   polarization="direct")),
    "helix_gk": (("amoeba2013.json", "amoeba2013_gk.json"), _amoeba_helix,
                 dict(nonbondedMethod="NoCutoff", polarization="mutual")),
}


@pytest.mark.parametrize("case", sorted(AMOEBA_CASES))
def test_amoeba_forcefield_matches_jax(case):
    """ForceField(amoeba files).createSystem in the port and in the JAX
    package: the same System, force by force and parameter by parameter,
    and its energy (1e-9 relative) and forces (1e-8 of the largest) on
    float64 against the JAX "Reference" platform (the JAX vdW twin with
    OpenMM's cubic mean, torch_port_helpers.jax_openmm_vdw)."""
    from torch_port_helpers import assert_close_to_jax, port_against_jax
    files, build, settings = AMOEBA_CASES[case]
    jtop, pos = build()
    psys, jsys = _pair(files, jtop, **settings)
    assert {type(f).__name__ for f in psys.getForces()} >= {
        "AmoebaVdwForce", "AmoebaMultipoleForce"}
    assert_same_params(omm.to_numpy(psys), system_params(jsys))
    assert_close_to_jax(port_against_jax(jsys, pos), 1e-9, 1e-8, case)


def test_iamoeba_forcefield_matches_jax():
    """iamoeba.json (its hydrogens carry no vdW: sigma and epsilon 0,
    whose pairs both packages' cubic mean turns into NaN) gives the same
    System in both packages."""
    jtop, _ = _amoeba_water_box(file="iamoeba.json")
    psys, jsys = _pair(("iamoeba.json",), jtop, nonbondedMethod="PME",
                       nonbondedCutoff=(0.45, "nanometer"), vdwCutoff=0.45)
    assert_same_params(omm.to_numpy(psys), system_params(jsys))
