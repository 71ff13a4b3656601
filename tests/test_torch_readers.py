"""The file readers of openmm_tpu_torch against openmm_tpu's: the same text
through both, the Systems' parameters equal (assert_same_params), and the
port's System on its "CPU" platform at Precision double against the JAX
System on "Reference": energy within 1e-10 relative, forces within 1e-9
of the largest component.

The inputs are written here: a small Amber prmtop with its inpcrd (a
hydroxyl chain molecule with an improper and a multi-term dihedral, and
two TIP3P waters), the CHARMM NBFIX psf and parameters of
tests/test_charmm_gromacs.py, an SPC/E .top with a .gro, a DMS built with
sqlite3, and a PDBx round trip of the cropped bilayer.
"""
import io
import math
import sqlite3

import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu import unit as ju

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.unit import plain
from test_torch_modeller import structure, water_topologies
from torch_port_helpers import (_cropped_patch, assert_same_params,
                                port_topology, system_params)

KCAL = 4.184


def compare(psys, jsys, positions):
    """Equal parameters, and the port's float64 energy and forces
    against the JAX "Reference" platform's."""
    assert_same_params(omm.to_numpy(psys), system_params(jsys))
    pos = np.asarray(positions, np.float64)
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    ref = jctx.getState(getEnergy=True, getForces=True)
    e_ref = ref.getPotentialEnergy()._value
    f_ref = np.asarray(ref.getForces(asNumpy=True)._value, np.float64)
    ctx = omm.Context(psys, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    assert abs(plain(st.getPotentialEnergy()) - e_ref) <= 1e-10 * abs(e_ref)
    assert np.abs(plain(st.getForces(asNumpy=True)) - f_ref).max() <= \
        1e-9 * np.abs(f_ref).max()


# -- Amber ------------------------------------------------------------------
# the chain molecule HO-O2-C2(-H21)-C1-H11 (residue MOL) and two waters
_ATOMS = [  # name, type, charge e, mass, atomic number, xyz Angstrom
    ("C1", "CT", -0.18, 12.01, 6, (0.000, 0.000, 0.000)),
    ("H11", "HC", 0.06, 1.008, 1, (-0.640, 0.880, 0.050)),
    ("C2", "CT", 0.14, 12.01, 6, (1.520, 0.030, 0.020)),
    ("O2", "OH", -0.65, 16.00, 8, (2.010, 1.360, -0.100)),
    ("HO", "HO", 0.42, 1.008, 1, (2.970, 1.330, -0.080)),
    ("H21", "HC", 0.21, 1.008, 1, (1.890, -0.520, 0.890)),
    ("O", "OW", -0.834, 16.00, 8, (4.500, -1.200, 1.900)),
    ("H1", "HW", 0.417, 1.008, 1, (5.457, -1.200, 1.900)),
    ("H2", "HW", 0.417, 1.008, 1, (4.260, -0.273, 1.900)),
    ("O", "OW", -0.834, 16.00, 8, (-2.600, 2.400, -2.200)),
    ("H1", "HW", 0.417, 1.008, 1, (-1.643, 2.400, -2.200)),
    ("H2", "HW", 0.417, 1.008, 1, (-2.840, 3.327, -2.200)),
]
_RESIDUES = [("MOL", 1), ("WAT", 7), ("WAT", 10)]     # label, first atom
_TYPES = {"CT": (1.9080, 0.1094), "HC": (1.4870, 0.0157),
          "OH": (1.7210, 0.2104), "HO": (0.0, 0.0),
          "OW": (1.7683, 0.1520), "HW": (0.0, 0.0)}    # Rmin/2 A, eps kcal
_BONDS = [  # i, j, type: (k kcal/mol/A^2, r0 A)
    (0, 1, 0), (0, 2, 1), (2, 3, 2), (3, 4, 3), (2, 5, 0),
    (6, 7, 4), (6, 8, 4), (9, 10, 4), (9, 11, 4)]
_BOND_TYPES = [(340.0, 1.09), (310.0, 1.526), (320.0, 1.41),
               (553.0, 0.96), (553.0, 0.9572)]
_ANGLES = [(1, 0, 2, 0), (0, 2, 3, 1), (2, 3, 4, 2), (0, 2, 5, 0),
           (3, 2, 5, 0), (7, 6, 8, 3), (10, 9, 11, 3)]
_ANGLE_TYPES = [(50.0, 109.5), (50.0, 109.5), (55.0, 108.5),
                (100.0, 104.52)]       # kcal/mol/rad^2, degrees
# i, j, k, l, type, flag: "" a proper with its 1-4 pair, "nb" a further
# term of the same dihedral (negative k: no 1-4), "imp" an improper
_DIHEDRALS = [(1, 0, 2, 3, 0, ""), (0, 2, 3, 4, 1, ""),
              (0, 2, 3, 4, 2, "nb"), (1, 0, 2, 5, 0, ""),
              (5, 2, 3, 4, 1, ""), (0, 3, 2, 5, 3, "imp")]
_DIHEDRAL_TYPES = [(0.15, 3, 0.0), (0.16, 3, 0.0), (0.25, 1, 0.0),
                   (1.1, 2, math.pi)]    # kcal/mol, periodicity, phase
_RADII = {"C": 1.7, "H": 1.2, "O": 1.5}
_SCREEN = {"C": 0.72, "H": 0.85, "O": 0.85}


def _block(flag, fmt, values, per_line, width):
    lines = ["%%FLAG %s" % flag, "%%FORMAT(%s)" % fmt]
    for k in range(0, max(len(values), 1), per_line):
        chunk = values[k:k + per_line]
        if isinstance(width, str):
            lines.append("".join(width % v for v in chunk))
        else:
            lines.append("".join(str(v).ljust(width) for v in chunk))
    return lines


def prmtop_text(box=None):
    """The prmtop of _ATOMS (box: the cubic box width in Angstrom)."""
    n = len(_ATOMS)
    type_names = list(_TYPES)
    type_index = [type_names.index(a[1]) + 1 for a in _ATOMS]
    nt = len(type_names)
    ico, acoef, bcoef = [0] * (nt * nt), [], []
    k = 0
    for i in range(nt):
        for j in range(i + 1):
            k += 1
            ico[nt * i + j] = ico[nt * j + i] = k
            ri, ei = _TYPES[type_names[i]]
            rj, ej = _TYPES[type_names[j]]
            eps, rmin = math.sqrt(ei * ej), ri + rj
            acoef.append(eps * rmin ** 12)
            bcoef.append(2.0 * eps * rmin ** 6)
    is_h = [a[4] == 1 for a in _ATOMS]
    bonds_h = [b for b in _BONDS if is_h[b[0]] or is_h[b[1]]]
    bonds_x = [b for b in _BONDS if b not in bonds_h]
    angles_h = [a for a in _ANGLES if any(is_h[i] for i in a[:3])]
    angles_x = [a for a in _ANGLES if a not in angles_h]
    dih_h = [d for d in _DIHEDRALS if any(is_h[i] for i in d[:4])]
    dih_x = [d for d in _DIHEDRALS if d not in dih_h]

    def flat_bonds(rows):
        return [v for i, j, t in rows for v in (3 * i, 3 * j, t + 1)]

    def flat_angles(rows):
        return [v for i, j, k_, t in rows
                for v in (3 * i, 3 * j, 3 * k_, t + 1)]

    def flat_dihedrals(rows):
        out = []
        for i, j, k_, l_, t, flag in rows:
            k3 = -3 * k_ if flag == "nb" else 3 * k_
            l3 = -3 * l_ if flag == "imp" else 3 * l_
            out += [3 * i, 3 * j, k3, l3, t + 1]
        return out

    excluded = [[] for _ in range(n)]
    for i, j, _ in _BONDS:
        excluded[min(i, j)].append(max(i, j))
    pointers = [n, nt, len(bonds_h), len(bonds_x), len(angles_h),
                len(angles_x), len(dih_h), len(dih_x), 0, 0,
                sum(max(len(e), 1) for e in excluded), len(_RESIDUES),
                len(bonds_x), len(angles_x), len(dih_x), len(_BOND_TYPES),
                len(_ANGLE_TYPES), len(_DIHEDRAL_TYPES), nt, 0, 0, 0, 0, 0,
                0, 0, 0, 1 if box else 0, 7, 0, 0]
    symbol = {1: "H", 6: "C", 8: "O"}
    text = ["%VERSION  VERSION_STAMP = V0001.000", "%FLAG TITLE",
            "%FORMAT(20a4)", "test"]
    text += _block("POINTERS", "10I8", pointers, 10, "%8d")
    text += _block("ATOM_NAME", "20a4", [a[0] for a in _ATOMS], 20, 4)
    text += _block("CHARGE", "5E16.8", [a[2] * 18.2223 for a in _ATOMS],
                   5, "%16.8E")
    text += _block("ATOMIC_NUMBER", "10I8", [a[4] for a in _ATOMS], 10,
                   "%8d")
    text += _block("MASS", "5E16.8", [a[3] for a in _ATOMS], 5, "%16.8E")
    text += _block("ATOM_TYPE_INDEX", "10I8", type_index, 10, "%8d")
    text += _block("NUMBER_EXCLUDED_ATOMS", "10I8",
                   [max(len(e), 1) for e in excluded], 10, "%8d")
    text += _block("NONBONDED_PARM_INDEX", "10I8", ico, 10, "%8d")
    text += _block("RESIDUE_LABEL", "20a4", [r[0] for r in _RESIDUES], 20,
                   4)
    text += _block("RESIDUE_POINTER", "10I8", [r[1] for r in _RESIDUES],
                   10, "%8d")
    text += _block("BOND_FORCE_CONSTANT", "5E16.8",
                   [b[0] for b in _BOND_TYPES], 5, "%16.8E")
    text += _block("BOND_EQUIL_VALUE", "5E16.8", [b[1] for b in _BOND_TYPES],
                   5, "%16.8E")
    text += _block("ANGLE_FORCE_CONSTANT", "5E16.8",
                   [a[0] for a in _ANGLE_TYPES], 5, "%16.8E")
    text += _block("ANGLE_EQUIL_VALUE", "5E16.8",
                   [math.radians(a[1]) for a in _ANGLE_TYPES], 5, "%16.8E")
    text += _block("DIHEDRAL_FORCE_CONSTANT", "5E16.8",
                   [d[0] for d in _DIHEDRAL_TYPES], 5, "%16.8E")
    text += _block("DIHEDRAL_PERIODICITY", "5E16.8",
                   [float(d[1]) for d in _DIHEDRAL_TYPES], 5, "%16.8E")
    text += _block("DIHEDRAL_PHASE", "5E16.8",
                   [d[2] for d in _DIHEDRAL_TYPES], 5, "%16.8E")
    text += _block("SCEE_SCALE_FACTOR", "5E16.8",
                   [1.2] * len(_DIHEDRAL_TYPES), 5, "%16.8E")
    text += _block("SCNB_SCALE_FACTOR", "5E16.8",
                   [2.0] * len(_DIHEDRAL_TYPES), 5, "%16.8E")
    text += _block("LENNARD_JONES_ACOEF", "5E16.8", acoef, 5, "%16.8E")
    text += _block("LENNARD_JONES_BCOEF", "5E16.8", bcoef, 5, "%16.8E")
    text += _block("BONDS_INC_HYDROGEN", "10I8", flat_bonds(bonds_h), 10,
                   "%8d")
    text += _block("BONDS_WITHOUT_HYDROGEN", "10I8", flat_bonds(bonds_x),
                   10, "%8d")
    text += _block("ANGLES_INC_HYDROGEN", "10I8", flat_angles(angles_h), 10,
                   "%8d")
    text += _block("ANGLES_WITHOUT_HYDROGEN", "10I8", flat_angles(angles_x),
                   10, "%8d")
    text += _block("DIHEDRALS_INC_HYDROGEN", "10I8", flat_dihedrals(dih_h),
                   10, "%8d")
    text += _block("DIHEDRALS_WITHOUT_HYDROGEN", "10I8",
                   flat_dihedrals(dih_x), 10, "%8d")
    text += _block("EXCLUDED_ATOMS_LIST", "10I8",
                   [j + 1 for e in excluded for j in e] or [0], 10, "%8d")
    text += _block("RADII", "5E16.8",
                   [_RADII[symbol[a[4]]] for a in _ATOMS], 5, "%16.8E")
    text += _block("SCREEN", "5E16.8",
                   [_SCREEN[symbol[a[4]]] for a in _ATOMS], 5, "%16.8E")
    if box:
        text += _block("BOX_DIMENSIONS", "5E16.8", [90.0, box, box, box], 5,
                       "%16.8E")
    return "\n".join(text) + "\n"


def inpcrd_text(box=None):
    lines = ["test", "%6d" % len(_ATOMS)]
    values = [c for a in _ATOMS for c in a[5]]
    for k in range(0, len(values), 6):
        lines.append("".join("%12.7f" % v for v in values[k:k + 6]))
    if box:
        lines.append("".join("%12.7f" % v
                             for v in (box, box, box, 90.0, 90.0, 90.0)))
    return "\n".join(lines) + "\n"


def _amber_pair(tmp_path, box, **settings):
    (tmp_path / "a.prmtop").write_text(prmtop_text(box))
    (tmp_path / "a.inpcrd").write_text(inpcrd_text(box))
    jp = japp.AmberPrmtopFile(str(tmp_path / "a.prmtop"))
    pp = papp.AmberPrmtopFile(str(tmp_path / "a.prmtop"))
    jc = japp.AmberInpcrdFile(str(tmp_path / "a.inpcrd"))
    pc = papp.AmberInpcrdFile(str(tmp_path / "a.inpcrd"))
    pos = plain(pc.getPositions(asNumpy=True))
    np.testing.assert_array_equal(pos, jc.getPositions(asNumpy=True)._value)
    assert structure(pp.topology)[:3] == structure(jp.topology)[:3]
    jkw = {k: getattr(japp, v) if isinstance(v, str) else v
           for k, v in settings.items()}
    pkw = {k: getattr(papp, v) if isinstance(v, str) else v
           for k, v in settings.items()}
    return pp.createSystem(**pkw), jp.createSystem(**jkw), pos, pc, jc


AMBER_CASES = {
    "nocutoff": (None, dict(nonbondedMethod="NoCutoff")),
    "hbonds": (None, dict(nonbondedMethod="NoCutoff", constraints="HBonds")),
    "pme": (24.0, dict(nonbondedMethod="PME", nonbondedCutoff=0.9)),
    "obc2": (None, dict(nonbondedMethod="NoCutoff",
                        implicitSolvent="OBC2")),
    "gbn2_salt": (None, dict(nonbondedMethod="NoCutoff",
                             implicitSolvent="GBn2",
                             implicitSolventSaltConc=0.1)),
}


@pytest.mark.parametrize("case", sorted(AMBER_CASES))
def test_amber_matches_jax(tmp_path, case):
    box, settings = AMBER_CASES[case]
    psys, jsys, pos, pc, jc = _amber_pair(tmp_path, box, **settings)
    compare(psys, jsys, pos)
    if box:
        np.testing.assert_allclose(
            plain(pc.getBoxVectors()),
            np.asarray([tuple(v) for v in jc.getBoxVectors()._value]),
            rtol=0, atol=1e-15)
        assert psys.usesPeriodicBoundaryConditions()


# -- CHARMM (the NBFIX case of tests/test_charmm_gromacs.py) ----------------
NBFIX_PRM = """
ATOMS
MASS 1 AR 39.948
MASS 2 KR 83.798

BONDS
ANGLES
DIHEDRALS
NONBONDED
AR 0.0 -0.2 1.9
KR 0.0 -0.3 2.1

NBFIX
AR KR -0.5 4.5

END
"""
NBFIX_PSF = """PSF

       1 !NTITLE
 REMARKS test

       2 !NATOM
       1 A    1    AR   AR   AR     0.000000       39.9480           0
       2 A    1    KR   KR   KR     0.000000       83.7980           0

       0 !NBOND: bonds


"""


def test_charmm_nbfix_matches_jax(tmp_path):
    (tmp_path / "t.prm").write_text(NBFIX_PRM)
    (tmp_path / "t.psf").write_text(NBFIX_PSF)
    systems = []
    for app_ in (papp, japp):
        params = app_.CharmmParameterSet(str(tmp_path / "t.prm"))
        assert ("AR", "KR") in params.nbfix_types
        systems.append(app_.CharmmPsfFile(str(tmp_path / "t.psf"))
                       .createSystem(params))
    compare(*systems, [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    # the NBFIX pair's Lennard-Jones: emin 0.5 kcal/mol at rmin 4.5 A
    ctx = omm.Context(systems[0], omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    q = (0.45 / 0.5) ** 6
    expected = 0.5 * KCAL * (q * q - 2 * q)
    e = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    assert abs(e - expected) < 1e-4 * abs(expected)


# -- GROMACS ------------------------------------------------------------------
SPCE_TOP = """
[ defaults ]
1 2 yes 0.5 0.8333

[ atomtypes ]
OW  15.9994 -0.8476 A 0.316557 0.650194
HW  1.008    0.4238 A 0.0      0.0

[ moleculetype ]
SOL 2

[ atoms ]
1 OW 1 SOL OW 1 -0.8476 15.9994
2 HW 1 SOL HW1 1 0.4238 1.008
3 HW 1 SOL HW2 1 0.4238 1.008

[ settles ]
1 1 0.1 0.16330

[ exclusions ]
1 2 3
2 1 3
3 1 2

[ system ]
water

[ molecules ]
SOL %d
"""


def gro_text(n_waters, seed=7):
    """SPC/E waters on a jittered lattice in a cubic box, as .gro text."""
    rng = np.random.RandomState(seed)
    side = int(math.ceil(n_waters ** (1.0 / 3.0)))
    box = side * 0.31
    lines = ["spc/e water", "%5d" % (3 * n_waters)]
    ref = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0],
                    [-0.0333, 0.0943, 0.0]])
    k = 0
    for w in range(n_waters):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        centre = (np.array([w % side, (w // side) % side, w // side ** 2])
                  + 0.5) * 0.31
        for name, p in zip(("OW", "HW1", "HW2"), ref @ q.T + centre):
            k += 1
            lines.append("%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (
                w + 1, "SOL", name, k, p[0], p[1], p[2]))
    lines.append("%10.5f%10.5f%10.5f" % (box, box, box))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("method", ["NoCutoff", "PME"])
def test_gromacs_matches_jax(tmp_path, method):
    n = 27
    (tmp_path / "w.top").write_text(SPCE_TOP % n)
    (tmp_path / "w.gro").write_text(gro_text(n))
    pgro = papp.GromacsGroFile(str(tmp_path / "w.gro"))
    jgro = japp.GromacsGroFile(str(tmp_path / "w.gro"))
    pos = plain(pgro.getPositions(asNumpy=True))
    np.testing.assert_array_equal(pos, jgro.getPositions(asNumpy=True)._value)
    box = pgro.getPeriodicBoxVectors()
    np.testing.assert_array_equal(
        plain(box), np.asarray([tuple(v) for v in
                                jgro.getPeriodicBoxVectors()._value]))
    ptop = papp.GromacsTopFile(str(tmp_path / "w.top"),
                               periodicBoxVectors=box)
    jtop = japp.GromacsTopFile(str(tmp_path / "w.top"),
                               periodicBoxVectors=jgro.getPeriodicBoxVectors())
    assert structure(ptop.topology)[:3] == structure(jtop.topology)[:3]
    psys = ptop.createSystem(nonbondedMethod=getattr(papp, method),
                             nonbondedCutoff=0.4 * pu.nanometer)
    jsys = jtop.createSystem(nonbondedMethod=getattr(japp, method),
                             nonbondedCutoff=0.4 * ju.nanometer)
    assert psys.getNumConstraints() == 3 * n
    compare(psys, jsys, pos)


def test_gromacs_default_include_dir_is_jax():
    import inspect
    jdefault = inspect.signature(japp.GromacsTopFile).parameters[
        "includeDir"].default
    pdefault = inspect.signature(papp.GromacsTopFile).parameters[
        "includeDir"].default
    assert pdefault == jdefault


# -- Desmond DMS ----------------------------------------------------------
def write_dms(path, box=None):
    """A DMS of _ATOMS with bonds, angles, dihedrals, an improper, LJ types,
    exclusions and a scaled 1-4 pair (Angstrom, kcal/mol, degrees)."""
    con = sqlite3.connect(str(path))
    c = con.cursor()
    c.execute("CREATE TABLE particle (id INTEGER PRIMARY KEY, anum INTEGER,"
              " name TEXT, resname TEXT, resid INTEGER, chain TEXT,"
              " mass FLOAT, charge FLOAT, x FLOAT, y FLOAT, z FLOAT,"
              " nbtype INTEGER)")
    types = list(_TYPES)
    resid = [1] * 6 + [2] * 3 + [3] * 3
    for i, (name, t, q, m, anum, xyz) in enumerate(_ATOMS):
        c.execute("INSERT INTO particle VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                  (i, anum, name, _RESIDUES[resid[i] - 1][0], resid[i], "A",
                   m, q, *xyz, types.index(t)))
    c.execute("CREATE TABLE bond (p0 INTEGER, p1 INTEGER, 'order' INTEGER)")
    for i, j, _ in _BONDS:
        c.execute("INSERT INTO bond VALUES (?,?,1)", (i, j))
    c.execute("CREATE TABLE global_cell (id INTEGER PRIMARY KEY, x FLOAT,"
              " y FLOAT, z FLOAT)")
    width = box or 0.0
    for k in range(3):
        c.execute("INSERT INTO global_cell VALUES (?,?,?,?)",
                  (k, *[width if a == k else 0.0 for a in range(3)]))
    c.execute("CREATE TABLE stretch_harm_param (id INTEGER PRIMARY KEY,"
              " r0 FLOAT, fc FLOAT, constrained INTEGER)")
    c.execute("CREATE TABLE stretch_harm_term (p0 INTEGER, p1 INTEGER,"
              " param INTEGER)")
    for k, (fc, r0) in enumerate(_BOND_TYPES):
        c.execute("INSERT INTO stretch_harm_param VALUES (?,?,?,?)",
                  (k, r0, fc, 1 if k == 4 else 0))
    for i, j, t in _BONDS:
        c.execute("INSERT INTO stretch_harm_term VALUES (?,?,?)", (i, j, t))
    c.execute("CREATE TABLE angle_harm_param (id INTEGER PRIMARY KEY,"
              " theta0 FLOAT, fc FLOAT, constrained INTEGER)")
    c.execute("CREATE TABLE angle_harm_term (p0 INTEGER, p1 INTEGER,"
              " p2 INTEGER, param INTEGER)")
    for k, (fc, theta0) in enumerate(_ANGLE_TYPES):
        c.execute("INSERT INTO angle_harm_param VALUES (?,?,?,?)",
                  (k, theta0, fc, 0))
    for i, j, k_, t in _ANGLES:
        c.execute("INSERT INTO angle_harm_term VALUES (?,?,?,?)",
                  (i, j, k_, t))
    c.execute("CREATE TABLE dihedral_trig_param (id INTEGER PRIMARY KEY,"
              " phi0 FLOAT, fc0 FLOAT, fc1 FLOAT, fc2 FLOAT, fc3 FLOAT,"
              " fc4 FLOAT, fc5 FLOAT, fc6 FLOAT)")
    c.execute("CREATE TABLE dihedral_trig_term (p0 INTEGER, p1 INTEGER,"
              " p2 INTEGER, p3 INTEGER, param INTEGER)")
    c.execute("INSERT INTO dihedral_trig_param VALUES (0,0,0,0.2,0,0.15,0,0,"
              "0)")
    c.execute("INSERT INTO dihedral_trig_param VALUES (1,180,0,0,1.1,0,0,0,"
              "0)")
    for i, j, k_, l_, _, flag in _DIHEDRALS:
        if flag == "":
            c.execute("INSERT INTO dihedral_trig_term VALUES (?,?,?,?,0)",
                      (i, j, k_, l_))
    c.execute("INSERT INTO dihedral_trig_term VALUES (1,0,2,5,1)")
    c.execute("CREATE TABLE improper_harm_param (id INTEGER PRIMARY KEY,"
              " phi0 FLOAT, fc FLOAT)")
    c.execute("CREATE TABLE improper_harm_term (p0 INTEGER, p1 INTEGER,"
              " p2 INTEGER, p3 INTEGER, param INTEGER)")
    c.execute("INSERT INTO improper_harm_param VALUES (0, 10.0, 40.0)")
    c.execute("INSERT INTO improper_harm_term VALUES (0, 3, 2, 5, 0)")
    c.execute("CREATE TABLE nonbonded_param (id INTEGER PRIMARY KEY,"
              " sigma FLOAT, epsilon FLOAT)")
    for k, t in enumerate(types):
        rhalf, eps = _TYPES[t]
        c.execute("INSERT INTO nonbonded_param VALUES (?,?,?)",
                  (k, 2.0 * rhalf / 2 ** (1.0 / 6.0) if rhalf else 1.0,
                   eps))
    c.execute("CREATE TABLE exclusion (p0 INTEGER, p1 INTEGER)")
    for i, j, _ in _BONDS:
        c.execute("INSERT INTO exclusion VALUES (?,?)", (i, j))
    for i, j in ((1, 3), (0, 3), (2, 4), (1, 5), (0, 5), (3, 5), (7, 8),
                 (10, 11)):
        c.execute("INSERT INTO exclusion VALUES (?,?)", (i, j))
    c.execute("CREATE TABLE pair_12_6_es_param (id INTEGER PRIMARY KEY,"
              " aij FLOAT, bij FLOAT, qij FLOAT)")
    c.execute("CREATE TABLE pair_12_6_es_term (p0 INTEGER, p1 INTEGER,"
              " param INTEGER)")
    c.execute("INSERT INTO pair_12_6_es_param VALUES (0, 4.0e5, 300.0,"
              " -0.05)")
    c.execute("INSERT INTO pair_12_6_es_term VALUES (0, 4, 0)")
    c.execute("INSERT INTO pair_12_6_es_term VALUES (1, 4, 0)")
    con.commit()
    con.close()


@pytest.mark.parametrize("box", [None, 24.0])
def test_dms_matches_jax(tmp_path, box):
    write_dms(tmp_path / "m.dms", box)
    preader = papp.DesmondDMSFile(str(tmp_path / "m.dms"))
    jreader = japp.DesmondDMSFile(str(tmp_path / "m.dms"))
    assert structure(preader.topology)[:3] == structure(jreader.topology)[:3]
    pos = plain(preader.getPositions(asNumpy=True))
    np.testing.assert_array_equal(pos,
                                  jreader.getPositions(asNumpy=True)._value)
    method = "PME" if box else "NoCutoff"
    psys = preader.createSystem(nonbondedMethod=getattr(papp, method),
                                nonbondedCutoff=0.9 * pu.nanometer)
    jsys = jreader.createSystem(nonbondedMethod=getattr(japp, method),
                                nonbondedCutoff=0.9 * ju.nanometer)
    assert psys.usesPeriodicBoundaryConditions() == bool(box)
    compare(psys, jsys, pos)
    preader.close()
    jreader.close()


# -- PDBx ---------------------------------------------------------------------
def test_pdbx_round_trip_matches_jax():
    """The cropped bilayer written by both packages' PDBxFile gives the
    same text; read back by both, the same structure and positions
    within the file's rounding (0.00005 A)."""
    top, pos, _ = _cropped_patch(0.33)
    ptop = port_topology(top)
    ptext, jtext = io.StringIO(), io.StringIO()
    papp.PDBxFile.writeFile(ptop, pu.Quantity(pos, pu.nanometer), ptext)
    japp.PDBxFile.writeFile(top, ju.Quantity(pos, ju.nanometer), jtext)
    assert ptext.getvalue() == jtext.getvalue()
    back = papp.PDBxFile(io.StringIO(ptext.getvalue()))
    jback = japp.PDBxFile(io.StringIO(jtext.getvalue()))
    assert structure(back.topology)[:3] == structure(jback.topology)[:3]
    got = plain(back.getPositions(asNumpy=True))
    np.testing.assert_array_equal(
        got, np.asarray(jback.getPositions(asNumpy=True)._value))
    assert np.abs(got - pos).max() <= 0.5e-5 * (1 + 1e-6)
    assert [r.name for r in back.topology.residues()] == \
        [r.name for r in ptop.residues()]


def test_pdbx_reporter_writes_models(tmp_path):
    """PDBxReporter on a Simulation of two waters: the header once and a
    model a report; the last model read back as the State's positions."""
    _, ptop, pos = water_topologies(2)
    ff = papp.ForceField("amber14-all.json", "amber14-tip3p.json")
    system = ff.createSystem(ptop, nonbondedMethod=papp.NoCutoff)
    sim = papp.Simulation(ptop, system, omm.VerletIntegrator(0.0005),
                          omm.Platform.getPlatformByName("CPU"))
    sim.context.setPositions(pos)
    path = str(tmp_path / "traj.cif")
    sim.reporters.append(papp.PDBxReporter(path, 5))
    sim.step(10)
    del sim.reporters[:]
    text = open(path).read()
    assert text.count("data_") == 1
    back = papp.PDBxFile(path)
    assert back.getNumFrames() == 2
    last = plain(sim.context.getState(getPositions=True)
                 .getPositions(asNumpy=True))
    assert np.abs(plain(back.getPositions(asNumpy=True, frame=1))
                  - last).max() <= 0.5e-5 * (1 + 1e-6)
