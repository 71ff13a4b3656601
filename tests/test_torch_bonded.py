"""openmm_tpu_torch's bonded forces (forces/bonded.py) against the JAX
package's, in float64.

The molecules are those of tests/test_bonded.py (a bond, an angle, a
periodic torsion in both chiralities, an RB torsion, a CMAP pair over five
atoms) plus a random set of many terms of each kind over 60 atoms (so
that atoms appear in many terms and the per-atom gathers add long rows),
with and without periodic images. The JAX side is a "Reference" Context
(float64, forces by jax.grad); the port's side is the compiled force's
analytic `ef` and the autograd gradient of its `energy`. Both evaluate
the same formulas in float64: energies within 1e-10 relative, forces
within 1e-9 of the largest component."""
import math

import numpy as np
import pytest
import torch

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.ops import geometry as geom
from torch_port_helpers import median_relative_error  # noqa: F401  (threads)

E_TOL, F_TOL = 1e-10, 1e-9

KINDS = {
    "bond": ("HarmonicBondForce", "addBond"),
    "angle": ("HarmonicAngleForce", "addAngle"),
    "torsion": ("PeriodicTorsionForce", "addTorsion"),
    "rb": ("RBTorsionForce", "addTorsion"),
    "cmap": ("CMAPTorsionForce", "addTorsion"),
}


def _cmap_map(size=24):
    def fmap(phi, psi):
        return (1.5 * math.cos(phi) + 0.5 * math.sin(psi)
                + 0.25 * math.cos(phi + psi))
    return [fmap(i * 2 * math.pi / size, j * 2 * math.pi / size)
            for j in range(size) for i in range(size)]


def _random_terms(kind, n, count, rng):
    terms = []
    width = {"bond": 2, "angle": 3, "torsion": 4, "rb": 4, "cmap": 5}[kind]
    for _ in range(count):
        start = rng.randint(0, n - 8)
        atoms = [int(a) for a in start + np.sort(
            rng.choice(np.arange(8), width, replace=False))]
        if kind == "bond":
            terms.append((*atoms, 0.1 + 0.1 * rng.rand(),
                          1000.0 * (1 + rng.rand())))
        elif kind == "angle":
            terms.append((*atoms, 1.6 + 0.6 * rng.rand(),
                          300.0 * (1 + rng.rand())))
        elif kind == "torsion":
            terms.append((*atoms, int(rng.randint(1, 5)),
                          float(2 * math.pi * rng.rand()),
                          5.0 * rng.rand()))
        elif kind == "rb":
            terms.append((*atoms, *(5.0 * rng.randn(6))))
        else:
            a, b, c, d, e = atoms
            terms.append((0, a, b, c, d, b, c, d, e))
    return terms


def _case(name):
    """(kind, terms, positions (n, 3), periodic box or None)."""
    if name == "bond":
        return "bond", [(0, 1, 1.5, 0.8)], \
            np.array([[0, 2, 0], [0, 0, 0]], float), None
    if name == "angle":
        return "angle", [(0, 1, 2, math.pi / 3, 1.1)], \
            np.array([[0, 1, 0], [0, 0, 0], [1, 0, 0]], float), None
    if name in ("torsion_plus", "torsion_minus"):
        z = 1.0 if name == "torsion_plus" else -1.0
        return "torsion", [(0, 1, 2, 3, 1, math.pi / 2, 1.0),
                           (0, 1, 2, 3, 2, math.pi / 3, 1.1)], \
            np.array([[0, 1, 0], [0, 0, 0], [1, 0, 0], [1, 0, z]], float), \
            None
    if name == "rb":
        return "rb", [(0, 1, 2, 3, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0)], \
            np.array([[0, 1, 0], [0, 0, 0], [1, 0, 0], [1, 1, 1]], float), \
            None
    if name == "cmap":
        return "cmap", [(0, 0, 1, 2, 3, 1, 2, 3, 4)], \
            np.array([[0, 1, 0], [0, 0, 0], [1, 0, 0], [1, 1, 0.3],
                      [2, 1, 0.8]], float), None
    kind, periodic = name.split("_")[1], name.endswith("pbc")
    rng = np.random.RandomState(sum(map(ord, name)))
    n = 60
    pos = rng.uniform(0.0, 2.0, (n, 3))
    box = np.diag([1.7, 1.8, 1.9]) if periodic else None
    return kind, _random_terms(kind, n, 150, rng), pos, box


CASES = ["bond", "angle", "torsion_plus", "torsion_minus", "rb", "cmap"] + [
    "many_%s%s" % (k, s) for k in KINDS for s in ("", "_pbc")]


def _jax_result(kind, terms, pos, box):
    system = mm.System()
    for _ in range(len(pos)):
        system.addParticle(1.0)
    cls, add = KINDS[kind]
    force = getattr(mm, cls)()
    if kind == "cmap":
        force.addMap(24, _cmap_map())
    for t in terms:
        getattr(force, add)(*t)
    if box is not None:
        system.setDefaultPeriodicBoxVectors(*(mm.Vec3(*r) for r in box))
        force.setUsesPeriodicBoundaryConditions(True)
    system.addForce(force)
    ctx = mm.Context(system, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return (st.getPotentialEnergy()._value,
            np.asarray(st.getForces(asNumpy=True)._value))


def _port_module(kind, terms, n, box):
    force = getattr(omm, KINDS[kind][0])()
    if kind == "cmap":
        force.addMap(24, _cmap_map())
    for t in terms:
        getattr(force, KINDS[kind][1])(*t)
    force.setUsesPeriodicBoundaryConditions(box is not None)
    return force._compile(n, torch.device("cpu"))


@pytest.mark.parametrize("name", CASES)
def test_bonded_force_matches_jax(name):
    kind, terms, pos, box = _case(name)
    e_ref, f_ref = _jax_result(kind, terms, pos, box)
    module = _port_module(kind, terms, len(pos), box)
    box_t = torch.as_tensor(np.eye(3) if box is None else box)
    pos_t = torch.as_tensor(pos)
    e, f = module.ef(pos_t, box_t)
    leaf = pos_t.clone().requires_grad_()
    e2 = module.energy(leaf, box_t)
    (g,) = torch.autograd.grad(e2, leaf)
    scale = np.abs(f_ref).max()
    assert scale > 0.0
    assert abs(float(e) - e_ref) <= E_TOL * abs(e_ref)
    assert abs(float(e2.detach()) - e_ref) <= E_TOL * abs(e_ref)
    assert np.abs(f.numpy() - f_ref).max() <= F_TOL * scale
    assert np.abs(-g.numpy() - f_ref).max() <= F_TOL * scale


def test_torsion_sign_convention():
    """The two chiralities give dihedrals of opposite sign, as
    tests/test_bonded.py's test_torsion_sign_convention requires."""
    r = torch.tensor([[0, 1, 0], [0, 0, 0], [1, 0, 0]], dtype=torch.float64)
    plus = geom.dihedral_angle(*r, torch.tensor([1.0, 0, 1],
                                                dtype=torch.float64))
    minus = geom.dihedral_angle(*r, torch.tensor([1.0, 0, -1],
                                                 dtype=torch.float64))
    assert float(plus) == pytest.approx(math.pi / 2)
    assert float(minus) == pytest.approx(-math.pi / 2)


def test_bicubic_coefficients_match_jax():
    from openmm_tpu.utils.splines import \
        bicubic_coefficients_periodic as jax_coeffs
    from openmm_tpu_torch.utils.splines import bicubic_coefficients_periodic
    grid = np.random.RandomState(2).randn(12, 12)
    np.testing.assert_array_equal(bicubic_coefficients_periodic(grid),
                                  jax_coeffs(grid))


def test_gather_sum_adds_in_a_fixed_order():
    """The per-atom gathers equal index_add_ within rounding, and two calls
    give the same bits."""
    from openmm_tpu_torch.ops.accumulate import GatherSum
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 50, (400, 4))
    contrib = torch.as_tensor(rng.randn(400, 4, 3))
    gather = GatherSum(idx, 60, torch.device("cpu"))
    got = gather(contrib)
    want = torch.zeros(60, 3, dtype=torch.float64).index_add_(
        0, torch.as_tensor(idx.reshape(-1)), contrib.reshape(-1, 3))
    assert torch.allclose(got, want, rtol=0, atol=1e-12)
    assert torch.equal(got, gather(contrib))
    assert torch.equal(got[50:], torch.zeros(10, 3, dtype=torch.float64))


def test_bonded_system_round_trips():
    """from_numpy / to_numpy carry every bonded kind, the CMMotionRemover
    and the force groups exactly."""
    rng = np.random.RandomState(9)
    n = 20
    params = {
        "masses": rng.uniform(1, 20, n), "charges": rng.uniform(-1, 1, n),
        "sigma": rng.uniform(0.1, 0.4, n), "epsilon": rng.uniform(0, 1, n),
        "exception_pairs": np.array([[0, 1]], np.int64),
        "exception_params": rng.uniform(0, 1, (1, 3)),
        "constraint_pairs": np.zeros((0, 2), np.int64),
        "constraint_distances": np.zeros(0),
        "box": np.diag([2.5, 2.6, 2.7]), "cutoff": 0.8, "method": "PME",
        "ewald_tolerance": 5e-4, "dispersion_correction": True,
        "switch_distance": -1.0,
        "bond_pairs": np.array([[0, 1], [2, 3]], np.int64),
        "bond_params": rng.uniform(0, 1, (2, 2)),
        "angle_triples": np.array([[0, 1, 2]], np.int64),
        "angle_params": rng.uniform(0, 1, (1, 2)),
        "torsion_quads": np.array([[0, 1, 2, 3]], np.int64),
        "torsion_params": np.array([[3.0, 0.5, 2.0]]),
        "rb_quads": np.array([[4, 5, 6, 7]], np.int64),
        "rb_params": rng.uniform(0, 1, (1, 6)),
        "cmap_sizes": np.array([4], np.int64),
        "cmap_energies": rng.uniform(0, 1, 16),
        "cmap_torsions": np.array([[0, 0, 1, 2, 3, 1, 2, 3, 4]], np.int64),
        "cmm_frequency": 10,
        "force_groups": {"angle": 2, "cmm": 5, "nonbonded": 1},
    }
    out = omm.to_numpy(omm.from_numpy(params))
    assert out.keys() == params.keys()
    for key, value in params.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(out[key], value, err_msg=key)
        else:
            assert out[key] == value, key
