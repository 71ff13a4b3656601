"""The AMOEBA forces of openmm_tpu_torch (forces/amoeba.py) against the JAX
package's "Reference" platform, in float64 on the CPU.

AmoebaVdwForce with hydrogen reduction, each combining rule, at NoCutoff
and CutoffPeriodic (the periodic one over the port's pair lists,
ops/amoeba_pairs.py); the JAX force's cubic mean leaves out OpenMM's
factor 2, so its twin gets doubled sigmas (torch_port_helpers
jax_openmm_vdw). AmoebaMultipoleForce at NoCutoff on molecules whose
sites use all six axis types, with covalent maps and polarization groups,
under Direct, Mutual and Extrapolated polarization; getInducedDipoles;
AmoebaTorsionTorsionForce (grids with and without derivatives, the
chirality flip) and AmoebaWcaDispersionForce, each also against the JAX
package's own goldens; ten steps at 0 K against the JAX Context;
updateParametersInContext and from_numpy/to_numpy.

Tolerances: energy 1e-9 (relative), forces 1e-8 of the largest force,
positions 1e-9 nm. Measured slack: energies <= 1e-13, forces <= 2e-13 of
the largest, positions after ten steps ~1e-15 nm.
"""
import math

import numpy as np
import pytest

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.unit import plain
from torch_port_helpers import (assert_close_to_jax, jax_openmm_vdw,
                                jax_system, port_against_jax, system_params)

E_TOL = 1e-9
F_TOL = 1e-8
POS_TOL = 1e-9
BOX = 2.5


def _molecules(n_mol, seed, box=BOX):
    """Positions of n_mol four-atom chains (bond 0.1 nm, random
    directions) spread over a box of edge `box`."""
    rng = np.random.RandomState(seed)
    pos = []
    grid = int(math.ceil(n_mol ** (1.0 / 3.0)))
    for m in range(n_mol):
        centre = (np.asarray(np.unravel_index(m, (grid,) * 3), float) + 0.5) \
            * box / grid + rng.uniform(-0.05, 0.05, 3)
        x = centre.copy()
        for _ in range(4):
            pos.append(x.copy())
            step = rng.normal(size=3)
            x = x + 0.1 * step / np.linalg.norm(step)
    return np.asarray(pos)


def _vdw_system(method, sigma_rule="CUBIC-MEAN", eps_rule="HHG", n_mol=8):
    system = mm.System()
    system.setDefaultPeriodicBoxVectors(mm.Vec3(BOX, 0, 0),
                                        mm.Vec3(0, BOX, 0),
                                        mm.Vec3(0, 0, BOX))
    f = mm.AmoebaVdwForce()
    f.setNonbondedMethod(method)
    f.setCutoffDistance(0.9)
    f.setSigmaCombiningRule(sigma_rule)
    f.setEpsilonCombiningRule(eps_rule)
    rng = np.random.RandomState(3)
    for m in range(n_mol):
        base = 4 * m
        for k in range(4):
            system.addParticle(12.0 if k == 0 else 1.0)
            heavy = k == 0
            f.addParticle(base if not heavy else base + k,
                          rng.uniform(0.15, 0.2) if heavy
                          else rng.uniform(0.12, 0.14),
                          rng.uniform(0.2, 0.5), 1.0 if heavy else 0.91)
        for k in range(4):
            f.setParticleExclusions(base + k, [base + j for j in range(4)])
    system.addForce(f)
    return system


@pytest.mark.parametrize("method", [mm.AmoebaVdwForce.NoCutoff,
                                    mm.AmoebaVdwForce.CutoffPeriodic],
                         ids=["nocutoff", "periodic"])
@pytest.mark.parametrize("rules", [("CUBIC-MEAN", "HHG"),
                                   ("GEOMETRIC", "GEOMETRIC"),
                                   ("ARITHMETIC", "ARITHMETIC")],
                         ids=["cubic_hhg", "geometric", "arithmetic"])
def test_vdw_matches_jax(method, rules):
    system = _vdw_system(method, *rules)
    pos = _molecules(8, 11, box=1.6)
    assert_close_to_jax(port_against_jax(system, pos), E_TOL, F_TOL,
                        "vdw %s %s" % (method, rules))


def test_vdw_cubic_mean_is_openmms():
    """Two particles: the port's cubic-mean r0 is OpenMM's 2 (s^3 + s^3) /
    (s^2 + s^2), the sum of the radii."""
    system = _vdw_system(mm.AmoebaVdwForce.NoCutoff, n_mol=0)
    f = system.getForces()[0]
    for x in (0.0, 0.4):
        system.addParticle(10.0)
        f.addParticle(system.getNumParticles() - 1, 0.175, 0.5, 1.0)
    port = omm.from_numpy(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(np.asarray([[0, 0, 0], [0.4, 0, 0]], float))
    e = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    rho = 0.4 / 0.35
    want = 0.5 * (1.07 / (rho + 0.07)) ** 7 * (1.12 / (rho ** 7 + 0.12) - 2)
    assert abs(e - want) <= 1e-12 * abs(want)


def _multipole_system(polarization, n_mol=6, seed=7):
    """n_mol four-atom molecules whose sites cycle through the six axis
    types, random multipoles (symmetric quadrupoles), polarities and
    damping, the covalent maps of a chain and each molecule one
    polarization group."""
    rng = np.random.RandomState(seed)
    system = mm.System()
    f = mm.AmoebaMultipoleForce()
    f.setNonbondedMethod(mm.AmoebaMultipoleForce.NoCutoff)
    f.setPolarizationType(polarization)
    A = mm.AmoebaMultipoleForce
    axes = [A.ZThenX, A.Bisector, A.ZBisect, A.ThreeFold, A.ZOnly,
            A.NoAxisType]
    site = 0
    for m in range(n_mol):
        base = 4 * m
        atoms = [base + k for k in range(4)]
        for k in range(4):
            system.addParticle(12.0)
            others = [a for a in atoms if a != base + k]
            axis = axes[site % 6]
            site += 1
            z, x, y = others
            if axis == A.ZOnly:
                x, y = -1, -1
            elif axis == A.NoAxisType:
                z, x, y = -1, -1, -1
            elif axis in (A.ZThenX, A.Bisector):
                y = -1
            q = rng.normal(size=(3, 3)) * 2e-4
            polarity = rng.uniform(4e-4, 1.2e-3)
            f.addMultipole(rng.uniform(-0.4, 0.4),
                           list(rng.normal(size=3) * 5e-3),
                           list((q + q.T).reshape(9)), axis, z, x, y,
                           0.39, polarity ** (1.0 / 6.0), polarity)
        for k in range(4):
            a = base + k
            near = [base + j for j in (k - 1, k + 1) if 0 <= j < 4]
            f.setCovalentMap(a, A.Covalent12, near)
            f.setCovalentMap(a, A.Covalent13, [base + j for j in (k - 2, k + 2)
                                              if 0 <= j < 4])
            f.setCovalentMap(a, A.Covalent14, [base + j for j in (k - 3, k + 3)
                                              if 0 <= j < 4])
            f.setCovalentMap(a, A.PolarizationCovalent11,
                             atoms[:2] if k < 2 else atoms[2:])
    system.addForce(f)
    return system


POLARIZATIONS = [mm.AmoebaMultipoleForce.Direct,
                 mm.AmoebaMultipoleForce.Mutual,
                 mm.AmoebaMultipoleForce.Extrapolated]


@pytest.mark.parametrize("polarization", POLARIZATIONS,
                         ids=["direct", "mutual", "extrapolated"])
def test_multipoles_nocutoff_match_jax(polarization):
    system = _multipole_system(polarization)
    pos = _molecules(6, 19, box=1.4)
    assert_close_to_jax(port_against_jax(system, pos), E_TOL, F_TOL,
                        "multipoles %d" % polarization)


def test_induced_dipoles_match_jax():
    system = _multipole_system(mm.AmoebaMultipoleForce.Mutual)
    pos = _molecules(6, 19, box=1.4)
    port = omm.from_numpy(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos)
    got = port.getForces()[0].getInducedDipoles(ctx)
    jctx = mm.Context(system, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in pos])
    want = np.asarray(system.getForces()[0].getInducedDipoles(jctx))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _tortor_system(with_derivatives, chiral):
    system = mm.System()
    f = mm.AmoebaTorsionTorsionForce()
    for _ in range(6):
        system.addParticle(10.0)
    f.addTorsionTorsion(0, 1, 2, 3, 4, 5 if chiral else -1, 0)
    xs = np.arange(-180.0, 181.0, 30.0)
    if with_derivatives:
        grid = [[[a1, a2, 0.01 * a1 * a1 + 0.02 * a2 * a2 + 0.03 * a1,
                  0.02 * a1 + 0.03, 0.04 * a2, 0.0] for a2 in xs]
                for a1 in xs]
    else:
        grid = [[[a1, a2, math.cos(math.radians(a1))
                  + 0.5 * math.sin(math.radians(2 * a2))] for a2 in xs]
                for a1 in xs]
    f.setTorsionTorsionGrid(0, grid)
    system.addForce(f)
    return system


TORTOR_POS = np.asarray([[0, 1, 0.3], [0, 0, 0], [1, 0, 0], [1, 1, 0.2],
                         [2, 1, 0.5], [1.5, 0.2, -0.7]], float) * 0.15


@pytest.mark.parametrize("with_derivatives", [True, False],
                         ids=["derivatives", "values"])
@pytest.mark.parametrize("chiral", [False, True], ids=["plain", "chiral"])
def test_torsion_torsion_matches_jax(with_derivatives, chiral):
    system = _tortor_system(with_derivatives, chiral)
    assert_close_to_jax(port_against_jax(system, TORTOR_POS), E_TOL, F_TOL,
                        "tortor")


def test_torsion_torsion_golden():
    """The analytic surface of the JAX package's test_torsion_torsion_grid
    (f = 0.01 a1^2 + 0.02 a2^2 + 0.03 a1 with exact derivatives) at the
    dihedrals numpy gives (1e-4, the bicubic interpolation's error)."""
    system = _tortor_system(True, False)
    port = omm.from_numpy(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(TORTOR_POS)
    e = plain(ctx.getState(getEnergy=True).getPotentialEnergy())

    def dihedral(p0, p1, p2, p3):
        b1, b2, b3 = p1 - p0, p2 - p1, p3 - p2
        n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
        return math.degrees(math.atan2(
            np.dot(np.cross(n1, n2), b2 / np.linalg.norm(b2)),
            np.dot(n1, n2)))

    a1 = dihedral(*TORTOR_POS[:4])
    a2 = dihedral(*TORTOR_POS[1:5])
    want = 0.01 * a1 * a1 + 0.02 * a2 * a2 + 0.03 * a1
    assert abs(e - want) <= 1e-4 * max(1.0, abs(want))


def _wca_system(positions):
    system = mm.System()
    f = mm.AmoebaWcaDispersionForce()
    rng = np.random.RandomState(2)
    for _ in positions:
        system.addParticle(10.0)
        f.addParticle(rng.uniform(0.15, 0.22), rng.uniform(0.2, 0.5))
    system.addForce(f)
    return system


def test_wca_matches_jax_and_golden():
    pos = _molecules(3, 5, box=1.2)
    assert_close_to_jax(port_against_jax(_wca_system(pos), pos), E_TOL,
                        F_TOL, "wca")
    # one atom: its bulk-water maximum (the JAX test's golden)
    one = _wca_system(pos[:1])
    port = omm.from_numpy(system_params(one))
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos[:1])
    e = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    r, eps = one.getForces()[0]._particles[0]
    want = one.getForces()[0]._max_dispersion_energy(r, eps)
    assert e < 0 and abs(e - want) <= 1e-12 * abs(want)


def _md_system():
    """Multipoles (Mutual) and vdW on the same molecules, with a
    torsion-torsion term."""
    system = _multipole_system(mm.AmoebaMultipoleForce.Mutual, n_mol=4)
    vdw = _vdw_system(mm.AmoebaVdwForce.NoCutoff, n_mol=4).getForces()[0]
    system.addForce(vdw)
    tt = _tortor_system(True, False).getForces()[0]
    tt._torsions = [(0, 1, 2, 3, 4, -1, 0)]
    system.addForce(tt)
    return system


def test_ten_steps_at_zero_kelvin_match_jax():
    system = _md_system()
    pos = _molecules(4, 23, box=1.1)
    port = omm.from_numpy(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.0005),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos)
    ctx.getIntegrator().step(10)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    twin = jax_openmm_vdw(jax_system(system_params(system)))
    jctx = mm.Context(twin, mm.VerletIntegrator(0.0005),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in pos])
    jctx.getIntegrator().step(10)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)
    assert np.abs(got - pos).max() > 1e-6          # they moved
    assert np.abs(got - want).max() <= POS_TOL


def test_update_parameters_and_round_trip():
    system = _multipole_system(mm.AmoebaMultipoleForce.Direct)
    pos = _molecules(6, 19, box=1.4)
    port = omm.from_numpy(system_params(system))
    again = omm.from_numpy(omm.to_numpy(port))
    assert omm.to_numpy(again)["custom_forces"] \
        == omm.to_numpy(port)["custom_forces"]
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos)
    force = port.getForces()[0]
    params = list(force.getMultipoleParameters(3))
    params[0] = -0.3
    force.setMultipoleParameters(3, *params)
    force.updateParametersInContext(ctx)
    e = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    fresh = omm.Context(port, omm.VerletIntegrator(0.001),
                        omm.Platform.getPlatformByName("CPU"),
                        {"Precision": "double"})
    fresh.setPositions(pos)
    want = plain(fresh.getState(getEnergy=True).getPotentialEnergy())
    assert abs(e - want) <= 1e-12 * abs(want)
    force.setCovalentMap(0, mm.AmoebaMultipoleForce.Covalent15, [8])
    with pytest.raises(ValueError, match="covalent maps"):
        force.updateParametersInContext(ctx)
