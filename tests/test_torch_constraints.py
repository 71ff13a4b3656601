"""openmm_tpu_torch's SHAKE and CCMA (ops/constraints.py) against the JAX
package's make_shake and make_ccma, in float64, and the Context's
constraint chain (SETTLE, then SHAKE, then CCMA, the corrections summed)
against the JAX Context's.

The systems are those of tests/test_constraints.py (a 5-bead CCMA chain
whose coupling cosines come from harmonic angles, CH3 and NH SHAKE-H
clusters), each also replicated with random orientations, plus a
branched CCMA network with a constrained triangle. From the same
reference and proposed positions both packages run the same fixed
iterations in float64, in the same order up to the sums of a few terms:
1e-12 nm, and 1e-12 nm/ps for velocities."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu.ops import constraints as jcons

import openmm_tpu_torch as omm
from openmm_tpu_torch.ops import constraints as tcons
from torch_port_helpers import median_relative_error  # noqa: F401  (threads)
from openmm_tpu_torch.unit import plain

TOL = 1e-12
CPU = torch.device("cpu")


def _rotation(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    a, b, c, d = q
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a - b * b - c * c + d * d]])


def _replicate(masses, pos, cons, angles, copies, rng):
    """`copies` randomly rotated and placed copies of a molecule."""
    n = len(masses)
    out_m, out_p, out_c, out_a = [], [], [], []
    for k in range(copies):
        o = k * n
        out_m += list(masses)
        out_p.append(pos @ _rotation(rng).T + rng.uniform(0, 3, 3))
        out_c += [(i + o, j + o, d) for i, j, d in cons]
        out_a += [(i + o, j + o, l + o, t) for i, j, l, t in angles]
    return out_m, np.concatenate(out_p), out_c, out_a


def ccma_chain():
    """tests/test_constraints.py:test_ccma_chain's molecule."""
    masses = [2.0 if i % 2 == 0 else 1.0 for i in range(5)]
    pos = np.array([[0.11 * i, 0.02 * (i % 2), 0.0] for i in range(5)])
    cons = [(i, i + 1, 0.11) for i in range(4)]
    angles = [(i, i + 1, i + 2, 2.0) for i in range(3)]
    return masses, pos, cons, angles


def shake_molecule():
    """tests/test_constraints.py:test_shake_h_clusters's CH3 and NH."""
    dirs = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1]]) / math.sqrt(3)
    masses = [12.0, 1.008, 1.008, 1.008, 14.0, 1.008]
    pos = np.array([[0, 0, 0], *(dirs * 0.109), [0.8, 0, 0],
                    [0.901, 0, 0]])
    cons = [(0, 1, 0.109), (0, 2, 0.109), (0, 3, 0.109), (4, 5, 0.101)]
    return masses, pos, cons, []


def branched_network():
    """A CCMA network: a constrained triangle (its angle from the
    distances), a branch point and a harmonic angle between two of its
    constraints."""
    masses = [12.0, 12.0, 14.0, 16.0, 1.008, 12.0]
    pos = np.array([[0, 0, 0], [0.15, 0, 0], [0.07, 0.13, 0],
                    [-0.12, -0.05, 0.04], [0.2, 0.09, 0.02],
                    [0.25, -0.1, 0.05]])
    cons = [(0, 1, 0.15), (1, 2, 0.148), (0, 2, 0.147), (0, 3, 0.13),
            (1, 4, 0.102), (1, 5, 0.152)]
    angles = [(4, 1, 5, 1.9)]
    return masses, pos, cons, angles


def _proposal(pos, rng, scale=0.01):
    return pos + scale * rng.randn(*pos.shape)


@pytest.mark.parametrize("copies", [1, 40])
def test_shake_matches_jax(copies):
    rng = np.random.RandomState(3 + copies)
    masses, pos, cons, _ = _replicate(*shake_molecule(), copies, rng)
    clusters, rest = tcons.partition_shake_clusters(cons, masses)
    assert (clusters, rest) == jcons.partition_shake_clusters(cons, masses)
    assert len(clusters) == 2 * copies and not rest
    new, vel = _proposal(pos, rng), rng.randn(*pos.shape)
    j_pos, j_vel = jcons.make_shake(clusters, masses, jnp.float64)
    shake = tcons.Shake(clusters, masses, CPU)
    got = shake.apply_positions(torch.as_tensor(pos), torch.as_tensor(new))
    want = np.asarray(j_pos(jnp.asarray(pos), jnp.asarray(new)))
    assert np.abs(got.numpy() - want).max() <= TOL
    assert np.abs(got.numpy() - new).max() > 1e-4     # it did move atoms
    got_v = shake.apply_velocities(torch.as_tensor(pos), torch.as_tensor(vel))
    want_v = np.asarray(j_vel(jnp.asarray(pos), jnp.asarray(vel)))
    assert np.abs(got_v.numpy() - want_v).max() <= TOL


@pytest.mark.parametrize("molecule,copies", [
    (ccma_chain, 1), (ccma_chain, 30), (branched_network, 1),
    (branched_network, 25)])
def test_ccma_matches_jax(molecule, copies):
    rng = np.random.RandomState(7 + copies)
    masses, pos, cons, angles = _replicate(*molecule(), copies, rng)
    np.testing.assert_array_equal(
        tcons.ccma_coupling_matrix(cons, masses, angles),
        jcons._ccma_coupling_matrix(cons, masses, angles))
    new, vel = _proposal(pos, rng, 0.005), rng.randn(*pos.shape)
    j_pos, j_vel = jcons.make_ccma(cons, masses, angles, jnp.float64)
    ccma = tcons.CCMA(cons, masses, angles, CPU)
    got = ccma.apply_positions(torch.as_tensor(pos), torch.as_tensor(new))
    want = np.asarray(j_pos(jnp.asarray(pos), jnp.asarray(new)))
    assert np.abs(got.numpy() - want).max() <= TOL
    assert np.abs(got.numpy() - new).max() > 1e-4
    got_v = ccma.apply_velocities(torch.as_tensor(pos), torch.as_tensor(vel))
    want_v = np.asarray(j_vel(jnp.asarray(pos), jnp.asarray(vel)))
    assert np.abs(got_v.numpy() - want_v).max() <= TOL


def _water(rng):
    masses = [15.99943, 1.007947, 1.007947]
    pos = np.array([[0, 0, 0], [0.09572, 0, 0], [-0.024, 0.0927, 0]])
    d_hh = 2 * 0.09572 * math.sin(0.5 * 104.52 * math.pi / 180)
    cons = [(0, 1, 0.09572), (0, 2, 0.09572), (1, 2, d_hh)]
    return masses, pos, cons, []


def _chain_system(rng):
    """Waters, SHAKE clusters and CCMA networks in one System for both
    packages (no other force)."""
    parts = [_replicate(*_water(rng), 20, rng),
             _replicate(*shake_molecule(), 10, rng),
             _replicate(*ccma_chain(), 5, rng),
             _replicate(*branched_network(), 5, rng)]
    masses, pos, cons, angles = [], [], [], []
    for m, p, c, a in parts:
        o = len(masses)
        masses += m
        pos.append(p)
        cons += [(i + o, j + o, d) for i, j, d in c]
        angles += [(i + o, j + o, k + o, t) for i, j, k, t in a]
    return masses, np.concatenate(pos), cons, angles


def test_context_constraint_chain_matches_jax():
    """The Context's position corrections (the field the integrator
    recovers velocities from), constrained positions and velocity
    constraints against the JAX Context's deps on the "Reference"
    platform, with SETTLE, SHAKE and CCMA all present."""
    rng = np.random.RandomState(21)
    masses, pos, cons, angles = _chain_system(rng)
    jsys, tsys = mm.System(), omm.System()
    for m in masses:
        jsys.addParticle(m)
        tsys.addParticle(m)
    jang, tang = mm.HarmonicAngleForce(), omm.HarmonicAngleForce()
    for i, j, k, t in angles:
        jang.addAngle(i, j, k, t, 100.0)
        tang.addAngle(i, j, k, t, 100.0)
    for i, j, d in cons:
        jsys.addConstraint(i, j, d)
        tsys.addConstraint(i, j, d)
    jsys.addForce(jang)
    tsys.addForce(tang)
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    ctx = omm.Context(tsys, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": "double"})
    assert ctx.constraint_split == (20, 2 * 10, 5 * 4 + 5 * 6)
    new, vel = _proposal(pos, rng, 0.005), rng.randn(*pos.shape)
    want, want_corr = jctx._deps.apply_position_constraints_corr(
        jnp.asarray(pos), jnp.asarray(new))
    got, corr = ctx._constrain_positions(torch.as_tensor(pos),
                                         torch.as_tensor(new))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert np.abs(corr.numpy() - np.asarray(want_corr)).max() <= TOL
    want_v = jctx._deps.apply_velocity_constraints(jnp.asarray(pos),
                                                   jnp.asarray(vel))
    got_v = ctx._constrain_velocities(torch.as_tensor(pos),
                                      torch.as_tensor(vel))
    assert np.abs(got_v.numpy() - np.asarray(want_v)).max() <= TOL


def test_system_without_nonbonded_steps_through_the_program():
    """A System of bonded forces and constraints alone (no
    NonbondedForce, so no candidate state and no rebuild gate) steps
    through the step program with the eager loop's bits, and its SETTLE,
    SHAKE and CCMA constraints hold."""
    rng = np.random.RandomState(8)
    masses, pos, cons, angles = _chain_system(rng)
    runs = []
    for eager in (False, True):
        system = omm.System()
        for m in masses:
            system.addParticle(m)
        for i, j, d in cons:
            system.addConstraint(i, j, d)
        force = omm.HarmonicAngleForce()
        for i, j, k, t in angles:
            force.addAngle(i, j, k, t, 100.0)
        system.addForce(force)
        integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.001)
        integ.setRandomNumberSeed(3)
        ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
        ctx.setPositions(pos)
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
        (ctx._step_eager if eager else integ.step)(5)
        runs.append(ctx.getState(getPositions=True,
                                 getVelocities=True))
    (got, want) = runs
    np.testing.assert_array_equal(plain(got.getPositions(asNumpy=True)),
                                  plain(want.getPositions(asNumpy=True)))
    np.testing.assert_array_equal(plain(got.getVelocities(asNumpy=True)),
                                  plain(want.getVelocities(asNumpy=True)))
    x = plain(got.getPositions(asNumpy=True))
    err = max(abs(np.linalg.norm(x[i] - x[j]) - d) / d for i, j, d in cons)
    assert err < 1e-5
