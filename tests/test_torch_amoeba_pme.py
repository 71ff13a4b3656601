"""The AMOEBA multipole PME of openmm_tpu_torch against the JAX package,
and kernel 5's VJP made differentiable.

The 12-water box of tests/test_amoeba_pme.py (OpenMM's
TestAmoebaMultipoleForce.h goldens) under Direct, Mutual and
Extrapolated polarization, and a 64-water box with the buffered 14-7 vdW
(CutoffPeriodic) beside the multipoles: the JAX package sweeps every
(n, n) pair; the port reads the pair lists of its candidate state
(ops/amoeba_pairs.py), its reciprocal space at "double" over each atom's
B-spline support, and through the differentiable spreads of
ops/pallas_pme.py (the route of "mixed", in float64 here). Energies within 1e-9 (relative), forces
within 1e-8 of the largest force (measured: 1e-13 and 2e-13), and the
12-water goldens within the JAX tests' 1e-5. The spread_triple VJP:
torch.autograd.gradgradcheck in float64, and its second derivatives
against those of the plain einsum within 1e-12 (relative to the largest).
"""
import numpy as np
import pytest
import torch

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.ops import pallas_pme
from openmm_tpu_torch.unit import plain
import test_amoeba_pme as water12
from torch_port_helpers import (assert_close_to_jax, port_against_jax,
                                system_params)

E_TOL = 1e-9
F_TOL = 1e-8
SECOND_ORDER_TOL = 1e-12
A = mm.AmoebaMultipoleForce


@pytest.mark.parametrize("polarization,e_exp,f_exp", [
    (A.Direct, water12.EXPECTED_E_DIRECT, water12.EXPECTED_F_DIRECT),
    (A.Mutual, water12.EXPECTED_E_MUTUAL, water12.EXPECTED_F_MUTUAL),
    (A.Extrapolated, None, None),
], ids=["direct", "mutual", "extrapolated"])
def test_water12_matches_jax_and_goldens(polarization, e_exp, f_exp):
    result = port_against_jax(water12.build_system(polarization),
                              water12.POSITIONS)
    assert_close_to_jax(result, E_TOL, F_TOL, "water12 %d" % polarization)
    if e_exp is not None:
        e, _, f, _ = result
        assert abs(e - e_exp) < 1e-5
        assert np.abs(f - f_exp).max() < 1e-5 * np.abs(f_exp).max()


@pytest.mark.parametrize("polarization", [A.Direct, A.Mutual],
                         ids=["direct", "mutual"])
def test_kernel_route_matches_jax(polarization):
    """The route of the "mixed" precision (kernels 4-5's autograd
    Functions, on the CPU their plain versions) in float64, against the
    JAX package: "double" takes the sparse route by default."""
    system = water12.build_system(polarization)
    port = omm.from_numpy(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    (module,) = ctx._custom
    module.sparse = False
    ctx.setPositions(water12.POSITIONS)
    st = ctx.getState(getEnergy=True, getForces=True)
    got = (plain(st.getPotentialEnergy()), None,
           plain(st.getForces(asNumpy=True)))
    want = port_against_jax(system, water12.POSITIONS)
    assert_close_to_jax((got[0], want[1], got[2], want[3]), E_TOL, F_TOL,
                        "kernel route")


def water_box(n_side=4, polarization=A.Mutual, cutoff=0.6, seed=9):
    """n_side^3 AMOEBA waters (the 12-water box's multipoles and
    polarities) on a jittered lattice at liquid density, random
    orientations, with an AmoebaVdwForce (CutoffPeriodic) of AMOEBA
    water's parameters: (JAX System, positions)."""
    rng = np.random.RandomState(seed)
    n = n_side ** 3
    edge = (n / 33.37) ** (1.0 / 3.0)
    system = mm.System()
    system.setDefaultPeriodicBoxVectors(mm.Vec3(edge, 0, 0),
                                        mm.Vec3(0, edge, 0),
                                        mm.Vec3(0, 0, edge))
    f = mm.AmoebaMultipoleForce()
    f.setNonbondedMethod(A.PME)
    f.setPolarizationType(polarization)
    f.setCutoffDistance(cutoff)
    f.setEwaldErrorTolerance(1e-4)
    vdw = mm.AmoebaVdwForce()
    vdw.setNonbondedMethod(mm.AmoebaVdwForce.CutoffPeriodic)
    vdw.setCutoffDistance(cutoff)
    geom = np.asarray([[0.0, 0.0, 0.0], [0.09572, 0.0, 0.0],
                       [-0.0304, 0.0907, 0.0]])
    pos = []
    for m in range(n):
        jj = 3 * m
        for mass in (15.995, 1.008, 1.008):
            system.addParticle(mass)
        f.addMultipole(-5.1966e-01, water12.O_DIPOLE, water12.O_QUAD, 1,
                       jj + 1, jj + 2, -1, 0.39, 3.0698765e-01, 8.37e-04)
        f.addMultipole(2.5983e-01, water12.H_DIPOLE, water12.H_QUAD, 0, jj,
                       jj + 2, -1, 0.39, 2.8135002e-01, 4.96e-04)
        f.addMultipole(2.5983e-01, water12.H_DIPOLE, water12.H_QUAD, 0, jj,
                       jj + 1, -1, 0.39, 2.8135002e-01, 4.96e-04)
        f.setCovalentMap(jj, A.Covalent12, [jj + 1, jj + 2])
        for k in range(3):
            f.setCovalentMap(jj + k, A.PolarizationCovalent11,
                             [jj, jj + 1, jj + 2])
        f.setCovalentMap(jj + 1, A.Covalent12, [jj])
        f.setCovalentMap(jj + 2, A.Covalent12, [jj])
        f.setCovalentMap(jj + 1, A.Covalent13, [jj + 2])
        f.setCovalentMap(jj + 2, A.Covalent13, [jj + 1])
        vdw.addParticle(jj, 0.17025, 0.46024, 1.0)
        vdw.addParticle(jj, 0.13275, 0.056484, 0.91)
        vdw.addParticle(jj, 0.13275, 0.056484, 0.91)
        for k in range(3):
            vdw.setParticleExclusions(jj + k, [jj, jj + 1, jj + 2])
        centre = (np.asarray(np.unravel_index(m, (n_side,) * 3), float)
                  + 0.5) * edge / n_side + rng.uniform(-0.02, 0.02, 3)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pos.extend(centre + geom @ q.T)
    system.addForce(f)
    system.addForce(vdw)
    return system, np.asarray(pos)


@pytest.mark.parametrize("polarization", [A.Direct, A.Mutual],
                         ids=["direct", "mutual"])
def test_water64_matches_jax(polarization):
    system, pos = water_box(polarization=polarization)
    assert_close_to_jax(port_against_jax(system, pos), E_TOL, F_TOL,
                        "water64 %d" % polarization)


def test_water64_steps_and_pair_lists():
    """Five steps at 0 K (float64, CPU), the pair lists rebuilt as the
    step program rebuilds them: the same positions as a Context that
    rebuilds every step (a fresh Context each step)."""
    system, pos = water_box(n_side=3, cutoff=0.45)
    port = omm.from_numpy(system_params(system))

    def context(x):
        c = omm.Context(port, omm.VerletIntegrator(0.0005),
                        omm.Platform.getPlatformByName("CPU"),
                        {"Precision": "double"})
        c.setPositions(x)
        return c

    ctx = context(pos)
    ctx.getIntegrator().step(5)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    x = pos
    v = np.zeros_like(pos)
    for _ in range(5):
        c = context(x)
        c.setVelocities(v)
        c.getIntegrator().step(1)
        st = c.getState(getPositions=True, getVelocities=True)
        x = plain(st.getPositions(asNumpy=True))
        v = plain(st.getVelocities(asNumpy=True))
    assert np.abs(got - x).max() <= 1e-12


def _planes(seed, n=7, grid=(5, 4, 6)):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(n, g, generator=gen, dtype=torch.float64,
                        requires_grad=True) for g in grid]


def test_spread_triple_gradgradcheck():
    a, wy, wz = _planes(1)
    dq = torch.randn(a.shape[1], wy.shape[1] * wz.shape[1],
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(pallas_pme.spread_triple,
                                        (a, wy, wz))
    assert torch.autograd.gradgradcheck(pallas_pme.spread_triple_vjp,
                                        (dq, a, wy, wz))


def _einsum_vjp(dq, a, wy, wz):
    d = dq.reshape(a.shape[1], wy.shape[1], wz.shape[1])
    return (torch.einsum("xyz,iy,iz->ix", d, wy, wz),
            torch.einsum("xyz,ix,iz->iy", d, a, wz),
            torch.einsum("xyz,ix,iy->iz", d, a, wy))


def test_spread_triple_second_derivatives_match_einsum():
    """The Hessian-vector products of a scalar of the spread, and the VJP
    of kernel 5's outputs, against autograd of the plain einsum."""
    a, wy, wz = _planes(2)
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(a.shape[1], wy.shape[1] * wz.shape[1], generator=gen,
                    dtype=torch.float64)
    vec = [torch.randn(t.shape, generator=gen, dtype=torch.float64)
           for t in (a, wy, wz)]

    def hvp(spread):
        q = spread(a, wy, wz)
        g = torch.autograd.grad((q * w).sum(), (a, wy, wz),
                                create_graph=True)
        return torch.autograd.grad(sum((x * v).sum()
                                       for x, v in zip(g, vec)),
                                   (a, wy, wz))

    got = hvp(pallas_pme.spread_triple)
    want = hvp(lambda *x: torch.einsum("ix,iy,iz->xyz", *x).reshape(
        a.shape[1], -1))
    for g, h in zip(got, want):
        assert (g - h).abs().max() <= SECOND_ORDER_TOL * h.abs().max()
    dq = torch.randn(w.shape, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    cot = [torch.randn(t.shape, generator=gen, dtype=torch.float64)
           for t in (a, wy, wz)]

    def vjp_grad(fn):
        out = fn(dq, a, wy, wz)
        return torch.autograd.grad(sum((o * c).sum()
                                       for o, c in zip(out, cot)),
                                   (dq, a, wy, wz))

    for g, h in zip(vjp_grad(pallas_pme.spread_triple_vjp),
                    vjp_grad(_einsum_vjp)):
        assert (g - h).abs().max() <= SECOND_ORDER_TOL * h.abs().max()


def _md_context():
    system, pos = water_box(n_side=3, polarization=A.Direct, cutoff=0.45)
    port = omm.from_numpy(system_params(system))
    for f in port.getForces():
        f.setForceGroup(1)
    integ = omm.MTSLangevinIntegrator(300.0, 1.0, 0.001, [(0, 2), (1, 1)])
    integ.setRandomNumberSeed(5)
    ctx = omm.Context(port, integ, omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
    return ctx, integ


def test_step_program_matches_eager_loop_and_reads_nothing_back():
    """The AMOEBA step through the step program against the eager loop
    from one snapshot, bit for bit, with a rebuild of the pair lists on
    the way; and the step body on fake tensors (the build run, as before
    a capture): no host read."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ctx, integ = _md_context()
    integ.step(1)
    snap = ctx._snapshot()
    integ.step(6)
    a = (ctx._state["positions"].clone(), ctx._state["velocities"].clone())
    ctx._restore(snap)
    ctx._step_eager(6)
    assert torch.equal(a[0], ctx._state["positions"])
    assert torch.equal(a[1], ctx._state["velocities"])
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)
