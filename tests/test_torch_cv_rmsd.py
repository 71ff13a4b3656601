"""RMSDForce and CustomCVForce of openmm_tpu_torch (forces/rmsd.py,
forces/customcv.py) against the JAX package.

On 128 particles on a jittered lattice (a multiple of the JAX "Reference"
platform's pair block, whose padded sweep gives NaN parameter derivatives
where a padding particle's epsilon 0 meets sqrt) with a NonbondedForce,
HarmonicBondForces and a GBSAOBCForce (float64): an RMSDForce over 24 of them; a CustomCVForce of
a restraint on that RMSD (0.5*k*(rmsd-r0)^2) and of three more variables
(a CustomBondForce, a HarmonicBondForce and a non-periodic
NonbondedForce with a global parameter and a particle offset), with
derivatives of r0 and of the inner parameter requested. Against the JAX
"Reference" platform: energies within 1e-10 (relative), forces within
1e-9 of the largest, parameter derivatives within 1e-9 (relative);
getCollectiveVariableValues against the JAX package's and against a
numpy Kabsch RMSD (1e-10). The RMSD's closed-form gradient against
torch.autograd of the same RMSD through torch.linalg.eigvalsh (1e-12 of
the largest force), the Newton root against eigvalsh (1e-12 relative).
Ten steps at 0 K against the JAX "Reference" Context (1e-9 nm);
updateParametersInContext; steering r0 by setParameter without a new
capture; the step body on fake tensors; a periodic (PME) NonbondedForce
as a variable against the JAX "Reference" platform; from_numpy/to_numpy of the CV with its
variables; chip_smoke.py's phase_rmsd_cv rehearsed on the CPU.
"""
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from openmm_tpu_torch.forces.rmsd import RMSDModule
from torch_port_helpers import jax_system
from openmm_tpu_torch.unit import plain

E_TOL = 1e-10
F_TOL = 1e-9
D_TOL = 1e-9
POS_TOL = 1e-9
N = 128
SUBSET = list(range(2, 26))


def _params():
    rng = np.random.RandomState(6)
    lattice = np.stack(np.meshgrid(np.arange(8), np.arange(4), np.arange(4),
                                   indexing="ij"), axis=-1).reshape(-1, 3)
    pos = 0.4 * lattice + rng.uniform(-0.05, 0.05, (N, 3))
    params = {
        "masses": rng.uniform(10.0, 20.0, N),
        "charges": rng.uniform(-0.4, 0.4, N),
        "sigma": rng.uniform(0.2, 0.3, N),
        "epsilon": rng.uniform(0.1, 0.5, N) * 0.1,
        "exception_pairs": np.zeros((0, 2), np.int64),
        "exception_params": np.zeros((0, 3)),
        "constraint_pairs": np.zeros((0, 2), np.int64),
        "constraint_distances": np.zeros(0),
        "box": np.diag([4.0, 4.0, 4.0]), "cutoff": 1.0,
        "method": "NoCutoff", "ewald_tolerance": 5e-4,
        "dispersion_correction": False, "switch_distance": -1.0,
        "bond_pairs": np.asarray([(i, i + 1) for i in range(0, N - 1, 2)]),
        "bond_params": np.tile([0.15, 5000.0], (N // 2, 1)),
        "gb_charges": rng.uniform(-0.3, 0.3, N),
        "gb_radii": rng.uniform(0.12, 0.18, N),
        "gb_scales": rng.uniform(0.7, 0.9, N),
        "gb_method": "NoCutoff", "gb_cutoff": 1.0,
        "gb_solute_dielectric": 1.0, "gb_solvent_dielectric": 78.5,
        "gb_surface_energy": 2.0,
    }
    reference = pos + rng.normal(0.0, 0.08, pos.shape)
    return params, pos, reference


def _specs(params, pos, reference):
    rmsd = {"kind": "RMSDForce", "group": 1,
            "reference": reference.tolist(), "particles": SUBSET}
    inner_nb = {k: params[k] for k in (
        "charges", "sigma", "epsilon", "exception_pairs",
        "exception_params", "cutoff", "ewald_tolerance",
        "dispersion_correction", "switch_distance")}
    inner_nb.update(kind="NonbondedForce", group=0,
                    method="CutoffNonPeriodic",
                    global_parameters=[("qscale", 0.5)],
                    particle_offsets=[("qscale", 3, 0.2, 0.0, 0.01),
                                      ("qscale", 7, -0.1, 0.01, 0.0)])
    cv = {"kind": "CustomCVForce", "group": 2,
          "energy": "0.5*k*(rmsd-r0)^2 + 0.1*d^2 + w*b + 0.01*nb",
          "globals": [("k", 800.0), ("r0", 0.05), ("w", 0.3),
                      ("qscale", 0.5)],
          "derivatives": ["r0", "qscale"], "functions": [],
          "periodic": False,
          "variables": [
              ("rmsd", dict(rmsd, group=0)),
              ("d", {"kind": "CustomBondForce", "group": 0,
                     "energy": "r", "globals": [], "derivatives": [],
                     "functions": [], "parameters": [],
                     "terms": [((0, 30), []), ((5, 33), [])],
                     "periodic": False}),
              ("b", {"kind": "HarmonicBondForce", "group": 0,
                     "bond_pairs": np.asarray([(1, 8), (9, 12)]),
                     "bond_params": np.asarray([[0.3, 100.0],
                                                [0.4, 50.0]])}),
              ("nb", inner_nb)]}
    return [rmsd, cv]


@pytest.fixture(scope="module")
def case():
    params, pos, reference = _params()
    params["custom_forces"] = _specs(params, pos, reference)
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    jctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    return params, pos, reference, ctx, jctx


def _reading(ctx, group, jax=False):
    st = ctx.getState(getEnergy=True, getForces=True,
                      getParameterDerivatives=True, groups={group})
    if not jax:
        return (plain(st.getPotentialEnergy()),
                plain(st.getForces(asNumpy=True)),
                st.getEnergyParameterDerivatives())
    return (float(u.strip(st.getPotentialEnergy())),
            np.asarray(u.strip(st.getForces(asNumpy=True))),
            {k: float(v) for k, v in
             st.getEnergyParameterDerivatives().items()})


def _close(got, want):
    e, f, d = got
    e_ref, f_ref, d_ref = want
    assert abs(e - e_ref) <= E_TOL * abs(e_ref), (e, e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL * np.abs(f_ref).max()
    assert set(d) == set(d_ref)
    for name, value in d_ref.items():
        assert abs(d[name] - value) <= D_TOL * max(abs(value), 1e-12), (
            name, d[name], value)


def _kabsch(x, y):
    x = x - x.mean(axis=0)
    y = y - y.mean(axis=0)
    v, s, wt = np.linalg.svd(x.T @ y)
    s[-1] *= np.sign(np.linalg.det(v @ wt))
    return np.sqrt(max((np.sum(x * x) + np.sum(y * y) - 2 * s.sum())
                       / len(x), 0.0))


@pytest.mark.parametrize("group", [1, 2], ids=["rmsd", "cv"])
def test_against_jax_reference(case, group):
    _, _, _, ctx, jctx = case
    want = _reading(jctx, group, jax=True)
    assert abs(want[0]) > 1e-3
    _close(_reading(ctx, group), want)


def test_collective_variable_values(case):
    params, pos, reference, ctx, jctx = case
    cv = ctx.getSystem().getForces()[-1]
    jcv = jctx.getSystem().getForces()[-1]
    got = cv.getCollectiveVariableValues(ctx)
    want = jcv.getCollectiveVariableValues(jctx)
    assert np.allclose(got, want, rtol=1e-10, atol=0.0)
    assert abs(got[0] - _kabsch(pos[SUBSET], reference[SUBSET])) <= (
        1e-10 * got[0])


def _eig_rmsd(module, x):
    """The RMSD through torch.linalg.eigvalsh (differentiable by
    autograd on the CPU)."""
    p = x[module.idx]
    p = p - p.mean(dim=0)
    y = module.ref
    key = torch.einsum("ab,abij->ij", p.T @ y, module.basis)
    lam = torch.linalg.eigvalsh(key)[-1]
    msd = ((p * p).sum() + (y * y).sum() - 2.0 * lam) / module.m
    return torch.sqrt(msd + 1e-30), lam


def test_rmsd_gradient_and_root_against_autograd(case):
    _, pos, _, ctx, _ = case
    (module,) = [m for m in ctx._custom if isinstance(m, RMSDModule)]
    x = torch.as_tensor(pos, dtype=torch.float64).requires_grad_(True)
    rmsd, lam = _eig_rmsd(module, x)
    lam = lam.detach()
    (grad,) = torch.autograd.grad(rmsd, x)
    value, forces = module.ef(x.detach(), ctx._box)
    lam_newton, _ = module._top(x.detach()[module.idx]
                                - x.detach()[module.idx].mean(dim=0))
    assert abs(float(lam_newton) - float(lam)) <= 1e-12 * abs(float(lam))
    rmsd = float(rmsd.detach())
    assert abs(float(value) - rmsd) <= 1e-12 * rmsd
    assert float((forces + grad).abs().max()) <= 1e-12 * float(
        grad.abs().max())


def test_ten_steps_at_zero_kelvin_match_jax_reference(case):
    params, pos = case[:2]
    integ = omm.LangevinMiddleIntegrator(0.0, 0.0, 0.001)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    jctx = mm.Context(jax_system(params),
                      mm.LangevinMiddleIntegrator(0.0, 0.0, 0.001),
                      mm.Platform.getPlatformByName("Reference"))
    vel = np.random.RandomState(3).randn(*pos.shape) * 0.3
    for c in (ctx, jctx):
        c.setPositions(pos)
        c.setVelocities(vel)
    integ.step(10)
    jctx.getIntegrator().step(10)
    want = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(want - pos).max() > 1e-3
    assert np.abs(got - want).max() <= POS_TOL


def test_update_and_steering_without_capture(case):
    """A new reference through updateParametersInContext in both
    packages, and r0 raised by setParameter between chunks: the same
    energies, and no new step program."""
    params, pos, reference = case[:3]
    integ = omm.VerletIntegrator(0.001)
    system = omm.from_numpy(params)
    ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
    ctx.setPositions(pos)
    jsystem = jax_system(params)
    jctx = mm.Context(jsystem, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    integ.step(2)
    programs = dict(ctx._programs)
    ctx.setPositions(pos)
    shifted = reference + 0.03
    for c, force in ((ctx, system.getForces()[-2]),
                     (jctx, jsystem.getForces()[-2])):
        force.setReferencePositions(shifted)
        force.updateParametersInContext(c)
    _close(_reading(ctx, 1), _reading(jctx, 1, jax=True))
    for r0 in (0.1, 0.2):
        ctx.setParameter("r0", r0)
        jctx.setParameter("r0", r0)
        _close(_reading(ctx, 2), _reading(jctx, 2, jax=True))
        integ.step(2)
        ctx.setPositions(pos)
    assert ctx._programs == programs


def test_step_body_reads_nothing_from_the_device(case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    params, pos = case[:2]
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.001)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx.setPositions(pos)
    integ.step(1)
    program = ctx._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)


def test_periodic_nonbonded_variable_is_refused(case):
    """A periodic (PME) NonbondedForce as the CV's variable, with its
    global parameter and particle offsets, once refused: its energy,
    forces and the offsets' parameter derivative against the JAX
    "Reference" platform, the variable's candidate state built under the
    Context's gate."""
    params = dict(case[0])
    cv = _specs(params, case[1], case[2])[1]
    nb = dict(cv["variables"][3][1], method="PME")
    cv["variables"] = [("nb", nb)]
    cv["energy"] = "0.5*nb"
    cv["globals"] = [("qscale", 0.5)]
    cv["derivatives"] = ["qscale"]
    params["custom_forces"] = [cv]
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": "double"})
    ctx.setPositions(case[1])
    jctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(case[1])
    assert [m.tiled for m in ctx._custom] == [ctx._cv_nonbondeds]
    assert ctx._candidates is ctx._cv_nonbondeds[0]
    want = _reading(jctx, 2, jax=True)
    assert abs(want[0]) > 1e-3
    _close(_reading(ctx, 2), want)
    assert ctx.rebuild_count == 1


def test_from_numpy_round_trip(case):
    params = case[0]
    again = omm.to_numpy(omm.from_numpy(params))
    rmsd, cv = again["custom_forces"]
    assert rmsd["particles"] == SUBSET
    assert np.array_equal(rmsd["reference"], params["custom_forces"][0][
        "reference"])
    assert [name for name, _ in cv["variables"]] == ["rmsd", "d", "b", "nb"]
    kinds = [spec["kind"] for _, spec in cv["variables"]]
    assert kinds == ["RMSDForce", "CustomBondForce", "HarmonicBondForce",
                     "NonbondedForce"]
    nb = cv["variables"][3][1]
    assert nb["particle_offsets"] == params["custom_forces"][1][
        "variables"][3][1]["particle_offsets"]
    assert np.array_equal(cv["variables"][2][1]["bond_pairs"],
                          [(1, 8), (9, 12)])


def test_chip_smoke_rmsd_cv_phase_on_cpu():
    """chip_smoke.py's phase_rmsd_cv rehearsed on the cropped bilayer (2
    chunks of 2 steps, 2 replayed): every gate holds on the CPU, and the
    CV force leaves the shared System."""
    import math

    import chip_smoke
    from torch_port_helpers import cropped_bilayer, system_params
    jsys, pos, _ = cropped_bilayer()
    system = omm.from_numpy(system_params(jsys))
    integ = omm.LangevinMiddleIntegrator(303.15, 1.0, 0.002)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=4)
    minimized = plain(ctx.getState(getPositions=True).getPositions(
        asNumpy=True))
    integ.step(3)
    forces = len(system.getForces())
    out = chip_smoke.phase_rmsd_cv(
        torch.device("cpu"), {"system": system, "context": ctx,
                              "minimized_positions": minimized,
                              "step": integ.step},
        chunk=2, chunks=2, replay=2, turn_steps=1, t_range=(0.0, math.inf))
    assert out["fd_err"] <= chip_smoke.RMSD_FD_BAR
    assert abs(out["rmsd"] - out["kabsch"]) <= 1e-9 * out["kabsch"]
    assert len(system.getForces()) == forces
