"""Energy derivatives of a global parameter that NonbondedForce offsets
read (forces/nonbonded.py parameter_derivatives; kernel 1's derivative
instantiation's plain version, ops/tile_pairs.py
nonbonded_tiles_deriv_plain) against the JAX package's derivative through
its offsets (openmm_tpu/forces/nonbonded.py:541-562), taken here by
forward-mode jax.jvp of its "Reference" platform's compiled energy in the
global parameters: its getState takes it by jax.grad, whose backward
through the masked pairs' jnp.where gives NaN (0 * inf at a masked
pair's sqrt of epsilon 0), though the masked pairs add nothing.

A small alchemical box: 128 TIP3P waters (384 atoms, a multiple of the
JAX "Reference" platform's pair block; its hydrogens take epsilon 0.01
and sigma 0.1: the derivative of sqrt(eps_i eps_j) in eps_i where eps_j
is 0 is 0, which the port takes, and NaN in JAX's automatic
differentiation), the first
four waters' charges and epsilons driven by `lambda` through particle
offsets, one oxygen's sigma by `mu`, three exceptions' chargeProd and
epsilon by `lambda`; a CustomBondForce in group 1 requests both
derivatives. At PME, LJPME, Ewald, CutoffPeriodic and CutoffNonPeriodic,
float64, the NonbondedForce's group alone (the direct space, the
exceptions, the exclusion correction, the reciprocal space and the self
energies): dE/dlambda and dE/dmu within 1e-9 (relative) of the JAX
"Reference" platform's, at two values of lambda; with the reciprocal
space in a group of its own, each group's share. The float32 path (the
plain float32 version of kernel 1's derivative instantiation and of
kernel 2) against float64 within 1e-5 (relative), and the float64
derivative against a central difference of float64 energies (1e-6
relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import jax_system
from openmm_tpu_torch.unit import plain

N_WATERS = 128
DECOUPLED = 4
D_TOL = 1e-9
D_TOL32 = 1e-5
FD_TOL = 1e-6
METHODS = {"PME": omm.NonbondedForce.PME, "LJPME": omm.NonbondedForce.LJPME,
           "Ewald": omm.NonbondedForce.Ewald,
           "CutoffPeriodic": omm.NonbondedForce.CutoffPeriodic,
           "CutoffNonPeriodic": omm.NonbondedForce.CutoffNonPeriodic}


def _box(method, recip_group=-1):
    system, pos = tip3p_water_box(N_WATERS, nonbonded_method=METHODS[method])
    params = omm.to_numpy(system)
    hydrogens = params["epsilon"] == 0.0
    params["epsilon"][hydrogens] = 0.01
    params["sigma"][hydrogens] = 0.1
    q, eps = params["charges"].copy(), params["epsilon"].copy()
    atoms = np.arange(3 * DECOUPLED)
    params["charges"][atoms] = 0.2 * q[atoms]
    params["epsilon"][atoms] = 0.0
    params["global_parameters"] = [("lambda", 1.0), ("mu", 0.25)]
    params["particle_offsets"] = [
        ("lambda", int(i), float(0.8 * q[i]), 0.0, float(eps[i]))
        for i in atoms]
    params["particle_offsets"].append(("mu", 3 * DECOUPLED, 0.0, 0.02, 0.0))
    params["exception_offsets"] = [("lambda", 3 * k, 0.05, 0.0, 0.1)
                                   for k in range(3)]
    params["exception_params"][[0, 3, 6], 1] = 0.08
    if recip_group >= 0:
        params["reciprocal_group"] = recip_group
    params["custom_forces"] = [{
        "kind": "CustomBondForce", "energy": "lambda*mu*(r-0.3)^2",
        "group": 1, "globals": [("lambda", 1.0), ("mu", 0.25)],
        "derivatives": ["lambda", "mu"], "functions": [],
        "parameters": [], "terms": [((0, 3), [])], "periodic": True}]
    return params, pos


def _derivs(ctx, groups):
    d = ctx.getState(getParameterDerivatives=True,
                     groups=groups).getEnergyParameterDerivatives()
    return {k: float(v) for k, v in d.items()}


def _jax_derivs(ctx, groups):
    """{name: dE/dname} of the JAX Context's compiled NonbondedForce parts
    in `groups`, by jax.jvp in each global parameter."""
    mods = [m for m in ctx._modules if m.name.startswith("NonbondedForce")
            and m.force_group in groups]
    s = ctx._state
    gp = s["gp"]

    def energy(g):
        return sum(m.energy_fn(s["positions"], s["box"], m.params, g)
                   for m in mods)

    out = {}
    for name in ("lambda", "mu"):
        tangent = {k: jnp.zeros_like(v) for k, v in gp.items()}
        tangent[name] = jnp.ones_like(gp[name])
        out[name] = float(jax.jvp(energy, (gp,), (tangent,))[1])
    return out


def _port(params, pos, precision="double"):
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU", {"Precision": precision})
    ctx.setPositions(pos)
    return ctx


def _jax(params, pos):
    ctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName("Reference"))
    ctx.setPositions(pos)
    return ctx


def _close(got, want, tol):
    """Each derivative within tol of its reference, relative (absolute
    below 1: the reciprocal space does not read sigma); dE/dlambda must
    not vanish."""
    assert set(got) == set(want)
    assert abs(want["lambda"]) > 1.0
    for name, value in want.items():
        assert abs(got[name] - value) <= tol * max(abs(value), 1.0), (
            name, got[name], value)


@pytest.mark.parametrize("method", list(METHODS))
def test_against_jax_reference(method):
    params, pos = _box(method)
    ctx, jctx = _port(params, pos), _jax(params, pos)
    for lam in (1.0, 0.4):
        ctx.setParameter("lambda", lam)
        jctx.setParameter("lambda", lam)
        _close(_derivs(ctx, {0}), _jax_derivs(jctx, {0}), D_TOL)


def test_reciprocal_group_shares():
    params, pos = _box("PME", recip_group=2)
    ctx, jctx = _port(params, pos), _jax(params, pos)
    for groups in ({0}, {2}):
        _close(_derivs(ctx, groups), _jax_derivs(jctx, groups), D_TOL)


@pytest.mark.parametrize("method", ["PME", "LJPME", "CutoffPeriodic"])
def test_float32_against_float64(method):
    params, pos = _box(method)
    _close(_derivs(_port(params, pos, "mixed"), {0}),
           _derivs(_port(params, pos), {0}), D_TOL32)


@pytest.mark.parametrize("method", ["PME", "Ewald"])
def test_against_central_difference(method):
    params, pos = _box(method)
    ctx = _port(params, pos)
    ctx.setParameter("lambda", 0.6)
    got = _derivs(ctx, {0})["lambda"]
    e = []
    for lam in (0.6 + 1e-4, 0.6 - 1e-4):
        ctx.setParameter("lambda", lam)
        e.append(plain(ctx.getState(getEnergy=True,
                              groups={0}).getPotentialEnergy()))
    want = (e[0] - e[1]) / 2e-4
    assert abs(got - want) <= FD_TOL * abs(want)
