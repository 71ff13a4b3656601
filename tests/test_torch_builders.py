"""openmm_tpu_torch's water-box builder and parameter carrier against the
JAX package: the same seed gives identical arrays, and from_numpy /
to_numpy round-trip exactly (no arithmetic happens, so equality is exact)."""
import numpy as np
import pytest

from openmm_tpu.models import tip3p_water_box as jax_water_box

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import system_params


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("n_waters,seed", [(27, 1234), (64, 7)])
def test_water_box_matches_jax_builder(n_waters, seed):
    jsys, jpos = jax_water_box(n_waters=n_waters, jitter_seed=seed)
    system, pos = tip3p_water_box(n_waters, jitter_seed=seed)
    np.testing.assert_array_equal(
        pos, np.array([[p.x, p.y, p.z] for p in jpos]))
    _assert_params_equal(omm.to_numpy(system), system_params(jsys))


def test_from_numpy_round_trips_jax_system():
    params = system_params(jax_water_box(n_waters=27)[0])
    _assert_params_equal(omm.to_numpy(omm.from_numpy(params)), params)


def test_from_numpy_round_trips_switch_and_exceptions():
    rng = np.random.RandomState(3)
    n = 12
    params = {
        "masses": rng.uniform(1, 20, n), "charges": rng.uniform(-1, 1, n),
        "sigma": rng.uniform(0.1, 0.4, n), "epsilon": rng.uniform(0, 1, n),
        "exception_pairs": np.array([[0, 1], [2, 5], [7, 3]], np.int64),
        "exception_params": rng.uniform(0, 1, (3, 3)),
        "constraint_pairs": np.array([[0, 1]], np.int64),
        "constraint_distances": np.array([0.1]),
        "box": np.diag([2.5, 2.6, 2.7]), "cutoff": 0.8,
        "method": "CutoffPeriodic", "ewald_tolerance": 1e-4,
        "dispersion_correction": False, "switch_distance": 0.7,
    }
    _assert_params_equal(omm.to_numpy(omm.from_numpy(params)), params)


@pytest.mark.parametrize("n", [3, 8])
def test_argon_gas_matches_jax_builder(n):
    """models.argon_gas (HelloArgon) against the JAX builder: the same
    System and positions, and the same energy and forces against the JAX
    "Reference" platform."""
    import openmm_tpu as mm
    from openmm_tpu.models import argon_gas as jax_argon_gas

    from openmm_tpu_torch.models import argon_gas
    from openmm_tpu_torch.unit import plain
    jsys, jpos = jax_argon_gas(n)
    system, pos = argon_gas(n)
    np.testing.assert_array_equal(
        pos, np.array([[p.x, p.y, p.z] for p in jpos]))
    _assert_params_equal(omm.to_numpy(system), system_params(jsys))
    jctx = mm.Context(jsys, mm.VerletIntegrator(0.002),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(jpos)
    jst = jctx.getState(getEnergy=True, getForces=True)
    ctx = omm.Context(system, omm.VerletIntegrator(0.002), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    e_ref = jst.getPotentialEnergy()._value
    f_ref = np.asarray(jst.getForces(asNumpy=True)._value)
    assert abs(plain(st.getPotentialEnergy()) - e_ref) \
        <= 1e-12 * max(abs(e_ref), 1.0)
    assert np.abs(plain(st.getForces(asNumpy=True)) - f_ref).max() \
        <= 1e-10 * max(np.abs(f_ref).max(), 1.0)
    assert "argon_gas" in omm.models.__all__
