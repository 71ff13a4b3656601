"""The slice on a reduced triclinic box: openmm_tpu_torch's Context on the
"CPU" platform against openmm_tpu's "CPU" (float32 tiles) and "Reference"
(float64, dense) platforms.

The system is the 343-water PME box of tests/test_torch_slice.py (1,029
atoms, so the neighbor-list engine runs) with its cubic box of edge L
sheared into a = (L, 0, 0), b = (2s, L, 0), c = (-s, 2s, L), where s = L/7
is the lattice spacing of tip3p_water_box's molecule sites. A shear by whole
spacings maps the site lattice onto itself, so no molecule meets an image
of another closer than on the cubic lattice, while every image shift, the
fractional coordinates and the PME reciprocal vectors take the triclinic
form. The bars are those of tests/test_torch_slice.py: median relative
force error <= 1e-5 and energy within 1e-5 of Reference and 5e-5 of the
JAX "CPU" platform for the float32 path; 1e-10 for the float64 path."""
import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu.models import tip3p_water_box as jax_water_box

import openmm_tpu_torch as omm
from torch_port_helpers import median_relative_error, system_params
from openmm_tpu_torch.unit import plain

N_SIDE = 7


@pytest.fixture(scope="module")
def triclinic343():
    jsys, jpos = jax_water_box(n_waters=N_SIDE ** 3)
    pos = np.array([[p.x, p.y, p.z] for p in jpos])
    edge = system_params(jsys)["box"][0, 0]
    s = edge / N_SIDE
    box = np.array([[edge, 0.0, 0.0], [2 * s, edge, 0.0],
                    [-s, 2 * s, edge]])
    jsys.setDefaultPeriodicBoxVectors(*[mm.Vec3(*v) for v in box])
    params = system_params(jsys)
    np.testing.assert_array_equal(params["box"], box)
    return jsys, pos, omm.from_numpy(params)


def _jax_state(jsys, pos, platform):
    ctx = mm.Context(jsys, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return st.getPotentialEnergy()._value, \
        np.asarray(st.getForces(asNumpy=True)._value)


def _port_state(system, pos, precision):
    ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.002),
                      "CPU", {"Precision": precision})
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return plain(st.getPotentialEnergy()), plain(st.getForces(asNumpy=True))


@pytest.mark.parametrize("precision", ["mixed", "double"])
def test_triclinic_energy_and_forces_match_jax_platforms(triclinic343,
                                                         precision):
    jsys, pos, system = triclinic343
    e_ref, f_ref = _jax_state(jsys, pos, "Reference")
    e, f = _port_state(system, pos, precision)
    if precision == "double":
        assert abs(e - e_ref) < 1e-10 * abs(e_ref)
        assert np.abs(f - f_ref).max() < 1e-10 * np.abs(f_ref).max()
        return
    e_cpu, f_cpu = _jax_state(jsys, pos, "CPU")
    assert abs(e - e_ref) < 1e-5 * abs(e_ref)
    assert abs(e - e_cpu) < 5e-5 * abs(e_cpu)
    assert median_relative_error(f, f_ref) <= 1e-5
    assert median_relative_error(f, f_cpu) <= 1e-5


def test_triclinic_box_differs_from_the_cubic_one(triclinic343):
    """The shear changes the physics: the energy is not the cubic box's."""
    jsys, pos, system = triclinic343
    cubic = system_params(jax_water_box(n_waters=N_SIDE ** 3)[0])
    cubic_system = omm.from_numpy(cubic)
    e_tri, _ = _port_state(system, pos, "double")
    e_cub, _ = _port_state(cubic_system, pos, "double")
    assert abs(e_tri - e_cub) > 1e-3 * abs(e_cub)


def test_chip_smoke_triclinic_phase_on_cpu():
    """The card's triclinic phase, rehearsed on the CPU at 343 waters:
    chip_smoke.SHEAR gives the box of this file's fixture, and kernels 1-3
    (their plain versions here) and the forces against the float64 plain
    path pass its checks."""
    import torch

    import chip_smoke
    system, _ = chip_smoke.water_box(N_SIDE ** 3, sheared=True)
    edge = plain(system.getDefaultPeriodicBoxVectors())[0][0]
    s = edge / N_SIDE
    np.testing.assert_allclose(
        plain(system.getDefaultPeriodicBoxVectors()),
        [[edge, 0, 0], [2 * s, edge, 0], [-s, 2 * s, edge]], rtol=1e-15)
    result = chip_smoke.phase_triclinic(torch.device("cpu"),
                                        n_waters=N_SIDE ** 3)
    assert set(result["errors"]) == set(chip_smoke.MAIN_PATH_NAMES)
    assert result["force_err"] <= chip_smoke.FORCE_ERR_BAR
