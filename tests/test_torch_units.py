"""The port's units (openmm_tpu_torch.unit) and Vec3 against the JAX
package's: conversions, strip and Vec3 arithmetic, one table of cases run
through both with the same arguments; and the port's setters, which strip
a Quantity to MD units and take a plain number unchanged."""
import math

import numpy as np
import pytest

from openmm_tpu import unit as ju
from openmm_tpu.vec3 import Vec3 as JVec3
import openmm_tpu_torch as omm
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.vec3 import Vec3 as PVec3


def _plain(x):
    """A comparable plain form: floats, nested tuples, arrays as lists;
    a Quantity as (value, unit name)."""
    if isinstance(x, (ju.Quantity, pu.Quantity)):
        return (_plain(x._value), x.unit.get_name())
    if isinstance(x, np.ndarray):
        return _plain(x.tolist())
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (bool, str)) or x is None:
        return x
    return float(x)


# each case: f(unit module, Vec3 class) -> a value, the same in both
CASES = {
    "nm_to_angstrom": lambda u, V: (2.5 * u.nanometer).value_in_unit(
        u.angstrom),
    "angstrom_to_nm": lambda u, V: (1.0 * u.angstrom).value_in_unit(
        u.nanometer),
    "kcal_to_kj": lambda u, V: (1.0 * u.kilocalorie_per_mole).value_in_unit(
        u.kilojoule_per_mole),
    "md_energy_identity": lambda u, V: (
        1.0 * u.dalton * u.nanometer ** 2 / u.picosecond ** 2
    ).value_in_unit(u.kilojoule_per_mole),
    "degree_to_radian": lambda u, V: (180.0 * u.degree).value_in_unit(
        u.radian),
    "fs_to_ps": lambda u, V: (2.0 * u.femtosecond).value_in_unit(
        u.picosecond),
    "bar_nm": lambda u, V: (3.0 * u.bar * u.nanometer).value_in_unit(
        u.bar * u.angstrom),
    "inverse_ps": lambda u, V: (2.0 / u.picosecond).value_in_unit(
        u.femtosecond ** -1),
    "force_constant": lambda u, V: (
        100.0 * u.kilocalorie_per_mole / u.angstrom ** 2).value_in_unit(
        u.kilojoule_per_mole / u.nanometer ** 2),
    "velocity": lambda u, V: (1.0 * u.angstrom / u.femtosecond
                              ).value_in_unit(u.nanometer / u.picosecond),
    "array_payload": lambda u, V: u.Quantity(
        np.array([[1.0, 2.0, 3.0]]), u.angstrom).value_in_unit(u.nanometer),
    "sum_and_difference": lambda u, V: (
        (2.0 * u.nanometer + 5.0 * u.angstrom).value_in_unit(u.nanometer),
        (2.0 * u.nanometer - 5.0 * u.angstrom).value_in_unit(u.nanometer)),
    "product_and_quotient": lambda u, V: (
        (2.0 * u.nanometer * (3.0 * u.nanometer)).value_in_unit(
            u.nanometer ** 2),
        (2.0 * u.nanometer / (2.0 * u.picosecond)).value_in_unit(
            u.nanometer / u.picosecond)),
    "sqrt": lambda u, V: u.sqrt(4.0 * u.nanometer ** 2).value_in_unit(
        u.angstrom),
    "unit_names": lambda u, V: (
        (u.kilojoule_per_mole / u.nanometer ** 2).get_name(),
        u.nanometer.get_symbol(), str(1.5 * u.kelvin)),
    "is_quantity": lambda u, V: (u.is_quantity(1.0 * u.kelvin),
                                 u.is_quantity(1.0)),
    "strip_md_length": lambda u, V: u.strip(3.0 * u.angstrom),
    "strip_md_energy": lambda u, V: u.strip(1.0 * u.kilocalorie_per_mole),
    "strip_md_temperature": lambda u, V: u.strip(300.0 * u.kelvin),
    "strip_md_inverse_time": lambda u, V: u.strip(2.0 / u.femtosecond),
    "strip_md_charge_product": lambda u, V: u.strip(
        -0.5 * u.elementary_charge ** 2),
    "strip_in_unit": lambda u, V: u.strip(2.0 * u.femtosecond,
                                          u.picosecond),
    "strip_plain_passes": lambda u, V: (u.strip(1.25),
                                        u.strip(1.25, u.nanometer)),
    "strip_list": lambda u, V: u.strip([1.0 * u.angstrom,
                                        2.0 * u.angstrom], u.nanometer),
    "strip_vec3_quantity": lambda u, V: u.strip(
        u.Quantity([V(1.0, 2.0, 3.0), V(4.0, 5.0, 6.0)], u.angstrom),
        u.nanometer),
    "strip_box": lambda u, V: u.strip(
        u.Quantity((V(3.0, 0, 0), V(0, 3.0, 0), V(0, 0, 3.0)), u.nanometer),
        u.angstrom),
    "vec3_add_sub": lambda u, V: (V(1.0, 2.0, 3.0) + V(0.5, 0.25, 0.125),
                                  V(1.0, 2.0, 3.0) - (1.0, 1.0, 1.0)),
    "vec3_scale": lambda u, V: (V(1.0, 2.0, 3.0) * 2.0,
                                2.0 * V(1.0, 2.0, 3.0),
                                V(1.0, 2.0, 3.0) / 4.0),
    "vec3_neg_dot_cross": lambda u, V: (
        -V(1.0, -2.0, 3.0), V(1.0, 2.0, 3.0).dot(V(4.0, 5.0, 6.0)),
        V(1.0, 0.0, 0.0).cross(V(0.0, 1.0, 0.0))),
    "vec3_times_unit": lambda u, V: (V(1.0, 2.0, 3.0) * u.angstrom
                                     ).value_in_unit(u.nanometer),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_units_match_jax(case):
    fn = CASES[case]
    expect = _plain(fn(ju, JVec3))
    got = _plain(fn(pu, PVec3))
    assert got == expect


def test_setters_strip_quantities():
    """A Quantity reaches the port's System, forces and integrators in MD
    units, a plain number unchanged."""
    system = omm.System()
    system.addParticle(15.999 * pu.dalton)
    system.addParticle(1.008)
    system.addConstraint(0, 1, 0.9572 * pu.angstrom)
    system.setDefaultPeriodicBoxVectors(
        *pu.Quantity((PVec3(30.0, 0, 0), PVec3(0, 30.0, 0),
                      PVec3(0, 0, 30.0)), pu.angstrom))
    assert system.getParticleMass(0) == 15.999
    assert system.getParticleMass(1) == 1.008
    assert math.isclose(system.getConstraintParameters(0)[2], 0.09572)
    assert np.allclose(system.getDefaultPeriodicBoxVectors(),
                       3.0 * np.eye(3))
    nb = omm.NonbondedForce()
    nb.addParticle(-0.834 * pu.elementary_charge, 3.15 * pu.angstrom,
                   0.152 * pu.kilocalorie_per_mole)
    nb.setCutoffDistance(9.0 * pu.angstrom)
    q, sig, eps = nb.getParticleParameters(0)
    assert (q, math.isclose(sig, 0.315), math.isclose(eps, 0.152 * 4.184)) \
        == (-0.834, True, True)
    assert math.isclose(nb.getCutoffDistance(), 0.9)
    bond = omm.HarmonicBondForce()
    bond.addBond(0, 1, 1.0 * pu.angstrom,
                 100.0 * pu.kilocalorie_per_mole / pu.angstrom ** 2)
    assert np.allclose(bond.getBondParameters(0)[2:], (0.1, 41840.0))
    integ = omm.LangevinMiddleIntegrator(300 * pu.kelvin, 1 / pu.picosecond,
                                         2.0 * pu.femtosecond)
    assert (integ.getTemperature(), integ.getFriction(),
            integ.getStepSize()) == (300.0, 1.0, 0.002)
    integ.setStepSize(0.001)
    assert integ.getStepSize() == 0.001
    # 1/picosecond is a bare Unit, which strips as one of it
    assert omm.LangevinIntegrator(300.0, 1 / pu.picosecond,
                                  0.002).getFriction() == 1.0
    with pytest.raises(TypeError):
        nb.setCutoffDistance(1.0 * pu.picosecond)
