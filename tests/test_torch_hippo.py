"""HippoNonbondedForce of openmm_tpu_torch (forces/hippo.py,
ops/hippo_math.py) against the JAX package and OpenMM's water-dimer
goldens (tests/test_hippo.py, after TestHippoNonbondedForce.h).

The water dimer: energy within 1e-9 (relative) and forces within 1e-8 of
the largest of the JAX "Reference" platform (measured 1.1e-13 and
9.2e-14), the goldens (energy, forces, lab-frame and induced dipoles)
within the JAX tests' 1e-5. A 27-water cluster of
models.hippo_water_cluster (HIPPO with its bonds and angles) against the
JAX package, and ten steps at 0 K against the JAX Context (1e-9 nm). PME
raises, as it does in the JAX package.
"""
import numpy as np
import pytest

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import hippo_water_cluster
from openmm_tpu_torch.unit import plain
import test_hippo as dimer
from torch_port_helpers import (assert_close_to_jax, jax_system,
                                port_against_jax, system_params)

E_TOL = 1e-9
F_TOL = 1e-8
POS_TOL = 1e-9


def _dimer_contexts():
    system, _ = dimer.build_water_system(2)
    port = omm.from_numpy(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.0005),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(dimer.DIMER_POSITIONS)
    return system, port, ctx


def test_dimer_matches_jax_and_goldens():
    system, port, ctx = _dimer_contexts()
    result = port_against_jax(system, dimer.DIMER_POSITIONS)
    assert_close_to_jax(result, E_TOL, F_TOL, "hippo dimer")
    e, _, f, _ = result
    assert abs(e - (-18.393623712669680)) < 1e-5 * 18.4
    expected = -np.array([
        [-162.94090034728887, 0.0, 35.06615691195519],
        [127.50063696213348, 0.0, -46.51857483822334],
        [39.59601328153432, 0.0, 11.805509637931072],
        [-73.52341534248339, 0.0, -92.08855312751808],
        [34.68383272305204, -26.35219958830841, 45.867730707927564],
        [34.68383272305204, 26.35219958830841, 45.867730707927564]])
    assert np.abs(f - expected).max() < 1e-5 * np.abs(expected).max()


def test_dimer_dipoles_match_jax_and_goldens():
    system, port, ctx = _dimer_contexts()
    force = port.getForces()[0]
    jctx = mm.Context(system, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(dimer.DIMER_POSITIONS)
    jforce = system.getForces()[0]
    for got, want in (
            (force.getLabFramePermanentDipoles(ctx),
             jforce.getLabFramePermanentDipoles(jctx)),
            (force.getInducedDipoles(ctx), jforce.getInducedDipoles(jctx))):
        want = np.asarray(want, np.float64)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    expected_ind = np.array([
        [-2.6946897397455059e-3, 0.0, 5.7283370317562626e-4],
        [-3.4687164828218306e-3, 0.0, 2.3558084682622801e-4],
        [-8.3759103839743578e-4, 0.0, -4.0453541836814088e-4],
        [-4.7635598636156719e-3, 0.0, -6.2133742026147971e-4],
        [-6.3777660942845697e-4, 5.2439508203868156e-4,
         -4.3219965383009991e-4],
        [-6.3777660942845697e-4, -5.2439508203868156e-4,
         -4.3219965383009991e-4]])
    assert np.abs(force.getInducedDipoles(ctx) - expected_ind).max() < 1e-5


def test_cluster_matches_jax_and_steps():
    system, pos = hippo_water_cluster(27)
    params = omm.to_numpy(system)
    twin = jax_system(params)
    assert_close_to_jax(port_against_jax(twin, pos), E_TOL, F_TOL,
                        "hippo cluster")
    ctx = omm.Context(system, omm.VerletIntegrator(0.0005),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(pos)
    ctx.getIntegrator().step(10)
    jctx = mm.Context(twin, mm.VerletIntegrator(0.0005),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in pos])
    jctx.getIntegrator().step(10)
    x = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    y = np.asarray(jctx.getState(getPositions=True)
                   .getPositions(asNumpy=True)._value)
    assert np.abs(x - pos).max() > 1e-6
    assert np.abs(x - y).max() <= POS_TOL


def test_pme_raises():
    system, _ = hippo_water_cluster(1)
    system.getForces()[0].setNonbondedMethod(1)
    with pytest.raises(NotImplementedError, match="NoCutoff"):
        omm.Context(system, omm.VerletIntegrator(0.001),
                    omm.Platform.getPlatformByName("CPU"))
