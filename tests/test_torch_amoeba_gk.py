"""AmoebaGeneralizedKirkwoodForce of openmm_tpu_torch (folded into the
multipole force, ops/gk.py) and AmoebaWcaDispersionForce beside it,
against the JAX package and OpenMM's ammonia-dimer goldens
(tests/test_amoeba_gk.py, after TestAmoebaGeneralizedKirkwoodForce.h).

The ammonia dimer under Direct and Mutual polarization, with and without
the cavity term: energy within 1e-9 (relative) and forces within 1e-8 of
the largest of the JAX "Reference" platform (measured 1.2e-15 and
9.9e-16), and the goldens within the JAX tests' 1e-5. Then the dimer with
a WCA dispersion force, getInducedDipoles (the SCF's dipoles without
the GK reaction field, as the JAX package gives them) and ten
steps at 0 K against the JAX Context (1e-9 nm).
"""
import numpy as np
import pytest

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.unit import plain
import test_amoeba_gk as ammonia
from torch_port_helpers import (assert_close_to_jax, jax_system,
                                port_against_jax, system_params)

E_TOL = 1e-9
F_TOL = 1e-8
POS_TOL = 1e-9
A = mm.AmoebaMultipoleForce


@pytest.mark.parametrize("polarization,cavity,expected", [
    (A.Direct, 0, -7.6636680e+01),
    (A.Mutual, 0, -7.8018875e+01),
    (A.Mutual, 1, -6.0434582e+01),
    (A.Extrapolated, 1, None),
], ids=["direct", "mutual", "mutual-cavity", "extrapolated-cavity"])
def test_gk_ammonia_matches_jax_and_golden(polarization, cavity, expected):
    result = port_against_jax(ammonia.build_ammonia(polarization, cavity),
                              ammonia.POSITIONS)
    assert_close_to_jax(result, E_TOL, F_TOL, "gk %d %d"
                        % (polarization, cavity))
    if expected is not None:
        assert abs(result[0] - expected) < 1e-5 * abs(expected)


def test_gk_direct_forces_golden():
    expected = np.array([
        [-6.9252994e+02, -8.9085133e+00, 9.6489739e+01],
        [1.5593797e+02, -6.0331931e+01, 1.5104507e+01],
        [1.5870088e+02, 6.1702809e+01, 6.7708985e+00],
        [1.4089885e+02, 7.5870617e+00, -1.1362294e+02],
        [-1.8916205e+02, 2.1465549e-01, -4.3433152e+02],
        [1.0208290e+01, 6.2676753e+01, 1.4987953e+02],
        [4.0621859e+02, 1.8962203e-01, 1.3021956e+02],
        [9.7274235e+00, -6.3130458e+01, 1.4949024e+02]])
    _, _, f, _ = port_against_jax(ammonia.build_ammonia(A.Direct, 0),
                                  ammonia.POSITIONS)
    assert np.abs(f - expected).max() < 1e-5 * np.abs(expected).max()


def _with_wca():
    system = ammonia.build_ammonia(A.Mutual, 1)
    wca = mm.AmoebaWcaDispersionForce()
    for k in range(8):
        wca.addParticle(0.185 if k % 4 == 0 else 0.135,
                        0.46 if k % 4 == 0 else 0.08)
    system.addForce(wca)
    return system


def test_gk_with_wca_matches_jax():
    assert_close_to_jax(port_against_jax(_with_wca(), ammonia.POSITIONS),
                        E_TOL, F_TOL, "gk + wca")


def test_solvated_induced_dipoles_and_steps_match_jax():
    system = _with_wca()
    port = omm.from_numpy(system_params(system))
    twin = jax_system(system_params(system))
    ctx = omm.Context(port, omm.VerletIntegrator(0.0005),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(ammonia.POSITIONS)
    jctx = mm.Context(twin, mm.VerletIntegrator(0.0005),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in ammonia.POSITIONS])
    got = port.getForces()[0].getInducedDipoles(ctx)
    want = np.asarray(twin.getForces()[0].getInducedDipoles(jctx))
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    ctx.getIntegrator().step(10)
    jctx.getIntegrator().step(10)
    x = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    y = np.asarray(jctx.getState(getPositions=True)
                   .getPositions(asNumpy=True)._value)
    assert np.abs(x - ammonia.POSITIONS).max() > 1e-6
    assert np.abs(x - y).max() <= POS_TOL


def _setup_inputs(n=7, seed=5):
    import torch
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(0.0, 0.8, (n, 3)), requires_grad=True)
    born = torch.tensor(rng.uniform(0.15, 0.3, n), requires_grad=True)
    charge = torch.tensor(rng.normal(0.0, 0.3, n))
    d_lab = torch.tensor(rng.normal(0.0, 0.02, (n, 3)), requires_grad=True)
    q = rng.normal(0.0, 0.002, (n, 3, 3))
    q_lab = torch.tensor(q + q.transpose(0, 2, 1), requires_grad=True)
    mu = torch.tensor(rng.normal(0.0, 0.01, (n, 3)))
    return pos, born, charge, d_lab, q_lab, mu


def _gk_energy(setup, mu):
    from openmm_tpu_torch.ops import gk
    return (gk.gk_energy_permanent(setup) + gk.gk_energy_induced(setup, mu)
            + (gk.gk_dipole_field(setup, mu) * mu).sum())


def test_recomputed_setup_has_the_plain_setups_gradients():
    """gk_setup_recomputed (its pair tensors recomputed in the backward)
    against gk_setup kept whole: energy and every input's gradient equal
    to 1e-12 relative (measured 0, the same operations in the same
    order)."""
    import torch
    from openmm_tpu_torch.ops import gk
    pos, born, charge, d_lab, q_lab, mu = _setup_inputs()
    inputs = (pos, born, d_lab, q_lab)
    results = []
    for make in (gk.gk_setup, gk.gk_setup_recomputed):
        setup = make(pos, born, charge, d_lab, q_lab, 78.3)
        energy = _gk_energy(setup, mu)
        results.append((energy.detach(),
                        torch.autograd.grad(energy, inputs)))
    (e0, g0), (e1, g1) = results
    assert abs(float(e1 - e0)) <= 1e-12 * abs(float(e0))
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())


def test_gk_forces_import_no_dynamo():
    """A GK energy's gradient leaves torch._dynamo unimported: the first
    import takes seconds, which torch.utils.checkpoint paid on its first
    call."""
    import inspect
    import subprocess
    import sys
    code = "\n".join([
        "import sys", "import numpy as np", "import torch",
        inspect.getsource(_setup_inputs), inspect.getsource(_gk_energy),
        "from openmm_tpu_torch.ops import gk",
        "pos, born, charge, d_lab, q_lab, mu = _setup_inputs()",
        "setup = gk.gk_setup_recomputed(pos, born, charge, d_lab, q_lab, "
        "78.3)",
        "torch.autograd.grad(_gk_energy(setup, mu), pos)",
        "print('torch._dynamo' in sys.modules)"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "False"
