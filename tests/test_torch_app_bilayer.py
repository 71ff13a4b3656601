"""chip_smoke.py's app-bilayer phase (phase_app_bilayer), rehearsed on the
CPU on the cropped POPC bilayer (tests/torch_port_helpers.py
_cropped_patch, ~2,300 atoms) with the JAX ForceField's System of that
crop (through system_params) as its reference: PDBFile there and back,
ForceField.createSystem gated equal to the reference (the box to the
PDB's precision), both Systems' energy and forces at the PDB's positions,
Simulation.minimizeEnergy, the StateDataReporter and DCDReporter over a
few steps, the DCD read back, and the turns. The gates are the card's but
the temperature's band: a minimization that stops at its first reading
(tolerance 1e9: each plain-PyTorch evaluation takes ~0.7 s here) and 4
steps of 2,300 atoms stray further from 300 K than 200 steps of 32,512."""
import torch

import openmm_tpu_torch as omm
from torch_port_helpers import (_cropped_patch, jax_bilayer_system,
                                port_topology, system_params)


def test_chip_smoke_app_bilayer_phase_on_cpu():
    import chip_smoke
    top, pos, _ = _cropped_patch(0.33)
    reference = omm.from_numpy(system_params(jax_bilayer_system(top)))
    out = chip_smoke.phase_app_bilayer(
        torch.device("cpu"), patch=(port_topology(top), pos),
        reference=(reference, pos), steps=4, report_every=2,
        minimize_iterations=1, minimize_tolerance=1e9, turn_steps=1,
        t_band=200.0)
    assert out["frames"] == 2 and len(out["energies"]) == 2
    assert out["energy_rel"] == 0.0 and out["force_err"] == 0.0
    assert out["reordered"] == []
    # CPU tensors take the plain versions: no kernel launched
    assert set(out["step_launches"].values()) == {0}
    assert set(out["minimize_launches"].values()) == {0}
