"""NVE energy drift of chip_smoke.py's three dense custom-force systems
against the step size, on several seeds.

    python3 nve_drift.py            (on a card: ~3 min)

Builds chip_smoke.py's relaxed water box (phase_main_path) for the
hydrogen-bond waters' positions, then, for each (velocity seed, argon
lattice seed) of SEEDS, runs chip_smoke.phase_more_custom on each of
more_custom_systems: at its own setting (MORE_DT, the system's steps: what
chip_smoke.py gates) and, for Axilrod-Teller, also 0.3 ps at 1, 0.5 and
0.25 fs. The phase's drift gate is off here (each drift is printed, none
raises); its other checks stand. Prints one JSON object a run: the system,
the seeds, dt, steps, the drift in kT/dof/ns as the phase computes it (the
slope of the total energy read every MORE_EVERY steps), and the RMS of
those readings about their fitted line in kT per degree of freedom. A
drift and a spread that fall with dt are the integrator's; forces that do
not conserve energy would leave a drift that does not.
"""
import json
import math
import sys

import numpy as np
import torch

import chip_smoke as cs
import openmm_tpu_torch as omm
from openmm_tpu_torch.unit import plain

SEEDS = ((cs.VELOCITY_SEED, 12), (9, 13), (10, 14))
SPAN_PS = 0.3
AT_STEP_SIZES = (0.001, 0.0005, 0.00025)


def spread(energies, every, dt, dof, temperature) -> float:
    """RMS of `energies` about their least-squares line, kT per dof."""
    times = np.arange(len(energies)) * every * dt
    fit = np.polyval(np.polyfit(times, energies, 1), times)
    rms = float(np.sqrt(np.mean((np.asarray(energies) - fit) ** 2)))
    return rms / (dof * omm.BOLTZ * temperature)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("nve_drift.py needs a CUDA device")
    device = torch.device("cuda", 0)
    cs.set_fp32_matmul_exact()
    cs.phase_device(device)
    cs.phase_build(cs.Deadline(cs.BUDGET_S))
    main_path = cs.phase_main_path(device)
    water = plain(main_path["context"].getState(
        getPositions=True).getPositions(asNumpy=True))
    for v_seed, l_seed in SEEDS:
        systems = cs.more_custom_systems(water_positions=water,
                                         argon_seed=l_seed)
        for label, (params, pos, temperature, steps) in systems.items():
            runs = [(cs.MORE_DT, steps)]
            if label == "axilrod-teller":
                runs += [(dt, round(SPAN_PS / dt)) for dt in AT_STEP_SIZES]
            for dt, n in runs:
                out = cs.phase_more_custom(
                    device, systems={label: (params, pos, temperature, n)},
                    dt=dt, gate=math.inf, seed=v_seed)[label]
                print(json.dumps({
                    "system": label, "velocity_seed": v_seed,
                    "lattice_seed": l_seed if label == "axilrod-teller"
                    else None, "dt_ps": dt, "steps": n,
                    "gated_setting": (dt, n) == runs[0],
                    "drift_kT_dof_ns": out["drift"],
                    "spread_kT_dof": spread(out["energies"], cs.MORE_EVERY,
                                            dt, out["dof"], temperature),
                    "ms_per_step": out["ms_per_step"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
