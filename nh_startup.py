"""The start-up of a constant-energy quantity from velocities drawn afresh.

    python3 nh_startup.py            (on a card: ~90 s)

Builds chip_smoke.py's relaxed water box (24,000 atoms, PME 0.9 nm) and
takes two start states: the end of its main path ("equilibrated") and the
state its Nose-Hoover phase starts from, after phase_step_program
("relaxing"). From each, with Maxwell-Boltzmann velocities at
chip_smoke.NH_START K (the phase's seed), it runs NoseHooverIntegrator
(chip_smoke's 300 K, 10/ps) at 1, 0.5 and 0.25 fs and NVE Verlet at 1 and
0.5 fs for 1 ps, reading every 50 fs the potential plus the kinetic energy
shifted by half a step plus the heat bath's (chip_smoke._nh_conserved).
Prints one JSON object a run: the start, the integrator, dt, the readings
less the first, the bath energy and the temperature at each reading, and
the start-up jump (the mean of the readings over the first 500 fs less
the first). A jump that goes as dt^2 is the step's, one that Verlet
shares is not the chains'.
"""
import json
import sys

import numpy as np
import torch

import chip_smoke as cs
import openmm_tpu_torch as omm
from openmm_tpu_torch.unit import plain

SPAN_FS = 1000
EVERY_FS = 50
STARTUP_FS = 500


def run(system, state, integ, dt, bath) -> dict:
    ctx = omm.Context(system, integ)
    ctx.setPositions(plain(state.getPositions(asNumpy=True)))
    ctx.setVelocitiesToTemperature(cs.NH_START, randomSeed=cs.VELOCITY_SEED)
    every = round(EVERY_FS / (dt * 1000.0))
    readings, baths, temperatures = [], [], []
    for i in range(SPAN_FS // EVERY_FS + 1):
        if i:
            integ.step(every)
        readings.append(cs._nh_conserved(ctx, bath, dt))
        baths.append(bath.computeHeatBathEnergy())
        temperatures.append(ctx.temperature())
    n = STARTUP_FS // EVERY_FS
    return {"dt": dt, "readings": [e - readings[0] for e in readings],
            "bath": baths, "temperature": temperatures,
            "jump": float(np.mean(readings[1:n + 1]) - readings[0])}


class _NoBath:
    @staticmethod
    def computeHeatBathEnergy() -> float:
        return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("nh_startup.py needs a CUDA device")
    device = torch.device("cuda", 0)
    cs.set_fp32_matmul_exact()
    cs.phase_device(device)
    cs.phase_build(cs.Deadline(cs.BUDGET_S))
    main_path = cs.phase_main_path(device)
    starts = [("equilibrated", cs._water_state(main_path))]
    cs.phase_step_program(device, main_path, cs.Deadline(cs.BUDGET_S))
    starts.append(("relaxing", cs._water_state(main_path)))
    for label, (system, state, dof) in starts:
        for dt in (0.001, 0.0005, 0.00025):
            integ = omm.NoseHooverIntegrator(cs.NH_TEMPERATURE,
                                             cs.NH_FREQUENCY, dt)
            print(json.dumps(dict(start=label, integrator="nose_hoover",
                                  **run(system, state, integ, dt, integ))),
                  flush=True)
        for dt in (0.001, 0.0005):
            print(json.dumps(dict(start=label, integrator="verlet", **run(
                system, state, omm.VerletIntegrator(dt), dt, _NoBath()))),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
