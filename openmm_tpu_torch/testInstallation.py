"""Check the installation: build a water box, compute its forces on every
platform, and report the median relative difference of each from the
float64 path (Platform "CPU" with Precision "double"), the ground truth.

The port's copy of openmm_tpu/testInstallation.py (after OpenMM's
wrappers/python/openmm/testInstallation.py). The JAX package takes its
"Reference" platform as the ground truth; the port's counterpart is the
float64 path. A platform that cannot run here (CUDA without a card)
reports its error and the others go on.

Run:  python -m openmm_tpu_torch.testInstallation
"""
from __future__ import annotations

import sys

import numpy as np

TOLERANCE = 1e-4    # median relative force difference that passes


def _forces(system, positions, platform, properties=None):
    from . import Context, VerletIntegrator
    ctx = Context(system, VerletIntegrator(0.001), platform, properties)
    ctx.setPositions(positions)
    return ctx.getState(getForces=True).getForces(asNumpy=True)._value


def main() -> int:
    from . import Platform
    from .models import tip3p_water_box

    print("openmm-tpu-torch version:", Platform.getOpenMMVersion())
    system, positions = tip3p_water_box(n_waters=125)
    platforms = [Platform.getPlatform(i)
                 for i in range(Platform.getNumPlatforms())]
    print("There are %d Platforms available:\n" % len(platforms))
    forces = {}
    for k, platform in enumerate(platforms):
        name = platform.getName()
        try:
            forces[name] = _forces(system, positions, platform)
            print("%d %s - Successfully computed forces" % (k + 1, name))
        except Exception as exc:  # noqa: BLE001 - report every platform
            print("%d %s - Error computing forces: %s" % (k + 1, name, exc))
    ref = _forces(system, positions, Platform.getPlatformByName("CPU"),
                  {"Precision": "double"})
    ref_norm = np.sqrt(np.sum(ref * ref, axis=1))
    print()
    worst = 0.0
    for name, f in forces.items():
        diff = np.sqrt(np.sum((f - ref) ** 2, axis=1))
        rel = float(np.median(diff / np.maximum(ref_norm, 1e-10)))
        worst = max(worst, rel)
        print("Median difference in forces between the float64 path and "
              "%s: %g" % (name, rel))
    if worst <= TOLERANCE:
        print("\nAll differences are within tolerance.")
        return 0
    print("\nA difference exceeds the tolerance of %g." % TOLERANCE)
    return 1


if __name__ == "__main__":
    sys.exit(main())
