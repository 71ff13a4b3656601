"""openmm_tpu_torch: the PyTorch/CUDA port of openmm_tpu for NVIDIA Hopper.

The JAX package openmm_tpu is the reference this package is tested
against; nothing here imports it or JAX. This slice runs the PME water-box
path: NonbondedForce (PME) with SETTLE water under LangevinMiddle, through
three hand-written CUDA kernels (csrc/). Numbers are plain floats in nm,
ps, amu, kJ/mol and e.
"""
from .constants import BOLTZ, ONE_4PI_EPS0
from .context import Context
from .forces.nonbonded import NonbondedForce
from .integrators.langevin import LangevinMiddleIntegrator
from .platform import Platform
from .state import State
from .system import System, from_numpy, to_numpy

__all__ = ["BOLTZ", "Context", "LangevinMiddleIntegrator", "NonbondedForce",
           "ONE_4PI_EPS0", "Platform", "State", "System", "from_numpy",
           "to_numpy"]
