"""openmm_tpu_torch: the PyTorch/CUDA port of openmm_tpu for NVIDIA Hopper.

The JAX package openmm_tpu is the reference this package is tested
against; nothing here imports it or JAX. It runs explicit-solvent MD:
NonbondedForce (PME) with its exceptions, the bonded forces, a
CMMotionRemover and the Monte Carlo barostats (isotropic, anisotropic,
membrane), SETTLE, SHAKE and CCMA constraints, under LangevinMiddle,
through three hand-written CUDA kernels (csrc/), and energy minimization
(LocalEnergyMinimizer) through the differentiable dense PME and two more.
Numbers are plain floats in nm, ps, amu, kJ/mol and e.
"""
from .constants import BOLTZ, ONE_4PI_EPS0
from .context import Context
from .forces import (CMAPTorsionForce, CMMotionRemover, Force,
                     HarmonicAngleForce, HarmonicBondForce,
                     MonteCarloAnisotropicBarostat, MonteCarloBarostat,
                     MonteCarloMembraneBarostat, NonbondedForce,
                     PeriodicTorsionForce, RBTorsionForce)
from .integrators.langevin import LangevinMiddleIntegrator
from .minimize import LocalEnergyMinimizer, MinimizationReporter
from .platform import Platform
from .state import State
from .system import System, from_numpy, to_numpy

__all__ = ["BOLTZ", "CMAPTorsionForce", "CMMotionRemover", "Context", "Force",
           "HarmonicAngleForce", "HarmonicBondForce",
           "LangevinMiddleIntegrator", "LocalEnergyMinimizer",
           "MinimizationReporter", "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "ONE_4PI_EPS0",
           "PeriodicTorsionForce", "Platform", "RBTorsionForce", "State",
           "System", "from_numpy", "to_numpy"]
