"""openmm_tpu_torch: the PyTorch/CUDA port of openmm_tpu for NVIDIA Hopper.

The JAX package openmm_tpu is the reference this package is tested
against; nothing here imports it or JAX. It runs MD: NonbondedForce
(PME and the other methods but LJPME) with its exceptions, implicit
solvent (GBSAOBCForce), the bonded forces, a CMMotionRemover, the Monte
Carlo barostats (isotropic, anisotropic, membrane) and the Andersen
thermostat, SETTLE, SHAKE and CCMA constraints and fixed (massless)
particles, under LangevinMiddle, leapfrog Langevin, Verlet or Brownian
dynamics, through three hand-written CUDA kernels (csrc/), and energy
minimization (LocalEnergyMinimizer) through the differentiable dense PME
and two more. Numbers are plain floats in nm, ps, amu, kJ/mol and e.
"""
from .constants import BOLTZ, ONE_4PI_EPS0
from .context import Context
from .forces import (AndersenThermostat, CMAPTorsionForce, CMMotionRemover,
                     Force, GBSAOBCForce, HarmonicAngleForce,
                     HarmonicBondForce, MonteCarloAnisotropicBarostat,
                     MonteCarloBarostat, MonteCarloMembraneBarostat,
                     NonbondedForce, PeriodicTorsionForce, RBTorsionForce)
from .integrators import (BrownianIntegrator, LangevinIntegrator,
                          LangevinMiddleIntegrator, VerletIntegrator)
from .minimize import LocalEnergyMinimizer, MinimizationReporter
from .platform import Platform
from .state import State
from .system import System, from_numpy, to_numpy

__all__ = ["AndersenThermostat", "BOLTZ", "BrownianIntegrator",
           "CMAPTorsionForce", "CMMotionRemover", "Context", "Force",
           "GBSAOBCForce", "HarmonicAngleForce", "HarmonicBondForce",
           "LangevinIntegrator", "LangevinMiddleIntegrator",
           "LocalEnergyMinimizer",
           "MinimizationReporter", "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "ONE_4PI_EPS0",
           "PeriodicTorsionForce", "Platform", "RBTorsionForce", "State",
           "System", "VerletIntegrator", "from_numpy", "to_numpy"]
