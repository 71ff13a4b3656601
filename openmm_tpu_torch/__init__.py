"""openmm_tpu_torch: the PyTorch/CUDA port of openmm_tpu for NVIDIA Hopper.

The JAX package openmm_tpu is the reference this package is tested
against; nothing here imports it or JAX. It runs MD: NonbondedForce
(every method, LJPME included, with its exceptions, global parameters,
parameter offsets and a reciprocal space in a force group of its own),
virtual sites (the four types), implicit
solvent (GBSAOBCForce), the bonded forces, a CMMotionRemover, the Monte
Carlo barostats (isotropic, anisotropic, membrane) and the Andersen
thermostat, SETTLE, SHAKE and CCMA constraints and fixed (massless)
particles, under LangevinMiddle, leapfrog Langevin, Verlet, Brownian,
Nose-Hoover, variable-step, multiple-time-step (MTS) or accelerated (aMD)
dynamics, a CustomIntegrator program or a CompoundIntegrator of these,
through three hand-written CUDA kernels (csrc/), and energy
minimization (LocalEnergyMinimizer) through the differentiable dense PME
and two more; Context.updateParametersInContext, createCheckpoint and
loadCheckpoint. Numbers are plain floats in nm, ps, amu, kJ/mol and e.
"""
from .constants import BOLTZ, ONE_4PI_EPS0
from .context import Context
from .forces import (AndersenThermostat, CMAPTorsionForce, CMMotionRemover,
                     Force, GBSAOBCForce, HarmonicAngleForce,
                     HarmonicBondForce, MonteCarloAnisotropicBarostat,
                     MonteCarloBarostat, MonteCarloMembraneBarostat,
                     NonbondedForce, PeriodicTorsionForce, RBTorsionForce)
from .integrators import (AMDForceGroupIntegrator, AMDIntegrator,
                          BrownianIntegrator, CompoundIntegrator,
                          CustomIntegrator, DualAMDIntegrator,
                          LangevinIntegrator, LangevinMiddleIntegrator,
                          MTSIntegrator, MTSLangevinIntegrator,
                          NoseHooverChain, NoseHooverIntegrator,
                          VariableLangevinIntegrator,
                          VariableVerletIntegrator, VerletIntegrator)
from .minimize import LocalEnergyMinimizer, MinimizationReporter
from .platform import Platform
from .state import State
from .system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                     ThreeParticleAverageSite, TwoParticleAverageSite,
                     VirtualSite, from_numpy, to_numpy)

__all__ = ["AMDForceGroupIntegrator", "AMDIntegrator",
           "AndersenThermostat", "BOLTZ", "BrownianIntegrator",
           "CMAPTorsionForce", "CMMotionRemover", "CompoundIntegrator",
           "Context", "CustomIntegrator", "DualAMDIntegrator", "Force",
           "GBSAOBCForce", "HarmonicAngleForce", "HarmonicBondForce",
           "LangevinIntegrator", "LangevinMiddleIntegrator",
           "LocalCoordinatesSite", "LocalEnergyMinimizer", "MTSIntegrator", "MTSLangevinIntegrator",
           "MinimizationReporter", "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "NoseHooverChain", "NoseHooverIntegrator",
           "ONE_4PI_EPS0", "OutOfPlaneSite", "PeriodicTorsionForce",
           "Platform", "RBTorsionForce", "State", "System",
           "ThreeParticleAverageSite", "TwoParticleAverageSite",
           "VariableLangevinIntegrator", "VariableVerletIntegrator",
           "VerletIntegrator", "VirtualSite", "from_numpy", "to_numpy"]
