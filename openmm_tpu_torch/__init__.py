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
the custom forces (External, Bond, Angle, Torsion, Nonbonded, CompoundBond,
CentroidBond, GB with the Amber GB recipes of app.gbforces, CV, Hbond,
ManyParticle) with tabulated functions and energy parameter derivatives
from symbolic derivatives (of NonbondedForce offsets too), RMSDForce and
GayBerneForce,
through three hand-written CUDA kernels (csrc/), and energy
minimization (LocalEnergyMinimizer) through the differentiable dense PME
and two more; Context.updateParametersInContext, createCheckpoint and
loadCheckpoint. Getters return plain floats and numpy arrays in nm, ps,
amu, kJ/mol and e; setters also take Quantities (openmm_tpu_torch.unit),
which they strip to those units. The app layer (openmm_tpu_torch.app:
PDBFile, ForceField, Simulation, reporters) builds and drives Systems as
OpenMM's does.
"""
from . import unit
from .constants import BOLTZ, ONE_4PI_EPS0
from .context import Context
from .forces import (AndersenThermostat, CMAPTorsionForce, CMMotionRemover,
                     CustomAngleForce, CustomBondForce, CustomCVForce,
                     CustomCentroidBondForce, CustomCompoundBondForce,
                     CustomExternalForce, CustomGBForce, CustomHbondForce,
                     CustomManyParticleForce, CustomNonbondedForce,
                     CustomTorsionForce, Force, GayBerneForce, GBSAOBCForce,
                     HarmonicAngleForce, HarmonicBondForce,
                     MonteCarloAnisotropicBarostat,
                     MonteCarloBarostat, MonteCarloMembraneBarostat,
                     NonbondedForce, PeriodicTorsionForce, RBTorsionForce,
                     RMSDForce)
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
from .tabulated import (Continuous1DFunction, Continuous2DFunction,
                        Continuous3DFunction, Discrete1DFunction,
                        Discrete2DFunction, Discrete3DFunction)
from .system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                     ThreeParticleAverageSite, TwoParticleAverageSite,
                     VirtualSite, from_numpy, to_numpy)
from .vec3 import Vec3

__all__ = ["AMDForceGroupIntegrator", "AMDIntegrator",
           "AndersenThermostat", "BOLTZ", "BrownianIntegrator",
           "CMAPTorsionForce", "CMMotionRemover", "CompoundIntegrator",
           "Context", "Continuous1DFunction", "Continuous2DFunction",
           "Continuous3DFunction", "CustomAngleForce", "CustomBondForce",
           "CustomCVForce", "CustomCentroidBondForce",
           "CustomCompoundBondForce", "CustomExternalForce",
           "CustomGBForce", "CustomHbondForce", "CustomIntegrator",
           "CustomManyParticleForce", "CustomNonbondedForce",
           "CustomTorsionForce", "GayBerneForce", "RMSDForce",
           "Discrete1DFunction", "Discrete2DFunction",
           "Discrete3DFunction", "DualAMDIntegrator", "Force",
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
           "Vec3", "VerletIntegrator", "VirtualSite", "from_numpy",
           "to_numpy", "unit"]
