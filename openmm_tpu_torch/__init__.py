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
from symbolic derivatives (of NonbondedForce offsets too), RMSDForce,
GayBerneForce, the AMOEBA forces (vdW, multipoles with induced dipoles at
NoCutoff and PME, generalized Kirkwood, torsion-torsion, WCA dispersion)
and HippoNonbondedForce, DrudeForce under the Drude Langevin, SCF and
Nose-Hoover integrators, and ring-polymer MD (RPMDIntegrator, its
contraction and RPMDMonteCarloBarostat),
through three hand-written CUDA kernels (csrc/), and energy
minimization (LocalEnergyMinimizer) through the differentiable dense PME
and two more; Context.updateParametersInContext, createCheckpoint and
loadCheckpoint. Getters return what the JAX package's return:
Quantities (openmm_tpu_torch.unit) in nm, ps, amu, kJ/mol, e, rad, K and
bar, or plain values; setters take Quantities or plain numbers in those
units. The app layer (openmm_tpu_torch.app: PDBFile, PDBxFile,
ForceField, Modeller, the Amber, CHARMM, GROMACS and DMS readers,
Simulation, reporters, Metadynamics, SimulatedTempering) builds and
drives Systems as OpenMM's does; XmlSerializer writes and reads Systems,
forces, integrators and States in the JAX package's XML; `python -m
openmm_tpu_torch.testInstallation` checks an installation.
"""
from . import unit
from .constants import BOLTZ, ONE_4PI_EPS0
from .context import Context
from .exceptions import OpenMMException
from .forces import (AmoebaGeneralizedKirkwoodForce, AmoebaMultipoleForce,
                     AmoebaTorsionTorsionForce, AmoebaVdwForce,
                     AmoebaWcaDispersionForce, AndersenThermostat, CMAPTorsionForce, CMMotionRemover,
                     CustomAngleForce, CustomBondForce, CustomCVForce,
                     CustomCentroidBondForce, CustomCompoundBondForce,
                     CustomExternalForce, CustomGBForce, CustomHbondForce,
                     CustomManyParticleForce, CustomNonbondedForce,
                     CustomTorsionForce, DrudeForce, Force,
                     GayBerneForce, GBSAOBCForce,
                     HarmonicAngleForce, HarmonicBondForce,
                     HippoNonbondedForce, MonteCarloAnisotropicBarostat,
                     MonteCarloBarostat, MonteCarloMembraneBarostat,
                     NonbondedForce, PeriodicTorsionForce, RBTorsionForce,
                     RMSDForce, RPMDMonteCarloBarostat, RPMDUpdater)
from .integrators import (AMDForceGroupIntegrator, AMDIntegrator,
                          BrownianIntegrator, CompoundIntegrator,
                          CustomIntegrator, DrudeLangevinIntegrator,
                          DrudeNoseHooverIntegrator, DrudeSCFIntegrator,
                          DualAMDIntegrator,
                          LangevinIntegrator, LangevinMiddleIntegrator,
                          MTSIntegrator, MTSLangevinIntegrator,
                          NoseHooverChain, NoseHooverIntegrator,
                          RPMDIntegrator, VariableLangevinIntegrator,
                          VariableVerletIntegrator, VerletIntegrator)
from .minimize import LocalEnergyMinimizer, MinimizationReporter
from .platform import Platform
from .serialization import XmlSerializer
from .state import State
from .tabulated import (Continuous1DFunction, Continuous2DFunction,
                        Continuous3DFunction, Discrete1DFunction,
                        Discrete2DFunction, Discrete3DFunction,
                        TabulatedFunction)
from .system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                     ThreeParticleAverageSite, TwoParticleAverageSite,
                     VirtualSite, from_numpy, to_numpy)
from .vec3 import Vec3
from .version import version as __version__

__all__ = ["AMDForceGroupIntegrator", "AMDIntegrator",
           "AmoebaGeneralizedKirkwoodForce", "AmoebaMultipoleForce",
           "AmoebaTorsionTorsionForce", "AmoebaVdwForce",
           "AmoebaWcaDispersionForce", "HippoNonbondedForce",
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
           "Discrete3DFunction", "DrudeForce", "DrudeLangevinIntegrator",
           "DrudeNoseHooverIntegrator", "DrudeSCFIntegrator",
           "DualAMDIntegrator", "Force",
           "GBSAOBCForce", "HarmonicAngleForce", "HarmonicBondForce",
           "LangevinIntegrator", "LangevinMiddleIntegrator",
           "LocalCoordinatesSite", "LocalEnergyMinimizer", "MTSIntegrator", "MTSLangevinIntegrator",
           "MinimizationReporter", "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "NoseHooverChain", "NoseHooverIntegrator",
           "ONE_4PI_EPS0", "OpenMMException", "OutOfPlaneSite", "PeriodicTorsionForce",
           "Platform", "RBTorsionForce", "RPMDIntegrator",
           "RPMDMonteCarloBarostat", "RPMDUpdater", "State", "System",
           "TabulatedFunction", "ThreeParticleAverageSite", "TwoParticleAverageSite",
           "VariableLangevinIntegrator", "VariableVerletIntegrator",
           "Vec3", "VerletIntegrator", "VirtualSite", "XmlSerializer",
           "from_numpy",
           "to_numpy", "unit"]
