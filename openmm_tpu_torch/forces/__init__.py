from .amoeba import (AMOEBA_FORCES, AmoebaGeneralizedKirkwoodForce,
                     AmoebaMultipoleForce, AmoebaTorsionTorsionForce,
                     AmoebaVdwForce, AmoebaWcaDispersionForce)
from .barostats import (MonteCarloAnisotropicBarostat, MonteCarloBarostat,
                        MonteCarloMembraneBarostat, RPMDMonteCarloBarostat,
                        RPMDUpdater)
from .base import Force
from .bonded import (CMAPTorsionForce, HarmonicAngleForce, HarmonicBondForce,
                     PeriodicTorsionForce, RBTorsionForce)
from .cmmotion import CMMotionRemover
from .custom import (CUSTOM_FORCES, CustomAngleForce, CustomBondForce,
                     CustomCentroidBondForce, CustomCompoundBondForce,
                     CustomExternalForce, CustomNonbondedForce,
                     CustomTorsionForce)
from .customcv import CustomCVForce
from .drude import DrudeForce
from .customgb import CustomGBForce
from .customhbond import CustomHbondForce
from .custommanyparticle import CustomManyParticleForce
from .gayberne import GayBerneForce
from .gbsa import GBSAOBCForce
from .hippo import HippoNonbondedForce
from .nonbonded import NonbondedForce, NonbondedModule
from .rmsd import RMSDForce
from .thermostats import AndersenThermostat
from ..tabulated import (Continuous1DFunction, Continuous2DFunction,
                         Continuous3DFunction, Discrete1DFunction,
                         Discrete2DFunction, Discrete3DFunction,
                         TabulatedFunction)

# the forces a Context compiles with _compile(context) into a module of
# forces/custom.py's CustomModule contract (ef, energy,
# parameter_derivatives, update)
MODULE_FORCES = (CUSTOM_FORCES + (CustomGBForce, CustomCVForce, RMSDForce,
                                  CustomHbondForce, CustomManyParticleForce,
                                  GayBerneForce) + AMOEBA_FORCES
                 + (HippoNonbondedForce,))

__all__ = ["AmoebaGeneralizedKirkwoodForce", "AmoebaMultipoleForce",
           "AmoebaTorsionTorsionForce", "AmoebaVdwForce",
           "AmoebaWcaDispersionForce", "AndersenThermostat", "CMAPTorsionForce", "CMMotionRemover",
           "Continuous1DFunction", "Continuous2DFunction",
           "Continuous3DFunction", "Discrete1DFunction", "Discrete2DFunction",
           "Discrete3DFunction", "TabulatedFunction",
           "CustomAngleForce", "CustomBondForce", "CustomCVForce",
           "CustomCentroidBondForce", "CustomCompoundBondForce",
           "CustomExternalForce", "CustomGBForce", "CustomHbondForce",
           "CustomManyParticleForce", "CustomNonbondedForce",
           "CustomTorsionForce", "DrudeForce", "Force", "GBSAOBCForce", "GayBerneForce",
           "HippoNonbondedForce",
           "MODULE_FORCES", "RMSDForce", "HarmonicAngleForce", "HarmonicBondForce",
           "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "NonbondedModule", "PeriodicTorsionForce",
           "RBTorsionForce", "RPMDMonteCarloBarostat", "RPMDUpdater"]
