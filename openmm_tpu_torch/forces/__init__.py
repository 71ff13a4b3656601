from .barostats import (MonteCarloAnisotropicBarostat, MonteCarloBarostat,
                        MonteCarloMembraneBarostat)
from .base import Force
from .bonded import (CMAPTorsionForce, HarmonicAngleForce, HarmonicBondForce,
                     PeriodicTorsionForce, RBTorsionForce)
from .cmmotion import CMMotionRemover
from .custom import (CUSTOM_FORCES, CustomAngleForce, CustomBondForce,
                     CustomCentroidBondForce, CustomCompoundBondForce,
                     CustomExternalForce, CustomNonbondedForce,
                     CustomTorsionForce)
from .customcv import CustomCVForce
from .customgb import CustomGBForce
from .customhbond import CustomHbondForce
from .custommanyparticle import CustomManyParticleForce
from .gayberne import GayBerneForce
from .gbsa import GBSAOBCForce
from .nonbonded import NonbondedForce, NonbondedModule
from .rmsd import RMSDForce
from .thermostats import AndersenThermostat

# the forces a Context compiles with _compile(context) into a module of
# forces/custom.py's CustomModule contract (ef, energy,
# parameter_derivatives, update)
MODULE_FORCES = (CUSTOM_FORCES + (CustomGBForce, CustomCVForce, RMSDForce,
                                  CustomHbondForce, CustomManyParticleForce,
                                  GayBerneForce))

__all__ = ["AndersenThermostat", "CMAPTorsionForce", "CMMotionRemover",
           "CustomAngleForce", "CustomBondForce", "CustomCVForce",
           "CustomCentroidBondForce", "CustomCompoundBondForce",
           "CustomExternalForce", "CustomGBForce", "CustomHbondForce",
           "CustomManyParticleForce", "CustomNonbondedForce",
           "CustomTorsionForce", "Force", "GBSAOBCForce", "GayBerneForce",
           "MODULE_FORCES", "RMSDForce", "HarmonicAngleForce", "HarmonicBondForce",
           "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "NonbondedModule", "PeriodicTorsionForce",
           "RBTorsionForce"]
