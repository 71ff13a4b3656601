from .barostats import (MonteCarloAnisotropicBarostat, MonteCarloBarostat,
                        MonteCarloMembraneBarostat)
from .base import Force
from .bonded import (CMAPTorsionForce, HarmonicAngleForce, HarmonicBondForce,
                     PeriodicTorsionForce, RBTorsionForce)
from .cmmotion import CMMotionRemover
from .custom import (CustomAngleForce, CustomBondForce,
                     CustomCentroidBondForce, CustomCompoundBondForce,
                     CustomExternalForce, CustomNonbondedForce,
                     CustomTorsionForce)
from .gbsa import GBSAOBCForce
from .nonbonded import NonbondedForce, NonbondedModule
from .thermostats import AndersenThermostat

__all__ = ["AndersenThermostat", "CMAPTorsionForce", "CMMotionRemover",
           "CustomAngleForce", "CustomBondForce", "CustomCentroidBondForce",
           "CustomCompoundBondForce", "CustomExternalForce",
           "CustomNonbondedForce", "CustomTorsionForce", "Force",
           "GBSAOBCForce", "HarmonicAngleForce", "HarmonicBondForce",
           "MonteCarloAnisotropicBarostat",
           "MonteCarloBarostat", "MonteCarloMembraneBarostat",
           "NonbondedForce", "NonbondedModule", "PeriodicTorsionForce",
           "RBTorsionForce"]
