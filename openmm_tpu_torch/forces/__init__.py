from .barostats import (MonteCarloAnisotropicBarostat, MonteCarloBarostat,
                        MonteCarloMembraneBarostat)
from .base import Force
from .bonded import (CMAPTorsionForce, HarmonicAngleForce, HarmonicBondForce,
                     PeriodicTorsionForce, RBTorsionForce)
from .cmmotion import CMMotionRemover
from .nonbonded import NonbondedForce, NonbondedModule

__all__ = ["CMAPTorsionForce", "CMMotionRemover", "Force",
           "HarmonicAngleForce", "HarmonicBondForce",
           "MonteCarloAnisotropicBarostat", "MonteCarloBarostat",
           "MonteCarloMembraneBarostat", "NonbondedForce",
           "NonbondedModule", "PeriodicTorsionForce", "RBTorsionForce"]
