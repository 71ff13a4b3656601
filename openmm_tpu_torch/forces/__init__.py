from .base import Force
from .bonded import (CMAPTorsionForce, HarmonicAngleForce, HarmonicBondForce,
                     PeriodicTorsionForce, RBTorsionForce)
from .cmmotion import CMMotionRemover
from .nonbonded import NonbondedForce, NonbondedModule

__all__ = ["CMAPTorsionForce", "CMMotionRemover", "Force",
           "HarmonicAngleForce", "HarmonicBondForce", "NonbondedForce",
           "NonbondedModule", "PeriodicTorsionForce", "RBTorsionForce"]
