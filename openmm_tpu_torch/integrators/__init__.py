from .base import Integrator, StepDeps
from .langevin import (BrownianIntegrator, LangevinIntegrator,
                       LangevinMiddleIntegrator)
from .verlet import VerletIntegrator

__all__ = ["BrownianIntegrator", "Integrator", "LangevinIntegrator",
           "LangevinMiddleIntegrator", "StepDeps", "VerletIntegrator"]
