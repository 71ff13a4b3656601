from .base import Integrator, StepDeps
from .langevin import LangevinMiddleIntegrator

__all__ = ["Integrator", "LangevinMiddleIntegrator", "StepDeps"]
