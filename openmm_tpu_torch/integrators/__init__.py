from .amd import AMDForceGroupIntegrator, AMDIntegrator, DualAMDIntegrator
from .base import Integrator, StepDeps
from .compound import CompoundIntegrator
from .custom import CustomIntegrator
from .langevin import (BrownianIntegrator, LangevinIntegrator,
                       LangevinMiddleIntegrator)
from .mts import MTSIntegrator, MTSLangevinIntegrator
from .nose_hoover import NoseHooverChain, NoseHooverIntegrator
from .variable import VariableLangevinIntegrator, VariableVerletIntegrator
from .verlet import VerletIntegrator

__all__ = ["AMDForceGroupIntegrator", "AMDIntegrator", "BrownianIntegrator",
           "CompoundIntegrator", "CustomIntegrator", "DualAMDIntegrator",
           "Integrator", "LangevinIntegrator", "LangevinMiddleIntegrator",
           "MTSIntegrator", "MTSLangevinIntegrator", "NoseHooverChain",
           "NoseHooverIntegrator", "StepDeps", "VariableLangevinIntegrator",
           "VariableVerletIntegrator", "VerletIntegrator"]
