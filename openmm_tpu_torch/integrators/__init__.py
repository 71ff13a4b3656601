from .amd import AMDForceGroupIntegrator, AMDIntegrator, DualAMDIntegrator
from .base import Integrator, StepDeps
from .compound import CompoundIntegrator
from .custom import CustomIntegrator
from .drude import (DrudeLangevinIntegrator, DrudeNoseHooverIntegrator,
                    DrudeSCFIntegrator)
from .langevin import (BrownianIntegrator, LangevinIntegrator,
                       LangevinMiddleIntegrator)
from .mts import MTSIntegrator, MTSLangevinIntegrator
from .nose_hoover import NoseHooverChain, NoseHooverIntegrator
from .rpmd import RPMDIntegrator
from .variable import VariableLangevinIntegrator, VariableVerletIntegrator
from .verlet import VerletIntegrator

__all__ = ["AMDForceGroupIntegrator", "AMDIntegrator", "BrownianIntegrator",
           "CompoundIntegrator", "CustomIntegrator", "DrudeLangevinIntegrator",
           "DrudeNoseHooverIntegrator", "DrudeSCFIntegrator",
           "DualAMDIntegrator",
           "Integrator", "LangevinIntegrator", "LangevinMiddleIntegrator",
           "MTSIntegrator", "MTSLangevinIntegrator", "NoseHooverChain",
           "NoseHooverIntegrator", "RPMDIntegrator", "StepDeps", "VariableLangevinIntegrator",
           "VariableVerletIntegrator", "VerletIntegrator"]
