from .nonbonded import NonbondedForce, NonbondedModule

__all__ = ["NonbondedForce", "NonbondedModule"]
