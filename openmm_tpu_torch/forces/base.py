"""Force: the base class of every force of a System.

Counterpart of openmm_tpu/forces/base.py (Force). A force belongs to a
force group, 0 to 31; getState(groups=...) sums the energies and forces of
the groups it names. A force names the particle pairs it binds into one
molecule (_bonded_particles) and the global parameters it defines with
their defaults (_global_defaults, the JAX CompiledForce.global_defaults).
"""
from __future__ import annotations


class Force:
    def __init__(self):
        self._force_group = 0
        self._name = type(self).__name__

    def getForceGroup(self) -> int:
        return self._force_group

    def setForceGroup(self, group: int) -> None:
        if not 0 <= int(group) <= 31:
            raise ValueError("Force group must be between 0 and 31")
        self._force_group = int(group)

    def getName(self) -> str:
        return self._name

    def setName(self, name: str) -> None:
        self._name = str(name)

    def _bonded_particles(self):
        """Pairs that bind particles into one molecule (the Context's
        molecule detection, ContextImpl.cpp:345-429)."""
        return ()

    def _global_defaults(self) -> dict:
        """{name: default value} of the global parameters this force
        defines; the Context keeps them as device scalars."""
        return {}
