"""CMMotionRemover: zero the centre-of-mass velocity every `frequency`
steps.

Counterpart of openmm_tpu/forces/cmmotion.py (after removeCM.cc): an
update hook that the integrator runs at the top of every step, before the
force kick. The gate is branchless, as in the JAX package: the hook
always computes the centre-of-mass velocity and subtracts it times
(step % frequency == 0), where `step` is the Context's device step
counter (the steps completed before this one). So it reads nothing on the
host and a captured step graph fires it on the right replays.
"""
from __future__ import annotations

import torch

from .base import Force


class CMMotionRemover(Force):
    def __init__(self, frequency: int = 1):
        super().__init__()
        self._frequency = int(frequency)

    def getFrequency(self) -> int:
        return self._frequency

    def setFrequency(self, frequency: int) -> None:
        self._frequency = int(frequency)

    def _make_hook(self, masses: torch.Tensor):
        """hook(step, pos, vel) -> vel for float64 (n,) masses on the
        Context's device; atoms without mass keep their velocities."""
        freq = self._frequency
        total = masses.sum()
        moving = (masses != 0).to(masses.dtype)

        def hook(step, pos, vel):
            v_cm = (masses[:, None] * vel).sum(dim=0) / total
            fires = (torch.remainder(step, freq) == 0).to(vel.dtype)
            return vel - (fires * moving)[:, None] * v_cm[None, :]

        return hook
