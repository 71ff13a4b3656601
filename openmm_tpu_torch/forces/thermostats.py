"""AndersenThermostat: velocities redrawn from the heat bath.

Counterpart of openmm_tpu/forces/thermostats.py (after
AndersenThermostatImpl and andersenThermostat.cc): an update hook that
the integrator runs at the top of every step. Each cluster of particles
joined by constraints (a lone particle is a cluster of its own) collides
with probability 1 - exp(-nu dt), and each of its particles with mass
takes a fresh Maxwell-Boltzmann velocity at the temperature T; massless
particles never collide. nu and T are the Context's global parameters
AndersenCollisionFrequency and AndersenTemperature, dt the integrator's
step size, all device scalars. The hook draws n x 3 normals and n
uniforms from the Context's generator on every step (a cluster reads
the uniform of its first particle): a fixed count, so a captured step
graph keeps its draws in step.

The JAX package collides particle by particle. Under constraints that
thermostats to a lower temperature: a particle's fresh velocity, mixed
with its cluster's old ones and projected onto the constraints, brings
less than its share of heat; for rigid TIP3P water the stationary
temperature is 0.886 T (the projection's traces, sum_a tr(P E_a) /
sum_a (2 tr(P E_a) - tr(P E_a P E_a)) over the atoms a;
tests/test_torch_integrators.py computes it). Collisions
by cluster, as OpenMM makes them, keep T. Without constraints the two
are the same.
"""
from __future__ import annotations

import torch

from .. import unit as u
from ..constants import BOLTZ
from .base import Force

_K = u.kelvin
_PER_PS = u.picosecond ** -1


class AndersenThermostat(Force):
    @staticmethod
    def Temperature() -> str:
        return "AndersenTemperature"

    @staticmethod
    def CollisionFrequency() -> str:
        return "AndersenCollisionFrequency"

    def __init__(self, defaultTemperature, defaultCollisionFrequency):
        super().__init__()
        self._temperature = float(u.strip(defaultTemperature, _K))
        self._frequency = float(u.strip(defaultCollisionFrequency, _PER_PS))
        self._seed = 0

    def getDefaultTemperature(self):
        return u.Quantity(self._temperature, _K)

    def setDefaultTemperature(self, temperature) -> None:
        self._temperature = float(u.strip(temperature, _K))

    def getDefaultCollisionFrequency(self):
        return u.Quantity(self._frequency, _PER_PS)

    def setDefaultCollisionFrequency(self, frequency) -> None:
        self._frequency = float(u.strip(frequency, _PER_PS))

    def getRandomNumberSeed(self) -> int:
        return self._seed

    def setRandomNumberSeed(self, seed) -> None:
        self._seed = int(seed)

    def _global_defaults(self) -> dict:
        return {self.Temperature(): self._temperature,
                self.CollisionFrequency(): self._frequency}

    def _make_hook(self, inv_masses, cluster, generator, params, gp,
                   gp_index):
        """hook(step, pos, vel, box) -> (pos, vel): inv_masses (n,) float64
        (0 for a massless particle), cluster (n,) int64 the first particle
        of each particle's constraint cluster, params the integrator's
        device parameters (the step size first), gp the global parameters
        and gp_index their positions."""
        temperature = gp_index[self.Temperature()]
        frequency = gp_index[self.CollisionFrequency()]
        moving = (inv_masses != 0)[:, None]

        def hook(step, pos, vel, box):
            xi = torch.randn(vel.shape, generator=generator,
                             dtype=vel.dtype, device=vel.device)
            u = torch.rand(vel.shape[0], generator=generator,
                           dtype=vel.dtype, device=vel.device)
            p_collide = 1.0 - torch.exp(-gp[frequency] * params[0])
            sigma = torch.sqrt(BOLTZ * gp[temperature] * inv_masses)[:, None]
            collide = (u[cluster] < p_collide)[:, None] & moving
            return pos, torch.where(collide, sigma * xi, vel)

        return hook
