"""The Drude integrators: dual-thermostat dynamics of polarizable systems.

Counterpart of openmm_tpu/integrators/drude.py (the drude plugin's
Drude{Langevin,SCF,NoseHoover}Integrator.h):

- DrudeLangevinIntegrator (after drudeLangevin.cc): the update hooks,
  then each particle outside a Drude pair by the leapfrog Langevin update
  v' = vscale v + fscale f / m + noisescale xi / sqrt(m) at T, and each
  (Drude, parent) pair in its centre of mass at T and in its relative
  coordinate at T_drude with its reduced mass and its own friction; a
  drift by v' dt, the position constraints, and the velocities corrected
  by the constraint correction alone (the round-5 drift fix).
- DrudeSCFIntegrator: Verlet (a kick by dt f / m, a drift, the position
  constraints and the correction), then a fixed SCF_ITERATIONS of x_d +=
  f_d / k on every Drude particle, k = k_e q^2 / alpha, each iteration a
  full force evaluation of the integration groups inside the step (so
  13 a step, each behind the candidate state's rebuild gate).
- DrudeNoseHooverIntegrator: a kick, the velocity constraints, half a
  drift, two Nose-Hoover chains (nose_hoover.propagate_chain: one over the
  particles outside the pairs and the pairs' centres of mass at T with 3
  (moving particles - pairs) degrees of freedom, one over the pairs'
  relative motion at T_drude with 3 a pair), half a drift, the position
  constraints and the correction.

Two behaviours of the JAX package are kept: maxDrudeDistance is stored
and never applied, and the SCF ignores its minimization tolerance (the
iteration count is fixed). The virtual sites are computed after the SCF's
Verlet drift, before its iterations (the JAX step iterates with the sites
where they were before the drift). Each pair's new velocities are put
back by one gather through a permutation built on the host (no scatter
on the step); the random numbers come from the Context's generator (after
the hooks' draws), so they do not reproduce the JAX package's stream.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import unit as u
from ..constants import BOLTZ, ONE_4PI_EPS0
from .base import Integrator, StepDeps
from .nose_hoover import propagate_chain

_K = u.kelvin
_PER_PS = u.picosecond ** -1
SCF_ITERATIONS = 12


def _drude_force(system):
    from ..forces.drude import DrudeForce
    for force in system.getForces():
        if isinstance(force, DrudeForce):
            return force
    raise ValueError("The System does not contain a DrudeForce")


class _DrudeBase(Integrator):
    _max_drude_distance = 0.0

    def getTemperature(self):
        return u.Quantity(self._temperature, _K)

    def setTemperature(self, temperature) -> None:
        self._temperature = float(u.strip(temperature, _K))

    def getDrudeTemperature(self):
        return u.Quantity(self._drude_temperature, _K)

    def setDrudeTemperature(self, temperature) -> None:
        self._drude_temperature = float(u.strip(temperature, _K))

    def getMaxDrudeDistance(self):
        return u.Quantity(self._max_drude_distance, u.nanometer)

    def setMaxDrudeDistance(self, distance) -> None:
        """Stored and never applied, as in the JAX package."""
        self._max_drude_distance = float(u.strip(distance, u.nanometer))

    def _kinetic_energy_shift(self) -> float:
        return 0.0

    def _pairs(self, deps):
        """((drude, parent) pairs (p, 2) int64 on the device; the
        permutation sel (n,) that gathers the full velocities from the
        rows [all particles; the pairs' Drudes; their parents])."""
        pairs = np.asarray(_drude_force(self._context._system)
                           ._drude_pairs(), np.int64).reshape(-1, 2)
        n = deps.inv_masses.shape[0]
        sel = np.arange(n, dtype=np.int64)
        sel[pairs[:, 0]] = n + np.arange(len(pairs))
        sel[pairs[:, 1]] = n + len(pairs) + np.arange(len(pairs))
        dev = deps.inv_masses.device
        return (torch.as_tensor(pairs, device=dev),
                torch.as_tensor(sel, device=dev))


def _friction_scales(dt, gamma, kT):
    """(vscale, fscale, noisescale) of a leapfrog Langevin update: fscale
    is dt in the limit gamma -> 0."""
    vscale = torch.exp(-dt * gamma)
    free = gamma == 0
    fscale = torch.where(free, dt, (1.0 - vscale)
                         / torch.where(free, 1.0, gamma))
    return vscale, fscale, torch.sqrt(kT * (1.0 - vscale * vscale))


class DrudeLangevinIntegrator(_DrudeBase):
    def __init__(self, temperature, frictionCoeff, drudeTemperature,
                 drudeFrictionCoeff, stepSize):
        super().__init__(stepSize)
        self._temperature = float(u.strip(temperature, _K))
        self._friction = float(u.strip(frictionCoeff, _PER_PS))
        self._drude_temperature = float(u.strip(drudeTemperature, _K))
        self._drude_friction = float(u.strip(drudeFrictionCoeff, _PER_PS))

    def getFriction(self):
        return u.Quantity(self._friction, _PER_PS)

    def setFriction(self, friction) -> None:
        self._friction = float(u.strip(friction, _PER_PS))

    def getDrudeFriction(self):
        return u.Quantity(self._drude_friction, _PER_PS)

    def setDrudeFriction(self, friction) -> None:
        self._drude_friction = float(u.strip(friction, _PER_PS))

    def _params(self) -> tuple:
        return (self._step_size, self._temperature, self._friction,
                self._drude_temperature, self._drude_friction)

    def _param_names(self) -> tuple:
        return ("dt", "temperature", "friction", "drudeTemperature",
                "drudeFriction")

    def _make_step_fn(self, deps: StepDeps):
        pairs, sel = self._pairs(deps)
        inv_m = deps.inv_masses
        masses = self._context._masses
        moving = deps.moving
        i1, i2 = pairs[:, 0], pairs[:, 1]
        m1, m2 = masses[i1, None], masses[i2, None]
        inv_total = 1.0 / (m1 + m2)
        inv_red = (m1 + m2) * inv_m[i1, None] * inv_m[i2, None]
        m1f, m2f = m1 * inv_total, m2 * inv_total
        sqrt_inv_m = torch.sqrt(inv_m)[:, None]
        dt, temperature, friction, drude_t, drude_friction = \
            deps.params.unbind()

        def step(pos, vel, box):
            vscale, fscale, noisescale = _friction_scales(
                dt, friction, BOLTZ * temperature)
            vscale_d, fscale_d, noisescale_d = _friction_scales(
                dt, drude_friction, BOLTZ * drude_t)
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            _, forces = deps.force_fn(pos, box)
            forces = forces.to(vel.dtype)
            gen = deps.generator
            xi = torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                             device=pos.device)
            r1 = torch.randn((i1.shape[0], 3), generator=gen,
                             dtype=pos.dtype, device=pos.device)
            r2 = torch.randn((i1.shape[0], 3), generator=gen,
                             dtype=pos.dtype, device=pos.device)
            v_norm = (vscale * vel + fscale * forces * inv_m[:, None]
                      + noisescale * sqrt_inv_m * xi)
            f1, f2 = forces[i1], forces[i2]
            v1, v2 = vel[i1], vel[i2]
            cm_vel = v1 * m1f + v2 * m2f
            rel_vel = v2 - v1
            cm_vel = (vscale * cm_vel + fscale * inv_total * (f1 + f2)
                      + noisescale * torch.sqrt(inv_total) * r1)
            rel_vel = (vscale_d * rel_vel
                       + fscale_d * inv_red * (f2 * m1f - f1 * m2f)
                       + noisescale_d * torch.sqrt(inv_red) * r2)
            v = torch.cat([v_norm, cm_vel - rel_vel * m2f,
                           cm_vel + rel_vel * m1f])[sel]
            v = torch.where(moving, v, vel)
            new_raw = pos + torch.where(moving, v * dt, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            if corr is not None:
                v = torch.where(moving, v + corr / dt, vel)
            new_pos = deps.compute_vsites(new_pos)
            deps.step.add_(1)
            return new_pos, v

        return step


class DrudeSCFIntegrator(_DrudeBase):
    """Verlet on the atoms, the Drude particles moved to their field's
    minimum by SCF_ITERATIONS fixed steps x_d += f_d / k each step."""

    def __init__(self, stepSize):
        super().__init__(stepSize)
        self._temperature = 1.0
        self._drude_temperature = 1.0
        self._minimization_tolerance = 1.0

    def getMinimizationErrorTolerance(self):
        return u.Quantity(self._minimization_tolerance,
                          u.kilojoule_per_mole / u.nanometer)

    def setMinimizationErrorTolerance(self, tol) -> None:
        """Stored and never applied: the iteration count is fixed, as in
        the JAX package."""
        self._minimization_tolerance = float(
            u.strip(tol, u.kilojoule_per_mole / u.nanometer))

    def _make_step_fn(self, deps: StepDeps):
        pairs, _ = self._pairs(deps)
        drude = pairs[:, 0]
        ks = [ONE_4PI_EPS0 * p[5] * p[5] / p[6]
              for p in _drude_force(self._context._system)._particles]
        inv_k = torch.as_tensor(1.0 / np.asarray(ks, np.float64).reshape(-1),
                                device=drude.device)[:, None]
        inv_m = deps.inv_masses[:, None]
        moving = deps.moving
        dt = deps.params[0]

        def step(pos, vel, box):
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            _, forces = deps.force_fn(pos, box)
            v = torch.where(moving, vel + dt * forces.to(vel.dtype) * inv_m,
                            vel)
            new_raw = pos + torch.where(moving, v * dt, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            if corr is not None:
                v = torch.where(moving, v + corr / dt, vel)
            new_pos = deps.compute_vsites(new_pos)
            for _ in range(SCF_ITERATIONS):
                _, f = deps.force_fn(new_pos, box)
                new_pos = new_pos.index_copy(
                    0, drude, new_pos[drude] + f.to(new_pos.dtype)[drude]
                    * inv_k)
            new_pos = deps.compute_vsites(new_pos)
            deps.step.add_(1)
            return new_pos, v

        return step


class DrudeNoseHooverIntegrator(_DrudeBase):
    """Two Nose-Hoover chains: the particles outside the pairs and the
    pairs' centres of mass at T, the pairs' relative motion at T_drude."""

    def __init__(self, temperature, collisionFrequency, drudeTemperature,
                 drudeCollisionFrequency, stepSize, chainLength=3, numMTS=3,
                 numYoshidaSuzuki=7):
        super().__init__(stepSize)
        self._temperature = float(u.strip(temperature, _K))
        self._frequency = float(u.strip(collisionFrequency, _PER_PS))
        self._drude_temperature = float(u.strip(drudeTemperature, _K))
        self._drude_frequency = float(u.strip(drudeCollisionFrequency,
                                              _PER_PS))
        self._chain_length = int(chainLength)
        self._n_mts = int(numMTS)
        self._n_ys = int(numYoshidaSuzuki)
        self._chains = ()

    def getCollisionFrequency(self):
        return u.Quantity(self._frequency, _PER_PS)

    def setCollisionFrequency(self, frequency) -> None:
        self._frequency = float(u.strip(frequency, _PER_PS))

    def getDrudeCollisionFrequency(self):
        return u.Quantity(self._drude_frequency, _PER_PS)

    def setDrudeCollisionFrequency(self, frequency) -> None:
        self._drude_frequency = float(u.strip(frequency, _PER_PS))

    def getChainState(self, relative=False) -> tuple:
        """(positions, velocities) of the centre-of-mass chain, or of the
        relative one, float64 numpy arrays."""
        cp, cv = self._chains[2:] if relative else self._chains[:2]
        return cp.cpu().numpy().copy(), cv.cpu().numpy().copy()

    def _params(self) -> tuple:
        return (self._step_size, self._temperature, self._frequency,
                self._drude_temperature, self._drude_frequency)

    def _param_names(self) -> tuple:
        return ("dt", "temperature", "frequency", "drudeTemperature",
                "drudeFrequency")

    def _init_state(self, deps: StepDeps) -> None:
        m = self._chain_length
        self._chains = tuple(torch.zeros(m, dtype=torch.float64,
                                         device=deps.inv_masses.device)
                             for _ in range(4))

    def _state_tensors(self) -> list:
        return list(self._chains)

    def _make_step_fn(self, deps: StepDeps):
        pairs, sel = self._pairs(deps)
        inv_m = deps.inv_masses[:, None]
        masses = self._context._masses
        moving = deps.moving
        i1, i2 = pairs[:, 0], pairs[:, 1]
        m1, m2 = masses[i1, None], masses[i2, None]
        inv_total = 1.0 / (m1 + m2)
        red_mass = m1 * m2 * inv_total
        single = torch.ones(masses.shape[0], dtype=torch.bool,
                            device=masses.device)
        single[pairs.reshape(-1)] = False
        single = single[:, None]
        n_pairs = int(pairs.shape[0])
        dof_com = 3.0 * (int(torch.count_nonzero(deps.inv_masses))
                         - n_pairs)
        dof_rel = 3.0 * n_pairs
        n_mts, n_ys = self._n_mts, self._n_ys
        chains = self._chains
        dt, temperature, frequency, drude_t, drude_frequency = \
            deps.params.unbind()

        def chain(k, ke2, kT, tau, dof):
            cp, cv = chains[2 * k], chains[2 * k + 1]
            scale, new_p, new_v = propagate_chain(ke2, cp, cv, kT, dof, dt,
                                                  tau, n_mts, n_ys)
            cp.copy_(new_p)
            cv.copy_(new_v)
            return scale

        def step(pos, vel, box):
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, box)
            _, forces = deps.force_fn(pos, box)
            v = torch.where(moving, vel + dt * forces.to(vel.dtype) * inv_m,
                            vel)
            v = deps.apply_velocity_constraints(pos, v)
            delta = 0.5 * dt * v
            cm_vel = (v[i1] * m1 + v[i2] * m2) * inv_total
            rel_vel = v[i2] - v[i1]
            ke2_single = torch.sum(torch.where(single, masses[:, None] * v * v,
                                               0.0))
            ke2_com = torch.sum((m1 + m2) * cm_vel * cm_vel)
            ke2_rel = torch.sum(red_mass * rel_vel * rel_vel)
            scale = chain(0, ke2_single + ke2_com, BOLTZ * temperature,
                          1.0 / frequency, dof_com)
            scale_d = chain(1, ke2_rel, BOLTZ * drude_t,
                            1.0 / drude_frequency, dof_rel)
            cm_vel = cm_vel * scale
            rel_vel = rel_vel * scale_d
            v = torch.cat([v * scale, cm_vel - rel_vel * m2 * inv_total,
                           cm_vel + rel_vel * m1 * inv_total])[sel]
            v = torch.where(moving, v, vel)
            delta = delta + 0.5 * dt * v
            new_raw = pos + torch.where(moving, delta, 0.0)
            new_pos, corr = deps.apply_position_constraints_corr(pos, new_raw)
            if corr is not None:
                v = v + torch.where(moving, corr / dt, 0.0)
            new_pos = deps.compute_vsites(new_pos)
            deps.step.add_(1)
            return new_pos, v

        return step
