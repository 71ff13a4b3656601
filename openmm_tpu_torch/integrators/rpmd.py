"""RPMDIntegrator: ring-polymer molecular dynamics.

Counterpart of openmm_tpu/integrators/rpmd.py (the rpmd plugin's
RPMDIntegrator.h; rpmd.cc). The K copies of the System are a leading
axis, (K, n, 3) float64 device tensors of the integrator's own state. A
step: the RPMD updaters' hooks (RPMDMonteCarloBarostat), half a PILE-L
thermostat step, half a kick, the free ring polymer evolved exactly in
normal modes (frequencies w_k = 2 (K kT / hbar) sin(k pi / K)), the
forces again, half a kick, half a PILE-L step. PILE-L (rpmd.cc:20-80)
damps the centroid with exp(-gamma dt / 2) and each internal mode
critically with exp(-w_k dt), its noise the orthonormal FFT of white
noise. The normal-mode transforms are torch.fft (cuFFT on a card).

Each copy's forces go through a candidate state of its own, the copies'
states rebuilt together under one gate (StepDeps.replica_forces,
replicas.py). Contraction (RPMDIntegrator.h:69-92): a force group listed
in `contractions` with M copies is evaluated on the ring polymer's
spectrum truncated to M modes (contractPositions, scale M / K here with
numpy-normed FFTs) and its forces padded back to K modes (contractForces,
scale K / M), the other groups on every copy. A step evaluates the
forces twice, as the JAX step does.

Until the copies have positions of their own (setPositions(copy, ...))
the first step takes every copy from the Context's positions, and the
same for the velocities (JAX rp_init); a flag a kind on the device, so a
snapshot and a captured step keep it. The Context's positions and
velocities are copy 0's after each step. A CMMotionRemover does nothing
under RPMD (its hook sees the copies as one configuration; the JAX step
discards what it does); the other update hooks (the Monte Carlo
barostats, the Andersen thermostat), constraints and virtual sites
raise: the JAX package runs them as if there were one copy, which moves
copy 0 alone or nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import unit as u
from ..constants import AVOGADRO, BOLTZ
from ..state import State
from .base import Integrator, StepDeps

HBAR = 1.054571628e-34 * AVOGADRO / (1000 * 1e-12)  # kJ/mol ps (rpmd.cc:138)
_K = u.kelvin
_PER_PS = u.picosecond ** -1


def _fft(x):
    return torch.fft.fft(x, dim=0, norm="ortho")


def _ifft(x):
    return torch.fft.ifft(x, dim=0, norm="ortho").real


def contract(pos_all, m):
    """The K configurations' spectrum truncated to m modes (split at
    (m + 1) // 2) and transformed back at size m (contractPositions)."""
    k = pos_all.shape[0]
    spec = torch.fft.fft(pos_all, dim=0)
    start = (m + 1) // 2
    keep = torch.cat([spec[:start], spec[k - (m - start):]], dim=0)
    return torch.fft.ifft(keep, dim=0).real * (m / k)


def expand(f_c, k):
    """m configurations' forces padded back to k modes, the transpose of
    contract (contractForces)."""
    m = f_c.shape[0]
    spec = torch.fft.fft(f_c, dim=0)
    start = (m + 1) // 2
    zeros = spec.new_zeros((k - m,) + tuple(spec.shape[1:]))
    padded = torch.cat([spec[:start], zeros, spec[start:]], dim=0)
    return torch.fft.ifft(padded, dim=0).real * (k / m)


class RPMDIntegrator(Integrator):
    def __init__(self, numCopies, temperature, frictionCoeff, stepSize,
                 contractions=None):
        super().__init__(stepSize)
        self._n_copies = int(numCopies)
        self._temperature = float(u.strip(temperature, _K))
        self._friction = float(u.strip(frictionCoeff, _PER_PS))
        self._apply_thermostat = True
        self._contractions = {int(g): int(m)
                              for g, m in dict(contractions or {}).items()}
        self._rp = None

    def getNumCopies(self) -> int:
        return self._n_copies

    def getTemperature(self):
        return u.Quantity(self._temperature, _K)

    def setTemperature(self, temperature) -> None:
        self._temperature = float(u.strip(temperature, _K))

    def getFriction(self):
        return u.Quantity(self._friction, _PER_PS)

    def setFriction(self, friction) -> None:
        self._friction = float(u.strip(friction, _PER_PS))

    def getApplyThermostat(self) -> bool:
        return self._apply_thermostat

    def setApplyThermostat(self, apply) -> None:
        self._apply_thermostat = bool(apply)

    def getContractions(self) -> dict:
        return dict(self._contractions)

    # -- the copies (RPMDIntegrator.h setPositions, getState) -------------
    def _require_context(self):
        if self._context is None:
            raise RuntimeError("This Integrator is not bound to a context")
        return self._context

    def setPositions(self, copy, positions) -> None:
        """The positions of one copy; from now on the copies are their
        own (the first step takes none from the Context)."""
        ctx = self._require_context()
        pos = np.asarray(u.strip(positions, u.nanometer), np.float64)
        self._rp[0][copy] = torch.as_tensor(pos, device=ctx._device)
        self._rp[2][0] = 1
        if copy == 0:
            ctx.setPositions(positions)
        else:
            ctx._positions_set = True

    def setVelocities(self, copy, velocities) -> None:
        ctx = self._require_context()
        vel = np.asarray(u.strip(velocities, u.nanometer / u.picosecond),
                         np.float64)
        self._rp[1][copy] = torch.as_tensor(vel, device=ctx._device)
        self._rp[2][1] = 1
        if copy == 0:
            ctx.setVelocities(velocities)

    def getState(self, copy, getEnergy=False, getForces=False,
                 getPositions=False, getVelocities=False, **kwargs) -> State:
        """The Context's getState with copy `copy`'s positions and
        velocities in place of its own."""
        ctx = self._require_context()
        saved = ctx._state["positions"], ctx._state["velocities"]
        ctx._state["positions"] = self._rp[0][copy].clone()
        ctx._state["velocities"] = self._rp[1][copy].clone()
        tiles = ctx._tiles, ctx._ref_pos, ctx._ref_box
        try:
            return ctx.getState(getEnergy=getEnergy, getForces=getForces,
                                getPositions=getPositions,
                                getVelocities=getVelocities, **kwargs)
        finally:
            ctx._state["positions"], ctx._state["velocities"] = saved
            ctx._tiles, ctx._ref_pos, ctx._ref_box = tiles

    def getTotalEnergy(self):
        """The copies' potential and kinetic energies and the ring
        polymer's springs, kJ/mol."""
        ctx = self._require_context()
        k = self._n_copies
        pos = self._rp[0].cpu().numpy()
        vel = self._rp[1].cpu().numpy()
        masses = ctx._masses.cpu().numpy()[None, :, None]
        wn = k * BOLTZ * self._temperature / HBAR
        e = sum(float(u.strip(self.getState(c, getEnergy=True)
                              .getPotentialEnergy(), u.kilojoule_per_mole))
                for c in range(k))
        e += 0.5 * np.sum(masses * vel * vel)
        springs = pos - np.roll(pos, 1, axis=0)
        e += 0.5 * wn * wn * np.sum(masses * springs * springs)
        return u.Quantity(e, u.kilojoule_per_mole)

    # -- the step ------------------------------------------------------------
    def _params(self) -> tuple:
        return (self._step_size, self._temperature, self._friction)

    def _param_names(self) -> tuple:
        return ("dt", "temperature", "friction")

    def _kinetic_energy_shift(self) -> float:
        return 0.0

    def _init_state(self, deps: StepDeps) -> None:
        dev = deps.inv_masses.device
        shape = (self._n_copies, deps.inv_masses.shape[0], 3)
        self._rp = (torch.zeros(shape, dtype=torch.float64, device=dev),
                    torch.zeros(shape, dtype=torch.float64, device=dev),
                    torch.zeros(2, dtype=torch.int64, device=dev))

    def _state_tensors(self) -> list:
        return list(self._rp)

    def _check_system(self, ctx, deps) -> list:
        """The update hooks a step runs (the RPMD updaters'); raises on
        what RPMD cannot run."""
        from ..forces.barostats import RPMDUpdater
        from ..forces.cmmotion import CMMotionRemover
        system = ctx._system
        if system.getNumConstraints():
            raise NotImplementedError(
                "RPMDIntegrator with constraints: the ring polymer's "
                "copies are not constrained in this port (the JAX step "
                "ignores the constraints)")
        if system._vsites:
            raise NotImplementedError("RPMDIntegrator with virtual sites "
                                      "is not in this slice of the port")
        for m in self._contractions.values():
            if m > self._n_copies:
                raise ValueError("RPMDIntegrator: Number of copies for "
                                 "contraction cannot be greater than the "
                                 "total number of copies")
        hooks = []
        for hook in deps.update_hooks:
            if isinstance(hook.force, RPMDUpdater):
                hooks.append(hook)
            elif not isinstance(hook.force, CMMotionRemover):
                raise NotImplementedError(
                    "%s under RPMDIntegrator (use RPMDMonteCarloBarostat)"
                    % type(hook.force).__name__)
        return hooks

    def _make_step_fn(self, deps: StepDeps):
        ctx = self._context
        hooks = self._check_system(ctx, deps)
        k = self._n_copies
        rp_pos, rp_vel, seeded = self._rp
        inv_m = deps.inv_masses[None, :, None]
        moving = deps.moving[None]
        sqrt_inv_m = torch.sqrt(deps.inv_masses)[None, :, None]
        dev = inv_m.device
        mode = np.arange(k)
        sin_fac = torch.as_tensor(
            np.sin(np.where(mode <= k // 2, mode, k - mode) * math.pi / k),
            device=dev)[:, None, None]
        is_centroid = torch.as_tensor(mode == 0, device=dev)[:, None, None]
        thermostat = self._apply_thermostat
        groups = self.getIntegrationForceGroups() & 0xffffffff
        contracted = sorted(self._contractions.items())
        for g, _ in contracted:
            groups &= ~(1 << g)
        dt, temperature, friction = deps.params.unbind()

        def all_forces(pos_all, box):
            forces = deps.replica_forces("copies", pos_all, box, groups)
            for g, m in contracted:
                f_c = deps.replica_forces(("contracted", g),
                                          contract(pos_all, m), box, 1 << g)
                forces = forces + expand(f_c, k)
            return forces

        def pile_half(vel_all, kT):
            nkT = k * kT
            c1 = torch.where(is_centroid, torch.exp(-0.5 * dt * friction),
                             torch.exp(-(2.0 * nkT / HBAR) * sin_fac * dt))
            c2 = torch.sqrt(1.0 - c1 * c1)
            xi = torch.randn(vel_all.shape, generator=deps.generator,
                             dtype=vel_all.dtype, device=dev)
            v_nm = c1 * _fft(vel_all) + c2 * torch.sqrt(nkT) * sqrt_inv_m \
                * _fft(xi)
            return _ifft(v_nm)

        def free_evolve(pos_all, vel_all, kT):
            wk = (2.0 * k * kT / HBAR) * sin_fac
            wt = wk * dt
            q_nm, v_nm = _fft(pos_all), _fft(vel_all)
            free = wk == 0
            cos_wt, sin_wt = torch.cos(wt), torch.sin(wt)
            q_new = torch.where(free, q_nm + v_nm * dt,
                                v_nm * (sin_wt / torch.where(free, 1.0, wk))
                                + q_nm * cos_wt)
            v_new = torch.where(free, v_nm, v_nm * cos_wt
                                - q_nm * wk * sin_wt)
            return _ifft(q_new), _ifft(v_new)

        def step(pos, vel, box):
            kT = BOLTZ * temperature
            pos_all = torch.where(seeded[0] > 0, rp_pos, pos.expand_as(rp_pos))
            vel_all = torch.where(seeded[1] > 0, rp_vel, vel.expand_as(rp_vel))
            for hook in hooks:
                pos_all, vel_all = hook(deps.step, pos_all, vel_all, box)
            if thermostat:
                vel_all = pile_half(vel_all, kT)
            vel_all = vel_all + 0.5 * dt * all_forces(pos_all, box) * inv_m
            pos_all, vel_all = free_evolve(pos_all, vel_all, kT)
            vel_all = vel_all + 0.5 * dt * all_forces(pos_all, box) * inv_m
            if thermostat:
                vel_all = pile_half(vel_all, kT)
            vel_all = torch.where(moving, vel_all, 0.0)
            rp_pos.copy_(pos_all)
            rp_vel.copy_(vel_all)
            seeded.fill_(1)
            deps.step.add_(1)
            return pos_all[0], vel_all[0]

        return step
