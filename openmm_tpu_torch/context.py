"""Context: binds a System and an Integrator to device state.

Counterpart of openmm_tpu/context.py. As the JAX Context compiles one
fused step program, this one steps through a StepProgram
(step_program.py): on a card each step is a replay of one captured CUDA
graph, the rebuild of the direct-space candidate state (when an atom has
moved more than skin/2) decided on the card; on the CPU the same step
body runs eagerly. Steps run in chunks of STEP_CHUNK, and the host reads
the chunk's overflow count once at its end: when the candidate state
overflowed its capacity (which poisoned the forces with NaN), the chunk is
undone from a copied snapshot, the capacity grows by 1.4x (a new program,
captured for the new shapes) and the chunk runs again, at most 6 times
(ContextImpl.cpp:298-307). _step_eager is the eager loop the program
replaced, one launch at a time with the rebuild decided on the host: the
reference that the tests and chip_smoke.py hold the program to.
_make_position_energy_fn is the minimizer's objective (energy and forces
by autograd at given positions).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .constants import BOLTZ
from .forces.nonbonded import NonbondedForce, NonbondedModule
from .integrators.base import StepDeps
from .ops.constraints import Settle, partition_constraints
from .ops.pairs import needs_rebuild
from .platform import Platform, set_fp32_matmul_exact
from .state import State
from .step_program import StepProgram

STEP_CHUNK = 100
MAX_ESCALATIONS = 6


class Context:
    def __init__(self, system, integrator, platform=None, properties=None):
        set_fp32_matmul_exact()
        if platform is None:
            platform = Platform.getDefaultPlatform()
        elif isinstance(platform, str):
            platform = Platform.getPlatformByName(platform)
        self._device, self._precision = platform.resolve(properties)
        self._system = system
        self._integrator = integrator
        n = system.getNumParticles()
        if n == 0:
            raise ValueError("Cannot create a Context for a System with no "
                             "particles")
        self._n = n
        masses = np.asarray([system.getParticleMass(i) for i in range(n)])
        if np.any(masses <= 0):
            raise NotImplementedError(
                "massless particles (virtual sites, fixed atoms) are not in "
                "this slice of the port")

        forces = system.getForces()
        if len(forces) != 1 or not isinstance(forces[0], NonbondedForce):
            raise NotImplementedError(
                "this slice of the port runs one NonbondedForce and nothing "
                "else")
        if forces[0].getNumParticles() != n:
            raise ValueError("NonbondedForce must have the same number of "
                             "particles as the System")
        self._nonbonded = NonbondedModule(
            forces[0], system.getDefaultPeriodicBoxVectors(), self._device,
            self._precision)

        constraints = [system.getConstraintParameters(i)
                       for i in range(system.getNumConstraints())]
        clusters, rest = partition_constraints(constraints, masses)
        if rest:
            raise NotImplementedError(
                "%d constraints are not SETTLE water triangles; CCMA is not "
                "in this slice of the port" % len(rest))
        self._settle = (Settle(clusters, masses, self._device)
                        if clusters else None)

        f64 = dict(dtype=torch.float64, device=self._device)
        self._masses = torch.as_tensor(masses, **f64)
        self._generator = torch.Generator(device=self._device)
        seed = integrator.getRandomNumberSeed() or int(
            np.random.randint(1, 2 ** 31 - 1))
        self._generator.manual_seed(seed)
        self._state = {
            "positions": torch.zeros((n, 3), **f64),
            "velocities": torch.zeros((n, 3), **f64),
            "box": torch.as_tensor(system.getDefaultPeriodicBoxVectors(),
                                   **f64),
            "time": 0.0, "step": 0}
        self._positions_set = False
        self._tiles = None          # candidate state of the direct space
        self._ref_pos = None        # positions at its build
        self._overflow = torch.zeros((), dtype=torch.int64,
                                     device=self._device)
        self.rebuild_count = 0
        self.escalation_count = 0
        self.energy_evaluations = 0     # of _make_position_energy_fn
        # host seconds spent issuing steps: each chunk up to its one read,
        # so without the wait for the card to finish the chunk
        self.issue_seconds = 0.0
        self._params_written = integrator._params()
        self._deps = StepDeps(
            inv_masses=1.0 / self._masses,
            force_fn=self._forces_for_step,
            apply_position_constraints_corr=self._constrain_positions,
            apply_velocity_constraints=self._constrain_velocities,
            generator=self._generator,
            params=torch.tensor(self._params_written, **f64))
        self._step_fn = integrator._make_step_fn(self._deps)
        self._programs = {}         # (capacity scale, box widths) -> program
        integrator._bind(self)

    # -- constraints -----------------------------------------------------
    def _constrain_positions(self, ref, new):
        if self._settle is None:
            return new, None
        corr = self._settle.position_corrections(ref, new)
        return new + corr, corr

    def _constrain_velocities(self, pos, vel):
        if self._settle is None:
            return vel
        return self._settle.apply_velocities(pos, vel)

    # -- forces ------------------------------------------------------------
    def _refresh_tiles(self, pos):
        """Rebuild the candidate state when the predicate fires."""
        if self._tiles is None or bool(needs_rebuild(
                pos, self._ref_pos, self._nonbonded.skin)):
            self._tiles = self._nonbonded.build_state(pos,
                                                      self._state["box"])
            self._ref_pos = pos
            self._overflow = self._overflow + self._tiles["overflow"]
            self.rebuild_count += 1

    def _forces_for_step(self, pos, box):
        self._refresh_tiles(pos)
        return self._nonbonded(pos, box, self._tiles)

    def _make_position_energy_fn(self):
        """(positions (n, 3) float64 numpy) -> (energy float, forces (n, 3)
        float64 numpy): the potential energy at those positions and minus
        its gradient by autograd, on this Context's device in its
        precision, with its current box. Used by LocalEnergyMinimizer; the
        Context's own state is not touched."""
        module = self._nonbonded

        def evaluate(positions):
            pos = torch.as_tensor(np.asarray(positions, np.float64),
                                  dtype=module.dtype, device=self._device)
            pos.requires_grad_(True)
            energy = module.potential_energy(pos, self._state["box"])
            (grad,) = torch.autograd.grad(energy, pos)
            self.energy_evaluations += 1
            return float(energy.detach()), -grad.to(torch.float64).cpu().numpy()

        return evaluate

    # -- accessors -----------------------------------------------------------
    def getSystem(self):
        return self._system

    def getIntegrator(self):
        return self._integrator

    def getStepCount(self) -> int:
        return self._state["step"]

    def _set_position_tensor(self, pos) -> None:
        """New positions: the candidate state built for the old ones is
        dropped, so the next force evaluation rebuilds it."""
        self._state["positions"] = pos
        self._tiles = None
        self._ref_pos = None

    def setPositions(self, positions) -> None:
        pos = np.asarray(positions, np.float64)
        if pos.shape != (self._n, 3):
            raise ValueError("setPositions: expected (%d, 3), got %s"
                             % (self._n, pos.shape))
        self._set_position_tensor(torch.as_tensor(
            pos, dtype=torch.float64, device=self._device))
        self._positions_set = True

    def setVelocities(self, velocities) -> None:
        vel = np.asarray(velocities, np.float64)
        if vel.shape != (self._n, 3):
            raise ValueError("setVelocities: wrong shape")
        self._state["velocities"] = torch.as_tensor(
            vel, dtype=torch.float64, device=self._device)

    def setVelocitiesToTemperature(self, temperature, randomSeed=None):
        """Maxwell-Boltzmann velocities at `temperature` K from a generator
        seeded with randomSeed, then the velocity constraints."""
        gen = torch.Generator(device=self._device)
        gen.manual_seed(int(randomSeed) if randomSeed is not None
                        else int(np.random.randint(1, 2 ** 31 - 1)))
        sigma = torch.sqrt(BOLTZ * float(temperature) / self._masses)
        v = sigma[:, None] * torch.randn((self._n, 3), generator=gen,
                                         dtype=torch.float64,
                                         device=self._device)
        self._state["velocities"] = self._constrain_velocities(
            self._state["positions"], v)

    def applyConstraints(self) -> None:
        pos = self._state["positions"]
        self._set_position_tensor(self._constrain_positions(pos, pos)[0])

    # -- stepping ----------------------------------------------------------------
    def _snapshot(self):
        """A copy of what a step changes: the state's tensors, the candidate
        state and its positions, and the generator. Copies, because a step
        program updates its buffers in place."""
        state = dict(self._state)
        for key in ("positions", "velocities"):
            state[key] = state[key].clone()
        tiles = (None if self._tiles is None else
                 {k: v.clone() for k, v in self._tiles.items()})
        ref_pos = None if self._ref_pos is None else self._ref_pos.clone()
        return state, self._generator.get_state(), tiles, ref_pos

    def _restore(self, snap):
        state, gen_state, tiles, ref_pos = snap
        self._state = dict(state)
        self._generator.set_state(gen_state)
        self._tiles, self._ref_pos = tiles, ref_pos

    def _write_params(self) -> None:
        """The integrator's parameters into the step's device tensor, when
        they changed since the last write."""
        params = self._integrator._params()
        if params != self._params_written:
            self._deps.params.copy_(torch.tensor(params,
                                                 dtype=torch.float64))
            self._params_written = params

    def _advance_clock(self, steps: int) -> None:
        dt = self._integrator.getStepSize()
        t = self._state["time"]
        for _ in range(steps):
            t = t + dt
        self._state["time"] = t
        self._state["step"] += steps

    def _escalate(self, snap, tries: int) -> int:
        """Undo an overflowing chunk and grow the capacity."""
        tries += 1
        if tries > MAX_ESCALATIONS:
            raise RuntimeError("neighbour-list capacity escalation failed "
                               "to converge")
        self._restore(snap)
        self._nonbonded.capacity_scale *= 1.4
        self._tiles = None
        self.escalation_count += 1
        return tries

    def _program(self) -> StepProgram:
        nb = self._nonbonded
        key = (nb.capacity_scale, tuple(nb.box_widths))
        if key not in self._programs:
            self._programs[key] = StepProgram(self)
        return self._programs[key]

    def _step(self, n_steps: int) -> None:
        """n_steps through the step program, in chunks of STEP_CHUNK; the
        host reads the chunk's counters (overflow, rebuilds) once at its
        end."""
        if not self._positions_set:
            raise RuntimeError("Particle positions have not been set")
        self._write_params()
        remaining, tries = n_steps, 0
        while remaining > 0:
            this = min(remaining, STEP_CHUNK)
            snap = self._snapshot()
            program = self._program()
            t0 = time.perf_counter()
            program.load()
            program.run(this)
            self.issue_seconds += time.perf_counter() - t0
            overflow, rebuilds = program.counters.tolist()
            program.store()
            self.rebuild_count += rebuilds
            self._advance_clock(this)
            if overflow > 0:
                tries = self._escalate(snap, tries)
                continue
            remaining -= this

    def _step_eager(self, n_steps: int) -> None:
        """The eager loop that the step program replaced: the same steps,
        launched op by op, the rebuild predicate read on the host every
        step. The reference for tests and chip_smoke.py; step() never
        calls it."""
        if not self._positions_set:
            raise RuntimeError("Particle positions have not been set")
        self._write_params()
        remaining, tries = n_steps, 0
        while remaining > 0:
            this = min(remaining, STEP_CHUNK)
            snap = self._snapshot()
            t0 = time.perf_counter()
            # a state built before the chunk poisons its steps too
            self._overflow = (self._tiles["overflow"].clone()
                              if self._tiles is not None
                              else torch.zeros_like(self._overflow))
            state = self._state
            for _ in range(this):
                state["positions"], state["velocities"] = self._step_fn(
                    state["positions"], state["velocities"], state["box"])
                self._advance_clock(1)
            self.issue_seconds += time.perf_counter() - t0
            if int(self._overflow) > 0:
                tries = self._escalate(snap, tries)
                continue
            remaining -= this

    # -- state -----------------------------------------------------------------
    def getState(self, getEnergy=False, getForces=False, getPositions=False,
                 getVelocities=False) -> State:
        s = self._state
        kw = {"time": s["time"], "step": s["step"],
              "box": s["box"].cpu().numpy()}
        if getEnergy or getForces:
            if not self._positions_set:
                raise RuntimeError("Particle positions have not been set")
            energy, forces = self._forces_for_step(s["positions"], s["box"])
            if getEnergy:
                kw["potential_energy"] = float(energy)
                kw["kinetic_energy"] = self.kinetic_energy()
            if getForces:
                kw["forces"] = forces.double().cpu().numpy()
        if getPositions:
            kw["positions"] = s["positions"].cpu().numpy()
        if getVelocities:
            kw["velocities"] = s["velocities"].cpu().numpy()
        return State(**kw)

    def kinetic_energy(self) -> float:
        """0.5 sum m v^2 (LangevinMiddle reports on-step velocities)."""
        v = self._state["velocities"]
        return float(0.5 * torch.sum(self._masses[:, None] * v * v))

    def temperature(self) -> float:
        """Instantaneous temperature from the kinetic energy, over the
        3n - (constraints) degrees of freedom (no COM motion removal)."""
        dof = 3 * self._n - self._system.getNumConstraints()
        return 2.0 * self.kinetic_energy() / (dof * BOLTZ)
