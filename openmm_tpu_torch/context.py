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
(ContextImpl.cpp:298-307). A reading outside the steps (getState, the
kinetic energy) whose rebuild overflows grows the capacity the same way
and builds again, so it never reports the poison (_forces_now).
_step_eager is the eager loop the program
replaced, one launch at a time with the rebuild decided on the host: the
reference that the tests and chip_smoke.py hold the program to.
_make_position_energy_fn is the minimizer's objective (energy and forces
by autograd at given positions). getState(getParameterDerivatives=True)
gives dE/dparameter of the parameters the custom forces request
(addEnergyParameterDerivative), summed over the forces in the groups
asked for, between steps (the step computes none): the custom forces'
from their symbolic derivatives, and, for a parameter that a
NonbondedForce's offsets also read, the NonbondedForce's through the
offsets (NonbondedModule.parameter_derivatives: kernel 1's derivative
instantiation on the candidate state, closed forms for the exceptions,
the exclusion correction and the self energies, the reciprocal space
as a bilinear form of the charges), as the JAX package's jax.grad
through its offsets (openmm_tpu/forces/nonbonded.py:541-562) gives it.

A System may hold NonbondedForces (any method, with global parameters and
offsets: forces/nonbonded.py; each its own module, those that keep a
candidate state rebuilt together under one predicate: CandidateSet),
GBSAOBCForces (forces/gbsa.py), any of the bonded forces
(forces/bonded.py), the custom forces (forces/custom.py), CMMotionRemovers,
Monte Carlo barostats (forces/barostats.py) and Andersen thermostats
(forces/thermostats.py): the last three are update hooks that the
integrator runs at the top of each step, in the System's force order.
Each force belongs to a force group, which getState(groups=...) selects;
a step evaluates the integrator's integration force groups only.
Constraints split into SETTLE water triangles, SHAKE-H star clusters and
the rest (CCMA), applied in that order (ops/constraints.py). A particle
of mass 0 is fixed: the integrators never move it, it has no kinetic
energy and no degrees of freedom, and no constraint may hold it. A virtual site
(System.setVirtualSite) must be massless: its position is computed from
its parents (ops/vsites.py) in setPositions, applyConstraints,
computeVirtualSites, after a barostat's move and after each position
update of every integrator (StepDeps.compute_vsites), and each force
evaluation spreads its force onto its parents; a site belongs to its
parents' molecule.

updateParametersInContext writes a force's new parameters into the
modules' device buffers in place (no step program is captured again) and
drops the candidate state, whose parameters it baked. createCheckpoint
holds what a snapshot holds, as the bytes of an npz archive (no pickle),
so that loadCheckpoint continues bit for bit.

The box is one float64 device tensor (3, 3), written in place
(setPeriodicBoxVectors, a barostat's accepted move), that the Context and
every step program share; the candidate state is rebuilt when the box
differs from the box it was built for. PME's alpha and grid, the sort's
cell counts and the candidate state's capacities stay those of the
System's default box, as in OpenMM; a box that shrinks far enough to
overflow them goes through the escalation. The global parameters the
forces define (the barostats' pressure, tension and temperature) are one
float64 device tensor too, so a new value needs no new program. The
molecules (a union-find over the constraints and each force's
_bonded_particles) are what the barostats scale and what
getState(enforcePeriodicBox=True) wraps whole. The time is a float64
device scalar too, which each step advances by the step size it used (a
variable-step integrator picks it on the card); the integrator's own
state (Nose-Hoover chains, a CustomIntegrator's variables) is device
tensors that a snapshot copies with the box, the clock and the
parameters (_step_tensors).
"""
from __future__ import annotations

import io
import time

import numpy as np
import torch

from . import unit as u
from .constants import BOLTZ
from .forces import MODULE_FORCES
from .forces.barostats import BAROSTATS
from .forces.bonded import BONDED_FORCES, HarmonicAngleForce
from .forces.cmmotion import CMMotionRemover
from .forces.drude import DrudeForce
from .forces.gbsa import GBSAOBCForce
from .forces.nonbonded import (CandidateSet, NonbondedForce,
                               NonbondedModule, NonbondedVariable)
from .forces.thermostats import AndersenThermostat
from .integrators.base import StepDeps
from .ops.amoeba_pairs import AmoebaPairs
from .ops.constraints import (CCMA, Settle, Shake, partition_constraints,
                              partition_shake_clusters)
from .ops.pairs import needs_rebuild
from .ops.vsites import VirtualSites
from .parallel.mesh import get_default_mesh
from .platform import Platform, set_fp32_matmul_exact
from .replicas import ReplicaStates
from .state import State
from .step_program import StepProgram, branch_host, loop_host
from .system import reduced_box

STEP_CHUNK = 100
# the forces compiled with _compile(n, device) into a float64 module of
# bonded terms (ef, energy, update)
TERM_FORCES = BONDED_FORCES + (DrudeForce,)
MAX_ESCALATIONS = 6
CHECKPOINT_MAGIC = "OMMTORCH1"


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor: on the CPU .numpy() would share the
    memory of a buffer that later steps write in place."""
    return t.detach().to("cpu", copy=True).numpy()


def _first_members(n: int, pairs) -> np.ndarray:
    """(n,) int64: for each of n items, the first (lowest) item of its
    connected component under `pairs`: each item's label lowered to its
    pair partners' and then to its label's label until nothing moves."""
    first = np.arange(n, dtype=np.int64)
    a, b = np.asarray(pairs, np.int64).reshape(-1, 2).T
    while True:
        low = np.minimum(first[a], first[b])
        new = first.copy()
        np.minimum.at(new, a, low)
        np.minimum.at(new, b, low)
        new = new[new]
        if np.array_equal(new, first):
            return first
        first = new


def _group_mask(groups) -> int:
    """A force-group bit mask from an int mask (-1: all) or a collection
    of group numbers."""
    if isinstance(groups, (set, frozenset, list, tuple)):
        mask = 0
        for g in groups:
            mask |= 1 << int(g)
        return mask
    return int(groups)


class Context:
    def __init__(self, system, integrator, platform=None, properties=None):
        set_fp32_matmul_exact()
        if platform is None:
            platform = Platform.getDefaultPlatform()
        elif isinstance(platform, str):
            platform = Platform.getPlatformByName(platform)
        self._platform, self._properties = platform, properties
        self._device, self._precision = platform.resolve(properties)
        # the mesh whose ranks split the direct sweeps (JAX context.py
        # :126-132: a Context built after set_default_mesh takes it)
        self._mesh = get_default_mesh()
        if self._mesh is not None:
            self._mesh.check_device(self._device)
        self._system = system
        self._integrator = integrator
        n = system.getNumParticles()
        if n == 0:
            raise ValueError("Cannot create a Context for a System with no "
                             "particles")
        self._n = n
        masses = np.asarray(system._masses, np.float64)
        if np.any(masses < 0):
            raise ValueError("a particle's mass must not be negative")
        for index in system._vsites:
            if masses[index] != 0.0:
                raise ValueError("Virtual site at index %d must have mass 0"
                                 % index)
        constraints = list(system._constraints)
        for p1, p2, _ in constraints:
            if masses[p1] == 0 or masses[p2] == 0:
                raise NotImplementedError(
                    "a constraint on a massless particle (%d-%d) is not in "
                    "this slice of the port: SETTLE, SHAKE and CCMA divide "
                    "by the masses" % (p1, p2))

        # the forces at construction: a force added to the System later
        # does not reach this Context's step programs
        forces = self._forces = system.getForces()
        for force in forces:
            if not isinstance(force, (NonbondedForce, GBSAOBCForce,
                                      CMMotionRemover, AndersenThermostat)
                              + TERM_FORCES + BAROSTATS + MODULE_FORCES):
                raise NotImplementedError(
                    "%s is not in this slice of the port"
                    % type(force).__name__)
        nonbonded = [f for f in forces if isinstance(f, NonbondedForce)]
        custom_forces = [f for f in forces if isinstance(f, MODULE_FORCES)]
        f64 = dict(dtype=torch.float64, device=self._device)
        defaults = {}
        for force in forces:
            defaults.update(force._global_defaults())
        self._gp_index = {name: i for i, name in enumerate(defaults)}
        self._gp = torch.as_tensor(list(defaults.values()), **f64)
        # the parameters whose energy derivatives getState reports
        self._deriv_names = sorted({name for f in custom_forces
                                    for name in getattr(
                                        f, "_deriv_requests", ())})
        for force in nonbonded:
            if force.getNumParticles() != n:
                raise ValueError("NonbondedForce must have the same number "
                                 "of particles as the System")
        self._nonbondeds = [NonbondedModule(
            force, system._box.copy(), self._device,
            self._precision, self._gp, self._gp_index) for force in nonbonded]
        for module in self._nonbondeds:
            module.mesh = self._mesh
        self._nonbonded = self._nonbondeds[0] if nonbonded else None
        # a Drude particle's dipole, ~0.005 nm between charges of ~1.7 e,
        # loses ~1e-4 of its length to float32 coordinates of a few nm
        # (the median force error of a 5.24 nm SWM4-NDP box 1.4e-5 on an
        # NVIDIA H100 80GB HBM3 at 700 W, 8.3e-6 with the pairs): kernel 1
        # then takes the positions as float32 pairs
        self._fine_positions = any(isinstance(f, DrudeForce) for f in forces)
        for module in self._nonbondeds:
            module.fine_positions = self._fine_positions
        gb_forces = [f for f in forces if isinstance(f, GBSAOBCForce)]
        bonded_forces = [f for f in forces if isinstance(f, TERM_FORCES)]
        # the custom forces read the masses (a centroid's weights)
        self._masses = torch.as_tensor(masses, **f64)
        self._gb = [self._compile_module(f) for f in gb_forces]
        self._bonded = [self._compile_module(f) for f in bonded_forces]
        # the pair lists of the periodic AMOEBA forces, made by the first
        # module that asks (_amoeba_pair_set)
        self._amoeba_pairs = None
        # the NonbondedModules of the CustomCVForces' variables that keep
        # a candidate state, which _compile_module gathers
        self._cv_nonbondeds = []
        self._custom = [self._compile_module(f) for f in custom_forces]
        # the modules whose direct space keeps a candidate state (none
        # when every pair is computed, or there is no direct space: no
        # rebuild, no overflow), the CV variables' among them, and the
        # AMOEBA pair lists: one itself, several a CandidateSet
        tiled = [m for m in self._nonbondeds if m.periodic and m.has_direct]
        tiled += self._cv_nonbondeds
        if self._amoeba_pairs is not None:
            tiled.append(self._amoeba_pairs)
        self._candidates = (None if not tiled else tiled[0]
                            if len(tiled) == 1 else CandidateSet(tiled))
        # each force's compiled module, for updateParametersInContext
        self._modules = dict(zip(
            map(id, nonbonded + gb_forces + bonded_forces + custom_forces),
            self._nonbondeds + self._gb + self._bonded + self._custom))
        self._vsites = (VirtualSites(system, self._device)
                        if system._vsites else None)
        self._has_cm_remover = any(isinstance(f, CMMotionRemover)
                                   for f in forces)

        clusters, rest = partition_constraints(constraints, masses)
        shake_clusters, ccma_cons = partition_shake_clusters(rest, masses)
        angles = [a[:4] for f in forces
                  if isinstance(f, HarmonicAngleForce) for a in f._angles]
        self._settle = (Settle(clusters, masses, self._device)
                        if clusters else None)
        self._shake = (Shake(shake_clusters, masses, self._device)
                       if shake_clusters else None)
        self._ccma = (CCMA(ccma_cons, masses, angles, self._device)
                      if ccma_cons else None)
        # SETTLE waters, SHAKE clusters and CCMA constraints
        self.constraint_split = (len(clusters), len(shake_clusters),
                                 len(ccma_cons))

        self._inv_masses = torch.as_tensor(
            np.where(masses == 0, 0.0, 1.0 / np.where(masses == 0, 1.0,
                                                      masses)), **f64)
        self._n_massive = int(np.count_nonzero(masses))
        # the first particle of each particle's constraint cluster
        self._clusters = torch.as_tensor(
            _first_members(n, [c[:2] for c in constraints]),
            device=self._device)
        self._molecule_id, self._n_molecules = self._detect_molecules()
        self._box = torch.as_tensor(system._box.copy(), **f64)
        # barostats that attempt moves (a frequency of 0 never does)
        self._barostats = [f._compile(self) for f in forces
                           if isinstance(f, BAROSTATS)
                           and f.getFrequency() > 0]
        self._generator = torch.Generator(device=self._device)
        seed = integrator.getRandomNumberSeed() or int(
            np.random.randint(1, 2 ** 31 - 1))
        self._generator.manual_seed(seed)
        # the clock: a device scalar that each step advances by the step
        # size it used (a variable-step integrator picks it on the card)
        self._time = torch.zeros((), **f64)
        self._state = {
            "positions": torch.zeros((n, 3), **f64),
            "velocities": torch.zeros((n, 3), **f64),
            "box": self._box, "time": self._time, "step": 0}
        self._positions_set = False
        self._tiles = None          # candidate state of the direct space
        self._ref_pos = None        # positions at its build
        self._ref_box = None        # and the box
        self._overflow = torch.zeros((), dtype=torch.int64,
                                     device=self._device)
        self.rebuild_count = 0
        self.escalation_count = 0
        self.energy_evaluations = 0     # of _make_position_energy_fn
        # host seconds spent issuing steps: each chunk up to its one read,
        # so without the wait for the card to finish the chunk
        self.issue_seconds = 0.0
        self._params_written = integrator._params()
        self._params = torch.tensor(self._params_written, **f64)
        # the candidate states of the eager loop's replica sets
        self._replicas = ReplicaStates(self)
        self._deps = StepDeps(
            inv_masses=self._inv_masses,
            moving=(self._inv_masses != 0)[:, None],
            force_fn=self._integration_forces,
            apply_position_constraints_corr=self._constrain_positions,
            apply_velocity_constraints=self._constrain_velocities,
            generator=self._generator,
            params=self._params,
            step=torch.zeros((), dtype=torch.int64, device=self._device),
            update_hooks=self._make_hooks(self._attempt_eager),
            forces_by_groups=self._forces_for_step,
            branch=branch_host, loop=loop_host,
            compute_vsites=self._compute_vsites,
            replica_forces=self._replica_forces)
        integrator._bind(self)
        integrator._init_state(self._deps)
        # the eager loop's step functions, by the integrator's program key
        self._eager_fns = {}
        # (capacity scale, integration groups, program key) -> program
        self._programs = {}

    def _compile_module(self, force):
        """The compiled module of a GBSAOBCForce, a bonded force or a force
        of MODULE_FORCES, for the Context's force lists or for a
        collective variable of a CustomCVForce, which the Context keeps
        out of them; a CV may also be a NonbondedForce (any method): one
        whose direct space keeps a candidate state joins
        _cv_nonbondeds, so that the Context's rebuild gate builds that
        state with its own. Each has ef, energy and update; the custom
        kinds also parameter_derivatives."""
        if isinstance(force, MODULE_FORCES):
            return force._compile(self)
        if isinstance(force, GBSAOBCForce):
            return force._compile(self._n, self._device, self._precision)
        if isinstance(force, TERM_FORCES):
            return force._compile(self._n, self._device)
        if isinstance(force, NonbondedForce):
            module = NonbondedModule(force, self._system._box.copy(),
                                     self._device, self._precision, self._gp,
                                     self._gp_index)
            module.fine_positions = self._fine_positions
            module.mesh = self._mesh
            if module.periodic and module.has_direct:
                self._cv_nonbondeds.append(module)
            return NonbondedVariable(module)
        raise NotImplementedError("%s as a collective variable is not in "
                                  "this slice of the port"
                                  % type(force).__name__)

    def _amoeba_pair_set(self):
        """The AmoebaPairs of this Context (ops/amoeba_pairs.py), which
        the periodic AMOEBA modules ask their cutoffs of; the rebuild gate
        builds it with the NonbondedForces' candidate states."""
        if self._amoeba_pairs is None:
            self._amoeba_pairs = AmoebaPairs(self._n, self._system._box,
                                             self._device)
        return self._amoeba_pairs

    def _detect_molecules(self):
        """(molecule of each atom (n,) int64, count): the components of
        the constraints and each force's _bonded_particles(), numbered in
        the order of their first atoms, as the JAX Context numbers them
        (context.py _detect_molecules)."""
        system = self._system
        pairs = [c[:2] for c in system._constraints]
        pairs += [(index, p) for index, site in system._vsites.items()
                  for p in site._particles]
        for force in system.getForces():
            pairs += list(force._bonded_particles())
        first = _first_members(self._n, pairs)
        # a component's first atom carries its own number, so numbering
        # in the order of first atoms is the order of those numbers
        labels, mol_id = np.unique(first, return_inverse=True)
        return mol_id.astype(np.int64), len(labels)

    # -- update hooks ------------------------------------------------------
    def _make_hooks(self, attempt) -> list:
        """The update hooks in the System's force order. A barostat's hook
        draws its uniforms from the generator every step (a fixed count
        a step, so a captured graph keeps its draws in step) and hands
        them to attempt(k, step, pos, box, u) -> pos, which runs barostat
        k's attempt on the steps it fires on; an Andersen thermostat's
        draws its normals and uniforms every step too."""
        hooks, k = [], 0
        for force in self._forces:
            if isinstance(force, CMMotionRemover):
                hooks.append(force._make_hook(self._masses))
            elif isinstance(force, AndersenThermostat):
                hooks.append(force._make_hook(
                    self._inv_masses, self._clusters, self._generator,
                    self._params, self._gp, self._gp_index))
            elif isinstance(force, BAROSTATS) and force.getFrequency() > 0:
                hooks.append(self._barostat_hook(k, attempt))
                k += 1
            else:
                continue
            # the force a hook belongs to (RPMD runs its updaters' alone)
            hooks[-1].force = force
        return hooks

    def _barostat_hook(self, k, attempt):
        baro = self._barostats[k]

        def hook(step, pos, vel, box):
            u = baro.draw(self._generator, pos.device)
            return attempt(k, step, pos, box, u), vel

        return hook

    def _trial_energy(self, pos, box):
        """(potential energy of every force at `pos` in `box`, float64;
        the overflow of the candidate state built for them): what a
        barostat's attempt compares. The NonbondedForce's energy goes
        through a candidate state built at the cutoff for these positions
        and this box (NonbondedModule.forward: kernels 1-3), NaN when it
        overflowed."""
        energy = torch.zeros((), dtype=torch.float64, device=pos.device)
        overflow = torch.zeros((), dtype=torch.int64, device=pos.device)
        for nb in self._nonbondeds:
            if nb.periodic and nb.has_direct:
                st = nb.build_state(pos, box, reach=nb.cutoff)
                energy = energy + nb.forward(pos, box, st)[0]
                overflow = overflow + st["overflow"]
            else:
                energy = energy + nb.forward(pos, box)[0]
        for m in self._gb + self._bonded + self._custom:
            energy = energy + m.energy(pos, box)
        return energy, overflow

    def _run_attempt(self, k, pos, box, u):
        """Barostat k's attempt from the uniforms u: writes the box and the
        statistics in place; returns (positions, overflow of its trial
        states)."""
        baro = self._barostats[k]
        out = baro.attempt(pos, box, u, self._gp, self._trial_energy)
        box.copy_(out["box"])
        baro.store(out)
        return self._compute_vsites(out["positions"]), out["overflow"]

    def _attempt_eager(self, k, step, pos, box, u):
        """The eager loop's gate: a host `if` on the host step count."""
        if not self._barostats[k].fires_at(self._state["step"]):
            return pos
        pos, overflow = self._run_attempt(k, pos, box, u)
        self._overflow = self._overflow + overflow
        return pos

    def _step_tensors(self) -> list:
        """The device tensors a step writes in place that the programs
        share: the box, the clock, the integrator's parameters (a
        variable step size), every barostat's statistics and the
        integrator's own state."""
        return ([self._box, self._time, self._params]
                + [t for b in self._barostats for t in b.statistics()]
                + self._integrator._state_tensors())

    # -- constraints and virtual sites -------------------------------------
    def _compute_vsites(self, pos):
        """pos with the virtual sites' rows computed from their parents."""
        return pos if self._vsites is None else self._vsites.compute(pos)

    def _constrain_positions(self, ref, new):
        """(constrained, corr): SETTLE, then SHAKE, then CCMA, with corr the
        sum of their corrections, exactly zero off the constrained atoms
        (None without constraints), as the JAX Context sums it
        (apply_position_constraints_corr)."""
        corr = None
        if self._settle is not None:
            corr = self._settle.position_corrections(ref, new)
            new = new + corr
        for stage in (self._shake, self._ccma):
            if stage is not None:
                out = stage.apply_positions(ref, new)
                c = out - new
                new = out
                corr = c if corr is None else corr + c
        return new, corr

    def _constrain_velocities(self, pos, vel):
        for stage in (self._settle, self._shake, self._ccma):
            if stage is not None:
                vel = stage.apply_velocities(pos, vel)
        return vel

    # -- forces ------------------------------------------------------------
    def _refresh_tiles(self, pos, box):
        """Rebuild the candidate state when the predicate fires."""
        nb = self._candidates
        if nb is None:
            return
        if self._tiles is None or bool(needs_rebuild(
                pos, self._ref_pos, nb.skin, box, self._ref_box)):
            self._tiles = nb.build_state(pos, box)
            # copies: an integrator may move `pos` in place
            self._ref_pos = pos.clone()
            self._ref_box = box.clone()
            self._overflow = self._overflow + self._tiles["overflow"]
            self.rebuild_count += 1

    def _evaluate(self, pos, box, tiles, groups=-1):
        """(energy float64 scalar, forces (n, 3) float64) of the forces in
        `groups` (a bit mask) at `pos`, the nonbonded one through the
        candidate state `tiles`; the forces add in the order of the
        System's forces, the NonbondedForce first, then the
        GBSAOBCForces."""
        parts = [nb(pos, box, self._module_state(nb, tiles), groups)
                 for nb in self._nonbondeds if nb.active(groups)]
        parts += [m.ef(pos, box) for m in self._gb + self._bonded
                  if (groups >> m.group) & 1]
        parts += [self._custom_ef(m, pos, box, tiles) for m in self._custom
                  if (groups >> m.group) & 1]
        if not parts:
            return (torch.zeros((), dtype=torch.float64, device=pos.device),
                    torch.zeros(pos.shape, dtype=torch.float64,
                                device=pos.device))
        energy, forces = parts[0][0], parts[0][1].to(torch.float64)
        for e, f in parts[1:]:
            energy = energy + e
            forces = forces + f.to(torch.float64)
        if self._vsites is not None:
            forces = self._vsites.distribute(pos, forces)
        return energy, forces

    def _custom_ef(self, m, pos, box, tiles):
        """(energy, forces) of custom module m; a module that reads the
        Context's candidate states is handed its part of `tiles`: a
        periodic AMOEBA force its pair lists' (pair_set), a CustomCVForce
        over periodic NonbondedForces a lookup of each variable's
        (tiled)."""
        if getattr(m, "pair_set", None) is not None:
            return m.ef(pos, box, self._module_state(m.pair_set, tiles))
        if getattr(m, "tiled", None):
            return m.ef(pos, box, lambda nb: self._module_state(nb, tiles))
        return m.ef(pos, box)

    def _module_state(self, nb, tiles):
        """The candidate state of NonbondedModule nb within `tiles` (None
        for a module that keeps none)."""
        if isinstance(self._candidates, CandidateSet):
            return self._candidates.module_state(nb, tiles)
        return tiles if nb is self._candidates else None

    def _forces_for_step(self, pos, box, groups=-1):
        self._refresh_tiles(pos, box)
        return self._evaluate(pos, box, self._tiles, groups)

    def _current_tiles(self):
        """The candidate state at the current state, for a reading between
        steps: one that overflows its capacity grows it and is built
        again (the retry of _step), where a step's evaluation would be
        poisoned with NaN."""
        pos, box = self._state["positions"], self._state["box"]
        tries = 0
        self._refresh_tiles(pos, box)
        while self._tiles is not None and int(self._tiles["overflow"]) > 0:
            tries = self._grow_capacity(tries)
            self._refresh_tiles(pos, box)
        return self._tiles

    def _forces_now(self, groups=-1):
        """The forces in `groups` at the current state, for a reading
        between steps (_current_tiles)."""
        tiles = self._current_tiles()
        return self._evaluate(self._state["positions"], self._state["box"],
                              tiles, groups)

    def _replica_forces(self, key, pos_all, box, mask):
        """The eager loop's forces at several configurations
        (replicas.py), the rebuild read on the host."""

        def on_rebuild(overflow):
            self._overflow = self._overflow + overflow
            self.rebuild_count += 1

        return self._replicas.forces(key, pos_all, box, mask, branch_host,
                                     on_rebuild)

    def _integration_forces(self, pos, box):
        """The eager loop's force evaluation: the integration groups."""
        return self._forces_for_step(
            pos, box, self._integrator.getIntegrationForceGroups())

    def _make_position_energy_fn(self):
        """(positions (n, 3) float64 numpy) -> (energy float, forces (n, 3)
        float64 numpy): the potential energy of every force at those
        positions and minus its gradient by autograd, on this Context's
        device in its precision (the bonded forces in float64), with its
        current box. Used by LocalEnergyMinimizer; the Context's own state
        is not touched."""

        def evaluate(positions):
            x = torch.as_tensor(np.asarray(positions, np.float64),
                                dtype=torch.float64, device=self._device)
            x.requires_grad_(True)
            # the sites from their parents: autograd spreads their forces
            pos = self._compute_vsites(x)
            box = self._state["box"]
            energy = torch.zeros((), dtype=torch.float64, device=self._device)
            for nb in self._nonbondeds:
                energy = energy + nb.potential_energy(pos, box)
            for m in self._gb + self._bonded + self._custom:
                energy = energy + m.energy(pos, box)
            (grad,) = torch.autograd.grad(energy, x)
            self.energy_evaluations += 1
            return float(energy.detach()), -grad.cpu().numpy()

        return evaluate

    # -- accessors -----------------------------------------------------------
    def getSystem(self):
        return self._system

    def getIntegrator(self):
        return self._integrator

    def getPlatform(self):
        return self._platform

    def getStepCount(self) -> int:
        return self._state["step"]

    def setStepCount(self, count) -> None:
        self._state["step"] = int(count)

    def getTime(self):
        return u.Quantity(float(self._time), u.picosecond)

    def setTime(self, time) -> None:
        self._time.fill_(float(u.strip(time, u.picosecond)))

    def getMolecules(self) -> list:
        """The atoms of each molecule, molecules in the JAX Context's
        order."""
        out = [[] for _ in range(self._n_molecules)]
        for atom, mol in enumerate(self._molecule_id):
            out[mol].append(atom)
        return out

    def setPeriodicBoxVectors(self, a, b, c) -> None:
        """Write a new box (reduced form) into the box tensor; the next
        force evaluation rebuilds the candidate state for it. PME's alpha
        and grid stay those of the System's default box."""
        box = reduced_box(*(u.strip(v, u.nanometer) for v in (a, b, c)))
        for nb in self._nonbondeds:
            if nb.periodic and nb.cutoff >= 0.5 * min(np.diag(box)):
                raise ValueError("the cutoff must be below half the box "
                                 "width")
        self._box.copy_(torch.as_tensor(box, dtype=torch.float64))

    def getParameter(self, name) -> float:
        if name not in self._gp_index:
            raise ValueError("Called getParameter() with invalid parameter "
                             "name: " + name)
        return float(self._gp[self._gp_index[name]])

    def getParameters(self) -> dict:
        values = self._gp.tolist()
        return {name: values[i] for name, i in self._gp_index.items()}

    def setParameter(self, name, value) -> None:
        """A new value for a global parameter, written into its device
        scalar: the steps read it from there, so no program is rebuilt."""
        if name not in self._gp_index:
            raise ValueError("Called setParameter() with invalid parameter "
                             "name: " + name)
        self._gp[self._gp_index[name]] = float(u.strip(value))

    def setState(self, state) -> None:
        """Restore the box, the time, the step count, and what the State
        holds of positions, velocities, this Context's global parameters
        and the integrator's parameters (Context::setState; the JAX
        Context's setState)."""
        self.setPeriodicBoxVectors(*state.getPeriodicBoxVectors(asNumpy=True))
        self.setTime(state.getTime())
        self.setStepCount(state.getStepCount())
        types = state.getDataTypes()
        if types & State.Positions:
            self.setPositions(state.getPositions(asNumpy=True))
        if types & State.Velocities:
            self.setVelocities(state.getVelocities(asNumpy=True))
        if types & State.Parameters:
            for name, value in state.getParameters().items():
                if name in self._gp_index:
                    self.setParameter(name, value)
        if types & State.IntegratorParameters:
            self._set_integrator_parameters(state.getIntegratorParameters())

    def _integrator_parameters(self) -> dict:
        """{name: value} of the integrator's parameters as the next step
        reads them from the device (_named_params), the host's written
        first: what the JAX Context keeps in state["iparams"]."""
        self._write_params()
        start, names = self._integrator._named_params()
        values = self._params[start:start + len(names)].tolist()
        return dict(zip(names, values))

    def _set_integrator_parameters(self, values: dict) -> None:
        """Write the integrator's parameters of `values` (keys of
        _named_params; others are ignored) into the step's device tensor.
        They hold until an integrator setter changes the host's values,
        as the JAX Context's state["iparams"] does."""
        self._write_params()
        start, names = self._integrator._named_params()
        params = self._params.tolist()
        for name, value in values.items():
            if name in names:
                params[start + names.index(name)] = float(value)
        self._params.copy_(torch.tensor(params, dtype=torch.float64))

    def _set_position_tensor(self, pos) -> None:
        """New positions: the candidate state built for the old ones is
        dropped, so the next force evaluation rebuilds it."""
        self._state["positions"] = pos
        self._tiles = None
        self._ref_pos = None

    def setPositions(self, positions) -> None:
        pos = np.array(u.strip(positions, u.nanometer), np.float64)
        if pos.shape != (self._n, 3):
            raise ValueError("setPositions: expected (%d, 3), got %s"
                             % (self._n, pos.shape))
        self._set_position_tensor(self._compute_vsites(torch.as_tensor(
            pos, dtype=torch.float64, device=self._device)))
        self._positions_set = True

    def setVelocities(self, velocities) -> None:
        vel = np.array(u.strip(velocities, u.nanometer / u.picosecond),
                       np.float64)
        if vel.shape != (self._n, 3):
            raise ValueError("setVelocities: wrong shape")
        self._state["velocities"] = torch.as_tensor(
            vel, dtype=torch.float64, device=self._device)

    def setVelocitiesToTemperature(self, temperature, randomSeed=None):
        """Maxwell-Boltzmann velocities at `temperature` K from a generator
        seeded with randomSeed (0 for a massless particle), then the
        velocity constraints."""
        gen = torch.Generator(device=self._device)
        gen.manual_seed(int(randomSeed) if randomSeed is not None
                        else int(np.random.randint(1, 2 ** 31 - 1)))
        sigma = torch.sqrt(BOLTZ * float(u.strip(temperature, u.kelvin))
                           * self._inv_masses)
        v = sigma[:, None] * torch.randn((self._n, 3), generator=gen,
                                         dtype=torch.float64,
                                         device=self._device)
        self._state["velocities"] = self._constrain_velocities(
            self._state["positions"], v)

    def applyConstraints(self) -> None:
        pos = self._state["positions"]
        self._set_position_tensor(self._compute_vsites(
            self._constrain_positions(pos, pos)[0]))

    def applyVelocityConstraints(self) -> None:
        """Remove the velocities' components along the constraints."""
        self._state["velocities"] = self._constrain_velocities(
            self._state["positions"], self._state["velocities"])

    def computeVirtualSites(self) -> None:
        """Set the virtual sites' positions from their parents'."""
        self._set_position_tensor(self._compute_vsites(
            self._state["positions"]))

    # -- parameters in the Context -------------------------------------------
    def _nonbonded_module(self, force):
        module = self._modules.get(id(force))
        if module is None or module not in self._nonbondeds:
            raise ValueError("the force is not a NonbondedForce of this "
                             "Context")
        return module

    def _update_force_parameters(self, force) -> None:
        """A force's updateParametersInContext: its module's buffers
        rewritten in place, and the candidate state, which may hold the
        old parameters, dropped so that the next evaluation rebuilds it
        (as the JAX Context sets ref_pos to inf)."""
        module = self._modules.get(id(force))
        if module is None:
            raise ValueError("updateParametersInContext: the force is not "
                             "part of this Context's System")
        module.update(force)
        self._tiles = None
        self._ref_pos = None

    # -- stepping ----------------------------------------------------------------
    def _snapshot(self):
        """A copy of what a step changes: the state's tensors, the candidate
        state with the positions and the box of its build, the generator,
        and the tensors written in place (_step_tensors: the box, the
        clock, the parameters, the barostats' statistics, the
        integrator's state), and the candidate state's capacity scale,
        which the copied state was built at. Copies, because a step
        program updates its buffers in place. The integrator's host
        parameters are written first, so that the copy holds what the
        next step would read."""
        self._write_params()
        state = dict(self._state)
        for key in ("positions", "velocities"):
            state[key] = state[key].clone()
        tiles = (None if self._tiles is None else
                 {k: v.clone() for k, v in self._tiles.items()})
        refs = tuple(None if r is None else r.clone()
                     for r in (self._ref_pos, self._ref_box))
        shared = [t.clone() for t in self._step_tensors()]
        scale = (None if self._candidates is None
                 else self._candidates.capacity_scale)
        return (state, self._generator.get_state(), tiles, refs, shared,
                self._params_written, scale)

    def _restore(self, snap):
        state, gen_state, tiles, refs, shared, written, scale = snap
        if scale is not None:
            self._candidates.capacity_scale = scale
        self._params_written = written
        self._state = dict(state)
        self._generator.set_state(gen_state)
        self._tiles = tiles
        self._ref_pos, self._ref_box = refs
        for t, value in zip(self._step_tensors(), shared):
            t.copy_(value)

    # -- checkpoints ---------------------------------------------------------
    def createCheckpoint(self) -> bytes:
        """The Context's state as bytes: an npz archive (no pickle) of
        what a snapshot holds (_snapshot: positions, velocities, the step
        count, the generator, the candidate state with the positions and
        the box of its build, the step tensors: box, clock, integrator
        parameters, barostat statistics, integrator state; the capacity
        scale) and the global parameters, headed by the port's magic and
        the particle count."""
        state, gen, tiles, refs, shared, written, scale = self._snapshot()
        arrays = {
            "header": np.asarray([CHECKPOINT_MAGIC, str(self._n),
                                  str(len(shared)), str(tiles is not None)]),
            "positions": _host(state["positions"]),
            "velocities": _host(state["velocities"]),
            "step": np.asarray(state["step"], np.int64),
            "generator": gen.numpy(),
            "params_written": np.asarray(written, np.float64),
            "capacity_scale": np.asarray(np.nan if scale is None else scale),
            "global_parameters": _host(self._gp),
        }
        for i, t in enumerate(shared):
            arrays["shared_%d" % i] = _host(t)
        if tiles is not None:
            arrays.update({"tiles_" + k: _host(v) for k, v in tiles.items()})
            arrays["ref_pos"], arrays["ref_box"] = (_host(r) for r in refs)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    def loadCheckpoint(self, checkpoint: bytes) -> None:
        """Restore a createCheckpoint of a Context of the same System:
        the run continues bit for bit. Raises ValueError on bytes that are
        no such checkpoint, or whose particle count or tensors' shapes do
        not match this Context's."""
        try:
            data = np.load(io.BytesIO(checkpoint), allow_pickle=False)
        except Exception as err:
            raise ValueError("Invalid checkpoint data") from err
        with data:
            if "header" not in data.files \
                    or str(data["header"][0]) != CHECKPOINT_MAGIC:
                raise ValueError("Invalid checkpoint data")
            header = data["header"]
            if int(header[1]) != self._n:
                raise ValueError("Checkpoint has wrong number of particles")
            shared_now = self._step_tensors()
            if int(header[2]) != len(shared_now):
                raise ValueError("Checkpoint does not match this Context's "
                                 "structure")
            arrays = {k: data[k] for k in data.files}
        dev = self._device

        def tensor(key, like):
            value = arrays[key]
            if tuple(value.shape) != tuple(like.shape):
                raise ValueError("Checkpoint entry %s has shape %s, this "
                                 "Context %s" % (key, value.shape,
                                                 tuple(like.shape)))
            return torch.as_tensor(value, dtype=like.dtype, device=dev)

        like = torch.empty((self._n, 3), dtype=torch.float64)
        state = dict(self._state)
        state["positions"] = tensor("positions", like)
        state["velocities"] = tensor("velocities", like)
        state["step"] = int(arrays["step"])
        shared = [tensor("shared_%d" % i, t)
                  for i, t in enumerate(shared_now)]
        gp = tensor("global_parameters", self._gp)
        tiles = refs = None
        scale = float(arrays["capacity_scale"])
        if header[3] == "True":
            if self._candidates is None:
                raise ValueError("Checkpoint holds a candidate state this "
                                 "Context has none of")
            tiles = {k[len("tiles_"):]: torch.as_tensor(v, device=dev)
                     for k, v in arrays.items() if k.startswith("tiles_")}
            refs = (torch.as_tensor(arrays["ref_pos"], device=dev),
                    torch.as_tensor(arrays["ref_box"], device=dev))
        else:
            refs = (None, None)
        self._restore((state, torch.as_tensor(arrays["generator"]), tiles,
                       refs, shared,
                       tuple(float(x) for x in arrays["params_written"]),
                       None if np.isnan(scale) else scale))
        self._gp.copy_(gp)
        self._positions_set = True

    def reinitialize(self, preserveState=False) -> None:
        """Build the Context anew from its System (forces changed since
        are taken up); with preserveState the state is restored, from a
        checkpoint where the structure allows, else positions, velocities,
        box, clock, step count and global parameters."""
        checkpoint = state = None
        if preserveState:
            checkpoint = self.createCheckpoint()
            state = self.getState(getPositions=True, getVelocities=True,
                                  getParameters=True)
        integrator = self._integrator
        integrator._context = None
        self.__init__(self._system, integrator, self._platform,
                      self._properties)
        if checkpoint is None:
            return
        try:
            self.loadCheckpoint(checkpoint)
        except ValueError:
            self.setState(state)

    def _write_params(self) -> None:
        """The integrator's parameters into the step's device tensor, when
        they changed since the last write."""
        params = self._integrator._params()
        if params != self._params_written:
            self._deps.params.copy_(torch.tensor(params,
                                                 dtype=torch.float64))
            self._params_written = params

    def _step_size_tensor(self) -> torch.Tensor:
        """The device scalar of the integrator's current step size, a view
        of the parameters: what a step adds to the clock."""
        return self._params[self._integrator._dt_index()]

    def _escalate(self, snap, tries: int) -> int:
        """Undo an overflowing chunk and grow the capacity."""
        self._restore(snap)
        return self._grow_capacity(tries)

    def _grow_capacity(self, tries: int) -> int:
        """Grow the candidate state's capacity by 1.4x and drop the
        state built at the old one; raises after MAX_ESCALATIONS tries."""
        tries += 1
        if tries > MAX_ESCALATIONS:
            raise RuntimeError("neighbour-list capacity escalation failed "
                               "to converge")
        self._candidates.capacity_scale *= 1.4
        self._tiles = None
        self.escalation_count += 1
        return tries

    def _program(self) -> StepProgram:
        nb = self._candidates
        groups = self._integrator.getIntegrationForceGroups()
        key = (None if nb is None else nb.capacity_scale, groups,
               self._integrator._program_key())
        if key not in self._programs:
            self._programs[key] = StepProgram(self, groups)
        return self._programs[key]

    def _eager_step_fn(self):
        key = self._integrator._program_key()
        if key not in self._eager_fns:
            self._eager_fns[key] = self._integrator._make_step_fn(
                self._deps)
        return self._eager_fns[key]

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
            overflow, rebuilds = program.finish(this)
            program.store()
            self.rebuild_count += rebuilds
            self._state["step"] += this
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
            self._deps.step.fill_(self._state["step"])
            # the replica sets are rebuilt at a chunk's first step, as
            # the step program rebuilds them (replicas.py)
            self._replicas.sets.clear()
            state = self._state
            step_fn, dt = self._eager_step_fn(), self._step_size_tensor()
            for _ in range(this):
                state["positions"], state["velocities"] = step_fn(
                    state["positions"], state["velocities"], state["box"])
                self._time.add_(dt)
                state["step"] += 1
            self.issue_seconds += time.perf_counter() - t0
            if int(self._overflow) > 0:
                tries = self._escalate(snap, tries)
                continue
            remaining -= this

    # -- state -----------------------------------------------------------------
    def getState(self, getEnergy=False, getForces=False, getPositions=False,
                 getVelocities=False, getParameters=False,
                 enforcePeriodicBox=False, groups=-1,
                 getParameterDerivatives=False,
                 getIntegratorParameters=False) -> State:
        """A State; energy, forces and parameter derivatives sum the forces
        in `groups`: a bit mask (-1, the default: all) or a collection of
        group numbers.
        The kinetic energy shifts the velocities by the integrator's
        _kinetic_energy_shift with these forces, as the JAX Context
        does. enforcePeriodicBox wraps each molecule whole into the home
        box when the System uses periodic boundaries.
        getIntegratorParameters: the integrator's parameters as the next
        step reads them (_integrator_parameters)."""
        s = self._state
        box = _host(s["box"])
        kw = {"time": float(self._time), "step": s["step"], "box": box}
        if getEnergy or getForces:
            if not self._positions_set:
                raise RuntimeError("Particle positions have not been set")
            energy, forces = self._forces_now(_group_mask(groups))
            if getEnergy:
                kw["potential_energy"] = float(energy)
                kw["kinetic_energy"] = self.kinetic_energy(forces)
            if getForces:
                kw["forces"] = forces.cpu().numpy()
        if getPositions:
            pos = _host(s["positions"])
            kw["positions"] = (
                self._wrap_positions(pos, box) if enforcePeriodicBox
                and self._system.usesPeriodicBoundaryConditions() else pos)
        if getVelocities:
            kw["velocities"] = _host(s["velocities"])
        if getParameters:
            kw["parameters"] = self.getParameters()
        if getParameterDerivatives:
            if not self._positions_set:
                raise RuntimeError("Particle positions have not been set")
            kw["parameter_derivatives"] = self._parameter_derivatives(
                _group_mask(groups))
        if getIntegratorParameters:
            kw["integrator_parameters"] = self._integrator_parameters()
        return State(**kw)

    def _parameter_derivatives(self, groups) -> dict:
        """{name: dE/dname} of the requested parameters, summed over the
        custom forces and, through their offsets, the NonbondedForces in
        `groups` (0 where none reads the parameter)."""
        pos, box = self._state["positions"], self._state["box"]
        totals = {name: 0.0 for name in self._deriv_names}
        for m in self._custom:
            if (groups >> m.group) & 1:
                for name, value in m.parameter_derivatives(pos, box).items():
                    totals[name] += float(value)
        offsets = [nb for nb in self._nonbondeds
                   if nb.offset_names & set(self._deriv_names)
                   and nb.active(groups)]
        if offsets:
            tiles = self._current_tiles()
            for nb in offsets:
                for name, value in nb.parameter_derivatives(
                        pos, box, self._module_state(nb, tiles), groups,
                        self._deriv_names).items():
                    totals[name] += float(value)
        return totals

    def _wrap_positions(self, pos, box):
        """Each molecule shifted by box vectors so that its centre of mass
        lies in the home box (Context.cpp:122-143, the JAX Context's
        _wrap_positions)."""
        mol = self._molecule_id
        m = self._masses.cpu().numpy()
        w = np.where(m == 0, 1e-10, m)
        num = np.zeros((self._n_molecules, 3))
        den = np.zeros(self._n_molecules)
        np.add.at(num, mol, w[:, None] * pos)
        np.add.at(den, mol, w)
        center = num / den[:, None]
        diff = np.zeros_like(center)
        for axis in (2, 1, 0):
            shift = np.floor(center[:, axis] / box[axis][axis])
            center -= shift[:, None] * box[axis][None, :]
            diff += shift[:, None] * box[axis][None, :]
        return pos - diff[mol]

    def kinetic_energy(self, forces=None) -> float:
        """The integrator's kinetic energy (Integrator._kinetic_energy):
        0.5 sum m (v + s dt f / m)^2 with s its _kinetic_energy_shift (0.5
        for leapfrog velocities, 0 for LangevinMiddle's and Brownian's),
        dt the step size on the device and f `forces`, (n, 3) float64 on
        the device; a CustomIntegrator's kinetic-energy expression. Without
        forces, the forces of every group where the integrator needs them
        (what getState(getEnergy=True) reports)."""
        integ = self._integrator
        if forces is None and integ._kinetic_energy_requires_force():
            forces = self._forces_now()[1]
        return float(integ._kinetic_energy(self, forces,
                                           self._step_size_tensor()))

    def degrees_of_freedom(self) -> int:
        """Three for each particle with mass, less the constraints, less 3
        when a CMMotionRemover holds the centre of mass still (as
        StateDataReporter counts them)."""
        dof = 3 * self._n_massive - self._system.getNumConstraints()
        return dof - 3 if self._has_cm_remover else dof

    def temperature(self) -> float:
        """Instantaneous temperature from the kinetic energy
        (kinetic_energy()) over degrees_of_freedom()."""
        return 2.0 * self.kinetic_energy() / (self.degrees_of_freedom()
                                              * BOLTZ)
