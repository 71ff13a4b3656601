"""CustomManyParticleForce: an energy of every set of N particles
(Stillinger-Weber, Axilrod-Teller, ...), with type filters and the two
permutation modes.

Counterpart of openmm_tpu/forces/custommanyparticle.py
(CustomManyParticleForce.h). As the JAX package does, the sets are
enumerated on the host when the Context is built (_enumerate_tuples, the
port's own copy: the exclusions, the type filters and the permutation
mode decide them) and evaluated as one sweep of forces/custom.py's points
module: the expression reads the points p1..pN, their coordinates
x1..zN, each particle's parameters as name1..nameN and the global
parameters; a set counts only while every particle lies within the
cutoff of the first (minimum images with CutoffPeriodic), a mask a step.
float64, the geometry's gradients by hand and the sums by a gather
table.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .. import unit as u
from ..ops import geometry as geom
from .base import Force
from .custom import _CustomMixin, _params, _PointsModule

# the most sets the enumeration lists (the JAX package's limit)
MAX_SETS = 8_000_000


class CustomManyParticleForce(_CustomMixin, Force):
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    SinglePermutation = 0
    UniqueCentralParticle = 1

    def __init__(self, particlesPerSet, energy):
        super().__init__()
        self._init_custom(energy)
        self._n_per_set = int(particlesPerSet)
        self._per_particle = []
        self._particles = []          # (params, type)
        self._exclusions = []
        self._type_filters = {}       # slot -> allowed types
        self._mode = CustomManyParticleForce.SinglePermutation
        self._method = CustomManyParticleForce.NoCutoff
        self._cutoff = 1.0

    def getNumParticlesPerSet(self) -> int:
        return self._n_per_set

    def getNumPerParticleParameters(self) -> int:
        return len(self._per_particle)

    def addPerParticleParameter(self, name) -> int:
        self._per_particle.append(str(name))
        return len(self._per_particle) - 1

    def getPerParticleParameterName(self, index) -> str:
        return self._per_particle[index]

    def getNumParticles(self) -> int:
        return len(self._particles)

    def addParticle(self, parameters=(), type=0) -> int:  # noqa: A002
        self._particles.append(([float(u.strip(p)) for p in parameters],
                                int(type)))
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        params, t = self._particles[index]
        return list(params), t

    def setParticleParameters(self, index, parameters=(),
                              type=0) -> None:  # noqa: A002
        self._particles[index] = ([float(u.strip(p)) for p in parameters],
                                  int(type))

    def getTypeFilter(self, index):
        return sorted(self._type_filters.get(index, set()))

    def setTypeFilter(self, index, types) -> None:
        self._type_filters[int(index)] = set(int(t) for t in types)

    def getNumExclusions(self) -> int:
        return len(self._exclusions)

    def addExclusion(self, particle1, particle2) -> int:
        self._exclusions.append((int(particle1), int(particle2)))
        return len(self._exclusions) - 1

    def getExclusionParticles(self, index):
        return self._exclusions[index]

    def setExclusionParticles(self, index, particle1, particle2) -> None:
        self._exclusions[index] = (int(particle1), int(particle2))

    def createExclusionsFromBonds(self, bonds, bondCutoff) -> None:
        """Exclude the particle pairs within bondCutoff bonds of each
        other."""
        bonded = {}
        for b1, b2 in bonds:
            bonded.setdefault(int(b1), set()).add(int(b2))
            bonded.setdefault(int(b2), set()).add(int(b1))
        excl = set()
        for i in bonded:
            cur = {i}
            for _ in range(bondCutoff):
                nxt = set()
                for a in cur:
                    nxt |= bonded.get(a, set())
                cur = nxt
                for j in cur:
                    if j != i:
                        excl.add((min(i, j), max(i, j)))
        for i, j in sorted(excl):
            self.addExclusion(i, j)

    def getPermutationMode(self) -> int:
        return self._mode

    def setPermutationMode(self, mode) -> None:
        self._mode = int(mode)

    def getNonbondedMethod(self) -> int:
        return self._method

    def setNonbondedMethod(self, method) -> None:
        self._method = int(method)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setCutoffDistance(self, distance) -> None:
        self._cutoff = float(u.strip(distance, u.nanometer))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method == CustomManyParticleForce.CutoffPeriodic

    def _enumerate_tuples(self) -> np.ndarray:
        """(sets, N) particles of every set that counts, in the JAX
        package's order: SinglePermutation takes each combination once,
        as the first ordering of it that the type filters accept;
        UniqueCentralParticle takes each particle as the first of the set
        with each combination of the others."""
        n = len(self._particles)
        k = self._n_per_set
        types = [p[1] for p in self._particles]
        filters = self._type_filters
        excluded = {(min(a, b), max(a, b)) for a, b in self._exclusions}

        def allowed(tup):
            return not any((min(a, b), max(a, b)) in excluded
                           for a, b in itertools.combinations(tup, 2))

        if self._mode == CustomManyParticleForce.SinglePermutation:
            return self._single_permutation(n, k, types, filters, excluded)
        tuples = []
        for center in range(n):
            if filters.get(0) and types[center] not in filters[0]:
                continue
            others = [i for i in range(n) if i != center]
            for rest in itertools.combinations(others, k - 1):
                tup = (center,) + rest
                if allowed(tup) and all(
                        not filters.get(slot) or types[p] in filters[slot]
                        for slot, p in enumerate(tup)):
                    tuples.append(tup)
            if len(tuples) > MAX_SETS:
                break
        if len(tuples) > MAX_SETS:
            raise ValueError("CustomManyParticleForce: more than %d particle "
                             "sets; a neighbour-list enumeration is not in "
                             "this slice of the port" % MAX_SETS)
        return np.asarray(tuples, np.int64).reshape(-1, k)

    def _single_permutation(self, n, k, types, filters, excluded):
        """SinglePermutation's sets, vectorized over the combinations (in
        itertools.combinations' order): the excluded ones dropped, each
        taken in the first ordering (itertools.permutations' order) that
        the type filters accept, dropped where none does."""
        count = math.comb(n, k) if n >= k else 0
        if count > MAX_SETS:
            raise ValueError("CustomManyParticleForce: more than %d particle "
                             "sets; a neighbour-list enumeration is not in "
                             "this slice of the port" % MAX_SETS)
        combos = np.fromiter(itertools.chain.from_iterable(
            itertools.combinations(range(n), k)), np.int64,
            count * k).reshape(-1, k)
        if excluded:
            table = np.zeros((n, n), bool)
            for a, b in excluded:
                table[a, b] = table[b, a] = True
            keep = np.ones(len(combos), bool)
            for a, b in itertools.combinations(range(k), 2):
                keep &= ~table[combos[:, a], combos[:, b]]
            combos = combos[keep]
        if not filters:
            return combos
        types = np.asarray(types)
        chosen = np.full(len(combos), -1)
        perms = list(itertools.permutations(range(k)))
        for p, perm in enumerate(perms):
            fits = np.ones(len(combos), bool)
            for slot, src in enumerate(perm):
                if filters.get(slot):
                    fits &= np.isin(types[combos[:, src]],
                                    list(filters[slot]))
            chosen = np.where((chosen < 0) & fits, p, chosen)
        combos = combos[chosen >= 0]
        order = np.asarray(perms)[chosen[chosen >= 0]]
        return np.take_along_axis(combos, order, axis=1)

    def _terms_arrays(self):
        """(sets, N) particles and (sets, N * parameters), each parameter
        of each slot (name1..nameN, parameter-major)."""
        idx = self._enumerate_tuples()
        par = _params([p[0] for p in self._particles],
                      len(self._per_particle))
        per_slot = [par[idx[:, slot], k] for k in range(par.shape[1])
                    for slot in range(self._n_per_set)]
        return idx, np.stack(per_slot, axis=1).reshape(len(idx), -1) \
            if per_slot else np.zeros((len(idx), 0))

    def _compile(self, ctx):
        return _ManyParticleModule(self, ctx)


class _ManyParticleModule(_PointsModule):
    def __init__(self, force, ctx):
        idx, params = force._terms_arrays()
        k = force._n_per_set
        super().__init__(force, ctx, idx, params,
                         ["p%d" % (s + 1) for s in range(k)],
                         names=["%s%d" % (name, s + 1)
                                for name in force._per_particle
                                for s in range(k)])
        self.cutoff = (None if force.getNonbondedMethod()
                       == CustomManyParticleForce.NoCutoff
                       else force.getCutoffDistance())

    def _points(self, pos):
        return pos[self.idx]

    def _mask(self, pos, box):
        if self.cutoff is None:
            return None
        box = box.to(torch.float64) if self.periodic else None
        first = pos[self.idx[:, 0]]
        ok = None
        for slot in range(1, self.n_points):
            d = geom.delta(pos[self.idx[:, slot]], first, box)
            near = (d * d).sum(dim=-1) < self.cutoff * self.cutoff
            ok = near if ok is None else ok & near
        return ok
