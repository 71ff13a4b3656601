"""CustomGBForce: generalized-Born-style forces written as expressions.

Counterpart of openmm_tpu/forces/customgb.py (the API of OpenMM's
CustomGBForce.h): per-particle computed values in stages, each a sum of a
pair expression over the other particles (ParticlePair, or
ParticlePairNoExclusions, which keeps the excluded pairs) or an
expression of one particle's own parameters, position and earlier values
(SingleParticle); then energy terms, each a sum over particles
(SingleParticle) or over unordered pairs (ParticlePair,
ParticlePairNoExclusions). A pair expression reads r, each per-particle
parameter and each earlier value as name1 and name2 (particle 1 the row,
the lower index in an energy term), the global parameters and the
tabulated functions; a single-particle one reads x, y, z, the parameters,
the earlier values and the globals.

The JAX package writes it as one differentiable program and takes forces
and parameter derivatives from jax.grad. The step here takes no autograd,
so the chain rule is OpenMM's reference order (ReferenceCustomGBIxn.cpp),
by hand, on the symbolic partials of each expression
(expressions/derivatives.py): the values forward; the energy terms with
their explicit forces and dE/dV of every value; the values backward, a
single-particle stage's x, y and z partials as forces and its partials in
earlier values carried to them; and one more pair sweep for each
pair-valued stage, its r partials times dE/dV of the row as pair forces.
Every pair sweep takes rows of particles against every particle in
chunks, each pair's displacement from the float64 positions rounded to
the Context's precision (as ops/custom_pairs.py takes it), and sums a
value, a force or a dE/dV over the columns of its row and over the rows
of its column in float64: no scatter, no float atomics. The per-particle
values and the single-particle stages are float64.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import unit as u
from ..expressions import compile_energy_derivatives, parse_inlined
from ..expressions.derivatives import free_variables
from ..ops import geometry as geom
from ..ops.pairs import build_exclusion_table
from .base import Force
from .custom import CustomModule, _CustomMixin, _full, _params

F64 = torch.float64
# pair elements a chunk of rows
PAIR_CHUNK = 1 << 23


class CustomGBForce(_CustomMixin, Force):
    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2
    SingleParticle = 0
    ParticlePair = 1
    ParticlePairNoExclusions = 2

    def __init__(self):
        super().__init__()
        self._init_custom("")
        self._per_particle = []
        self._particles = []
        self._values = []             # (name, expression, type)
        self._energy_terms = []       # (expression, type)
        self._exclusions = []
        self._method = CustomGBForce.NoCutoff
        self._cutoff = 1.0

    def getNumPerParticleParameters(self) -> int:
        return len(self._per_particle)

    def addPerParticleParameter(self, name) -> int:
        self._per_particle.append(str(name))
        return len(self._per_particle) - 1

    def getPerParticleParameterName(self, index) -> str:
        return self._per_particle[index]

    def getNumParticles(self) -> int:
        return len(self._particles)

    def addParticle(self, parameters=()) -> int:
        self._particles.append([float(u.strip(p)) for p in parameters])
        return len(self._particles) - 1

    def getParticleParameters(self, index):
        return list(self._particles[index])

    def setParticleParameters(self, index, parameters=()) -> None:
        self._particles[index] = [float(u.strip(p)) for p in parameters]

    def getNumComputedValues(self) -> int:
        return len(self._values)

    def addComputedValue(self, name, expression, type) -> int:  # noqa: A002
        self._values.append((str(name), str(expression), int(type)))
        return len(self._values) - 1

    def getComputedValueParameters(self, index):
        return self._values[index]

    def setComputedValueParameters(self, index, name, expression,
                                   type) -> None:  # noqa: A002
        self._values[index] = (str(name), str(expression), int(type))

    def getNumEnergyTerms(self) -> int:
        return len(self._energy_terms)

    def addEnergyTerm(self, expression, type) -> int:  # noqa: A002
        self._energy_terms.append((str(expression), int(type)))
        return len(self._energy_terms) - 1

    def getEnergyTermParameters(self, index):
        return self._energy_terms[index]

    def setEnergyTermParameters(self, index, expression,
                                type) -> None:  # noqa: A002
        self._energy_terms[index] = (str(expression), int(type))

    def getNumExclusions(self) -> int:
        return len(self._exclusions)

    def addExclusion(self, particle1, particle2) -> int:
        self._exclusions.append((int(particle1), int(particle2)))
        return len(self._exclusions) - 1

    def getExclusionParticles(self, index):
        return self._exclusions[index]

    def setExclusionParticles(self, index, particle1, particle2) -> None:
        self._exclusions[index] = (int(particle1), int(particle2))

    def getNonbondedMethod(self) -> int:
        return self._method

    def setNonbondedMethod(self, method) -> None:
        self._method = int(method)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setCutoffDistance(self, distance) -> None:
        self._cutoff = float(u.strip(distance, u.nanometer))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method == CustomGBForce.CutoffPeriodic

    def _compile(self, ctx) -> CustomModule:
        return CustomGBModule(self, ctx)


def _suffixed(names, k):
    return [name + str(k) for name in names]


class _Stage:
    """One computed value or energy term: pair or single, its expression's
    compiled energy and partials (without and with the parameter
    derivatives), and the names of the earlier values it may read."""

    def __init__(self, text, kind, earlier, derivs, functions_pair,
                 functions_single):
        self.pair = kind != CustomGBForce.SingleParticle
        self.exclusions = kind == CustomGBForce.ParticlePair
        self.earlier = list(earlier)
        if self.pair:
            coords = ["r"]
            values = _suffixed(earlier, 1) + _suffixed(earlier, 2)
            functions = functions_pair
        else:
            coords = ["x", "y", "z"]
            values = list(earlier)
            functions = functions_single
        self.value = compile_energy_derivatives(text, [], functions)
        self.wrt = coords + values
        self.fn = compile_energy_derivatives(text, self.wrt, functions)
        self.fn_d = compile_energy_derivatives(text, self.wrt + list(derivs),
                                               functions)


class CustomGBModule(CustomModule):
    """The compiled CustomGBForce: ef, energy, parameter_derivatives (the
    CustomModule contract), float64 but the pairs, which take the
    Context's precision."""

    def __init__(self, force, ctx):
        n = ctx._n
        if len(force._particles) != n:
            raise ValueError("CustomGBForce must have the same number of "
                             "particles as the System")
        probe = force._tables(F64, "cpu")
        variables = set()
        for text, _ in ([(v[1], v[2]) for v in force._values]
                        + force._energy_terms):
            variables |= free_variables(parse_inlined(text, probe))
        super().__init__(force, ctx, variables)
        dev = ctx._device
        self.dtype = F64 if ctx._precision == "double" else torch.float32
        self.names = list(force._per_particle)
        self.register_buffer("par", torch.as_tensor(
            _params(force._particles, len(self.names)), dtype=F64,
            device=dev))
        method = force.getNonbondedMethod()
        self.periodic = method == CustomGBForce.CutoffPeriodic
        self.cutoff = (None if method == CustomGBForce.NoCutoff
                       else force.getCutoffDistance())
        table = build_exclusion_table(n, force._exclusions)
        self.has_exclusions = bool(np.any(table >= 0))
        self.register_buffer("exclusions", torch.as_tensor(
            np.where(table >= 0, table, n), dtype=torch.int64, device=dev))
        pair_fns = force._tables(self.dtype, dev)
        single_fns = force._tables(F64, dev)
        self.value_names = [v[0] for v in force._values]
        self.values = [
            _Stage(text, kind, self.value_names[:k], self.derivs, pair_fns,
                   single_fns)
            for k, (_, text, kind) in enumerate(force._values)]
        self.terms = [_Stage(text, kind, self.value_names, self.derivs,
                             pair_fns, single_fns)
                      for text, kind in force._energy_terms]
        rows = max(1, PAIR_CHUNK // n)
        self.chunks = [(r0, min(n, r0 + rows)) for r0 in range(0, n, rows)]

    def update(self, force) -> None:
        self._put("par", _params(force._particles, len(self.names)))

    # -- the pairs --------------------------------------------------------------
    def _rows(self, pos, box, r0, r1, exclusions, half):
        """(displacements (rows, n, 3) in self.dtype, r (1 where a pair is
        not kept), keep) of particles r0:r1 against every particle: another
        particle, within the cutoff, not excluded (`exclusions`), of a
        higher index (`half`)."""
        n = self.n
        dev = pos.device
        d = pos[r0:r1, None, :] - pos[None, :, :]
        if box is not None:
            d = geom.periodic_delta(d, box)
        d = d.to(self.dtype)
        dx, dy, dz = d.unbind(-1)
        r2 = dx * dx + dy * dy + dz * dz
        rows = torch.arange(r0, r1, device=dev)[:, None]
        cols = torch.arange(n, device=dev)[None, :]
        keep = cols > rows if half else rows != cols
        if exclusions and self.has_exclusions:
            skip = torch.zeros((r1 - r0, n + 1), dtype=torch.bool,
                               device=dev)
            skip.scatter_(1, self.exclusions[r0:r1], True)
            keep = keep & ~skip[:, :n]
        if self.cutoff is not None:
            keep = keep & (r2 < self.cutoff * self.cutoff)
        return d, torch.sqrt(torch.where(keep, r2, 1.0)), keep

    def _pair_env(self, r, r0, r1, values, earlier, gp):
        env = dict(gp)
        env["r"] = r
        dt = self.dtype
        for k, name in enumerate(self.names):
            env[name + "1"] = self.par[r0:r1, k].to(dt)[:, None]
            env[name + "2"] = self.par[:, k].to(dt)[None, :]
        for name in earlier:
            v = values[name].to(dt)
            env[name + "1"] = v[r0:r1, None]
            env[name + "2"] = v[None, :]
        return env

    def _single_env(self, pos, values, earlier, gp):
        env = dict(gp)
        env.update({"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]})
        for k, name in enumerate(self.names):
            env[name] = self.par[:, k]
        for name in earlier:
            env[name] = values[name]
        return env

    def _pair_value(self, stage, pos, box, values, gp):
        """The value of a pair stage: each row's sum of its expression."""
        sums = []
        for r0, r1 in self.chunks:
            _, r, keep = self._rows(pos, box, r0, r1, stage.exclusions,
                                    False)
            e, _ = stage.value(self._pair_env(r, r0, r1, values,
                                              stage.earlier, gp))
            sums.append(torch.where(keep, _full(e, r), 0.0).sum(
                dim=1, dtype=F64))
        return torch.cat(sums)

    def _pair_chain(self, stage, pos, box, values, gp, weight, half,
                    grads, forces, with_derivs):
        """One sweep of pair stage `stage` weighted per row by `weight`
        ((n,) float64: 1 for an energy term, dE/dV of the row for a
        value): adds to `forces` the pairs' forces, to grads[name] the
        partials in the values of rows (name1) and columns (name2);
        returns (the weighted sum of the expression, [its parameter
        derivatives])."""
        fn = stage.fn_d if with_derivs else stage.fn
        nv = len(stage.earlier)
        dev = pos.device
        total = torch.zeros((), dtype=F64, device=dev)
        derivs = [torch.zeros((), dtype=F64, device=dev)
                  for _ in (self.derivs if with_derivs else ())]
        col_f = torch.zeros((self.n, 3), dtype=F64, device=dev)
        col_g = torch.zeros((nv, self.n), dtype=F64, device=dev)
        row_f, row_g = [], []
        for r0, r1 in self.chunks:
            d, r, keep = self._rows(pos, box, r0, r1, stage.exclusions,
                                    half)
            e, partials = fn(self._pair_env(r, r0, r1, values,
                                            stage.earlier, gp))
            w = weight[r0:r1, None].to(self.dtype)
            e = torch.where(keep, _full(e, r) * w, 0.0)
            total = total + e.sum(dtype=F64)
            p = [torch.where(keep, _full(x, r) * w, 0.0) for x in partials]
            g = (p[0] / r)[..., None] * d
            row_f.append(-g.sum(dim=1, dtype=F64))
            col_f = col_f + g.sum(dim=0, dtype=F64)
            row_g.append(torch.stack([x.sum(dim=1, dtype=F64)
                                      for x in p[1:1 + nv]])
                         if nv else None)
            if nv:
                col_g = col_g + torch.stack(
                    [x.sum(dim=0, dtype=F64) for x in p[1 + nv:1 + 2 * nv]])
            for k, x in enumerate(p[1 + 2 * nv:]):
                derivs[k] = derivs[k] + x.sum(dtype=F64)
        forces.add_(torch.cat(row_f) + col_f)
        if nv:
            rows = torch.cat(row_g, dim=1) + col_g
            for k, name in enumerate(stage.earlier):
                grads[name] = grads[name] + rows[k]
        return total, derivs

    def _single_chain(self, stage, pos, values, gp, weight, grads, forces,
                      with_derivs):
        """A single-particle stage weighted per particle by `weight`: its
        x, y, z partials as forces, its partials in earlier values into
        `grads`; returns (weighted sum, [parameter derivatives])."""
        fn = stage.fn_d if with_derivs else stage.fn
        e, partials = fn(self._single_env(pos, values, stage.earlier, gp))
        like = weight
        p = [_full(x, like) * weight for x in partials]
        forces.sub_(torch.stack(p[:3], dim=1))
        nv = len(stage.earlier)
        for name, x in zip(stage.earlier, p[3:3 + nv]):
            grads[name] = grads[name] + x
        return ((_full(e, like) * weight).sum(),
                [x.sum() for x in p[3 + nv:]])

    def _compute(self, pos, box, with_derivs):
        pos = pos.to(F64)
        box = box.to(F64) if self.periodic else None
        gp64 = self._globals()
        gpd = self._globals(self.dtype)
        values = self.computed_values(pos, box)
        ones = torch.ones(self.n, dtype=F64, device=pos.device)
        grads = {name: torch.zeros_like(ones) for name in self.value_names}
        forces = torch.zeros_like(pos)
        energy = torch.zeros((), dtype=F64, device=pos.device)
        derivs = [torch.zeros_like(energy)
                  for _ in (self.derivs if with_derivs else ())]

        def add(result):
            nonlocal energy
            energy = energy + result[0]
            for k, x in enumerate(result[1]):
                derivs[k] = derivs[k] + x

        for stage in self.terms:
            if stage.pair:
                add(self._pair_chain(stage, pos, box, values, gpd, ones,
                                     True, grads, forces, with_derivs))
            else:
                add(self._single_chain(stage, pos, values, gp64, ones, grads,
                                       forces, with_derivs))
        for name, stage in reversed(list(zip(self.value_names,
                                             self.values))):
            if stage.pair:
                _, d = self._pair_chain(stage, pos, box, values, gpd,
                                        grads[name], False, grads, forces,
                                        with_derivs)
            else:
                _, d = self._single_chain(stage, pos, values, gp64,
                                          grads[name], grads, forces,
                                          with_derivs)
            for k, x in enumerate(d):
                derivs[k] = derivs[k] + x
        return energy, forces, derivs

    def computed_values(self, pos, box) -> dict:
        """{name: (n,) float64} of the computed values at `pos` (float64)
        in `box` (None: no images), stage by stage."""
        values = {}
        for name, stage in zip(self.value_names, self.values):
            if stage.pair:
                values[name] = self._pair_value(
                    stage, pos, box, values, self._globals(self.dtype))
            else:
                e, _ = stage.value(self._single_env(pos, values,
                                                    stage.earlier,
                                                    self._globals()))
                values[name] = _full(e, pos[:, 0])
        return values
