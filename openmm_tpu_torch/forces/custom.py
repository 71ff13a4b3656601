"""Custom forces driven by energy expressions: CustomExternal, CustomBond,
CustomAngle, CustomTorsion, CustomNonbonded, CustomCompoundBond and
CustomCentroidBond.

Counterpart of openmm_tpu/forces/custom.py (the API of OpenMM's
Custom*Force.h). The JAX package takes every force and every energy
parameter derivative from jax.grad; the port's step takes no autograd (a
captured CUDA graph held bit for bit against the eager loop, where
autograd's backward of a gather would add with float atomics). So the
expression is differentiated symbolically (expressions/derivatives.py, as
OpenMM's Lepton does) in its geometric variables (r, theta, x, y, z, the
compound forces' coordinates and geometry calls) and in the global
parameters whose derivatives the System requests, and the forces follow
by the chain rule through the geometry written by hand (forces/bonded.py's
bond vectors, angle_gradient and dihedral_gradient), the per-atom sums by
gathers in a fixed order (ops/accumulate.py) or, for CustomNonbonded, by
the row and column sums of ops/custom_pairs.py.

Each compiled force (a CustomModule) has ef(pos, box) -> (float64 energy,
(n, 3) float64 forces) for the step, energy(pos, box), which autograd
differentiates through those forces (ops/pairs.py AnalyticEnergy: the
minimizer and the barostats), and parameter_derivatives(pos, box) ->
{name: float64 dE/dname} for getState(getParameterDerivatives=True),
computed between steps and never in the step. Global parameters are read
from the Context's device tensor at each evaluation, so setParameter
needs no new program; updateParametersInContext copies the per-term
parameters in place. The bonded kinds, CustomExternal and the compound
forces are float64 in every precision, as the bonded forces are;
CustomNonbonded's pairs are in the Context's precision. As in the JAX
package, CustomExternal's x, y and z are the raw positions, and its
periodicdistance takes the minimum image in the Context's box.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import unit as u
from ..expressions import (Function, compile_energy_derivatives,
                           compile_energy_expression, parse_inlined)
from ..expressions.derivatives import free_variables, replace_calls
from ..ops import geometry as geom
from ..ops.accumulate import GatherSum
from ..ops.custom_pairs import PairSweep, switch
from ..ops.pairs import AnalyticEnergy
from .base import Force
from .bonded import angle_gradient, dihedral_gradient

F64 = torch.float64
GEOMETRY = ("distance", "angle", "dihedral")


class _CustomMixin:
    """Global parameters, energy parameter derivatives and tabulated
    functions."""

    def _init_custom(self, energy):
        self._energy_expr = str(energy)
        self._global_params = []      # (name, default)
        self._deriv_requests = []
        self._functions = []          # (name, TabulatedFunction)

    def getEnergyFunction(self) -> str:
        return self._energy_expr

    def setEnergyFunction(self, energy) -> None:
        self._energy_expr = str(energy)

    def getNumGlobalParameters(self) -> int:
        return len(self._global_params)

    def addGlobalParameter(self, name, defaultValue) -> int:
        self._global_params.append((str(name), float(u.strip(defaultValue))))
        return len(self._global_params) - 1

    def getGlobalParameterName(self, index) -> str:
        return self._global_params[index][0]

    def setGlobalParameterName(self, index, name) -> None:
        self._global_params[index] = (str(name),
                                      self._global_params[index][1])

    def getGlobalParameterDefaultValue(self, index) -> float:
        return self._global_params[index][1]

    def setGlobalParameterDefaultValue(self, index, value) -> None:
        self._global_params[index] = (self._global_params[index][0],
                                      float(u.strip(value)))

    def getNumEnergyParameterDerivatives(self) -> int:
        return len(self._deriv_requests)

    def addEnergyParameterDerivative(self, name) -> None:
        if name not in [n for n, _ in self._global_params]:
            raise ValueError("addEnergyParameterDerivative: unknown global "
                             "parameter %r" % name)
        self._deriv_requests.append(str(name))

    def getEnergyParameterDerivativeName(self, index) -> str:
        return self._deriv_requests[index]

    def getNumTabulatedFunctions(self) -> int:
        return len(self._functions)

    def addTabulatedFunction(self, name, function) -> int:
        self._functions.append((str(name), function))
        return len(self._functions) - 1

    def getTabulatedFunction(self, index):
        return self._functions[index][1]

    def getTabulatedFunctionName(self, index) -> str:
        return self._functions[index][0]

    def addFunction(self, name, values, min, max) -> int:  # noqa: A002
        """The legacy form of addTabulatedFunction with a
        Continuous1DFunction."""
        from ..tabulated import Continuous1DFunction
        return self.addTabulatedFunction(
            name, Continuous1DFunction(values, min, max))

    def updateParametersInContext(self, context) -> None:
        context._update_force_parameters(self)

    def _global_defaults(self) -> dict:
        return dict(self._global_params)

    def _tables(self, dtype, device) -> dict:
        return {name: fn._compile(dtype, device)
                for name, fn in self._functions}


class _PeriodicFlagMixin:
    def setUsesPeriodicBoundaryConditions(self, periodic) -> None:
        self._periodic = bool(periodic)

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._periodic


def _params(rows, n_params) -> np.ndarray:
    """(terms, n_params) float64 per-term parameters."""
    return np.asarray(rows, np.float64).reshape(len(rows), n_params)


def _full(value, like):
    """`value` (a number or a tensor that broadcasts) as a tensor of
    like's shape and dtype."""
    if torch.is_tensor(value):
        return value.to(like.dtype).expand(like.shape)
    return torch.full_like(like, float(value))


# -- geometry with gradients ------------------------------------------------
def _distance(a, b, box):
    """(|a - b| at the minimum image in box (None: none), [d/da, d/db])."""
    d = geom.delta(a, b, box)
    r = geom.distance(d)
    g = d / r[:, None]
    return r, [g, -g]


def _angle(a, b, c, box):
    theta, g1, g2 = angle_gradient(geom.delta(a, b, box),
                                   geom.delta(c, b, box))
    return theta, [g1, -(g1 + g2), g2]


def _dihedral(a, b, c, d, box):
    phi, g = dihedral_gradient(a, b, c, d, box)
    return phi, list(g.unbind(1))


_GEOMETRY_FNS = {"distance": _distance, "angle": _angle,
                 "dihedral": _dihedral}


def _point_function(kind, get_box):
    """pointdistance / pointangle / pointdihedral (or periodicdistance) of
    scalar coordinates as a Function: the value and its partials in the
    coordinates, from the vector form's gradients, in the box get_box()
    returns (None: no images)."""
    fn = _GEOMETRY_FNS[kind]

    def points(args):
        dev = next(a.device for a in args if torch.is_tensor(a))
        xs = torch.broadcast_tensors(*(
            a.to(F64) if torch.is_tensor(a)
            else torch.full((), float(a), dtype=F64, device=dev)
            for a in args))
        shape = xs[0].shape
        pts = [torch.stack(xs[k:k + 3], dim=-1).reshape(-1, 3)
               for k in range(0, len(xs), 3)]
        return pts, shape

    def value(*args):
        pts, shape = points(args)
        return fn(*pts, get_box())[0].reshape(shape)

    def both(*args):
        pts, shape = points(args)
        val, grads = fn(*pts, get_box())
        return val.reshape(shape), [g[:, k].reshape(shape) for g in grads
                                    for k in range(3)]

    return Function(value, both)


def _point_functions(get_box) -> dict:
    return {"point" + kind: _point_function(kind, get_box)
            for kind in GEOMETRY}


# -- the compiled forces ------------------------------------------------------
class CustomModule(nn.Module):
    """The common part of a compiled custom force: its group and name, the
    Context's global parameters, and which of the System's requested
    parameter derivatives its expression reads."""

    def __init__(self, force, ctx, variables):
        super().__init__()
        self.name = force.getName()
        self.group = force.getForceGroup()
        self.n = ctx._n
        self.gp, self.gp_index = ctx._gp, ctx._gp_index
        self.derivs = tuple(name for name in ctx._deriv_names
                            if name in variables)

    def _globals(self, dtype=F64) -> dict:
        return {name: self.gp[i].to(dtype)
                for name, i in self.gp_index.items()}

    def ef(self, pos, box):
        e, f, _ = self._compute(pos, box, False)
        return e, f

    def energy(self, pos, box):
        return AnalyticEnergy.apply(self.ef, pos, box)

    def parameter_derivatives(self, pos, box) -> dict:
        if not self.derivs:
            return {}
        _, _, d = self._compute(pos, box, True)
        return dict(zip(self.derivs, d))

    def _put(self, name, value) -> None:
        t = getattr(self, name)
        value = torch.as_tensor(np.asarray(value), dtype=t.dtype)
        if value.shape != t.shape:
            raise ValueError("updateParametersInContext: the number of "
                             "terms of %s or their particles have changed"
                             % self.name)
        t.copy_(value)


class TermModule(CustomModule):
    """A force of terms over a few atoms each (CustomExternal, Bond, Angle,
    Torsion, CompoundBond, CentroidBond), in float64: the expression's
    energy and partials per term in its coordinate variables `coords`
    (their values from _env), turned into per-atom forces by
    _chain(pos, box, partials) -> (terms, atoms, 3) and summed by a gather
    table over `idx` (or `gather_idx`)."""

    def __init__(self, force, ctx, idx, params, names, coords, functions,
                 ast=None, gather_idx=None):
        text = force.getEnergyFunction()
        main = parse_inlined(text, functions) if ast is None else ast
        super().__init__(force, ctx, free_variables(main))
        dev = ctx._device
        self.m = int(idx.shape[0])
        self.register_buffer("idx", torch.as_tensor(idx, device=dev))
        self.register_buffer("par", torch.as_tensor(params, dtype=F64,
                                                    device=dev))
        self.names = list(names)
        self.coords = list(coords)
        # the atoms of each contribution _chain returns
        self.gather = GatherSum(idx if gather_idx is None else gather_idx,
                                self.n, dev)
        self._fn = compile_energy_derivatives(text, self.coords, functions,
                                              ast=main)
        self._fn_d = compile_energy_derivatives(
            text, self.coords + list(self.derivs), functions, ast=main)

    def _env(self, pos, box) -> dict:
        raise NotImplementedError

    def _chain(self, pos, box, partials):
        raise NotImplementedError

    def _compute(self, pos, box, with_derivs):
        pos = pos.to(F64)
        # the box that the point functions read
        self._box_now = box.to(F64)
        if self.m == 0:
            zero = pos.new_zeros(())
            return zero, torch.zeros_like(pos), [zero] * len(self.derivs)
        env = self._globals()
        env.update({name: self.par[:, k] for k, name in
                    enumerate(self.names)})
        env.update(self._env(pos, box))
        fn = self._fn_d if with_derivs else self._fn
        e, partials = fn(env)
        like = self.par.new_zeros(self.m)
        mask = self._mask(pos, box)

        def full(x):
            x = _full(x, like)
            return x if mask is None else torch.where(mask, x, 0.0)

        energy = full(e).sum()
        nc = len(self.coords)
        contrib = self._chain(pos, box, [full(p) for p in partials[:nc]])
        derivs = [full(p).sum() for p in partials[nc:]]
        return energy, self.gather(contrib), derivs

    def _mask(self, pos, box):
        """(terms,) bool of the terms that count at `pos` (a cutoff), or
        None: all."""
        return None

    def update(self, force) -> None:
        idx, params = force._terms_arrays()
        if not np.array_equal(idx, self.idx.cpu().numpy()):
            raise ValueError("updateParametersInContext: the number of "
                             "terms of %s or their particles have changed"
                             % self.name)
        self._put("par", params)


class _ExternalModule(TermModule):
    def __init__(self, force, ctx):
        idx, params = force._terms_arrays()
        functions = force._tables(F64, ctx._device)
        functions["periodicdistance"] = _point_function(
            "distance", lambda: self._box_now)
        super().__init__(force, ctx, idx, params, force._per_particle,
                         ("x", "y", "z"), functions)

    def _env(self, pos, box):
        xyz = pos[self.idx[:, 0]]
        return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}

    def _chain(self, pos, box, partials):
        return -torch.stack(partials, dim=-1)[:, None, :]


class _BondedModule(TermModule):
    """CustomBond (r), CustomAngle (theta) and CustomTorsion (theta, the
    dihedral)."""

    def __init__(self, force, ctx):
        idx, params = force._terms_arrays()
        self.periodic = force.usesPeriodicBoundaryConditions()
        super().__init__(force, ctx, idx, params, force._per_term,
                         (force._coord_name,), force._tables(F64,
                                                             ctx._device))
        self.kind = type(force).__name__

    def _env(self, pos, box):
        box = box.to(F64) if self.periodic else None
        pts = [pos[self.idx[:, k]] for k in range(self.idx.shape[1])]
        fn = {"CustomBondForce": _distance, "CustomAngleForce": _angle,
              "CustomTorsionForce": _dihedral}[self.kind]
        value, self._grads = fn(*pts, box)
        return {self.coords[0]: value}

    def _chain(self, pos, box, partials):
        de = partials[0][:, None]
        return torch.stack([-de * g for g in self._grads], dim=1)


class _PointsModule(TermModule):
    """Terms over points, the expression reading the geometry calls
    distance, angle and dihedral of them (taken out of the expression as
    variables whose gradients in the points are written by hand) and,
    with `scalar_coords`, each point's coordinates x1..zN:
    CustomCompoundBond (points p1..pN, the particles), CustomCentroidBond
    (g1..gN, the groups' centroids), CustomHbond (d1..d3, a1..a3) and
    CustomManyParticle (p1..pN). `names`: the per-term parameters (the
    force's per-term parameter names by default)."""

    def __init__(self, force, ctx, idx, params, points, gather_idx=None,
                 names=None, scalar_coords=True):
        functions = force._tables(F64, ctx._device)
        self.periodic = force.usesPeriodicBoundaryConditions()
        functions.update(_point_functions(
            (lambda: self._box_now) if self.periodic else (lambda: None)))
        # the geometry calls pass the compiler's check as names it knows
        ast, calls = replace_calls(
            parse_inlined(force.getEnergyFunction(),
                          dict(functions, **dict.fromkeys(GEOMETRY))),
            GEOMETRY)
        points = list(points)
        self.calls = []
        for var, name, args in calls:
            if not all(a[0] == "var" and a[1] in points for a in args):
                raise ValueError("the arguments of %s() must be among %s"
                                 % (name, ", ".join(points)))
            self.calls.append((var, name, [points.index(a[1])
                                           for a in args]))
        n_points = len(points)
        coords = (["%s%d" % (c, k + 1) for k in range(n_points)
                   for c in "xyz"] if scalar_coords else [])
        self.n_points = n_points
        # the points whose forces the gather takes: without scalar
        # coordinates only those the geometry calls read (an unused slot
        # of a CustomHbondForce, -1, would otherwise gather every term
        # onto particle 0)
        self.used = (list(range(n_points)) if scalar_coords else
                     sorted({k for _, _, which in self.calls for k in which}))
        if gather_idx is None:
            gather_idx = np.asarray(idx)[:, self.used]
        super().__init__(force, ctx, idx, params,
                         force._per_term if names is None else names,
                         coords + [v for v, _, _ in self.calls], functions,
                         ast=ast, gather_idx=gather_idx)
        self.coords_xyz = len(coords)
        # a device index (a list would be copied from the host at every
        # call, which a CUDA graph cannot capture); None: every point
        self.register_buffer("used_idx", None if len(self.used) == n_points
                             else torch.as_tensor(self.used,
                                                  device=ctx._device))

    def _points(self, pos):
        """(terms, n_points, 3) positions of each term's points."""
        raise NotImplementedError

    def _env(self, pos, box):
        box = box.to(F64) if self.periodic else None
        pts = self._points(pos)
        env = {}
        if self.coords_xyz:
            for k in range(self.n_points):
                for c, axis in zip("xyz", range(3)):
                    env["%s%d" % (c, k + 1)] = pts[:, k, axis]
        self._grads = []
        for var, name, which in self.calls:
            value, grads = _GEOMETRY_FNS[name](*(pts[:, k] for k in which),
                                               box)
            env[var] = value
            self._grads.append((which, grads))
        return env

    def _chain(self, pos, box, partials):
        f = self._point_forces(partials)
        return f if self.used_idx is None else f[:, self.used_idx]

    def _point_forces(self, partials):
        """(terms, n_points, 3) minus the energy's gradient in the
        points."""
        nxyz = self.coords_xyz
        if nxyz:
            f = -torch.stack(partials[:nxyz], dim=-1).reshape(
                -1, self.n_points, 3)
        else:
            f = self.par.new_zeros((self.m, self.n_points, 3))
        for p, (which, grads) in zip(partials[nxyz:], self._grads):
            for k, g in zip(which, grads):
                f[:, k] = f[:, k] - p[:, None] * g
        return f


class _CompoundModule(_PointsModule):
    def __init__(self, force, ctx):
        idx, params = force._terms_arrays()
        super().__init__(force, ctx, idx, params,
                         ["p%d" % (k + 1) for k in range(force._n_atoms)])

    def _points(self, pos):
        return pos[self.idx]


class _CentroidModule(_PointsModule):
    """Centroids c_g = sum_k w_gk r_gk of each group's particles, the
    weights normalized (the masses by default, ones when they sum to 0, as
    the JAX package takes them); a centroid's force goes to its particles
    by weight through one gather table over (group, slot)."""

    def __init__(self, force, ctx):
        idx, params = force._terms_arrays()
        n_groups = len(force._groups)
        width = max((len(g[0]) for g in force._groups), default=1)
        members = np.zeros((n_groups, width), np.int64)
        weights = np.zeros((n_groups, width))
        masses = ctx._masses.cpu().numpy()
        for g, (particles, w) in enumerate(force._groups):
            k = len(particles)
            w = (masses[list(particles)] if w is None
                 else np.asarray(w, np.float64))
            if w.sum() == 0:
                w = np.ones(k)
            members[g, :k] = particles
            members[g, k:] = particles[0]
            weights[g, :k] = w / w.sum()
        super().__init__(force, ctx, idx, params,
                         ["g%d" % (k + 1) for k in range(force._n_groups)],
                         gather_idx=members)
        dev = ctx._device
        self.register_buffer("members", torch.as_tensor(members,
                                                        device=dev))
        self.register_buffer("weights", torch.as_tensor(weights, dtype=F64,
                                                        device=dev))
        # the terms' centroid forces onto the groups (then self.gather
        # takes them onto the atoms)
        self.group_gather = GatherSum(idx, n_groups, dev)

    def _points(self, pos):
        centroids = (pos[self.members] * self.weights[:, :, None]).sum(1)
        return centroids[self.idx]

    def _chain(self, pos, box, partials):
        fc = self.group_gather(self._point_forces(partials))
        return self.weights[:, :, None] * fc[:, None, :]


class CustomNonbondedModule(CustomModule):
    """The pairs of a CustomNonbondedForce through ops/custom_pairs.py in
    the Context's precision (each pair's displacement from the float64
    positions), with the switch and the long-range
    correction's coefficient / volume (float64, a constant of the
    parameters' defaults, as the JAX package computes it)."""

    def __init__(self, force, ctx):
        functions_probe = force._tables(F64, "cpu")
        main = parse_inlined(force.getEnergyFunction(), functions_probe)
        super().__init__(force, ctx, free_variables(main))
        if len(force._particles) != ctx._n:
            raise ValueError("CustomNonbondedForce must have the same number "
                             "of particles as the System")
        dev = ctx._device
        self.dtype = F64 if ctx._precision == "double" else torch.float32
        self.names = list(force._per_particle)
        self.register_buffer("par", torch.as_tensor(
            _params(force._particles, len(self.names)), dtype=self.dtype,
            device=dev))
        method = force.getNonbondedMethod()
        self.periodic = method == CustomNonbondedForce.CutoffPeriodic
        self.cutoff = (None if method == CustomNonbondedForce.NoCutoff
                       else force.getCutoffDistance())
        self.switch = (force.getSwitchingDistance()
                       if force.getUseSwitchingFunction()
                       and self.cutoff is not None else None)
        self.use_lrc = force.getUseLongRangeCorrection() and self.periodic
        self.register_buffer("lrc", torch.as_tensor(
            force._long_range_coefficient() if self.use_lrc else 0.0,
            dtype=F64, device=dev))
        self.sweep = PairSweep(ctx._n, force._groups, force._exclusions, dev)
        functions = force._tables(self.dtype, dev)
        text = force.getEnergyFunction()
        self._fn = compile_energy_derivatives(text, ["r"], functions)
        self._fn_d = compile_energy_derivatives(
            text, ["r"] + list(self.derivs), functions)

    def _pair_fn(self, fn, env0):
        names = self.names

        def pair(r, rows, cols):
            env = dict(env0)
            env["r"] = r
            for k, name in enumerate(names):
                env[name + "1"] = self.par[rows, k][:, None]
                env[name + "2"] = self.par[cols, k][None, :]
            e, partials = fn(env)
            e = _full(e, r)
            partials = [_full(p, r) for p in partials]
            de_dr, de_dp = partials[0], partials[1:]
            if self.switch is not None:
                e, de_dr, s = switch(r, e, de_dr, self.switch, self.cutoff)
                de_dp = [d * s for d in de_dp]
            return e, de_dr, de_dp

        return pair

    def _compute(self, pos, box, with_derivs):
        fn = self._fn_d if with_derivs else self._fn
        energy, forces, derivs = self.sweep(
            pos.to(F64), box.to(F64) if self.periodic else None,
            self._pair_fn(fn, self._globals(self.dtype)), self.cutoff,
            len(self.derivs) if with_derivs else 0, self.dtype)
        if self.use_lrc:
            energy = energy + self.lrc / geom.box_volume(box.to(F64))
        return energy, forces, derivs

    def update(self, force) -> None:
        self._put("par", _params(force._particles, len(self.names)))
        if self.use_lrc:
            self._put("lrc", force._long_range_coefficient())


# -- the force classes -------------------------------------------------------
class CustomExternalForce(_CustomMixin, Force):
    """E(x, y, z; per-particle and global parameters) on single
    particles; periodicdistance(x, y, z, x0, y0, z0) is the minimum-image
    distance."""

    def __init__(self, energy):
        super().__init__()
        self._init_custom(energy)
        self._per_particle = []
        self._terms = []              # (particle, params)

    def getNumPerParticleParameters(self) -> int:
        return len(self._per_particle)

    def addPerParticleParameter(self, name) -> int:
        self._per_particle.append(str(name))
        return len(self._per_particle) - 1

    def getPerParticleParameterName(self, index) -> str:
        return self._per_particle[index]

    def getNumParticles(self) -> int:
        return len(self._terms)

    def addParticle(self, particle, parameters=()) -> int:
        self._terms.append((int(particle),
                            [float(u.strip(p)) for p in parameters]))
        return len(self._terms) - 1

    def getParticleParameters(self, index):
        return self._terms[index]

    def setParticleParameters(self, index, particle, parameters=()) -> None:
        self._terms[index] = (int(particle),
                              [float(u.strip(p)) for p in parameters])

    def _terms_arrays(self):
        idx = np.asarray([t[0] for t in self._terms], np.int64).reshape(-1, 1)
        return idx, _params([t[1] for t in self._terms],
                            len(self._per_particle))

    def _compile(self, ctx) -> CustomModule:
        return _ExternalModule(self, ctx)


class _CustomBondedBase(_CustomMixin, _PeriodicFlagMixin, Force):
    _n_atoms = 2
    _coord_name = "r"

    def __init__(self, energy):
        super().__init__()
        self._init_custom(energy)
        self._per_term = []
        self._terms = []              # (atoms, params)
        self._periodic = False

    def _add_per_term_parameter(self, name) -> int:
        self._per_term.append(str(name))
        return len(self._per_term) - 1

    def _add_term(self, atoms, parameters) -> int:
        self._terms.append((tuple(int(a) for a in atoms),
                            [float(u.strip(p)) for p in parameters]))
        return len(self._terms) - 1

    def _bonded_particles(self):
        return [(atoms[i], atoms[i + 1]) for atoms, _ in self._terms
                for i in range(len(atoms) - 1)]

    def _terms_arrays(self):
        idx = np.asarray([t[0] for t in self._terms], np.int64).reshape(
            -1, self._n_atoms)
        return idx, _params([t[1] for t in self._terms], len(self._per_term))

    def _compile(self, ctx) -> CustomModule:
        return _BondedModule(self, ctx)


class CustomBondForce(_CustomBondedBase):
    """E(r) of particle pairs."""
    _n_atoms = 2
    _coord_name = "r"

    def getNumPerBondParameters(self) -> int:
        return len(self._per_term)

    def addPerBondParameter(self, name) -> int:
        return self._add_per_term_parameter(name)

    def getPerBondParameterName(self, index) -> str:
        return self._per_term[index]

    def getNumBonds(self) -> int:
        return len(self._terms)

    def addBond(self, particle1, particle2, parameters=()) -> int:
        return self._add_term((particle1, particle2), parameters)

    def getBondParameters(self, index):
        (p1, p2), params = self._terms[index]
        return p1, p2, list(params)

    def setBondParameters(self, index, particle1, particle2,
                          parameters=()) -> None:
        self._terms[index] = ((int(particle1), int(particle2)),
                              [float(u.strip(p)) for p in parameters])


class CustomAngleForce(_CustomBondedBase):
    """E(theta) of particle triples, theta the angle at the second."""
    _n_atoms = 3
    _coord_name = "theta"

    def getNumPerAngleParameters(self) -> int:
        return len(self._per_term)

    def addPerAngleParameter(self, name) -> int:
        return self._add_per_term_parameter(name)

    def getPerAngleParameterName(self, index) -> str:
        return self._per_term[index]

    def getNumAngles(self) -> int:
        return len(self._terms)

    def addAngle(self, p1, p2, p3, parameters=()) -> int:
        return self._add_term((p1, p2, p3), parameters)

    def getAngleParameters(self, index):
        (p1, p2, p3), params = self._terms[index]
        return p1, p2, p3, list(params)

    def setAngleParameters(self, index, p1, p2, p3, parameters=()) -> None:
        self._terms[index] = ((int(p1), int(p2), int(p3)),
                              [float(u.strip(p)) for p in parameters])


class CustomTorsionForce(_CustomBondedBase):
    """E(theta) of particle quadruples, theta the dihedral angle."""
    _n_atoms = 4
    _coord_name = "theta"

    def getNumPerTorsionParameters(self) -> int:
        return len(self._per_term)

    def addPerTorsionParameter(self, name) -> int:
        return self._add_per_term_parameter(name)

    def getPerTorsionParameterName(self, index) -> str:
        return self._per_term[index]

    def getNumTorsions(self) -> int:
        return len(self._terms)

    def addTorsion(self, p1, p2, p3, p4, parameters=()) -> int:
        return self._add_term((p1, p2, p3, p4), parameters)

    def getTorsionParameters(self, index):
        (p1, p2, p3, p4), params = self._terms[index]
        return p1, p2, p3, p4, list(params)

    def setTorsionParameters(self, index, p1, p2, p3, p4,
                             parameters=()) -> None:
        self._terms[index] = ((int(p1), int(p2), int(p3), int(p4)),
                              [float(u.strip(p)) for p in parameters])


class CustomNonbondedForce(_CustomMixin, Force):
    """A pair energy E(r; name1, name2 of each per-particle parameter)
    with exclusions, interaction groups, a switch and the long-range
    correction."""

    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2

    def __init__(self, energy):
        super().__init__()
        self._init_custom(energy)
        self._per_particle = []
        self._particles = []
        self._exclusions = []
        self._method = CustomNonbondedForce.NoCutoff
        self._cutoff = 1.0
        self._switching = False
        self._switch_dist = -1.0
        self._lrc = False
        self._groups = []             # (set1, set2)

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

    def getNonbondedMethod(self) -> int:
        return self._method

    def setNonbondedMethod(self, method) -> None:
        self._method = int(method)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def setCutoffDistance(self, distance) -> None:
        self._cutoff = float(u.strip(distance, u.nanometer))

    def getUseSwitchingFunction(self) -> bool:
        return self._switching

    def setUseSwitchingFunction(self, use) -> None:
        self._switching = bool(use)

    def getSwitchingDistance(self) -> float:
        return self._switch_dist

    def setSwitchingDistance(self, distance) -> None:
        self._switch_dist = float(u.strip(distance, u.nanometer))

    def getUseLongRangeCorrection(self) -> bool:
        return self._lrc

    def setUseLongRangeCorrection(self, use) -> None:
        self._lrc = bool(use)

    def getNumInteractionGroups(self) -> int:
        return len(self._groups)

    def addInteractionGroup(self, set1, set2) -> int:
        self._groups.append((sorted(set(int(i) for i in set1)),
                             sorted(set(int(i) for i in set2))))
        return len(self._groups) - 1

    def getInteractionGroupParameters(self, index):
        return self._groups[index]

    def setInteractionGroupParameters(self, index, set1, set2) -> None:
        self._groups[index] = (sorted(set(int(i) for i in set1)),
                               sorted(set(int(i) for i in set2)))

    def usesPeriodicBoundaryConditions(self) -> bool:
        return self._method == CustomNonbondedForce.CutoffPeriodic

    def _long_range_coefficient(self) -> float:
        """2 pi n^2 <int_rc^inf E(r) r^2 dr> over the pairs of particle
        classes (and, with the switch, the switched region's deficit), as
        the JAX package computes it (custom.py _long_range_coefficient:
        Gauss-Legendre in t = rc / r), at the global parameters'
        defaults."""
        classes = {}
        for p in self._particles:
            classes[tuple(p)] = classes.get(tuple(p), 0) + 1
        keys = list(classes)
        gp = self._global_defaults()
        expr_fn = compile_energy_expression(self._energy_expr,
                                            self._tables(F64, "cpu"))
        rc = self._cutoff
        x_gl, w_gl = np.polynomial.legendre.leggauss(128)
        t = 0.5 * (x_gl + 1.0)
        wt = 0.5 * w_gl
        r = rc / t

        def energies(radii, ka, kb):
            env = {"r": torch.as_tensor(radii, dtype=F64)}
            for k, name in enumerate(self._per_particle):
                env[name + "1"] = ka[k]
                env[name + "2"] = kb[k]
            env.update(gp)
            value = expr_fn(env)
            return (value.numpy() if torch.is_tensor(value)
                    else np.float64(value))

        total = 0.0
        for a, ka in enumerate(keys):
            for b in range(a + 1):
                kb = keys[b]
                count = (classes[ka] * (classes[ka] + 1) / 2.0 if a == b
                         else classes[ka] * classes[kb])
                integral = rc * np.sum(wt * energies(r, ka, kb) * (r ** 2)
                                       / (t ** 2))
                if self._switching and self._switch_dist >= 0:
                    rs = self._switch_dist
                    xq, wq = np.polynomial.legendre.leggauss(64)
                    rq = 0.5 * (rc - rs) * xq + 0.5 * (rc + rs)
                    wq2 = 0.5 * (rc - rs) * wq
                    tt = (rq - rs) / (rc - rs)
                    sw = 1 - tt ** 3 * (10 - 15 * tt + 6 * tt * tt)
                    integral += np.sum(wq2 * energies(rq, ka, kb) * (1 - sw)
                                       * rq * rq)
                total += count * integral
        n = len(self._particles)
        return 2.0 * math.pi * n * n * (total / (n * (n + 1) / 2.0))

    def _compile(self, ctx) -> CustomModule:
        return CustomNonbondedModule(self, ctx)


class CustomCompoundBondForce(_CustomMixin, _PeriodicFlagMixin, Force):
    """Terms over numParticles particles each: the expression reads x1..zN
    and distance, angle, dihedral of the points p1..pN (and the point*
    forms of coordinates)."""

    def __init__(self, numParticles, energy):
        super().__init__()
        self._init_custom(energy)
        self._n_atoms = int(numParticles)
        self._per_term = []
        self._terms = []
        self._periodic = False

    def getNumParticlesPerBond(self) -> int:
        return self._n_atoms

    def getNumPerBondParameters(self) -> int:
        return len(self._per_term)

    def addPerBondParameter(self, name) -> int:
        self._per_term.append(str(name))
        return len(self._per_term) - 1

    def getPerBondParameterName(self, index) -> str:
        return self._per_term[index]

    def getNumBonds(self) -> int:
        return len(self._terms)

    def addBond(self, particles, parameters=()) -> int:
        if len(particles) != self._n_atoms:
            raise ValueError("wrong number of particles in bond")
        self._terms.append((tuple(int(p) for p in particles),
                            [float(u.strip(p)) for p in parameters]))
        return len(self._terms) - 1

    def getBondParameters(self, index):
        atoms, params = self._terms[index]
        return list(atoms), list(params)

    def setBondParameters(self, index, particles, parameters=()) -> None:
        self._terms[index] = (tuple(int(p) for p in particles),
                              [float(u.strip(p)) for p in parameters])

    def _bonded_particles(self):
        return [(atoms[i], atoms[i + 1]) for atoms, _ in self._terms
                for i in range(len(atoms) - 1)]

    def _terms_arrays(self):
        idx = np.asarray([t[0] for t in self._terms], np.int64).reshape(
            -1, self._n_atoms)
        return idx, _params([t[1] for t in self._terms], len(self._per_term))

    def _compile(self, ctx) -> CustomModule:
        return _CompoundModule(self, ctx)


class CustomCentroidBondForce(_CustomMixin, _PeriodicFlagMixin, Force):
    """Terms over numGroups groups each, their points g1..gN the groups'
    weighted centroids (mass weights by default)."""

    def __init__(self, numGroups, energy):
        super().__init__()
        self._init_custom(energy)
        self._n_groups = int(numGroups)
        self._per_term = []
        self._groups = []             # (particles, weights or None)
        self._terms = []              # (group indices, params)
        self._periodic = False

    def getNumGroupsPerBond(self) -> int:
        return self._n_groups

    def getNumGroups(self) -> int:
        return len(self._groups)

    def addGroup(self, particles, weights=None) -> int:
        self._groups.append((tuple(int(p) for p in particles),
                             None if weights is None or len(weights) == 0
                             else [float(w) for w in weights]))
        return len(self._groups) - 1

    def getGroupParameters(self, index):
        particles, weights = self._groups[index]
        return list(particles), list(weights) if weights else []

    def setGroupParameters(self, index, particles, weights=None) -> None:
        self._groups[index] = (tuple(int(p) for p in particles),
                               None if weights is None or len(weights) == 0
                               else [float(w) for w in weights])

    def getNumPerBondParameters(self) -> int:
        return len(self._per_term)

    def addPerBondParameter(self, name) -> int:
        self._per_term.append(str(name))
        return len(self._per_term) - 1

    def getPerBondParameterName(self, index) -> str:
        return self._per_term[index]

    def getNumBonds(self) -> int:
        return len(self._terms)

    def addBond(self, groups, parameters=()) -> int:
        if len(groups) != self._n_groups:
            raise ValueError("wrong number of groups in bond")
        self._terms.append((tuple(int(g) for g in groups),
                            [float(u.strip(p)) for p in parameters]))
        return len(self._terms) - 1

    def getBondParameters(self, index):
        groups, params = self._terms[index]
        return list(groups), list(params)

    def setBondParameters(self, index, groups, parameters=()) -> None:
        self._terms[index] = (tuple(int(g) for g in groups),
                              [float(u.strip(p)) for p in parameters])

    def _bonded_particles(self):
        out = []
        for groups, _ in self._terms:
            atoms = [self._groups[g][0][0] for g in groups]
            out += [(atoms[i], atoms[i + 1]) for i in range(len(atoms) - 1)]
        return out

    def _terms_arrays(self):
        idx = np.asarray([t[0] for t in self._terms], np.int64).reshape(
            -1, self._n_groups)
        return idx, _params([t[1] for t in self._terms], len(self._per_term))

    def _compile(self, ctx) -> CustomModule:
        return _CentroidModule(self, ctx)


CUSTOM_FORCES = (CustomExternalForce, CustomBondForce, CustomAngleForce,
                 CustomTorsionForce, CustomNonbondedForce,
                 CustomCompoundBondForce, CustomCentroidBondForce)
