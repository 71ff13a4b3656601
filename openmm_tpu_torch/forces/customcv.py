"""CustomCVForce: an energy expression of collective variables, each of
them the energy of a Force.

Counterpart of openmm_tpu/forces/customcv.py (CustomCVForce.h). OpenMM
evaluates each variable in an inner Context; the JAX package compiles the
variables' forces into its program and takes the forces by jax.grad. Here
each variable's Force is compiled into a module of its own
(Context._compile_module) that the Context keeps out of its force lists:
the variable's value is that module's energy, its forces the module's
`ef`, and the CV's forces sum_k dE/dcv_k F_k with dE/dcv_k the
expression's symbolic partial. The variables' own force groups do not
count; the CV's does. A NonbondedForce variable with periodic boundaries
keeps a candidate state of its own, which the Context builds and
rebuilds with its own under one gate (Context._cv_nonbondeds) and hands
to the variable's kernels 1-3 through `state_of`; every kind serves.
Energy parameter derivatives take the expression's
explicit partial plus sum_k dE/dcv_k dcv_k/dparameter from the
variables' modules. This is what metadynamics and steered or restrained
MD build on.
"""
from __future__ import annotations

import torch
from torch import nn

from ..expressions import compile_energy_derivatives
from ..ops.pairs import AnalyticEnergy
from ..tabulated import refresh
from .base import Force
from .custom import _CustomMixin

F64 = torch.float64


class CustomCVForce(_CustomMixin, Force):
    def __init__(self, energy):
        super().__init__()
        self._init_custom(energy)
        self._cvs = []                # (name, Force)

    def getNumCollectiveVariables(self) -> int:
        return len(self._cvs)

    def addCollectiveVariable(self, name, variable) -> int:
        self._cvs.append((str(name), variable))
        return len(self._cvs) - 1

    def getCollectiveVariable(self, index):
        return self._cvs[index][1]

    def getCollectiveVariableName(self, index) -> str:
        return self._cvs[index][0]

    def getCollectiveVariableValues(self, context) -> list:
        """The variables' values at the Context's current positions."""
        module = context._modules.get(id(self))
        if module is None:
            raise ValueError("the force is not part of this Context's "
                             "System")
        s = context._state
        return [float(v) for v in module.cv_values(s["positions"],
                                                   s["box"])]

    def usesPeriodicBoundaryConditions(self) -> bool:
        return any(v.usesPeriodicBoundaryConditions() for _, v in self._cvs)

    def _global_defaults(self) -> dict:
        """The CV's own global parameters and its variables'."""
        out = {}
        for _, force in self._cvs:
            out.update(force._global_defaults())
        out.update(self._global_params)
        return out

    def _bonded_particles(self):
        return [pair for _, force in self._cvs
                for pair in force._bonded_particles()]

    def _compile(self, ctx):
        return CustomCVModule(self, ctx)


class CustomCVModule(nn.Module):
    """The compiled CustomCVForce (forces/custom.py's CustomModule
    contract: ef, energy, parameter_derivatives, update)."""

    def __init__(self, force, ctx):
        super().__init__()
        self.name = force.getName()
        self.group = force.getForceGroup()
        self.gp, self.gp_index = ctx._gp, ctx._gp_index
        self.cv_names = [name for name, _ in force._cvs]
        self.cvs = [ctx._compile_module(f) for _, f in force._cvs]
        # the variables' NonbondedModules that keep a candidate state
        self.tiled = [m.module for m in self.cvs if getattr(m, "tiled",
                                                             False)]
        functions = force._tables(F64, ctx._device)
        self.tables = functions
        text = force.getEnergyFunction()
        self.derivs = tuple(ctx._deriv_names)
        self._fn = compile_energy_derivatives(text, self.cv_names,
                                              functions)
        self._fn_d = compile_energy_derivatives(
            text, self.cv_names + list(self.derivs), functions)

    def _env(self, values) -> dict:
        env = {name: self.gp[i] for name, i in self.gp_index.items()}
        env.update(zip(self.cv_names, values))
        return env

    def cv_values(self, pos, box) -> list:
        return [m.ef(pos, box)[0] for m in self.cvs]

    def ef(self, pos, box, state_of=None):
        """(energy, forces); state_of(module) gives the candidate state of
        each tiled variable's module (without it, each builds one)."""
        parts = [m.ef(pos, box, state_of(m.module))
                 if state_of is not None and getattr(m, "tiled", False)
                 else m.ef(pos, box) for m in self.cvs]
        e, partials = self._fn(self._env([p[0] for p in parts]))
        forces = torch.zeros(pos.shape, dtype=F64, device=pos.device)
        for de, (_, f) in zip(partials, parts):
            forces = forces + de * f.to(F64)
        like = torch.zeros((), dtype=F64, device=pos.device)
        return like + e, forces

    def energy(self, pos, box):
        return AnalyticEnergy.apply(self.ef, pos, box)

    def parameter_derivatives(self, pos, box) -> dict:
        if not self.derivs:
            return {}
        values = [m.ef(pos, box)[0] for m in self.cvs]
        _, partials = self._fn_d(self._env(values))
        k = len(self.cvs)
        out = {name: float(p) for name, p in zip(self.derivs, partials[k:])}
        for de, m in zip(partials[:k], self.cvs):
            inner = getattr(m, "parameter_derivatives", None)
            for name, value in (inner(pos, box) if inner else {}).items():
                if name in out:
                    out[name] += float(de) * float(value)
        return out

    def update(self, force) -> None:
        """The variables' parameters and the tabulated functions' values,
        in place (metadynamics rewrites its bias table every deposition)."""
        for m, (_, f) in zip(self.cvs, force._cvs):
            m.update(f)
        for name, table in force._functions:
            refresh(self.tables[name], table)

