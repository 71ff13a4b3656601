"""CustomIntegrator: integration algorithms written as a program of steps.

Counterpart of openmm_tpu/integrators/custom.py (the API of OpenMM's
CustomIntegrator.h): ComputeGlobal, ComputePerDof and ComputeSum into
global variables, per-DOF variables, x, v or the Context's global
parameters; ConstrainPositions, ConstrainVelocities, UpdateContextState;
if and while blocks. Expressions (expressions/) may name x, v, m, dt, f,
f0..f31, energy, energy0..energy31, uniform, gaussian, the variables and
the Context's global parameters.

The program is parsed into a tree of blocks once, when the Context binds,
and the step walks it; a block is deps.branch or deps.loop on its device
condition, so the captured step holds IF and WHILE nodes. The state lives
on the device and is written in place: the globals as one float64 tensor,
each per-DOF variable (n, 3), the constraints' reference, and, for each
force group the program reads, its forces, its energy and whether they
are valid. The reference that ConstrainPositions solves from is the last
constrained configuration, as in OpenMM's CustomIntegrator: the
positions at the step's start or at its last ConstrainPositions (or
after a barostat's move). The JAX package takes the positions before
the last assignment to x, which a program that moves x twice before it
constrains (BAOAB, MTSLangevinIntegrator) leaves off the constraints:
SETTLE and SHAKE then solve from a distorted reference, and such a
program cools (ROADMAP, notes on the reference). Forces are lazy, as in
the JAX package: a group is evaluated (deps.forces_by_groups) where an
expression first reads it, and its buffers keep the positions, box and
global parameters it was evaluated at. Unlike the JAX package, which
drops its cache at every hook and block, the port keeps them across a
block and from one step to the next: where the program moves x (an
assignment, a constraint, a barostat's hook) the next read evaluates;
where the step cannot know from the program alone (the start of a step,
after a block) the evaluation sits under a branch on whether those
inputs equal the current ones, so a write from the host or a move by
another member of a CompoundIntegrator is seen, and forces at unchanged
positions are never evaluated twice. The values are those the JAX
package recomputes.

Random numbers come from the Context's generator, one draw per operation
that names uniform or gaussian (per DOF, or one number for a global).
A draw inside an if block is made before the block, whether it runs or
not, so that a step draws a fixed count and the captured graph and the
eager loop draw the same numbers. A while block runs a count of times
that only the card knows, and a draw from the generator inside a
captured body would repeat the same numbers at every pass (the graph
fixes its offsets at capture). So a program that draws inside a while
block takes one seed a step from the generator, at the step's start, and
every draw inside a while block (its body or its condition) advances a
device counter and hashes (seed, counter, element) into its numbers
(_hashed: 53-bit uniforms, gaussians by Box-Muller): the same arithmetic
on the device in the eager loop and in the graph, so their bits agree,
and a new counter value for every draw of the step. The JAX package
threads its key through the loop (openmm_tpu/integrators/custom.py
:446-462).
"""
from __future__ import annotations

import operator
import re

import numpy as np
import torch

from .. import unit as u
from ..expressions import compile_energy_expression, expression_variables
from ..expressions.parser import ExpressionError
from .base import Integrator, StepDeps

# computation-step type codes (CustomIntegrator.h ComputationType)
ComputeGlobal = 0
ComputePerDof = 1
ComputeSum = 2
ConstrainPositions = 3
ConstrainVelocities = 4
UpdateContextState = 5
IfBlockStart = 6
WhileBlockStart = 7
BlockEnd = 8

_COND_RE = re.compile(r"^(.*?)(<=|>=|!=|=|<|>)(.*)$")
_COMPARE = {"=": operator.eq, "!=": operator.ne, "<": operator.lt,
            "<=": operator.le, ">": operator.gt, ">=": operator.ge}
_RANDOM = ("gaussian", "uniform")
_M32 = 0xFFFFFFFF


def _mix(x):
    """A 32-bit integer hash of int64 values in [0, 2^32) (every product
    stays below 2^63)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _hashed(seed, counter, shape, gaussian, device):
    """float64 numbers of `shape` from the int64 device scalars seed and
    counter: uniforms in [0, 1) of 53 bits, or gaussians by Box-Muller."""
    numel = 1
    for d in shape:
        numel *= d
    count = 2 * numel if gaussian else numel
    key = _mix((_mix(seed & _M32) ^ (counter & _M32)) & _M32)
    h = _mix(key ^ _mix(torch.arange(2 * count, device=device)))
    u = ((h[0::2] >> 6) * (1 << 27) + (h[1::2] >> 5)).to(torch.float64) \
        * 2.0 ** -53
    if gaussian:
        u = (torch.sqrt(-2.0 * torch.log(1.0 - u[:numel]))
             * torch.cos((2.0 * np.pi) * u[numel:]))
    return u.reshape(shape)


def _group_of(name):
    """The force group a variable reads (-1: all), or None."""
    if name in ("f", "energy"):
        return -1
    m = re.fullmatch(r"(?:f|energy)(\d+)", name)
    if m and 0 <= int(m.group(1)) < 32:
        return int(m.group(1))
    return None


def _mask(group) -> int:
    return -1 if group == -1 else 1 << group


class _Expr:
    """A compiled expression with what it reads: its force groups and its
    random numbers."""

    def __init__(self, text):
        self.text = text
        self.fn = compile_energy_expression(text)
        names = expression_variables(text)
        self.names = names
        self.groups = sorted({g for g in map(_group_of, names)
                              if g is not None})
        self.randoms = [r for r in _RANDOM if r in names]


class CustomIntegrator(Integrator):
    def __init__(self, stepSize: float):
        super().__init__(stepSize)
        self._global_vars = []      # [name, initial value]
        self._perdof_vars = []      # [name, initial value]
        self._perdof_initial_values = {}
        self._steps = []            # (type, variable, expression)
        self._ke_expression = "m*v*v/2"
        self._globals = None        # (G,) float64 on the device, once bound
        self._perdof = {}           # name -> (n, 3) float64 on the device

    # -- variables ---------------------------------------------------------
    def getNumGlobalVariables(self) -> int:
        return len(self._global_vars)

    def addGlobalVariable(self, name, initialValue) -> int:
        if self._context is not None:
            raise RuntimeError("variables must be added before the "
                               "integrator is bound to a Context")
        self._global_vars.append([str(name), float(u.strip(initialValue))])
        return len(self._global_vars) - 1

    def getGlobalVariableName(self, index) -> str:
        return self._global_vars[index][0]

    def _global_index(self, name) -> int:
        for i, (n, _) in enumerate(self._global_vars):
            if n == name:
                return i
        raise ValueError("unknown global variable: " + name)

    def getGlobalVariable(self, index) -> float:
        if self._globals is not None:
            return float(self._globals[index])
        return self._global_vars[index][1]

    def getGlobalVariableByName(self, name) -> float:
        return self.getGlobalVariable(self._global_index(name))

    def setGlobalVariable(self, index, value) -> None:
        self._global_vars[index][1] = float(u.strip(value))
        if self._globals is not None:
            self._globals[index].fill_(float(u.strip(value)))

    def setGlobalVariableByName(self, name, value) -> None:
        self.setGlobalVariable(self._global_index(name), value)

    def getNumPerDofVariables(self) -> int:
        return len(self._perdof_vars)

    def addPerDofVariable(self, name, initialValue) -> int:
        if self._context is not None:
            raise RuntimeError("variables must be added before the "
                               "integrator is bound to a Context")
        self._perdof_vars.append([str(name), float(u.strip(initialValue))])
        return len(self._perdof_vars) - 1

    def getPerDofVariableName(self, index) -> str:
        return self._perdof_vars[index][0]

    def _perdof_index(self, name) -> int:
        for i, (n, _) in enumerate(self._perdof_vars):
            if n == name:
                return i
        raise ValueError("unknown per-DOF variable: " + name)

    def getPerDofVariable(self, index) -> np.ndarray:
        """The values, (n, 3) float64."""
        name = self._perdof_vars[index][0]
        if name in self._perdof:
            return self._perdof[name].detach().to("cpu", copy=True).numpy()
        if name in self._perdof_initial_values:
            return self._perdof_initial_values[name].copy()
        raise RuntimeError("the integrator is not bound to a Context")

    def getPerDofVariableByName(self, name) -> np.ndarray:
        return self.getPerDofVariable(self._perdof_index(name))

    def setPerDofVariable(self, index, values) -> None:
        name = self._perdof_vars[index][0]
        arr = np.array(u.strip(values), np.float64)
        if name in self._perdof:
            self._perdof[name].copy_(torch.as_tensor(arr).reshape(
                self._perdof[name].shape))
        else:
            self._perdof_initial_values[name] = arr

    def setPerDofVariableByName(self, name, values) -> None:
        self.setPerDofVariable(self._perdof_index(name), values)

    # -- the program --------------------------------------------------------
    def getNumComputations(self) -> int:
        return len(self._steps)

    def getComputationStep(self, index) -> tuple:
        return self._steps[index]

    def _add(self, kind, variable="", expression="") -> int:
        if self._context is not None:
            raise RuntimeError("computations must be added before the "
                               "integrator is bound to a Context")
        self._steps.append((kind, str(variable), str(expression)))
        return len(self._steps) - 1

    def addComputeGlobal(self, variable, expression) -> int:
        return self._add(ComputeGlobal, variable, expression)

    def addComputePerDof(self, variable, expression) -> int:
        return self._add(ComputePerDof, variable, expression)

    def addComputeSum(self, variable, expression) -> int:
        return self._add(ComputeSum, variable, expression)

    def addConstrainPositions(self) -> int:
        return self._add(ConstrainPositions)

    def addConstrainVelocities(self) -> int:
        return self._add(ConstrainVelocities)

    def addUpdateContextState(self) -> int:
        return self._add(UpdateContextState)

    def beginIfBlock(self, condition) -> int:
        return self._add(IfBlockStart, "", condition)

    def beginWhileBlock(self, condition) -> int:
        return self._add(WhileBlockStart, "", condition)

    def endBlock(self) -> int:
        return self._add(BlockEnd)

    def getKineticEnergyExpression(self) -> str:
        return self._ke_expression

    def setKineticEnergyExpression(self, expression) -> None:
        self._ke_expression = str(expression)

    # -- binding -------------------------------------------------------------
    def _tree(self):
        """The program as a tree: ("op", kind, variable, _Expr or None) and
        ("if" | "while", (lhs _Expr, comparison, rhs _Expr), children)."""
        steps = self._steps

        def parse(i, depth):
            nodes = []
            while i < len(steps):
                kind, var, text = steps[i]
                if kind == BlockEnd:
                    if depth == 0:
                        raise ValueError("endBlock() without a block")
                    return nodes, i + 1
                if kind in (IfBlockStart, WhileBlockStart):
                    m = _COND_RE.match(text)
                    if m is None:
                        raise ValueError("invalid condition: " + text)
                    cond = (_Expr(m.group(1)), m.group(2),
                            _Expr(m.group(3)))
                    children, i = parse(i + 1, depth + 1)
                    nodes.append(("if" if kind == IfBlockStart else "while",
                                  cond, children))
                    continue
                expr = (_Expr(text) if kind in (ComputeGlobal,
                                                 ComputePerDof, ComputeSum)
                        else None)
                nodes.append(("op", kind, var, expr))
                i += 1
            if depth:
                raise ValueError("a block is missing its endBlock()")
            return nodes, i

        return parse(0, 0)[0]

    def _exprs(self, nodes):
        """Every _Expr in `nodes`, conditions included, in program order."""
        for node in nodes:
            if node[0] == "op":
                if node[3] is not None:
                    yield node[3]
            else:
                yield node[1][0]
                yield node[1][2]
                yield from self._exprs(node[2])

    def _init_state(self, deps: StepDeps) -> None:
        ctx = self._context
        dev = deps.inv_masses.device
        n = deps.inv_masses.shape[0]
        f64 = dict(dtype=torch.float64, device=dev)
        self._tree_nodes = self._tree()
        self._ke = _Expr(self._ke_expression)
        known = ({"x", "v", "m", "dt", "f", "energy"} | set(_RANDOM)
                 | {v[0] for v in self._global_vars}
                 | {v[0] for v in self._perdof_vars}
                 | set(ctx._gp_index))
        for expr in list(self._exprs(self._tree_nodes)) + [self._ke]:
            unknown = {name for name in expr.names
                       if name not in known and _group_of(name) is None}
            if unknown:
                raise ExpressionError("unknown variable %s in %r" % (
                    ", ".join(sorted(unknown)), expr.text))
        # [seed, counter] of the draws inside while blocks
        self._loop_rng = None
        if any(expr.randoms
               for node in self._walk(self._tree_nodes, "while")
               for expr in self._exprs([node])):
            self._loop_rng = torch.zeros(2, dtype=torch.int64, device=dev)
        self._globals = torch.tensor([v for _, v in self._global_vars],
                                     **f64)
        self._perdof = {}
        for name, value in self._perdof_vars:
            init = self._perdof_initial_values.get(name)
            self._perdof[name] = (
                torch.full((n, 3), value, **f64) if init is None
                else torch.as_tensor(init, **f64).reshape(n, 3).clone())
        self._x = torch.zeros((n, 3), **f64)
        self._v = torch.zeros((n, 3), **f64)
        self._xref = torch.zeros((n, 3), **f64)
        groups = sorted({g for e in self._exprs(self._tree_nodes)
                         for g in e.groups})
        self._group_slot = {g: k for k, g in enumerate(groups)}
        self._fbuf = [torch.zeros((n, 3), **f64) for _ in groups]
        self._ebuf = [torch.zeros((), **f64) for _ in groups]
        # the inputs of each group's buffers; NaN equals nothing
        nan = float("nan")
        self._fpos = [torch.full((n, 3), nan, **f64) for _ in groups]
        self._fbox = [torch.full((3, 3), nan, **f64) for _ in groups]
        self._fgp = [torch.full_like(ctx._gp, nan) for _ in groups]

    def _walk(self, nodes, kind):
        for node in nodes:
            if node[0] != "op":
                if node[0] == kind:
                    yield node
                yield from self._walk(node[2], kind)

    def _state_tensors(self) -> list:
        if self._globals is None:
            return []
        return ([self._globals] + list(self._perdof.values())
                + [self._xref] + self._fbuf + self._ebuf + self._fpos
                + self._fbox + self._fgp
                + ([] if self._loop_rng is None else [self._loop_rng]))

    # -- kinetic energy ------------------------------------------------------
    def _kinetic_energy_shift(self) -> float:
        return 0.0

    def _kinetic_energy_requires_force(self) -> bool:
        return bool(_Expr(self._ke_expression).groups)

    def _kinetic_energy(self, ctx, forces, dt) -> torch.Tensor:
        """The kinetic-energy expression summed over the DOFs of the
        particles with mass, at the Context's state; f is `forces`."""
        env = self._variables(ctx, dt)
        env.update(x=ctx._state["positions"], v=ctx._state["velocities"])
        if forces is not None:
            env["f"] = forces
        val = _Expr(self._ke_expression).fn(env)
        moving = ctx._inv_masses[:, None] != 0
        n = moving.shape[0]
        if not torch.is_tensor(val):
            val = torch.full((), val, dtype=torch.float64,
                             device=moving.device)
        return torch.sum(torch.where(moving, val.expand(n, 3), 0.0))

    def _variables(self, ctx, dt) -> dict:
        """The names an expression reads besides x, v, the forces and the
        random numbers: m, dt, the globals, the per-DOF variables and the
        Context's global parameters, as device tensors (views that see
        every write)."""
        env = {name: ctx._gp[i] for name, i in ctx._gp_index.items()}
        env.update({name: self._globals[i]
                    for i, (name, _) in enumerate(self._global_vars)})
        env.update(self._perdof)
        env["m"] = ctx._masses[:, None]
        env["dt"] = dt
        return env

    # -- the step ------------------------------------------------------------
    def _make_step_fn(self, deps: StepDeps):
        return _Step(self, deps)


class _Trace:
    """What the step knows, where it is traced, of the force cache: the
    groups whose buffers are valid (`valid`) and those that are not
    (`stale`); any other group is unknown and its validity is read on the
    device."""

    def __init__(self, valid=None, stale=()):
        self.valid = dict(valid or {})
        self.stale = set(stale)


class _Step:
    """The step function of a CustomIntegrator, bound to one StepDeps."""

    def __init__(self, integ: CustomIntegrator, deps: StepDeps):
        self.integ = integ
        self.deps = deps
        ctx = integ._context
        self.ctx = ctx
        self.moving = deps.moving
        self.n = deps.inv_masses.shape[0]
        self.env0 = integ._variables(ctx, deps.params[0])
        self.trace = _Trace()
        self.box = None
        self.randoms = {}           # id(_Expr) -> drawn numbers
        self.in_loop = 0            # the depth of while blocks being walked

    def __call__(self, pos, vel, box):
        integ = self.integ
        x, v = integ._x, integ._v
        x.copy_(pos)
        v.copy_(vel)
        integ._xref.copy_(pos)
        self.box = box
        self.trace = _Trace()
        self.randoms = {}
        rng = integ._loop_rng
        if rng is not None:
            # the step's seed of the draws inside while blocks
            rng[0].copy_(torch.randint(
                0, 2 ** 31 - 1, (), generator=self.deps.generator,
                device=rng.device))
            rng[1].zero_()
        self._nodes(integ._tree_nodes, top=True)
        self.deps.step.add_(1)
        return x.clone(), v.clone()

    # -- forces ---------------------------------------------------------------
    def _forces(self, group):
        """(energy, forces) of `group` at the current x, from the cache
        where valid; an evaluation of a group whose validity the trace
        cannot know sits under a branch on its inputs' equality with the
        current ones."""
        tr = self.trace
        if group in tr.valid:
            return tr.valid[group]
        integ, gp = self.integ, self.ctx._gp
        k = integ._group_slot[group]

        def evaluate():
            e, f = self.deps.forces_by_groups(integ._x, self.box,
                                              _mask(group))
            integ._ebuf[k].copy_(e)
            integ._fbuf[k].copy_(f)
            integ._fpos[k].copy_(integ._x)
            integ._fbox[k].copy_(self.box)
            integ._fgp[k].copy_(gp)

        if group in tr.stale:
            evaluate()
        else:
            same = ((integ._fpos[k] == integ._x).all()
                    & (integ._fbox[k] == self.box).all()
                    & (integ._fgp[k] == gp).all())
            self.deps.branch(~same, evaluate)
        tr.stale.discard(group)
        tr.valid[group] = (integ._ebuf[k], integ._fbuf[k])
        return tr.valid[group]

    def _invalidate(self):
        """The step moved the positions (or the box, or a parameter): no
        force is valid."""
        self.trace = _Trace(stale=self.integ._group_slot)

    # -- expressions ---------------------------------------------------------
    def _draw(self, expr, perdof):
        """The random numbers `expr` names: one draw each."""
        deps = self.deps
        shape = (self.n, 3) if perdof else ()
        out = {}
        for name in expr.randoms:
            fn = torch.randn if name == "gaussian" else torch.rand
            out[name] = fn(shape, generator=deps.generator,
                           dtype=torch.float64,
                           device=deps.inv_masses.device)
        return out

    def _loop_draw(self, expr, perdof):
        """The random numbers `expr` names inside a while block: each a
        new counter value hashed with the step's seed."""
        rng = self.integ._loop_rng
        shape = (self.n, 3) if perdof else ()
        out = {}
        for name in expr.randoms:
            rng[1].add_(1)
            out[name] = _hashed(rng[0], rng[1], shape, name == "gaussian",
                                rng.device)
        return out

    def _predraw(self, nodes):
        """Draw, before a block, the random numbers its operations and
        the conditions of its inner if blocks name (a while block's come
        from _loop_draw)."""
        for node in nodes:
            if node[0] == "while":
                continue
            if node[0] == "op":
                exprs = [(node[3], node[1] != ComputeGlobal)]
            else:
                exprs = [(node[1][0], False), (node[1][2], False)]
                self._predraw(node[2])
            for expr, perdof in exprs:
                if expr is not None and expr.randoms:
                    self.randoms[id(expr)] = self._draw(expr, perdof)

    def _eval(self, expr, perdof, top):
        env = dict(self.env0)
        env["x"] = self.integ._x
        env["v"] = self.integ._v
        for g in expr.groups:
            e, f = self._forces(g)
            if g == -1:
                env["energy"], env["f"] = e, f
            else:
                env["energy%d" % g], env["f%d" % g] = e, f
        if expr.randoms:
            env.update(self._loop_draw(expr, perdof) if self.in_loop
                       else self._draw(expr, perdof) if top
                       else self.randoms[id(expr)])
        return expr.fn(env)

    def _condition(self, cond, top):
        lhs, op, rhs = cond
        out = _COMPARE[op](self._eval(lhs, False, top),
                           self._eval(rhs, False, top))
        if not torch.is_tensor(out):
            # numbers alone: a constant branch
            return torch.full((), bool(out), dtype=torch.bool,
                              device=self.deps.inv_masses.device)
        if out.dim() != 0:
            raise ValueError("a block's condition must be a global value")
        return out

    # -- the tree -------------------------------------------------------------
    def _nodes(self, nodes, top):
        for node in nodes:
            if node[0] == "op":
                self._op(node, top)
            elif node[0] == "if":
                self._if(node, top)
            else:
                self._while(node, top)

    def _if(self, node, top):
        _, cond, children = node
        if top:
            self._predraw(children)
        pred = self._condition(cond, top)
        outer = self.trace

        def body():
            self.trace = _Trace(outer.valid, outer.stale)
            self._nodes(children, False)

        self.deps.branch(pred, body)
        self.trace = _Trace()

    def _while(self, node, top):
        _, cond, children = node

        def inside(fn):
            self.in_loop += 1
            try:
                return fn()
            finally:
                self.in_loop -= 1

        def body():
            self.trace = _Trace()
            inside(lambda: self._nodes(children, False))

        self.deps.loop(lambda: inside(lambda: self._condition(cond, False)),
                       body)
        self.trace = _Trace()

    def _op(self, node, top):
        _, kind, var, expr = node
        integ, deps = self.integ, self.deps
        x, v = integ._x, integ._v
        if kind == UpdateContextState:
            pos, vel = x, v
            for hook in deps.update_hooks:
                pos, vel = hook(deps.step, pos, vel, self.box)
            if pos is not x:
                x.copy_(pos)
            if vel is not v:
                v.copy_(vel)
            if self.ctx._barostats:
                # a barostat scales whole molecules: still constrained
                integ._xref.copy_(x)
                self._invalidate()
            return
        if kind == ConstrainPositions:
            x.copy_(deps.compute_vsites(
                deps.apply_position_constraints_corr(integ._xref, x)[0]))
            integ._xref.copy_(x)
            self._invalidate()
            return
        if kind == ConstrainVelocities:
            v.copy_(deps.apply_velocity_constraints(x, v))
            return
        val = self._eval(expr, kind != ComputeGlobal, top)
        if kind == ComputeSum:
            if not torch.is_tensor(val):
                val = torch.full((), val, dtype=torch.float64,
                                 device=x.device)
            val = torch.sum(torch.where(self.moving,
                                        val.expand(self.n, 3), 0.0))
        if kind in (ComputeGlobal, ComputeSum):
            self._assign(self._global_target(var), val)
            return
        if var == "x":
            x.copy_(deps.compute_vsites(torch.where(self.moving, val, x)))
            self._invalidate()
        elif var == "v":
            v.copy_(torch.where(self.moving, val, v))
        elif var in integ._perdof:
            self._assign(integ._perdof[var], val)
        else:
            raise ValueError("unknown per-DOF variable: " + var)

    def _global_target(self, var):
        integ, ctx = self.integ, self.ctx
        for i, (name, _) in enumerate(integ._global_vars):
            if name == var:
                return integ._globals[i]
        if var in ctx._gp_index:
            # forces may read a global parameter
            self._invalidate()
            return ctx._gp[ctx._gp_index[var]]
        raise ValueError("unknown global variable: " + var)

    @staticmethod
    def _assign(target, val):
        if torch.is_tensor(val):
            target.copy_(val.expand_as(target))
        else:
            target.fill_(float(val))
