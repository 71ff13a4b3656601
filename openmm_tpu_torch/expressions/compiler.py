"""AST -> torch operations.

Counterpart of openmm_tpu/expressions/compiler.py. The function set is
Lepton's (libraries/lepton/include/lepton/Operation.h): sqrt, exp, log,
sin, cos, sec, csc, tan, cot, asin, acos, atan, atan2, sinh, cosh, tanh,
erf, erfc, min, max, abs, floor, ceil, step, delta, select, square, cube,
recip and pow; step, delta and select are torch.where. An integer power
up to 8 is lowered to products, as the JAX compiler lowers it (x^2 of a
negative base must work). Numbers stay Python floats, and a function of
numbers alone folds on the host (math), so an expression evaluates to a
float or to a tensor and never reads a tensor back. A name that is neither
a function of the set nor one the caller supplies raises
NotImplementedError when the expression is compiled.

compile_energy_derivatives compiles an energy with its partial
derivatives (derivatives.py, symbolic, as OpenMM's Lepton takes them): one
call evaluates the energy and every partial, each distinct subtree once
(a cache keyed on the subtree's structure), so the derivative of a
soft-core energy reuses the energy's x. A supplied function with partials
is a Function: value(*args), and both(*args) -> (value, the list of its
partials in its arguments), which a call whose partials the derivatives
need takes, once.
"""
from __future__ import annotations

import math

import torch

from .derivatives import differentiate, inline
from .parser import ExpressionError, parse_expression, variables_in


def _is_number(x) -> bool:
    return isinstance(x, (int, float))


def _unary(tensor_fn, number_fn):
    def fn(x):
        return number_fn(x) if _is_number(x) else tensor_fn(x)
    return fn


def _where(cond, a, b):
    return torch.where(cond, a, b)


def _step(x):
    if _is_number(x):
        return 1.0 if x >= 0 else 0.0
    return _where(x >= 0, 1.0, 0.0).to(x.dtype)


def _delta(x):
    if _is_number(x):
        return 1.0 if x == 0 else 0.0
    return _where(x == 0, 1.0, 0.0).to(x.dtype)


def _select(x, y, z):
    if _is_number(x):
        return y if x != 0 else z
    if _is_number(y) and _is_number(z):
        return _where(x != 0, y, z).to(x.dtype)
    return _where(x != 0, y, z)


def _binary(tensor_fn, number_fn):
    def fn(a, b):
        if _is_number(a) and _is_number(b):
            return number_fn(a, b)
        ref = b if _is_number(a) else a
        if _is_number(a):
            a = torch.full((), float(a), dtype=ref.dtype, device=ref.device)
        if _is_number(b):
            b = torch.full((), float(b), dtype=ref.dtype, device=ref.device)
        return tensor_fn(a, b)
    return fn


def _power(a, b):
    if _is_number(a) and _is_number(b):
        return float(a) ** float(b)
    return torch.pow(a, b)


_FUNCS_1 = {
    "sqrt": _unary(torch.sqrt, math.sqrt),
    "exp": _unary(torch.exp, math.exp),
    "log": _unary(torch.log, math.log),
    "sin": _unary(torch.sin, math.sin),
    "cos": _unary(torch.cos, math.cos),
    "tan": _unary(torch.tan, math.tan),
    "asin": _unary(torch.asin, math.asin),
    "acos": _unary(torch.acos, math.acos),
    "atan": _unary(torch.atan, math.atan),
    "sinh": _unary(torch.sinh, math.sinh),
    "cosh": _unary(torch.cosh, math.cosh),
    "tanh": _unary(torch.tanh, math.tanh),
    "erf": _unary(torch.special.erf, math.erf),
    "erfc": _unary(torch.special.erfc, math.erfc),
    "abs": _unary(torch.abs, abs),
    "floor": _unary(torch.floor, lambda x: float(math.floor(x))),
    "ceil": _unary(torch.ceil, lambda x: float(math.ceil(x))),
    "step": _step,
    "delta": _delta,
    "sec": lambda x: 1.0 / _FUNCS_1["cos"](x),
    "csc": lambda x: 1.0 / _FUNCS_1["sin"](x),
    "cot": lambda x: 1.0 / _FUNCS_1["tan"](x),
    "square": lambda x: x * x,
    "cube": lambda x: x * x * x,
    "recip": lambda x: 1.0 / x,
}
_FUNCS_2 = {
    "min": _binary(torch.minimum, min),
    "max": _binary(torch.maximum, max),
    "atan2": _binary(torch.atan2, math.atan2),
    "pow": _power,
}
_FUNCS_3 = {"select": _select}
FUNCTIONS = {name: n for n, table in ((1, _FUNCS_1), (2, _FUNCS_2),
                                      (3, _FUNCS_3)) for name in table}


def _emit(ast, env, defs, functions, stack):
    kind = ast[0]
    if kind == "num":
        return ast[1]
    if kind == "var":
        name = ast[1]
        if name in env:
            return env[name]
        if name in defs:
            if name in stack:
                raise ExpressionError("circular definition of %r" % name)
            return _emit(defs[name], env, defs, functions, stack | {name})
        raise ExpressionError("unknown variable %r" % name)
    if kind == "neg":
        return -_emit(ast[1], env, defs, functions, stack)
    if kind == "call":
        name = ast[1]
        args = [_emit(a, env, defs, functions, stack) for a in ast[2]]
        if name in functions:
            return functions[name](*args)
        table = {1: _FUNCS_1, 2: _FUNCS_2, 3: _FUNCS_3}.get(len(args), {})
        if name in table:
            return table[name](*args)
        raise NotImplementedError("the function %r with %d arguments is not "
                                  "in the port's expression compiler"
                                  % (name, len(args)))
    a = _emit(ast[1], env, defs, functions, stack)
    b = _emit(ast[2], env, defs, functions, stack)
    return _binary_op(kind, a, b)


def _binary_op(kind, a, b):
    if kind == "+":
        return a + b
    if kind == "-":
        return a - b
    if kind == "*":
        return a * b
    if kind == "/":
        return a / b
    if kind == "^":
        # integer exponents lower to repeated multiplication
        if _is_number(b) and float(b).is_integer() and abs(b) <= 8:
            n = int(b)
            if n == 0:
                return torch.ones_like(a) if torch.is_tensor(a) else 1.0
            out = a
            for _ in range(abs(n) - 1):
                out = out * a
            return out if n > 0 else 1.0 / out
        return _power(a, b)
    raise ExpressionError("unknown AST node %r" % (kind,))


def _check_functions(ast, functions):
    """NotImplementedError for a call of a function that is neither in the
    set nor supplied, found when the expression is compiled."""
    kind = ast[0]
    if kind == "call":
        name, args = ast[1], ast[2]
        if name not in functions and FUNCTIONS.get(name) != len(args):
            raise NotImplementedError(
                "the function %r with %d arguments is not in the port's "
                "expression compiler" % (name, len(args)))
        for a in args:
            _check_functions(a, functions)
    elif kind == "neg":
        _check_functions(ast[1], functions)
    elif kind not in ("num", "var"):
        _check_functions(ast[1], functions)
        _check_functions(ast[2], functions)


def _parse_checked(text, functions):
    main, defs = parse_expression(text)
    for ast in (main, *defs.values()):
        _check_functions(ast, functions)
    return main, defs


def compile_expression(text, variable_names, functions=None):
    """Compile `text` into fn(*values), the values in the order of
    variable_names. `functions`: name -> callable for further
    functions."""
    functions = functions or {}
    main, defs = _parse_checked(text, functions)

    def fn(*values):
        env = dict(zip(variable_names, values))
        return _emit(main, env, defs, functions, frozenset())

    return fn


def compile_energy_expression(text, functions=None):
    """Compile into fn(env) -> value, the free variables looked up in the
    dict `env` at call time."""
    functions = functions or {}
    main, defs = _parse_checked(text, functions)

    def fn(env):
        return _emit(main, env, defs, functions, frozenset())

    return fn


def expression_variables(text) -> set:
    """The free variables of an expression, its definitions substituted."""
    main, defs = parse_expression(text)
    return variables_in(main, defs)


class Function:
    """A function the caller supplies, with its partial derivatives:
    value(*args) -> tensor and both(*args) -> (tensor, [d/d arg_k])."""

    def __init__(self, value, both):
        self.value = value
        self.both = both

    def __call__(self, *args):
        return self.value(*args)


_MISSING = object()


def evaluate(ast, env, functions, cache, paired=frozenset()):
    """The value of an inlined (tuple) AST, each distinct subtree computed
    once per `cache` (a dict the caller owns for one set of inputs); the
    calls in `paired` ((name, argument ASTs) of a Function whose partials
    will be asked for) take value and partials in one both() call."""
    hit = cache.get(ast, _MISSING)
    if hit is not _MISSING:
        return hit
    kind = ast[0]
    if kind == "num":
        out = ast[1]
    elif kind == "var":
        if ast[1] not in env:
            raise ExpressionError("unknown variable %r" % ast[1])
        out = env[ast[1]]
    elif kind == "neg":
        out = -evaluate(ast[1], env, functions, cache, paired)
    elif kind == "call":
        name = ast[1]
        args = [evaluate(a, env, functions, cache, paired) for a in ast[2]]
        if (name, ast[2]) in paired:
            out, cache[("grad", name, ast[2])] = functions[name].both(*args)
        elif name in functions:
            out = functions[name](*args)
        else:
            out = {1: _FUNCS_1, 2: _FUNCS_2, 3: _FUNCS_3}[len(args)][name](
                *args)
    elif kind == "dcall":
        _, name, k, arg_asts = ast
        key = ("grad", name, arg_asts)
        grads = cache.get(key, _MISSING)
        if grads is _MISSING:
            fn = functions.get(name)
            if not isinstance(fn, Function):
                raise NotImplementedError(
                    "the function %r has no derivatives" % name)
            grads = fn.both(*(evaluate(a, env, functions, cache, paired)
                              for a in arg_asts))[1]
            cache[key] = grads
        out = grads[k]
    else:
        out = _binary_op(kind,
                         evaluate(ast[1], env, functions, cache, paired),
                         evaluate(ast[2], env, functions, cache, paired))
    cache[ast] = out
    return out


def parse_inlined(text, functions=None):
    """The main expression of `text` with its definitions substituted, as
    a tuple AST; a call of an unknown function raises
    NotImplementedError."""
    main, defs = _parse_checked(text, functions or {})
    return inline(main, defs)


# the symbolic partials of each (inlined AST, names) compiled in this
# process: a force field's long expressions (AMOEBA's bonded terms) are
# differentiated once, not again for every Context built from them
_PARTIALS = {}


def compile_energy_derivatives(text, wrt, functions=None, ast=None):
    """Compile into fn(env) -> (energy, [d energy / d name for name in
    wrt]), each a tensor or a float (0.0 where the energy does not depend
    on the name). `ast`: the inlined AST to compile in place of `text`'s
    (a force that took its geometry calls out of it)."""
    functions = functions or {}
    main = parse_inlined(text, functions) if ast is None else ast
    key = (main, tuple(wrt))
    if key not in _PARTIALS:
        partials = [differentiate(main, name) for name in wrt]
        _PARTIALS[key] = (partials, frozenset(_dcalls(partials)))
    partials, paired = _PARTIALS[key]

    def fn(env):
        cache = {}
        value = evaluate(main, env, functions, cache, paired)
        return value, [evaluate(p, env, functions, cache, paired)
                       for p in partials]

    return fn


def _dcalls(asts):
    """(name, argument ASTs) of every supplied function's partial in
    `asts`."""
    for ast in asts:
        kind = ast[0]
        if kind == "dcall":
            yield ast[1], ast[3]
        elif kind == "call":
            yield from _dcalls(ast[2])
        elif kind == "neg":
            yield from _dcalls([ast[1]])
        elif kind not in ("num", "var"):
            yield from _dcalls([ast[1], ast[2]])
