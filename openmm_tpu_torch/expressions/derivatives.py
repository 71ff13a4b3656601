"""Symbolic derivatives of parsed expressions.

The JAX package takes every force and every energy parameter derivative of
its custom forces from jax.grad. The port's MD step takes no autograd (it
is one captured CUDA graph, held bit for bit against the eager loop, and
autograd's backward of a gather adds with float atomics), so it
differentiates the expression itself, as OpenMM's Lepton does
(ExpressionTreeNode differentiate, Operation.cpp): `differentiate(ast,
name)` returns the AST of the partial derivative, folded as it is built
(0 * x is 0, 1 * x is x, numbers fold), over the parser's AST with the
definitions substituted (`inline`). The chain rule runs through every
function the compiler lowers. At kinks and jumps it takes Lepton's
conventions: step, delta, floor and ceil have derivative 0; min, max, abs
and select take the branch they evaluate (abs' = 1 at 0, min takes its
second argument at a tie, max its first). A function the caller supplies
(a tabulated function, a geometry call) is a leaf: its partial with
respect to argument k is the node ("dcall", name, k, args), which the
caller's Function evaluates (compiler.py).
"""
from __future__ import annotations

import math

from .parser import ExpressionError

ZERO = ("num", 0.0)
ONE = ("num", 1.0)
TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def _num(value) -> tuple:
    return ("num", float(value))


def _is(a, value=None) -> bool:
    return a[0] == "num" and (value is None or a[1] == value)


def add(a, b):
    if _is(a, 0.0):
        return b
    if _is(b, 0.0):
        return a
    if _is(a) and _is(b):
        return _num(a[1] + b[1])
    return ("+", a, b)


def sub(a, b):
    if _is(b, 0.0):
        return a
    if _is(a, 0.0):
        return neg(b)
    if _is(a) and _is(b):
        return _num(a[1] - b[1])
    return ("-", a, b)


def mul(a, b):
    if _is(a, 0.0) or _is(b, 0.0):
        return ZERO
    if _is(a, 1.0):
        return b
    if _is(b, 1.0):
        return a
    if _is(a) and _is(b):
        return _num(a[1] * b[1])
    return ("*", a, b)


def div(a, b):
    if _is(a, 0.0):
        return ZERO
    if _is(b, 1.0):
        return a
    if _is(a) and _is(b):
        return _num(a[1] / b[1])
    return ("/", a, b)


def neg(a):
    if _is(a):
        return _num(-a[1])
    if a[0] == "neg":
        return a[1]
    return ("neg", a)


def power(a, b):
    if _is(b, 0.0):
        return ONE
    if _is(b, 1.0):
        return a
    return ("^", a, b)


def call(name, *args):
    return ("call", name, tuple(args))


def inline(ast, defs, stack=frozenset()):
    """`ast` with every defined name replaced by its definition, as tuples
    (hashable: the evaluator caches values by subtree)."""
    kind = ast[0]
    if kind == "num":
        return ast
    if kind == "var":
        name = ast[1]
        if name in defs:
            if name in stack:
                raise ExpressionError("circular definition of %r" % name)
            return inline(defs[name], defs, stack | {name})
        return ast
    if kind == "neg":
        return ("neg", inline(ast[1], defs, stack))
    if kind == "call":
        return ("call", ast[1], tuple(inline(a, defs, stack)
                                      for a in ast[2]))
    return (kind, inline(ast[1], defs, stack), inline(ast[2], defs, stack))


def free_variables(ast) -> set:
    kind = ast[0]
    if kind == "num":
        return set()
    if kind == "var":
        return {ast[1]}
    if kind == "neg":
        return free_variables(ast[1])
    if kind in ("call", "dcall"):
        out = set()
        for a in ast[-1]:
            out |= free_variables(a)
        return out
    return free_variables(ast[1]) | free_variables(ast[2])


def replace_calls(ast, names, found=None):
    """(ast with each call of a function in `names` replaced by a variable
    "__call<k>", [(variable, name, args)]): distinct calls by structure,
    in the order of first appearance. The custom compound and centroid
    forces take their geometry calls out so; their gradients in the
    points are written by hand."""
    found = {} if found is None else found

    def walk(node):
        kind = node[0]
        if kind in ("num", "var"):
            return node
        if kind == "neg":
            return ("neg", walk(node[1]))
        if kind == "call":
            args = tuple(walk(a) for a in node[2])
            if node[1] in names:
                key = (node[1], args)
                if key not in found:
                    found[key] = "__call%d" % len(found)
                return ("var", found[key])
            return ("call", node[1], args)
        return (kind, walk(node[1]), walk(node[2]))

    out = walk(ast)
    return out, [(var, name, args) for (name, args), var in found.items()]


def _d_call(name, args, d):
    """The derivative of a built-in function of `args` whose arguments'
    derivatives are d; None when `name` with this many arguments is not
    built in."""
    if len(args) == 1:
        x, dx = args[0], d[0]
        if _is(dx, 0.0):
            return ZERO
        table = {
            "sqrt": lambda: div(mul(_num(0.5), dx), call("sqrt", x)),
            "exp": lambda: mul(call("exp", x), dx),
            "log": lambda: div(dx, x),
            "sin": lambda: mul(call("cos", x), dx),
            "cos": lambda: neg(mul(call("sin", x), dx)),
            "tan": lambda: div(dx, power(call("cos", x), _num(2))),
            "sec": lambda: mul(mul(call("sec", x), call("tan", x)), dx),
            "csc": lambda: neg(mul(mul(call("csc", x), call("cot", x)), dx)),
            "cot": lambda: neg(div(dx, power(call("sin", x), _num(2)))),
            "asin": lambda: div(dx, call("sqrt", sub(ONE, mul(x, x)))),
            "acos": lambda: neg(div(dx, call("sqrt", sub(ONE, mul(x, x))))),
            "atan": lambda: div(dx, add(ONE, mul(x, x))),
            "sinh": lambda: mul(call("cosh", x), dx),
            "cosh": lambda: mul(call("sinh", x), dx),
            "tanh": lambda: mul(sub(ONE, power(call("tanh", x), _num(2))),
                                dx),
            "erf": lambda: mul(mul(_num(TWO_OVER_SQRT_PI),
                                   call("exp", neg(mul(x, x)))), dx),
            "erfc": lambda: neg(mul(mul(_num(TWO_OVER_SQRT_PI),
                                        call("exp", neg(mul(x, x)))), dx)),
            # Lepton: d|x| = (2 step(x) - 1) dx, so +dx at 0
            "abs": lambda: mul(sub(mul(_num(2), call("step", x)), ONE), dx),
            "floor": lambda: ZERO, "ceil": lambda: ZERO,
            "step": lambda: ZERO, "delta": lambda: ZERO,
            "square": lambda: mul(mul(_num(2), x), dx),
            "cube": lambda: mul(mul(_num(3), mul(x, x)), dx),
            "recip": lambda: neg(div(dx, mul(x, x))),
        }
        fn = table.get(name)
        return None if fn is None else fn()
    if len(args) == 2:
        (a, b), (da, db) = args, d
        if name in ("min", "max"):
            # Lepton: step(a - b) picks b for min, a for max, at a tie too
            s = call("step", sub(a, b))
            first, second = (db, da) if name == "min" else (da, db)
            return add(mul(first, s), mul(second, sub(ONE, s)))
        if name == "atan2":
            # atan2(y, x): (x dy - y dx) / (x^2 + y^2)
            return div(sub(mul(b, da), mul(a, db)),
                       add(mul(a, a), mul(b, b)))
        if name == "pow":
            return _d_power(a, b, da, db, lambda x, y: call("pow", x, y))
        return None
    if len(args) == 3 and name == "select":
        return call("select", args[0], d[1], d[2]) \
            if not (_is(d[1], 0.0) and _is(d[2], 0.0)) else ZERO
    return None


def _d_power(a, b, da, db, make):
    """d(a^b): b a^(b-1) da for a number b, else a^b (db log a + b da / a)."""
    if _is(b):
        if _is(da, 0.0):
            return ZERO
        return mul(mul(b, make(a, _num(b[1] - 1.0))), da)
    out = mul(make(a, b), mul(db, call("log", a)))
    if not _is(da, 0.0):
        out = add(out, mul(make(a, b), div(mul(b, da), a)))
    return out


def differentiate(ast, name):
    """The AST of d ast / d name; `ast` with its definitions inlined."""
    kind = ast[0]
    if kind == "num":
        return ZERO
    if kind == "var":
        return ONE if ast[1] == name else ZERO
    if kind == "neg":
        return neg(differentiate(ast[1], name))
    if kind == "call":
        fname, args = ast[1], ast[2]
        d = [differentiate(a, name) for a in args]
        if all(_is(x, 0.0) for x in d):
            return ZERO
        out = _d_call(fname, args, d)
        if out is not None:
            return out
        # a function the caller supplies: its partials times the
        # arguments' derivatives
        total = ZERO
        for k, dk in enumerate(d):
            if not _is(dk, 0.0):
                total = add(total, mul(("dcall", fname, k, args), dk))
        return total
    if kind == "dcall":
        raise ExpressionError("a second derivative of the supplied function "
                              "%r" % ast[1])
    a, b = ast[1], ast[2]
    da, db = differentiate(a, name), differentiate(b, name)
    if kind == "+":
        return add(da, db)
    if kind == "-":
        return sub(da, db)
    if kind == "*":
        return add(mul(da, b), mul(a, db))
    if kind == "/":
        return sub(div(da, b), div(mul(a, db), mul(b, b)))
    if kind == "^":
        return _d_power(a, b, da, db, power)
    raise ExpressionError("unknown AST node %r" % (kind,))
