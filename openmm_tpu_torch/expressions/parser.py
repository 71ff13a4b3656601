"""Tokenizer and Pratt parser of the Lepton expression grammar.

A copy of openmm_tpu/expressions/parser.py (libraries/lepton/src/Parser.cpp
in OpenMM): + - * / and ^ (right-associative), unary minus, parentheses,
function calls, and semicolon-separated definitions after the main
expression ("k*d^2; d=r-r0").
"""
from __future__ import annotations

import re


class ExpressionError(ValueError):
    """An expression that does not parse or names what is not defined."""


# AST: tuples ('num', v) | ('var', name) | ('call', name, [args]) |
#      ('+', a, b) | ('-', a, b) | ('*', a, b) | ('/', a, b) | ('^', a, b) |
#      ('neg', a)

_TOKEN_RE = re.compile(r"""
    (?P<num>(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>[-+*/^(),])
  | (?P<ws>\s+)
""", re.VERBOSE)


def _tokenize(text):
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ExpressionError("unexpected character %r in expression %r"
                                  % (text[pos], text))
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        tokens.append((m.lastgroup, m.group()))
    tokens.append(("end", ""))
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        t = self.tokens[self.i]
        self.i += 1
        return t

    def expect(self, value):
        t = self.next()
        if t[1] != value:
            raise ExpressionError("expected %r, found %r" % (value, t[1]))

    # precedence: + - (10) < * / (20) < unary- (25) < ^ (30, right-assoc)
    def parse(self, min_prec=0):
        left = self.parse_unary()
        while True:
            kind, val = self.peek()
            prec = {"+": 10, "-": 10, "*": 20, "/": 20, "^": 30}.get(val)
            if kind != "op" or prec is None or prec < min_prec:
                return left
            self.next()
            # right-assoc for ^, left for the rest
            right = self.parse(prec if val == "^" else prec + 1)
            left = (val, left, right)

    def parse_unary(self):
        kind, val = self.peek()
        if kind == "op" and val == "-":
            self.next()
            # unary minus binds tighter than * but looser than ^:
            # -x^2 == -(x^2)
            return ("neg", self.parse(25))
        if kind == "op" and val == "+":
            self.next()
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", float(val))
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    while True:
                        args.append(self.parse(0))
                        k, v = self.next()
                        if v == ")":
                            break
                        if v != ",":
                            raise ExpressionError(
                                "expected , or ) in call to %s" % val)
                else:
                    self.next()
                return ("call", val, args)
            return ("var", val)
        if val == "(":
            inner = self.parse(0)
            self.expect(")")
            return inner
        raise ExpressionError("unexpected token %r" % val)


def parse_expression(text):
    """Parse a full (possibly multi-statement) expression. Returns
    (main_ast, {name: ast}) where named subexpressions come from trailing
    'name=expr' statements (Lepton CustomFunction-style definitions)."""
    parts = [p.strip() for p in text.split(";") if p.strip()]
    if not parts:
        raise ExpressionError("empty expression")
    main = _parse_single(parts[0])
    defs = {}
    for part in parts[1:]:
        if "=" not in part:
            raise ExpressionError("expected name=expression in %r" % part)
        name, rhs = part.split("=", 1)
        name = name.strip()
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
            raise ExpressionError("invalid variable name %r" % name)
        defs[name] = _parse_single(rhs.strip())
    return main, defs


def _parse_single(text):
    p = _Parser(_tokenize(text))
    ast = p.parse(0)
    if p.peek()[0] != "end":
        raise ExpressionError("unexpected trailing tokens in %r" % text)
    return ast


def variables_in(ast, defs=None, _seen=None):
    """Free variables of an expression (after substituting definitions)."""
    defs = defs or {}
    _seen = _seen or set()
    out = set()
    kind = ast[0]
    if kind == "num":
        return out
    if kind == "var":
        name = ast[1]
        if name in defs:
            if name in _seen:
                raise ExpressionError("circular definition of %r" % name)
            return variables_in(defs[name], defs, _seen | {name})
        out.add(name)
        return out
    if kind == "call":
        for a in ast[2]:
            out |= variables_in(a, defs, _seen)
        return out
    if kind == "neg":
        return variables_in(ast[1], defs, _seen)
    return (variables_in(ast[1], defs, _seen)
            | variables_in(ast[2], defs, _seen))
