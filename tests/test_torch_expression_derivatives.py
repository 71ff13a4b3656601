"""Symbolic derivatives of the port's expression compiler
(openmm_tpu_torch/expressions/derivatives.py) against torch.autograd.

Every function the compiler lowers is differentiated at seeded inputs away
from its kinks and jumps and held against autograd of the same emitted
expression (1e-12 relative); the soft-core energy of an alchemical run and
an expression with nested definitions in several variables too. At the
kinks the derivative takes Lepton's conventions (step, delta, floor and
ceil 0; min, max, abs and select the branch they evaluate), and a supplied
function's value and partials are evaluated once per distinct call.
"""
import numpy as np
import pytest
import torch

from openmm_tpu_torch.expressions import (Function,
                                          compile_energy_derivatives,
                                          compile_energy_expression)
from openmm_tpu_torch.models.builders import SOFTCORE

torch.set_num_threads(1)
TOL = 1e-12

# (expression in x, y, z; the range the inputs are drawn from)
CASES = {
    "sqrt": ("sqrt(x)", (0.2, 3.0)),
    "exp": ("exp(x)", (-2.0, 2.0)),
    "log": ("log(x)", (0.2, 3.0)),
    "sin": ("sin(x)", (-3.0, 3.0)),
    "cos": ("cos(x)", (-3.0, 3.0)),
    "tan": ("tan(x)", (-1.2, 1.2)),
    "sec": ("sec(x)", (-1.2, 1.2)),
    "csc": ("csc(x)", (0.2, 2.9)),
    "cot": ("cot(x)", (0.2, 2.9)),
    "asin": ("asin(x)", (-0.9, 0.9)),
    "acos": ("acos(x)", (-0.9, 0.9)),
    "atan": ("atan(x)", (-3.0, 3.0)),
    "sinh": ("sinh(x)", (-2.0, 2.0)),
    "cosh": ("cosh(x)", (-2.0, 2.0)),
    "tanh": ("tanh(x)", (-2.0, 2.0)),
    "erf": ("erf(x)", (-2.0, 2.0)),
    "erfc": ("erfc(x)", (-2.0, 2.0)),
    "min": ("min(x, y)", (-2.0, 2.0)),
    "max": ("max(x, y)", (-2.0, 2.0)),
    "abs": ("abs(x)", (-2.0, 2.0)),
    "floor": ("floor(x)*x", (0.1, 2.9)),
    "ceil": ("ceil(x)*y", (0.1, 2.9)),
    "step": ("step(x)*y*y", (-2.0, 2.0)),
    "delta": ("delta(x)+y", (-2.0, 2.0)),
    "select": ("select(step(x), y*y, z^3)", (-2.0, 2.0)),
    "square": ("square(x*y)", (-2.0, 2.0)),
    "cube": ("cube(x-z)", (-2.0, 2.0)),
    "recip": ("recip(x)", (0.2, 3.0)),
    "pow": ("pow(x, y)", (0.3, 2.0)),
    "atan2": ("atan2(x, y)", (-2.0, 2.0)),
    "powers": ("x^2 - y^-3 + x^2.5 + x^y", (0.3, 2.0)),
    "arithmetic": ("-(x*y - z)/(x + 3) + 2*z", (0.3, 2.0)),
    "nested": ("a*b + sin(b); a=x*exp(c); b=c^2 - y; c=z/(1+x)",
               (0.1, 1.5)),
}


def _inputs(lo, hi, seed=7, n=64):
    rng = np.random.RandomState(seed)
    return {name: torch.tensor(rng.uniform(lo, hi, n), dtype=torch.float64,
                               requires_grad=True) for name in "xyz"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_derivative_matches_autograd(name):
    text, (lo, hi) = CASES[name]
    env = _inputs(lo, hi)
    fn = compile_energy_derivatives(text, ["x", "y", "z"])
    value, partials = fn(env)
    want_value = compile_energy_expression(text)(env)
    torch.testing.assert_close(value, want_value, rtol=0, atol=0)
    wanted = [env[v] for v in "xyz"]
    grads = torch.autograd.grad(want_value.sum(), wanted, allow_unused=True)
    for var, got, want in zip("xyz", partials, grads):
        want = torch.zeros(64, dtype=torch.float64) if want is None else want
        got = got.detach() if torch.is_tensor(got) else torch.full_like(
            want, float(got))
        np.testing.assert_allclose(got.expand_as(want).numpy(),
                                   want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg="d/d%s of %s" % (var, text))


def test_softcore_energy_and_lambda_derivative():
    """The alchemical soft-core energy (models.builders.SOFTCORE) in r and
    lambda_sterics, per-particle parameters broadcast over a pair matrix."""
    rng = np.random.RandomState(3)
    r = torch.tensor(rng.uniform(0.2, 1.0, (16, 24)), requires_grad=True)
    lam = torch.tensor(0.35, dtype=torch.float64, requires_grad=True)
    env = {"r": r, "lambda_sterics": lam,
           "sigma1": torch.tensor(rng.uniform(0.25, 0.35, (16, 1))),
           "sigma2": torch.tensor(rng.uniform(0.25, 0.35, (1, 24))),
           "epsilon1": torch.tensor(rng.uniform(0.1, 1.0, (16, 1))),
           "epsilon2": torch.tensor(rng.uniform(0.1, 1.0, (1, 24)))}
    e, (de_dr, de_dl) = compile_energy_derivatives(
        SOFTCORE, ["r", "lambda_sterics"])(env)
    g_r, g_l = torch.autograd.grad(e.sum(), [r, lam])
    np.testing.assert_allclose(de_dr.detach().numpy(), g_r.numpy(),
                               rtol=TOL, atol=TOL)
    assert abs(float(de_dl.detach().sum()) - float(g_l)) <= TOL * abs(
        float(g_l))


def test_kinks_take_lepton_conventions():
    """At a tie min takes its second argument and max its first, abs' is 1
    at 0, and step, delta, floor and ceil have derivative 0 everywhere."""
    x = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    y = torch.tensor([0.0, 1.0, 3.0], dtype=torch.float64)
    env = {"x": x, "y": y}

    def partials(text):
        _, (dx, dy) = compile_energy_derivatives(text, ["x", "y"])(env)
        return [torch.as_tensor(d, dtype=torch.float64).expand(3).tolist()
                for d in (dx, dy)]

    assert partials("min(x, y)") == [[0.0, 0.0, 1.0], [1.0, 1.0, 0.0]]
    assert partials("max(x, y)") == [[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    assert partials("abs(x - 1)")[0] == [-1.0, 1.0, 1.0]
    for text in ("step(x-1)", "delta(x-1)", "floor(x)", "ceil(x)"):
        assert partials(text) == [[0.0] * 3, [0.0] * 3]
    assert partials("select(x-1, x, 2*y)") == [[1.0, 0.0, 1.0],
                                               [0.0, 2.0, 0.0]]


def test_supplied_function_is_evaluated_once_per_call():
    """A supplied Function with its partials: the chain rule through its
    arguments, and one both() evaluation (value and partials) for a call
    that the expression names twice; the energy alone takes value()."""
    calls = {"value": 0, "both": 0}

    def value(a, b):
        calls["value"] += 1
        return a * a * b

    def both(a, b):
        calls["both"] += 1
        return a * a * b, [2.0 * a * b, a * a]

    fns = {"f": Function(value, both)}
    env = _inputs(0.5, 1.5)
    e, (dx, dy) = compile_energy_derivatives(
        "f(x, 2*y)^2 + f(x, 2*y)", ["x", "y"], fns)(env)
    assert calls == {"value": 0, "both": 1}
    x, y = env["x"], env["y"]
    want = (x * x * 2 * y) ** 2 + x * x * 2 * y
    gx, gy = torch.autograd.grad(want.sum(), [x, y])
    np.testing.assert_allclose(e.detach().numpy(), want.detach().numpy(),
                               rtol=TOL)
    np.testing.assert_allclose(dx.detach().numpy(), gx.numpy(), rtol=TOL)
    np.testing.assert_allclose(dy.detach().numpy(), gy.numpy(), rtol=TOL)
    compile_energy_derivatives("f(x, y) + z", ["z"], fns)(env)
    assert calls == {"value": 1, "both": 1}


def test_numbers_fold_and_absent_variables_give_zero():
    value, (dx, dz) = compile_energy_derivatives(
        "2*3 + x*x*sqrt(4)", ["x", "z"])({"x": torch.tensor(3.0)})
    assert float(value) == 24.0 and float(dx) == 12.0 and dz == 0.0
