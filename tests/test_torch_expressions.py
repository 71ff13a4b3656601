"""The expression compiler of openmm_tpu_torch (expressions/) against
openmm_tpu's, on seeded random inputs: every function of the JAX
compiler's set, ^ with integer and non-integer exponents, and ;
definitions, to 1e-12 relative; a function outside the set raises
NotImplementedError when the expression is compiled, and numbers fold on
the host."""
import zlib

import jax
import numpy as np
import pytest
import torch

from openmm_tpu.expressions import compile_energy_expression as jax_compile

import torch_port_helpers  # noqa: F401  (one torch thread)
from openmm_tpu_torch.expressions import (ExpressionError,
                                          compile_energy_expression,
                                          expression_variables)

# expression: the range of x, y and z it is evaluated on
CASES = {
    "sqrt(x)": (0.1, 4.0), "exp(x)": (-3.0, 3.0), "log(x)": (0.1, 4.0),
    "sin(x)": (-3.0, 3.0), "cos(x)": (-3.0, 3.0), "tan(x)": (-1.2, 1.2),
    "asin(x)": (-0.9, 0.9), "acos(x)": (-0.9, 0.9), "atan(x)": (-3.0, 3.0),
    "sinh(x)": (-3.0, 3.0), "cosh(x)": (-3.0, 3.0), "tanh(x)": (-3.0, 3.0),
    "erf(x)": (-3.0, 3.0), "erfc(x)": (-3.0, 3.0), "abs(x)": (-3.0, 3.0),
    "floor(x)": (-3.0, 3.0), "ceil(x)": (-3.0, 3.0),
    "step(x)": (-3.0, 3.0), "delta(floor(x))": (-2.0, 2.0),
    "sec(x)": (-1.2, 1.2), "csc(x)": (0.2, 2.9), "cot(x)": (0.2, 2.9),
    "square(x)": (-3.0, 3.0), "cube(x)": (-3.0, 3.0),
    "recip(x)": (0.2, 3.0), "min(x, y)": (-3.0, 3.0),
    "max(x, y)": (-3.0, 3.0), "atan2(x, y)": (-3.0, 3.0),
    "pow(x, y)": (0.2, 3.0), "select(step(x), y, z)": (-3.0, 3.0),
    "x^2": (-3.0, 3.0), "x^3 - y^-2": (0.3, 3.0), "-x^8": (-1.5, 1.5),
    "x^0 + y^1": (-3.0, 3.0), "x^2.5": (0.1, 3.0), "x^y": (0.2, 2.0),
    "x^-1.5": (0.2, 3.0), "2^x": (-3.0, 3.0),
    "k*d^2; d=x-y; k=z+2": (-3.0, 3.0),
    "a*b - c; a=x+1; b=a*y; c=sqrt(abs(z)) + b": (-3.0, 3.0),
    "-(x - y)/(1 + z*z) + 3.5e-1": (-3.0, 3.0),
    "min(x, 0.5) + max(1, y) + atan2(0.3, z)": (-3.0, 3.0),
}


@pytest.mark.parametrize("text", sorted(CASES))
def test_matches_jax_compiler(text):
    lo, hi = CASES[text]
    rng = np.random.RandomState(zlib.crc32(text.encode()))
    values = {k: rng.uniform(lo, hi, 64) for k in "xyz"}
    want = np.asarray(jax_compile(text)(
        {k: jax.numpy.asarray(v) for k, v in values.items()}), np.float64)
    got = compile_energy_expression(text)(
        {k: torch.as_tensor(v) for k, v in values.items()})
    got = np.broadcast_to(got.numpy(), want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def test_numbers_fold_on_the_host():
    """An expression of numbers alone gives a Python float (no tensor to
    create on a device inside a capture)."""
    value = compile_energy_expression(
        "sqrt(4) + 2^3 + step(-1) + select(0, 1, 7) + min(1, 2); a=1")({})
    assert isinstance(value, float) and value == 18.0


def test_errors():
    with pytest.raises(NotImplementedError, match="frobnicate"):
        compile_energy_expression("frobnicate(x)")
    with pytest.raises(NotImplementedError, match="min"):
        compile_energy_expression("min(x)")
    with pytest.raises(ExpressionError):
        compile_energy_expression("x +* y")
    with pytest.raises(ExpressionError, match="unknown variable"):
        compile_energy_expression("x + q")({"x": torch.ones(2)})
    assert expression_variables("k*d^2; d=r-r0") == {"k", "r", "r0"}
