"""The Lepton expression grammar, compiled to PyTorch.

Counterpart of openmm_tpu/expressions (a copy: the port imports nothing of
the JAX package). An expression is parsed once into an AST and emitted as
torch operations on the tensors of an environment; the constants fold on
the host, so evaluating an expression on device tensors never reads from
the device. Derivatives are symbolic (derivatives.py), as Lepton's.
"""
from .compiler import (Function, compile_energy_derivatives,
                       compile_energy_expression, compile_expression,
                       expression_variables, parse_inlined)
from .derivatives import differentiate
from .parser import ExpressionError, parse_expression, variables_in

__all__ = ["ExpressionError", "Function", "compile_energy_derivatives",
           "compile_energy_expression", "compile_expression",
           "differentiate", "expression_variables", "parse_expression",
           "parse_inlined", "variables_in"]
