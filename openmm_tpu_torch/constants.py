"""Physical constants in MD units (nm, ps, amu, kJ/mol, e, K).

The same CODATA values the JAX package uses (openmm_tpu/constants.py), kept
as this package's own copy so that nothing here imports openmm_tpu.
"""
import math

AVOGADRO = 6.02214076e23
E_CHARGE = 1.602176634e-19
BOLTZMANN_SI = 1.380649e-23                      # J/K
RGAS = BOLTZMANN_SI * AVOGADRO                   # J/(mol K)
BOLTZ = RGAS / 1e3                               # kJ/(mol K)
EPSILON0 = 1e-6 * 8.8541878128e-12 / (E_CHARGE * E_CHARGE * AVOGADRO)
ONE_4PI_EPS0 = 1.0 / (4.0 * math.pi * EPSILON0)  # kJ nm / (mol e^2)
