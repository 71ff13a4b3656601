"""openmm_tpu_torch.unit: dimensioned quantities for the port.

The port's own copy of openmm_tpu/unit/__init__.py: an API-compatible
subset of OpenMM's units package (wrappers/python/openmm/unit/), a single
compact module in which a Unit is an immutable (dimension vector, SI scale
factor) pair and a Quantity wraps any numeric payload (float, list, numpy
array, torch tensor). The md_unit_system solver expresses any dimension in
the MD coherent units (nm, ps, dalton, K, mol, e, rad; energy in kJ/mol),
the units every number inside the port is in. strip() is the port's input
boundary: the setters of the System, the forces, the integrators and the
Context pass what they are given through it, so a Quantity arrives in MD
units and a plain number passes unchanged.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as _np

__all__ = []  # populated at bottom


def _export(obj, *names):
    for n in names:
        globals()[n] = obj
        __all__.append(n)
    return obj


# ---------------------------------------------------------------------------
# Dimensions: fixed-order exponent vector over SI-ish base dimensions.
# ---------------------------------------------------------------------------
_DIMS = ("mass", "length", "time", "temperature", "amount", "charge", "angle",
         "luminous_intensity", "information")
_NDIM = len(_DIMS)
_ZERO = (Fraction(0),) * _NDIM


def _dimvec(**kw):
    v = [Fraction(0)] * _NDIM
    for k, e in kw.items():
        v[_DIMS.index(k)] = Fraction(e)
    return tuple(v)


class Unit(object):
    """An immutable physical unit: dimension vector + scale factor to SI coherent."""

    __slots__ = ("dims", "factor", "_name", "_symbol")
    __array_priority__ = 100.0

    def __init__(self, dims, factor, name=None, symbol=None):
        object.__setattr__(self, "dims", tuple(Fraction(d) for d in dims))
        object.__setattr__(self, "factor", float(factor))
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_symbol", symbol)

    # -- algebra ------------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit([a + b for a, b in zip(self.dims, other.dims)],
                        self.factor * other.factor)
        return Quantity(other, self)

    def __rmul__(self, other):
        if isinstance(other, Unit):
            return other.__mul__(self)
        return Quantity(other, self)

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit([a - b for a, b in zip(self.dims, other.dims)],
                        self.factor / other.factor)
        return Unit(self.dims, self.factor / other)

    def __rtruediv__(self, other):
        inv = self.__pow__(-1)
        if other == 1:
            return inv
        return Quantity(other, inv)

    def __pow__(self, p):
        p = Fraction(p).limit_denominator(1000000)
        return Unit([d * p for d in self.dims], self.factor ** float(p))

    def sqrt(self):
        return self.__pow__(Fraction(1, 2))

    # -- comparisons ----------------------------------------------------------
    def __eq__(self, other):
        return (isinstance(other, Unit) and self.dims == other.dims
                and abs(self.factor - other.factor) <= 1e-12 * abs(self.factor))

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((self.dims, round(math.log(self.factor) if self.factor > 0 else 0, 9)))

    # -- queries --------------------------------------------------------------
    def is_dimensionless(self):
        return self.dims == _ZERO

    def is_compatible(self, other):
        return isinstance(other, Unit) and self.dims == other.dims

    def conversion_factor_to(self, other):
        if not self.is_compatible(other):
            raise TypeError("Unit %s is not compatible with %s." % (self, other))
        if self.factor == other.factor:
            return 1.0
        f = self.factor / other.factor
        # float artifacts of composing SI factors in different orders; no
        # physical unit conversion is within 1e-12 of unity
        if abs(f - 1.0) < 1e-12:
            return 1.0
        return f

    def in_unit_system(self, system):
        return system.express_unit(self)

    def get_name(self):
        return self._name if self._name else self._construct_name()

    def get_symbol(self):
        return self._symbol if self._symbol else self.get_name()

    def _construct_name(self):
        # derive a name from the md unit system decomposition when possible
        try:
            exps = md_unit_system.solve(self.dims)
        except Exception:
            return "arbitrary unit"
        num, den = [], []
        for (u, nm), e in zip(md_unit_system.units_named, exps):
            if e == 0:
                continue
            s = nm if abs(e) == 1 else "%s**%s" % (nm, abs(e))
            (num if e > 0 else den).append(s)
        name = "*".join(num) if num else ("dimensionless" if not den else "1")
        if den:
            name += "/" + "/".join(den)
        return name

    def __repr__(self):
        return "Unit({%s})" % self.get_name()

    def __str__(self):
        return self.get_name()

    def iter_base_dimensions(self):
        for n, e in zip(_DIMS, self.dims):
            if e != 0:
                yield n, e


class UnitSystem(object):
    """Expresses an arbitrary dimension vector as a product of system units."""

    def __init__(self, units_named):
        self.units_named = list(units_named)  # [(Unit, name)]
        # matrix: rows = base dims used, cols = units
        self._cols = [u.dims for u, _ in self.units_named]

    def solve(self, dims):
        """Solve for exponents e such that prod units[i]**e[i] has `dims`."""
        cols = [list(c) for c in self._cols]
        n = len(cols)
        rhs = list(dims)
        # Gaussian elimination over Fractions on the (ndim x n) system
        A = [[cols[j][i] for j in range(n)] for i in range(_NDIM)]
        x = [Fraction(0)] * n
        used_rows = []
        col_of_pivot = {}
        r = 0
        for c in range(n):
            piv = None
            for i in range(_NDIM):
                if i in used_rows:
                    continue
                if A[i][c] != 0:
                    piv = i
                    break
            if piv is None:
                continue
            used_rows.append(piv)
            col_of_pivot[piv] = c
            pv = A[piv][c]
            for i in range(_NDIM):
                if i != piv and A[i][c] != 0:
                    f = A[i][c] / pv
                    for j in range(n):
                        A[i][j] -= f * A[piv][j]
                    rhs[i] -= f * rhs[piv]
            r += 1
        for i in range(_NDIM):
            if i in col_of_pivot:
                c = col_of_pivot[i]
                x[c] = rhs[i] / A[i][c]
            elif rhs[i] != 0:
                raise TypeError("dimension not expressible in this unit system")
        return x

    def express_unit(self, unit):
        exps = self.solve(unit.dims)
        out = dimensionless
        for (u, _), e in zip(self.units_named, exps):
            if e != 0:
                out = out * (u ** e)
        return out

    def __iter__(self):
        return iter(u for u, _ in self.units_named)


def _is_arraylike(v):
    return isinstance(v, _np.ndarray) or (
        hasattr(v, "shape") and hasattr(v, "dtype"))


class Quantity(object):
    """A number (or array, or list of Vec3/tuples) with a Unit attached."""

    __slots__ = ("_value", "unit")
    __array_priority__ = 101.0

    def __init__(self, value=None, unit=None):
        if unit is None:
            unit = dimensionless
        if isinstance(value, Quantity):
            value = value.value_in_unit(unit)
        self._value = value
        self.unit = unit

    # -- unit conversion ------------------------------------------------------
    def value_in_unit(self, unit):
        f = self.unit.conversion_factor_to(unit)
        return _scale(self._value, f)

    def in_units_of(self, unit):
        return Quantity(self.value_in_unit(unit), unit)

    def value_in_unit_system(self, system):
        u = system.express_unit(self.unit)
        return self.value_in_unit(u)

    def in_unit_system(self, system):
        u = system.express_unit(self.unit)
        return Quantity(self.value_in_unit(u), u)

    def reduce_unit(self, guide_unit=None):
        return self

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Quantity):
            return Quantity(_add(self._value, other.value_in_unit(self.unit)), self.unit)
        if self.unit.is_dimensionless():
            return Quantity(_add(self.value_in_unit(dimensionless), other), dimensionless)
        raise TypeError("cannot add %r to Quantity" % (other,))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Quantity):
            return Quantity(_sub(self._value, other.value_in_unit(self.unit)), self.unit)
        if self.unit.is_dimensionless():
            return Quantity(_sub(self.value_in_unit(dimensionless), other), dimensionless)
        raise TypeError("cannot subtract %r from Quantity" % (other,))

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        return Quantity(_scale(self._value, -1.0), self.unit)

    def __pos__(self):
        return self

    def __abs__(self):
        return Quantity(abs(self._value) if not _is_arraylike(self._value)
                        else _np.abs(self._value), self.unit)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return _mk(_mul(self._value, other._value), self.unit * other.unit)
        if isinstance(other, Unit):
            return _mk(self._value, self.unit * other)
        return Quantity(_mul(self._value, other), self.unit)

    def __rmul__(self, other):
        if isinstance(other, Unit):
            return _mk(self._value, other * self.unit)
        return Quantity(_mul(self._value, other), self.unit)

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return _mk(_div(self._value, other._value), self.unit / other.unit)
        if isinstance(other, Unit):
            return _mk(self._value, self.unit / other)
        return Quantity(_div(self._value, other), self.unit)

    def __rtruediv__(self, other):
        inv_unit = self.unit ** -1
        if isinstance(other, Unit):
            return _mk(_div(1.0, self._value), other * inv_unit)
        return _mk(_div(other, self._value), inv_unit)

    def __pow__(self, p):
        return _mk(self._value ** p, self.unit ** p)

    def sqrt(self):
        v = self._value
        sv = _np.sqrt(v) if _is_arraylike(v) else math.sqrt(v)
        return _mk(sv, self.unit.sqrt())

    # -- comparisons ------------------------------------------------------------
    def _cmp_value(self, other):
        if isinstance(other, Quantity):
            return other.value_in_unit(self.unit)
        if self.unit.is_dimensionless():
            return other
        if other == 0:
            return 0
        raise TypeError("cannot compare Quantity to %r" % (other,))

    def __eq__(self, other):
        try:
            o = self._cmp_value(other)
        except TypeError:
            return NotImplemented
        return self._value == o

    def __ne__(self, other):
        r = self.__eq__(other)
        return NotImplemented if r is NotImplemented else not r

    def __lt__(self, other):
        return self._value < self._cmp_value(other)

    def __le__(self, other):
        return self._value <= self._cmp_value(other)

    def __gt__(self, other):
        return self._value > self._cmp_value(other)

    def __ge__(self, other):
        return self._value >= self._cmp_value(other)

    def __hash__(self):
        return hash((self._value if not _is_arraylike(self._value) else id(self._value),
                     self.unit))

    # -- container protocol ------------------------------------------------------
    def __len__(self):
        return len(self._value)

    def __getitem__(self, i):
        return _mk(self._value[i], self.unit)

    def __setitem__(self, i, v):
        if isinstance(v, Quantity):
            self._value[i] = v.value_in_unit(self.unit)
        elif self.unit.is_dimensionless():
            self._value[i] = v
        else:
            raise TypeError("cannot assign unitless value into dimensioned Quantity")

    def __iter__(self):
        for v in self._value:
            yield _mk(v, self.unit)

    def __bool__(self):
        return bool(self._value)

    def __float__(self):
        if not self.unit.is_dimensionless():
            raise TypeError("cannot convert dimensioned Quantity to float")
        return float(self.value_in_unit(dimensionless))

    # -- misc ---------------------------------------------------------------------
    def __repr__(self):
        return "Quantity(value=%r, unit=%s)" % (self._value, self.unit)

    def __str__(self):
        return "%s %s" % (self._value, self.unit.get_symbol())

    def max(self):
        return _mk(_np.max(self._value), self.unit)

    def min(self):
        return _mk(_np.min(self._value), self.unit)

    def mean(self):
        return _mk(_np.mean(self._value), self.unit)

    def sum(self):
        return _mk(_np.sum(self._value), self.unit)

    @property
    def shape(self):
        return _np.shape(self._value)


def _mk(value, unit):
    """Collapse to a bare number when the unit is exactly dimensionless w/ factor 1."""
    if unit.dims == _ZERO and abs(unit.factor - 1.0) < 1e-15:
        return value
    return Quantity(value, unit)


def _scale(v, f):
    if f == 1.0:
        return v
    if _is_arraylike(v):
        return v * f
    if isinstance(v, (list, tuple)):
        t = type(v) if type(v) in (list, tuple) else list
        return t(_scale(x, f) for x in v)
    if hasattr(v, "__mul__") and not isinstance(v, (int, float, complex)):
        return v * f
    return v * f


def _binary(a, b, op, opname):
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        a2 = _np.asarray(a, dtype=float) if isinstance(a, (list, tuple)) else a
        b2 = _np.asarray(b, dtype=float) if isinstance(b, (list, tuple)) else b
        return op(a2, b2)
    return op(a, b)


def _add(a, b):
    return _binary(a, b, lambda x, y: x + y, "+")


def _sub(a, b):
    return _binary(a, b, lambda x, y: x - y, "-")


def _mul(a, b):
    return _binary(a, b, lambda x, y: x * y, "*")


def _div(a, b):
    return _binary(a, b, lambda x, y: x / y, "/")


def is_quantity(x):
    return isinstance(x, Quantity)


def is_unit(x):
    return isinstance(x, Unit)


def is_dimensionless(x):
    if isinstance(x, Quantity):
        return x.unit.is_dimensionless()
    if isinstance(x, Unit):
        return x.is_dimensionless()
    return True


def sqrt(x):
    if isinstance(x, (Quantity, Unit)):
        return x.sqrt()
    return math.sqrt(x)


def sum(seq):  # noqa: A001 - mirrors reference API
    it = iter(seq)
    try:
        total = next(it)
    except StopIteration:
        return 0
    for v in it:
        total = total + v
    return total


def norm(q):
    if isinstance(q, Quantity):
        return _mk(_np.linalg.norm(_np.asarray(q._value, dtype=float)), q.unit)
    return _np.linalg.norm(q)


def dot(a, b):
    if isinstance(a, Quantity) or isinstance(b, Quantity):
        av, au = (a._value, a.unit) if isinstance(a, Quantity) else (a, dimensionless)
        bv, bu = (b._value, b.unit) if isinstance(b, Quantity) else (b, dimensionless)
        return _mk(_np.dot(_np.asarray(av, float), _np.asarray(bv, float)), au * bu)
    return _np.dot(a, b)


# ---------------------------------------------------------------------------
# Unit definitions (SI factors).
# ---------------------------------------------------------------------------
dimensionless = _export(Unit(_ZERO, 1.0, "dimensionless", ""), "dimensionless")

_AVOGADRO = 6.02214076e23

_prefixes = {
    "yotta": 1e24, "zetta": 1e21, "exa": 1e18, "peta": 1e15, "tera": 1e12,
    "giga": 1e9, "mega": 1e6, "kilo": 1e3, "hecto": 1e2, "deka": 1e1,
    "deci": 1e-1, "centi": 1e-2, "milli": 1e-3, "micro": 1e-6, "nano": 1e-9,
    "pico": 1e-12, "femto": 1e-15, "atto": 1e-18, "zepto": 1e-21, "yocto": 1e-24,
}


def _define(name, unit, plural=True, prefixable=False, symbol=None):
    u = Unit(unit.dims, unit.factor, name, symbol)
    names = [name]
    if plural:
        names.append(name + "s")
    _export(u, *names)
    if prefixable:
        for p, f in _prefixes.items():
            pu = Unit(u.dims, u.factor * f, p + name)
            pn = [p + name]
            if plural:
                pn.append(p + name + "s")
            _export(pu, *pn)
    return u


# length
meter = _define("meter", Unit(_dimvec(length=1), 1.0), prefixable=True)
angstrom = _define("angstrom", Unit(_dimvec(length=1), 1e-10))
_export(angstrom, "angstroms")
# time
second = _define("second", Unit(_dimvec(time=1), 1.0), prefixable=True)
minute = _define("minute", Unit(_dimvec(time=1), 60.0))
hour = _define("hour", Unit(_dimvec(time=1), 3600.0))
day = _define("day", Unit(_dimvec(time=1), 86400.0))
# mass
gram = _define("gram", Unit(_dimvec(mass=1), 1e-3), prefixable=True)
# amount
mole = _define("mole", Unit(_dimvec(amount=1), 1.0))
_export(mole, "moles", "mol")
item = _define("item", Unit(_dimvec(amount=1), 1.0 / _AVOGADRO))
# temperature
kelvin = _define("kelvin", Unit(_dimvec(temperature=1), 1.0))
# charge
coulomb = _define("coulomb", Unit(_dimvec(charge=1), 1.0), prefixable=True)
elementary_charge = _define("elementary_charge", Unit(_dimvec(charge=1), 1.602176634e-19))
_export(elementary_charge, "elementary_charges")
# angle
radian = _define("radian", Unit(_dimvec(angle=1), 1.0))
degree = _define("degree", Unit(_dimvec(angle=1), math.pi / 180.0))
_export(degree, "degrees")
# luminous / information (rarely used)
candela = _define("candela", Unit(_dimvec(luminous_intensity=1), 1.0))
bit = _define("bit", Unit(_dimvec(information=1), 1.0))

# derived
dalton = _define("dalton", gram / mole)  # == amu; dims mass*amount^-1
_export(dalton, "daltons", "amu", "amus", "atomic_mass_unit", "atom_mass_units")
newton = _define("newton", Unit(_dimvec(mass=1, length=1, time=-2), 1.0), prefixable=True)
joule = _define("joule", Unit(_dimvec(mass=1, length=2, time=-2), 1.0), prefixable=True)
calorie = _define("calorie", Unit(_dimvec(mass=1, length=2, time=-2), 4.184), prefixable=True)
watt = _define("watt", Unit(_dimvec(mass=1, length=2, time=-3), 1.0), prefixable=True)
pascal = _define("pascal", Unit(_dimvec(mass=1, length=-1, time=-2), 1.0), prefixable=True)
bar = _define("bar", Unit(_dimvec(mass=1, length=-1, time=-2), 1e5))
atmosphere = _define("atmosphere", Unit(_dimvec(mass=1, length=-1, time=-2), 101325.0))
_export(atmosphere, "atmospheres", "atm")
volt = _define("volt", Unit(_dimvec(mass=1, length=2, time=-2, charge=-1), 1.0), prefixable=True)
ampere = _define("ampere", Unit(_dimvec(charge=1, time=-1), 1.0), prefixable=True)
liter = _define("liter", Unit(_dimvec(length=3), 1e-3), prefixable=True)
_export(liter, "litre", "litres")
debye = _define("debye", Unit(_dimvec(charge=1, length=1), 1e-21 / 299792458.0))

kilojoule_per_mole = _define("kilojoule_per_mole", kilojoule / mole, plural=False)  # noqa: F821
_export(kilojoule_per_mole, "kilojoules_per_mole")
kilocalorie_per_mole = _define("kilocalorie_per_mole", kilocalorie / mole, plural=False)  # noqa: F821
_export(kilocalorie_per_mole, "kilocalories_per_mole")

# common molarity
molar = _define("molar", mole / liter)

# physical constants (as Quantities, values per CODATA as used by the reference
# openmmapi/include/openmm/Units.h and unit/constants.py)
AVOGADRO_CONSTANT_NA = Quantity(_AVOGADRO, item ** -1)
BOLTZMANN_CONSTANT_kB = Quantity(1.380649e-23, joule / kelvin)
MOLAR_GAS_CONSTANT_R = Quantity(8.31446261815324e-3, kilojoule_per_mole / kelvin)
GRAVITATIONAL_ACCELERATION_g = Quantity(9.80665, meter / second ** 2)
SPEED_OF_LIGHT_C = Quantity(299792458.0, meter / second)
__all__ += ["AVOGADRO_CONSTANT_NA", "BOLTZMANN_CONSTANT_kB", "MOLAR_GAS_CONSTANT_R",
            "GRAVITATIONAL_ACCELERATION_g", "SPEED_OF_LIGHT_C"]

# the MD coherent unit system: nm, ps, dalton, K, mol, e, rad
md_unit_system = UnitSystem([
    (nanometer, "nanometer"),       # noqa: F821
    (picosecond, "picosecond"),     # noqa: F821
    (dalton, "dalton"),
    (kelvin, "kelvin"),
    (mole, "mole"),
    (elementary_charge, "elementary charge"),
    (radian, "radian"),
])
si_unit_system = UnitSystem([
    (meter, "meter"), (second, "second"), (kilogram, "kilogram"),  # noqa: F821
    (kelvin, "kelvin"), (mole, "mole"), (coulomb, "coulomb"), (radian, "radian"),
])
__all__ += ["md_unit_system", "si_unit_system", "Unit", "Quantity", "UnitSystem",
            "is_quantity", "is_unit", "is_dimensionless", "sqrt", "sum", "norm", "dot"]


# ---------------------------------------------------------------------------
# Internal strip helpers used across the framework: accept Quantity or raw
# (raw numbers are assumed to already be in MD units), return floats/arrays.
# This mirrors the reference's SWIG stripUnits typemaps
# (wrappers/python/src/swig_doxygen/swig_lib/python/typemaps.i).
# ---------------------------------------------------------------------------
_PLAIN = frozenset((float, int))     # strip's fast path: no unit to strip


def strip(value, unit=None):
    """Return `value` as raw numbers in `unit` (or MD units if unit is None).
    A bare Unit counts as one of it: 1/picosecond is the Unit ps^-1 here
    (OpenMM makes it a Quantity), and strips to 1.0. The JAX package's
    strip hands a bare Unit back unchanged."""
    if value.__class__ in _PLAIN:
        return value
    if isinstance(value, Unit):
        value = Quantity(1.0, value)
    if isinstance(value, Quantity):
        if unit is None:
            return value.value_in_unit_system(md_unit_system)
        return value.value_in_unit(unit)
    if isinstance(value, (list, tuple)) and len(value) and isinstance(value[0], Quantity):
        return [strip(v, unit) for v in value]
    return value


def plain(value):
    """`value` as a caller in plain numbers wants it: every Quantity in it
    replaced by its number in the unit it carries (the getters' units: nm,
    ps, K, kJ/mol, amu, e, rad, bar), a list or tuple of vectors
    (positions, box vectors) as an (n, 3) float64 array, a tuple of
    parameters as a tuple of plain numbers. Values without units pass
    unchanged. To read a Quantity in a unit of one's choosing, use
    strip."""
    if value.__class__ in _PLAIN:
        return value
    if isinstance(value, Quantity):
        value = value._value
    if isinstance(value, (list, tuple)) and value:
        if all(isinstance(v, Quantity) and isinstance(v._value, tuple)
               for v in value):
            value = [v._value for v in value]
        if all(isinstance(v, tuple) and len(v) == 3 for v in value):
            return _np.asarray(value, _np.float64)
        if isinstance(value, tuple):
            return tuple(plain(v) for v in value)
        return [plain(v) for v in value]
    return value


__all__ += ["strip", "plain"]
