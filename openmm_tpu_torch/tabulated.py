"""Tabulated functions: Continuous1D/2D/3D (cubic splines) and
Discrete1D/2D/3D.

Counterpart of openmm_tpu/tabulated.py (the API of OpenMM's
TabulatedFunction.h, the splines of SplineFitter.cpp): a point out of
range gives 0, a periodic table wraps. Each compiles (`_compile(dtype,
device)`) to an expressions.Function: the value and its partial
derivatives in the arguments, written out from the spline (the JAX package
takes them from jax.grad), the derivatives 0 out of range and for the
discrete tables. The coefficient tables are made on the host with the JAX
package's arithmetic (utils/splines.py) and live on the device; a cell's
index is a clamped floor of the argument, computed on the device with no
host read.
"""
from __future__ import annotations

import numpy as np
import torch

from . import unit as u
from .expressions.compiler import Function
from .utils.splines import (bicubic_coefficients_from_derivatives,
                            natural_spline, periodic_spline,
                            spline_first_derivatives)


def _spline_d2(x, y, periodic):
    return periodic_spline(x, y) if periodic else natural_spline(x, y)


def _tensors(args, dtype, device):
    """The arguments as tensors of `dtype`, broadcast to one shape."""
    return torch.broadcast_tensors(*(
        a.to(dtype) if torch.is_tensor(a)
        else torch.full((), float(a), dtype=dtype, device=device)
        for a in args))


def _wrap(x, lo, hi, periodic):
    return lo + torch.remainder(x - lo, hi - lo) if periodic else x


def _cell(x, lo, h, n):
    """(cell index clamped to [0, n - 2], position in the cell in [0, 1])
    of x clamped into the table; the index by a floor on the device."""
    i = torch.clamp(torch.floor((x - lo) / h), 0, n - 2)
    return i.long(), (x - lo) / h - i


def _powers(t):
    return torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1)


def _dpowers(t):
    return torch.stack([torch.zeros_like(t), torch.ones_like(t), 2.0 * t,
                        3.0 * t * t], dim=-1)


class TabulatedFunction:
    def getPeriodic(self) -> bool:
        return getattr(self, "_periodic", False)

    def getUpdateCount(self) -> int:
        return getattr(self, "_update_count", 0)


class Continuous1DFunction(TabulatedFunction):
    def __init__(self, values, min, max, periodic=False):  # noqa: A002
        values = [float(u.strip(v)) for v in values]
        if len(values) < 2:
            raise ValueError("Continuous1DFunction needs >= 2 values")
        if periodic and abs(values[0] - values[-1]) > 1e-10:
            raise ValueError("periodic function must have matching "
                             "endpoints")
        self._values = values
        self._min, self._max = float(u.strip(min)), float(u.strip(max))
        self._periodic = bool(periodic)
        self._update_count = 0

    def getFunctionParameters(self):
        return list(self._values), self._min, self._max

    def setFunctionParameters(self, values, min, max):  # noqa: A002
        self._values = [float(u.strip(v)) for v in values]
        self._min, self._max = float(u.strip(min)), float(u.strip(max))
        self._update_count += 1

    def Copy(self):
        return Continuous1DFunction(self._values, self._min, self._max,
                                    self._periodic)

    def _compile(self, dtype, device) -> Function:
        y_np = np.asarray(self._values, np.float64)
        n = len(y_np)
        d2_np = _spline_d2(np.linspace(self._min, self._max, n), y_np,
                           self._periodic)
        y = torch.as_tensor(y_np, dtype=dtype, device=device)
        d2 = torch.as_tensor(d2_np, dtype=dtype, device=device)
        lo, hi, periodic = self._min, self._max, self._periodic
        h = (hi - lo) / (n - 1)

        def cell(x):
            (x,) = _tensors((x,), dtype, device)
            x = _wrap(x, lo, hi, periodic)
            inside = (x >= lo) & (x <= hi)
            xc = torch.clamp(x, lo, hi)
            i = torch.clamp(torch.floor((xc - lo) / h), 0, n - 2)
            xl = lo + i * h
            a = (xl + h - xc) / h
            b = (xc - xl) / h
            return inside, i.long(), a, b

        def spline(inside, i, a, b):
            val = (a * y[i] + b * y[i + 1]
                   + ((a * a * a - a) * d2[i] + (b * b * b - b) * d2[i + 1])
                   * (h * h) / 6.0)
            return torch.where(inside, val, 0.0)

        def value(x):
            return spline(*cell(x))

        def both(x):
            inside, i, a, b = cell(x)
            d = ((y[i + 1] - y[i]) / h
                 + ((1.0 - 3.0 * a * a) * d2[i] + (3.0 * b * b - 1.0)
                    * d2[i + 1]) * (h / 6.0))
            return (spline(inside, i, a, b),
                    [torch.where(inside, d, 0.0)])

        return Function(value, both)


class _GridFunction(TabulatedFunction):
    """A bicubic (2D) or tricubic (3D) spline over a grid: the per-cell
    coefficients (cells..., 4, ...) on the device, evaluated as sums of
    monomials of the positions in the cell."""

    def _evaluator(self, coeffs, lims, sizes, dtype, device) -> Function:
        coeffs = torch.as_tensor(coeffs, dtype=dtype, device=device)
        periodic = self._periodic
        dims = len(sizes)
        widths = [(lims[2 * k + 1] - lims[2 * k]) / (sizes[k] - 1)
                  for k in range(dims)]
        spec = ("...a,...ab,...b->..." if dims == 2
                else "...a,...abc,...b,...c->...")

        def cell(args):
            xs = _tensors(args, dtype, device)
            inside, cells, ts = None, [], []
            for k, x in enumerate(xs):
                lo, hi = lims[2 * k], lims[2 * k + 1]
                x = _wrap(x, lo, hi, periodic)
                ok = (x >= lo) & (x <= hi)
                inside = ok if inside is None else inside & ok
                i, t = _cell(torch.clamp(x, lo, hi), lo, widths[k],
                             sizes[k])
                cells.append(i)
                ts.append(t)
            return inside, coeffs[tuple(cells)], ts

        def contract(c, rows):
            if dims == 2:
                return torch.einsum(spec, rows[0], c, rows[1])
            return torch.einsum(spec, rows[0], c, rows[1], rows[2])

        def value(*args):
            inside, c, ts = cell(args)
            return torch.where(inside, contract(c, [_powers(t) for t in ts]),
                               0.0)

        def both(*args):
            inside, c, ts = cell(args)
            rows = [_powers(t) for t in ts]
            out = []
            for k in range(dims):
                drows = [_dpowers(t) if j == k else rows[j]
                         for j, t in enumerate(ts)]
                out.append(torch.where(inside, contract(c, drows)
                                       / widths[k], 0.0))
            return torch.where(inside, contract(c, rows), 0.0), out

        return Function(value, both)


def _first_derivatives(a, axis, periodic):
    """The spline's first derivative along `axis` at every node of the
    grid a, the nodes at unit spacing (the JAX package's d1_axis)."""
    grid = np.arange(a.shape[axis], dtype=np.float64)
    moved = np.moveaxis(a, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    out = np.zeros_like(flat)
    for k in range(flat.shape[1]):
        d2 = _spline_d2(grid, flat[:, k], periodic)
        out[:, k] = spline_first_derivatives(grid, flat[:, k], d2)
    return np.moveaxis(out.reshape(moved.shape), 0, axis)


class Continuous2DFunction(_GridFunction):
    def __init__(self, xsize, ysize, values, xmin, xmax, ymin, ymax,
                 periodic=False):
        values = [float(u.strip(v)) for v in values]
        if len(values) != xsize * ysize:
            raise ValueError("values must have xsize*ysize elements")
        self._xsize, self._ysize = int(xsize), int(ysize)
        self._values = values
        self._xmin, self._xmax = float(u.strip(xmin)), float(u.strip(xmax))
        self._ymin, self._ymax = float(u.strip(ymin)), float(u.strip(ymax))
        self._periodic = bool(periodic)
        self._update_count = getattr(self, "_update_count", 0)

    def getFunctionParameters(self):
        return (self._xsize, self._ysize, list(self._values), self._xmin,
                self._xmax, self._ymin, self._ymax)

    def setFunctionParameters(self, xsize, ysize, values, xmin, xmax, ymin,
                              ymax):
        self.__init__(xsize, ysize, values, xmin, xmax, ymin, ymax,
                      self._periodic)
        self._update_count += 1

    def Copy(self):
        return Continuous2DFunction(self._xsize, self._ysize, self._values,
                                    self._xmin, self._xmax, self._ymin,
                                    self._ymax, self._periodic)

    def _coefficients(self) -> np.ndarray:
        """(nx-1, ny-1, 4, 4) bicubic coefficients in cell-local units;
        values[i + xsize*j] = f(x_i, y_j)."""
        g = np.asarray(self._values, np.float64).reshape(
            self._xsize, self._ysize, order="F")
        fx = _first_derivatives(g, 0, self._periodic)
        fy = _first_derivatives(g, 1, self._periodic)
        fxy = _first_derivatives(fy, 0, self._periodic)
        return bicubic_coefficients_from_derivatives(g, fx, fy, fxy)

    def _compile(self, dtype, device) -> Function:
        return self._evaluator(
            self._coefficients(),
            (self._xmin, self._xmax, self._ymin, self._ymax),
            (self._xsize, self._ysize), dtype, device)


def _tricubic_solver_matrix():
    """Inverse of the matrix that maps the tricubic coefficients c[i][j][k]
    to the 64 constraints f, fx, fy, fz, fxy, fxz, fyz, fxyz at the 8
    corners of a unit cell."""
    corners = [(i, j, k) for k in (0.0, 1.0) for j in (0.0, 1.0)
               for i in (0.0, 1.0)]

    def mono(i, t):
        return t ** i if i > 0 else 1.0

    def dmono(i, t):
        return i * t ** (i - 1) if i >= 2 else (1.0 if i == 1 else 0.0)

    a = np.zeros((64, 64))
    row = 0
    kinds = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
             (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    for dx, dy, dz in kinds:
        for (t, v, w) in corners:
            for i in range(4):
                for j in range(4):
                    for k in range(4):
                        fi = dmono(i, t) if dx else mono(i, t)
                        fj = dmono(j, v) if dy else mono(j, v)
                        fk = dmono(k, w) if dz else mono(k, w)
                        a[row, 16 * i + 4 * j + k] = fi * fj * fk
            row += 1
    return np.linalg.inv(a)


class Continuous3DFunction(_GridFunction):
    def __init__(self, xsize, ysize, zsize, values, xmin, xmax, ymin, ymax,
                 zmin, zmax, periodic=False):
        values = [float(u.strip(v)) for v in values]
        if len(values) != xsize * ysize * zsize:
            raise ValueError("values must have xsize*ysize*zsize elements")
        self._sizes = (int(xsize), int(ysize), int(zsize))
        self._values = values
        self._lims = tuple(float(u.strip(v)) for v in (xmin, xmax, ymin,
                                                       ymax, zmin, zmax))
        self._periodic = bool(periodic)
        self._update_count = getattr(self, "_update_count", 0)

    def getFunctionParameters(self):
        return (*self._sizes, list(self._values), *self._lims)

    def setFunctionParameters(self, xsize, ysize, zsize, values, xmin, xmax,
                              ymin, ymax, zmin, zmax):
        self.__init__(xsize, ysize, zsize, values, xmin, xmax, ymin, ymax,
                      zmin, zmax, self._periodic)
        self._update_count += 1

    def Copy(self):
        return Continuous3DFunction(*self._sizes, self._values, *self._lims,
                                    self._periodic)

    def _coefficients(self) -> np.ndarray:
        """(nx-1, ny-1, nz-1, 4, 4, 4) tricubic coefficients in cell-local
        units, the corners in the solver matrix's order."""
        nx, ny, nz = self._sizes
        g = np.asarray(self._values, np.float64).reshape(nx, ny, nz,
                                                         order="F")
        per = self._periodic
        fx = _first_derivatives(g, 0, per)
        fy = _first_derivatives(g, 1, per)
        fz = _first_derivatives(g, 2, per)
        fxy = _first_derivatives(fy, 0, per)
        fxz = _first_derivatives(fz, 0, per)
        fyz = _first_derivatives(fz, 1, per)
        fxyz = _first_derivatives(fyz, 0, per)

        def corners(a):
            return np.stack([
                a[:-1, :-1, :-1], a[1:, :-1, :-1], a[:-1, 1:, :-1],
                a[1:, 1:, :-1], a[:-1, :-1, 1:], a[1:, :-1, 1:],
                a[:-1, 1:, 1:], a[1:, 1:, 1:]], axis=-1)

        vec = np.concatenate([corners(v) for v in
                              (g, fx, fy, fz, fxy, fxz, fyz, fxyz)], axis=-1)
        return (vec @ _tricubic_solver_matrix().T).reshape(
            nx - 1, ny - 1, nz - 1, 4, 4, 4)

    def _compile(self, dtype, device) -> Function:
        return self._evaluator(self._coefficients(), self._lims, self._sizes,
                               dtype, device)


class _DiscreteFunction(TabulatedFunction):
    """A table read at the rounded arguments (half to even), clamped into
    its range; its derivatives are 0."""

    def _compile(self, dtype, device) -> Function:
        sizes = self._table_sizes()
        table = torch.as_tensor(
            np.asarray(self._values, np.float64).reshape(sizes, order="F"),
            dtype=dtype, device=device)

        def index(args):
            xs = _tensors(args, dtype, device)
            return tuple(torch.clamp(torch.round(x).long(), 0, size - 1)
                         for x, size in zip(xs, sizes)), xs[0]

        def value(*args):
            return table[index(args)[0]]

        def both(*args):
            cells, x = index(args)
            return table[cells], [torch.zeros_like(x) for _ in sizes]

        return Function(value, both)


class Discrete1DFunction(_DiscreteFunction):
    def __init__(self, values):
        self._values = [float(u.strip(v)) for v in values]
        self._update_count = getattr(self, "_update_count", 0)

    def _table_sizes(self):
        return (len(self._values),)

    def getFunctionParameters(self):
        return list(self._values)

    def setFunctionParameters(self, values):
        self.__init__(values)
        self._update_count += 1

    def Copy(self):
        return Discrete1DFunction(self._values)


class Discrete2DFunction(_DiscreteFunction):
    def __init__(self, xsize, ysize, values):
        values = [float(u.strip(v)) for v in values]
        if len(values) != xsize * ysize:
            raise ValueError("values must have xsize*ysize elements")
        self._sizes = (int(xsize), int(ysize))
        self._values = values
        self._update_count = getattr(self, "_update_count", 0)

    def _table_sizes(self):
        return self._sizes

    def getFunctionParameters(self):
        return (*self._sizes, list(self._values))

    def setFunctionParameters(self, xsize, ysize, values):
        self.__init__(xsize, ysize, values)
        self._update_count += 1

    def Copy(self):
        return Discrete2DFunction(*self._sizes, self._values)


class Discrete3DFunction(_DiscreteFunction):
    def __init__(self, xsize, ysize, zsize, values):
        values = [float(u.strip(v)) for v in values]
        if len(values) != xsize * ysize * zsize:
            raise ValueError("values must have xsize*ysize*zsize elements")
        self._sizes = (int(xsize), int(ysize), int(zsize))
        self._values = values
        self._update_count = getattr(self, "_update_count", 0)

    def _table_sizes(self):
        return self._sizes

    def getFunctionParameters(self):
        return (*self._sizes, list(self._values))

    def setFunctionParameters(self, xsize, ysize, zsize, values):
        self.__init__(xsize, ysize, zsize, values)
        self._update_count += 1

    def Copy(self):
        return Discrete3DFunction(*self._sizes, self._values)


TABULATED_FUNCTIONS = {cls.__name__: cls for cls in (
    Continuous1DFunction, Continuous2DFunction, Continuous3DFunction,
    Discrete1DFunction, Discrete2DFunction, Discrete3DFunction)}
