"""Cubic splines (natural and periodic) and bicubic coefficients: of a
CMAP map and of a tabulated function's grid.

Counterpart of openmm_tpu/utils/splines.py (natural_spline,
_solve_tridiag, periodic_spline, spline_first_derivatives,
bicubic_coefficients_periodic, bicubic_coefficients_from_derivatives):
host-side numpy set-up math, the same arithmetic as the JAX package's, so
a map or a table gives the same coefficients in both packages.
"""
from __future__ import annotations

import numpy as np


def natural_spline(x, y):
    """Second derivatives of the natural cubic spline through (x, y)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    if n < 2:
        raise ValueError("spline requires at least two points")
    if n == 2:
        return np.zeros(n)
    h = np.diff(x)
    # the tridiagonal system of the interior second derivatives
    a = np.zeros(n - 2)
    b = np.zeros(n - 2)
    c = np.zeros(n - 2)
    d = np.zeros(n - 2)
    for i in range(1, n - 1):
        a[i - 1] = h[i - 1]
        b[i - 1] = 2.0 * (h[i - 1] + h[i])
        c[i - 1] = h[i]
        d[i - 1] = 6.0 * ((y[i + 1] - y[i]) / h[i]
                          - (y[i] - y[i - 1]) / h[i - 1])
    deriv2 = np.zeros(n)
    deriv2[1:-1] = _solve_tridiag(a, b, c, d)
    return deriv2


def _solve_tridiag(a, b, c, d):
    """The solution of the tridiagonal system with sub-diagonal a,
    diagonal b and super-diagonal c (Thomas algorithm)."""
    n = len(d)
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, n):
        mdiv = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / mdiv
        dp[i] = (d[i] - a[i] * dp[i - 1]) / mdiv
    x = np.zeros(n)
    x[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


def periodic_spline(x, y):
    """Second derivatives of the periodic cubic spline (y[0] must equal
    y[-1])."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    if n < 3:
        return np.zeros(n)
    h = np.diff(x)
    m = n - 1  # unique points
    a = np.zeros((m, m))
    d = np.zeros(m)
    for i in range(m):
        hm = h[i - 1] if i > 0 else h[m - 1]
        hp = h[i]
        im = (i - 1) % m
        ip = (i + 1) % m
        a[i, im] += hm
        a[i, i] += 2.0 * (hm + hp)
        a[i, ip] += hp
        ym = y[im] if i > 0 else y[m - 1]
        d[i] = 6.0 * ((y[ip] - y[i]) / hp - (y[i] - ym) / hm)
    sol = np.linalg.solve(a, d)
    deriv2 = np.zeros(n)
    deriv2[:m] = sol
    deriv2[m] = sol[0]
    return deriv2


def spline_first_derivatives(x, y, deriv2):
    """First derivative of the cubic spline at every knot."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    d1 = np.zeros(n)
    for i in range(n - 1):
        h = x[i + 1] - x[i]
        d1[i] = ((y[i + 1] - y[i]) / h
                 - h * (2.0 * deriv2[i] + deriv2[i + 1]) / 6.0)
    h = x[n - 1] - x[n - 2]
    d1[n - 1] = ((y[n - 1] - y[n - 2]) / h
                 + h * (deriv2[n - 2] + 2.0 * deriv2[n - 1]) / 6.0)
    return d1


def _bicubic_solver_matrix():
    """Inverse of the matrix that maps the bicubic coefficients c[i][j]
    (f(t, u) = sum c_ij t^i u^j over a unit cell) to the 16 constraints
    [f, ft, fu, ftu] at the corners (0,0), (1,0), (1,1), (0,1)."""
    corners = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    a = np.zeros((16, 16))

    def mono(i, t):
        return t ** i if i > 0 else 1.0

    def dmono(i, t):
        return i * t ** (i - 1) if i >= 2 else (1.0 if i == 1 else 0.0)

    row = 0
    for kind in range(4):  # f, ft, fu, ftu
        for (t, u) in corners:
            for i in range(4):
                for j in range(4):
                    col = 4 * i + j
                    if kind == 0:
                        a[row, col] = mono(i, t) * mono(j, u)
                    elif kind == 1:
                        a[row, col] = dmono(i, t) * mono(j, u)
                    elif kind == 2:
                        a[row, col] = mono(i, t) * dmono(j, u)
                    else:
                        a[row, col] = dmono(i, t) * dmono(j, u)
            row += 1
    return np.linalg.inv(a)


_BICUBIC_INV = _bicubic_solver_matrix()


def bicubic_coefficients_periodic(grid):
    """Per-cell bicubic coefficients (size, size, 4, 4) of a doubly periodic
    square grid of values with unit cell spacing: grid[i, j] = f(x_i, y_j).
    The derivatives come from periodic cubic spline fits along each axis
    (CMAPTorsionForceImpl::calcMapDerivatives)."""
    grid = np.asarray(grid, dtype=np.float64)
    size = grid.shape[0]
    xs = np.arange(size + 1, dtype=np.float64)

    def periodic_d1(values, axis):
        v = values if axis == 0 else values.T
        res = np.zeros_like(v)
        for k in range(v.shape[1]):
            col = np.concatenate([v[:, k], v[:1, k]])
            d2 = periodic_spline(xs, col)
            res[:, k] = spline_first_derivatives(xs, col, d2)[:size]
        return res if axis == 0 else res.T

    fx = periodic_d1(grid, axis=0)
    fy = periodic_d1(grid, axis=1)
    fxy = periodic_d1(fy, axis=0)
    ip = (np.arange(size) + 1) % size

    # corner order: (i,j), (i+1,j), (i+1,j+1), (i,j+1)
    def corners(a):
        return np.stack([a, a[ip, :], a[ip][:, ip], a[:, ip]], axis=-1)

    vec = np.concatenate([corners(grid), corners(fx), corners(fy),
                          corners(fxy)], axis=-1)
    coeffs = vec @ _BICUBIC_INV.T
    return coeffs.reshape(size, size, 4, 4)


def bicubic_coefficients_from_derivatives(f, fx, fy, fxy):
    """Per-cell bicubic coefficients (nx-1, ny-1, 4, 4) from the values
    and partial derivatives at the grid nodes, all in cell-local units (fx
    times the cell width, and so on). Not periodic: the last row and
    column only bound the last cells."""
    f = np.asarray(f, np.float64)
    nx, ny = f.shape

    def corners(a):
        return np.stack([a[:-1, :-1], a[1:, :-1], a[1:, 1:], a[:-1, 1:]],
                        axis=-1)

    vec = np.concatenate([corners(f), corners(fx), corners(fy),
                          corners(fxy)], axis=-1)
    coeffs = vec @ _BICUBIC_INV.T
    return coeffs.reshape(nx - 1, ny - 1, 4, 4)
