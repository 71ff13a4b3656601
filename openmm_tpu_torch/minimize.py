"""LocalEnergyMinimizer: L-BFGS energy minimization with constraint
penalties.

Counterpart of openmm_tpu/minimize.py (after LocalEnergyMinimizer.cpp):
minimize E(x) + sum_c (k/2)(r_c - d_c)^2 with k escalated tenfold until the
constraints hold to twice the integrator's tolerance, then apply the exact
constraints. The L-BFGS two-loop recursion and the Armijo backtracking run
on the host in float64 numpy; E and its gradient come from the Context's
objective (Context._make_position_energy_fn) on its device. The only change
from the JAX module: the constraint penalty is vectorized over the
constraints with the same arithmetic in the same order (terms added one at
a time, gradients accumulated constraint by constraint), so energy and
gradient are the same numbers as the per-constraint loop gives.
"""
from __future__ import annotations

import numpy as np

from . import unit as u


class LocalEnergyMinimizer:
    @staticmethod
    def minimize(context, tolerance=10.0, maxIterations=0, reporter=None):
        """Minimize the Context's potential energy in place. tolerance: the
        RMS gradient per particle (kJ/mol/nm) at which L-BFGS stops;
        maxIterations: iterations per penalty stage, 0 for 10 * n;
        reporter: a MinimizationReporter, called once per iteration."""
        tolerance = float(u.strip(tolerance,
                                  u.kilojoule_per_mole / u.nanometer))
        system = context.getSystem()
        n = system.getNumParticles()
        cons = [system.getConstraintParameters(i)
                for i in range(system.getNumConstraints())]
        p1 = np.array([c[0] for c in cons], np.int64)
        p2 = np.array([c[1] for c in cons], np.int64)
        dist = np.array([c[2] for c in cons], np.float64)
        tol_c = context.getIntegrator().getConstraintTolerance()
        working_tol = max(tolerance, 1e-4)
        k_penalty = 100.0 / max(tol_c, 1e-10)
        free = np.array([system.getParticleMass(i) > 0 for i in range(n)])

        x0 = np.asarray(context.getState(getPositions=True).getPositions(),
                        np.float64)
        eval_fn = context._make_position_energy_fn()

        def objective(x):
            pos = x.reshape(n, 3)
            e, g = eval_fn(pos)
            e = float(e)
            g = -np.asarray(g, np.float64)  # gradient = -force
            if cons:
                e = _add_penalty(pos, p1, p2, dist, k_penalty, e, g)
            g[~free] = 0.0
            return e, g.reshape(-1)

        max_iter = maxIterations if maxIterations > 0 else 10 * n

        for _ in range(6):
            x = _lbfgs(objective, x0.reshape(-1).copy(), working_tol,
                       max_iter, reporter)
            x0 = x.reshape(n, 3)
            if not cons:
                break
            r = _constraint_vectors(x0, p1, p2)[1]
            if np.max(np.abs(r - dist) / dist) < 2 * tol_c:
                break
            k_penalty *= 10.0
        context.setPositions(x0)
        if cons:
            context.applyConstraints()


def _constraint_vectors(pos, p1, p2):
    """(p1 - p2 vectors, their lengths), each length computed as
    np.linalg.norm computes it for one vector (sqrt of a BLAS dot)."""
    delta = pos[p1] - pos[p2]
    return delta, np.sqrt(np.matmul(delta[:, None, :],
                                    delta[:, :, None])[:, 0, 0])


def _add_penalty(pos, p1, p2, dist, k_penalty, e, g):
    """Add sum_c (k/2)(r_c - d_c)^2 to the energy e (returned) and its
    gradient to g (in place), in the order of the per-constraint loop of
    the JAX module: the energy terms one after another (np.cumsum is a
    sequential sum), and for each constraint +gdir on p1, then -gdir on p2
    (np.add.at applies its updates in index order)."""
    delta, r = _constraint_vectors(pos, p1, p2)
    viol = r - dist
    terms = 0.5 * k_penalty * viol * viol
    e = float(np.cumsum(np.concatenate([[e], terms]))[-1])
    gdir = (k_penalty * viol)[:, None] * delta / np.maximum(r, 1e-12)[:, None]
    np.add.at(g, np.stack([p1, p2], axis=1).reshape(-1),
              np.stack([gdir, -gdir], axis=1).reshape(-1, 3))
    return e


def _lbfgs(objective, x, gtol, max_iter, reporter=None, memory=12):
    f, g = objective(x)
    s_list, y_list, rho_list = [], [], []
    n_particles = len(x) // 3
    for it in range(max_iter):
        gnorm = np.sqrt(np.sum(g * g) / max(n_particles, 1))
        if reporter is not None:
            try:
                if reporter.report(it, x.reshape(-1, 3), gnorm, dict()):
                    break
            except Exception:
                pass
        if gnorm < gtol:
            break
        # two-loop recursion
        q = g.copy()
        alphas = []
        for s, y, rho in zip(reversed(s_list), reversed(y_list),
                             reversed(rho_list)):
            a = rho * np.dot(s, q)
            alphas.append(a)
            q -= a * y
        if y_list:
            gamma = np.dot(s_list[-1], y_list[-1]) / np.dot(y_list[-1],
                                                            y_list[-1])
        else:
            gamma = 1.0 / max(np.linalg.norm(g), 1.0)
        z = gamma * q
        for (s, y, rho), a in zip(zip(s_list, y_list, rho_list),
                                  reversed(alphas)):
            b = rho * np.dot(y, z)
            z += (a - b) * s
        d = -z
        # backtracking line search with Armijo condition
        dg = np.dot(d, g)
        if dg >= 0:   # not a descent direction; reset
            d = -g
            dg = -np.dot(g, g)
            s_list, y_list, rho_list = [], [], []
        step = 1.0
        # cap the initial displacement at 0.1 nm per atom
        max_disp = np.max(np.abs(d)) + 1e-300
        step = min(step, 0.1 / max_disp)
        success = False
        for _ in range(30):
            x_new = x + step * d
            f_new, g_new = objective(x_new)
            if np.isfinite(f_new) and f_new <= f + 1e-4 * step * dg:
                success = True
                break
            step *= 0.5
        if not success:
            break
        s = x_new - x
        yv = g_new - g
        sy = np.dot(s, yv)
        if sy > 1e-12:
            s_list.append(s)
            y_list.append(yv)
            rho_list.append(1.0 / sy)
            if len(s_list) > memory:
                s_list.pop(0)
                y_list.pop(0)
                rho_list.pop(0)
        if abs(f - f_new) < 1e-12 * max(1.0, abs(f)):
            x, f, g = x_new, f_new, g_new
            break
        x, f, g = x_new, f_new, g_new
    return x


class MinimizationReporter:
    """Callback interface (openmmapi/include/openmm/MinimizationReporter.h):
    report(iteration, x, grad, args) is called once per L-BFGS iteration;
    returning True stops the minimization. Exceptions it raises are
    ignored."""

    def report(self, iteration, x, grad, args):
        return False
