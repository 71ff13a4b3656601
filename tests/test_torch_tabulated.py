"""The six tabulated functions of openmm_tpu_torch (tabulated.py) against
the JAX package's (openmm_tpu/tabulated.py): the values against its
_make_eval (1e-12 relative) and the partial derivatives, written out from
the splines in the port, against jax.grad of the same evaluators (1e-10
relative), at seeded points inside the tables, on the periodic tables'
wrap (points beyond the range) and out of range (0, with derivative 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_tpu import tabulated as jtab

import openmm_tpu_torch as omm

torch.set_num_threads(1)
VALUE_TOL = 1e-12
GRAD_TOL = 1e-10


def _tables(periodic):
    """(name, constructor arguments, dimensions) of each function, smooth
    seeded tables; the periodic ones with matching edges."""
    rng = np.random.RandomState(11)
    g1 = np.sin(np.linspace(0.0, 2.0 * np.pi, 13)) + 0.1 * rng.randn(13)
    g2 = rng.randn(7, 6)
    g3 = rng.randn(5, 4, 6)
    if periodic:
        g1[-1] = g1[0]
        g2[-1, :] = g2[0, :]
        g2[:, -1] = g2[:, 0]
        g3[-1] = g3[0]
        g3[:, -1] = g3[:, 0]
        g3[:, :, -1] = g3[:, :, 0]
    return [
        ("Continuous1DFunction", (list(g1), -1.0, 2.0), 1),
        ("Continuous2DFunction", (7, 6, list(g2.ravel(order="F")), -1.0,
                                  1.5, 0.0, 2.0), 2),
        ("Continuous3DFunction", (5, 4, 6, list(g3.ravel(order="F")), 0.0,
                                  1.0, -1.0, 1.0, 0.5, 2.5), 3),
        ("Discrete1DFunction", (list(rng.randn(9)),), 1),
        ("Discrete2DFunction", (4, 3, list(rng.randn(12))), 2),
        ("Discrete3DFunction", (2, 3, 4, list(rng.randn(24))), 3),
    ]


def _points(args, dims, kind, inside):
    """(dims, 40) points: in the table (the discrete ones at indices and
    between), or beyond it on each side."""
    rng = np.random.RandomState(5)
    if kind.startswith("Discrete"):
        sizes = args[:dims] if dims > 1 else (len(args[0]),)
        return np.stack([rng.uniform(-1.5, s + 0.5, 40) for s in sizes])
    lims = ((args[1], args[2]) if dims == 1 else
            [(args[dims + 1 + 2 * k], args[dims + 2 + 2 * k])
             for k in range(dims)])
    lims = [lims] if dims == 1 else lims
    pts = []
    for lo, hi in lims:
        width = hi - lo
        if inside:
            pts.append(rng.uniform(lo, hi, 40))
        else:
            pts.append(np.where(rng.rand(40) < 0.5,
                                rng.uniform(lo - 1.5 * width, lo, 40),
                                rng.uniform(hi, hi + 1.5 * width, 40)))
    return np.stack(pts)


def _case(kind, args, periodic):
    jcls = getattr(jtab, kind)
    cls = getattr(omm, kind)
    if kind.startswith("Continuous"):
        return jcls(*args, periodic), cls(*args, periodic)
    return jcls(*args), cls(*args)


@pytest.mark.parametrize("where", ["inside", "beyond"])
@pytest.mark.parametrize("index, periodic", [
    (k, p) for p in (False, True) for k in range(6 if not p else 3)])
def test_function_values_and_derivatives_match_jax(index, periodic, where):
    """(The discrete tables have no periodic form; beyond their range they
    read their edge.)"""
    kind, args, dims = _tables(periodic)[index]
    jfn, fn = _case(kind, args, periodic)
    pts = _points(args, dims, kind, where == "inside")
    jeval = jfn._make_eval(np.float64)
    want = np.asarray(jeval(*(jnp.asarray(p) for p in pts)))
    compiled = fn._compile(torch.float64, "cpu")
    got = compiled.value(*(torch.as_tensor(p) for p in pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=VALUE_TOL, atol=VALUE_TOL)
    if where == "beyond" and not periodic and kind.startswith("Continuous"):
        assert not got.any()
    both, grads = compiled.both(*(torch.as_tensor(p) for p in pts))
    np.testing.assert_array_equal(both.numpy(), got)
    for k in range(dims):
        def one(*xs, k=k):
            return jeval(*xs)
        jg = jax.vmap(jax.grad(one, argnums=k))(
            *(jnp.asarray(p) for p in pts))
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_api_copy_and_update_count():
    fn = omm.Continuous1DFunction([0.0, 1.0, 4.0], 0.0, 2.0)
    assert fn.getFunctionParameters() == ([0.0, 1.0, 4.0], 0.0, 2.0)
    copy = fn.Copy()
    fn.setFunctionParameters([1.0, 2.0], -1.0, 1.0)
    assert fn.getUpdateCount() == 1 and copy.getUpdateCount() == 0
    assert copy.getFunctionParameters()[0] == [0.0, 1.0, 4.0]
    grid = omm.Continuous2DFunction(2, 2, [0, 1, 2, 3], 0, 1, 0, 1, True)
    assert grid.getPeriodic() and grid.Copy().getPeriodic()
    with pytest.raises(ValueError):
        omm.Discrete2DFunction(2, 2, [1.0, 2.0, 3.0])


def test_nan_argument_reads_inside_the_table():
    """An overflowed step poisons the positions with NaN; a table read at
    a NaN argument must stay inside the table (a NaN cast to an index is a
    device-side assert on a card, before the host can undo the chunk), and
    so must a CMAP map at a NaN angle."""
    import math

    from openmm_tpu_torch import tabulated
    from openmm_tpu_torch.forces.bonded import _cmap_cell
    x = torch.tensor([math.nan, 1.5], dtype=torch.float64)
    fns = [tabulated.Continuous1DFunction([0.0, 1.0, 4.0, 9.0], 0.0, 3.0),
           tabulated.Continuous2DFunction(3, 3, list(range(9)), 0.0, 2.0,
                                          0.0, 2.0),
           tabulated.Continuous3DFunction(2, 2, 2, list(range(8)), 0.0, 1.0,
                                          0.0, 1.0, 0.0, 1.0),
           tabulated.Discrete1DFunction([1.0, 2.0, 3.0])]
    for fn in fns:
        compiled = fn._compile(torch.float64, "cpu")
        dims = {"Continuous1DFunction": 1, "Continuous2DFunction": 2,
                "Continuous3DFunction": 3, "Discrete1DFunction": 1}[
                    type(fn).__name__]
        out = compiled(*([x] * dims))
        assert out.shape == x.shape and math.isfinite(float(out[1]))
    cell, frac, _ = _cmap_cell(torch.tensor([math.nan, 1.0],
                                            dtype=torch.float64), 24)
    assert cell.tolist()[0] == 0 and 0 <= cell.tolist()[1] < 24
