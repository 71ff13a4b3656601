"""The dense spread of openmm_tpu_torch (ops/pallas_pme.py, ops/pme.py)
against openmm_tpu on the same numpy-seeded inputs: the plain versions of
kernels 4 and 5 against the Pallas kernels of ops/pallas_pme.py run by the
Pallas interpreter (force_tpu_interpret_mode), the autograd Function on the
CPU, and the dense reciprocal energy and its gradient against
pme.pme_reciprocal_energy(pallas=True) under the same interpreter.

Tolerances: the float32 spread sums N products per grid value in another
order than the Pallas kernel's chunked matmuls; with N = 300 uniform inputs
that is within 2e-6 of the largest |Q| (measured 5e-7) and 2e-6 of the
largest cotangent component (measured 5e-7). The float32 reciprocal energy
allows 2e-5 relative and its forces 1e-4 of the largest force, the bars of
tests/test_torch_pme.py (another summation order over 125 grid points per
atom and an FFT against a matmul DFT); float64 evaluations of the same
formulas allow 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from openmm_tpu.models import tip3p_water_box as jax_water_box
from openmm_tpu.ops import geometry as jgeom
from openmm_tpu.ops import pallas_pme as jpp
from openmm_tpu.ops import pme as jpme

from openmm_tpu_torch.ops import geometry as geom
from openmm_tpu_torch.ops import pallas_pme as pp
from openmm_tpu_torch.ops import pme as pme_mod
from torch_port_helpers import system_params

GRID = (12, 10, 14)       # not a cube, so no axis can stand in for another
N = 300                   # the JAX side pads to 512; the port takes 300


@pytest.fixture(scope="module")
def triple():
    rng = np.random.RandomState(3)
    nx, ny, nz = GRID
    a = rng.uniform(size=(N, nx)).astype(np.float32)
    wy = rng.uniform(size=(N, ny)).astype(np.float32)
    wz = rng.uniform(size=(N, nz)).astype(np.float32)
    dq = rng.randn(nx, ny * nz).astype(np.float32)
    return a, wy, wz, dq


def _pad(x, rows):
    return np.concatenate([x, np.zeros((rows - x.shape[0], x.shape[1]),
                                       x.dtype)])


@pytest.fixture(scope="module")
def pallas_results(triple):
    """Q and the VJP of the Pallas spread_triple, run by the interpreter
    on the inputs zero-padded to its chunk, cut back to N rows."""
    a, wy, wz, dq = triple
    rows = -(-N // jpp.CHUNK) * jpp.CHUNK
    args = [jnp.asarray(_pad(x, rows)) for x in (a, wy, wz)]
    with pltpu.force_tpu_interpret_mode():
        q, vjp = jax.vjp(jpp.spread_triple, *args)
        grads = vjp(jnp.asarray(dq))
    return np.asarray(q), [np.asarray(g)[:N] for g in grads]


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - want).max() / np.abs(want).max()


def test_plain_spread_matches_pallas_kernel(triple, pallas_results):
    a, wy, wz, _ = triple
    q = pp.spread_triple_plain(_t(a), _t(wy), _t(wz))
    assert q.shape == (GRID[0], GRID[1] * GRID[2])
    assert _rel(q, pallas_results[0]) < 2e-6


def test_plain_vjp_matches_pallas_kernel(triple, pallas_results):
    a, wy, wz, dq = triple
    grads = pp.spread_triple_vjp_plain(_t(dq), _t(a), _t(wy), _t(wz))
    for got, want in zip(grads, pallas_results[1]):
        assert got.shape == want.shape
        assert _rel(got, want) < 2e-6


def test_spread_triple_function_on_cpu(triple, pallas_results):
    """The autograd Function takes the plain versions for CPU tensors (no
    launch), at the ragged N, and its backward is the VJP."""
    a, wy, wz, dq = triple
    launches = (pp.FWD.launches, pp.BWD.launches)
    leaves = [_t(x).requires_grad_() for x in (a, wy, wz)]
    q = pp.spread_triple(*leaves)
    grads = torch.autograd.grad(q, leaves, _t(dq))
    assert _rel(q, pallas_results[0]) < 2e-6
    for got, want in zip(grads, pallas_results[1]):
        assert _rel(got, want) < 2e-6
    assert (pp.FWD.launches, pp.BWD.launches) == launches
    small = [torch.as_tensor(x[:7, :5], dtype=torch.float64).contiguous()
             .requires_grad_() for x in (a, wy, wz)]
    assert torch.autograd.gradcheck(pp.spread_triple, small)


def test_wrappers_check_their_inputs(triple):
    a, wy, wz, dq = triple
    with pytest.raises(ValueError):
        pp.spread_triple_fwd(_t(a), _t(wy)[:-1], _t(wz))
    with pytest.raises(ValueError):
        pp.spread_triple_bwd(_t(dq)[:, :-1], _t(a), _t(wy), _t(wz))
    with pytest.raises(ValueError):
        pp.spread_triple_fwd(_t(a), _t(wy, torch.float64), _t(wz))
    # a tensor that is neither on the CPU nor a float32 CUDA tensor is
    # refused, not sent to the plain version
    meta = [torch.empty(x.shape, device="meta") for x in (a, wy, wz)]
    with pytest.raises(TypeError):
        pp.spread_triple_fwd(*meta)
    with pytest.raises(TypeError):
        pp.spread_triple_bwd(torch.empty(dq.shape, device="meta"), *meta)


def _spline_planes(rng, n, grid, wrap):
    """Rows of 5 nonzero weights at a random base, wrapping round the
    grid's edge where the base is within 4 of it, as the B-splines give;
    wrap=True puts every base there."""
    planes = []
    for width in grid:
        lo = width - 4 if wrap else 0
        base = rng.randint(lo, width, size=(n, 1))
        cols = (base + np.arange(5)) % width
        w = np.zeros((n, width), np.float32)
        np.put_along_axis(w, cols, rng.uniform(0.05, 1.0, (n, 5)), axis=1)
        planes.append(w)
    return planes


@pytest.mark.parametrize("kind,grid", [("uniform", (12, 10, 14)),
                                       ("spline", (144, 20, 160)),
                                       ("wrapped", (12, 10, 14))])
def test_vjp_matches_pallas_kernel_on_any_grid(kind, grid):
    """Kernel 5 takes any grid in one launch. Its plain version, and the
    Function's backward on the CPU, against the JAX spread_triple VJP run
    by the Pallas interpreter: dense uniform planes, spline planes on a
    grid with two axes above 128, and spline planes whose every support
    wraps round the grid's edge; bar 2e-6 of each output's largest value,
    as above."""
    rng = np.random.RandomState(12)
    n = 200
    if kind == "uniform":
        planes = [rng.uniform(size=(n, g)).astype(np.float32) for g in grid]
    else:
        planes = _spline_planes(rng, n, grid, wrap=kind == "wrapped")
    dq = rng.randn(grid[0], grid[1] * grid[2]).astype(np.float32)
    rows = -(-n // jpp.CHUNK) * jpp.CHUNK
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jpp.spread_triple,
                         *(jnp.asarray(_pad(x, rows)) for x in planes))
        want = [np.asarray(g)[:n] for g in vjp(jnp.asarray(dq))]
    plain = pp.spread_triple_vjp_plain(_t(dq), *map(_t, planes))
    leaves = [_t(x).requires_grad_() for x in planes]
    backward = torch.autograd.grad(pp.spread_triple(*leaves), leaves,
                                   _t(dq))
    for got in (plain, backward):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) < 2e-6


@pytest.fixture(scope="module")
def box343():
    jsys, jpos = jax_water_box(n_waters=343)
    pos = np.array([[p.x, p.y, p.z] for p in jpos])
    params = system_params(jsys)
    q, box = params["charges"], params["box"]
    alpha = pme_mod.ewald_alpha(0.9, 5e-4)
    grid = tuple(pme_mod.pme_grid_size(np.diag(box), alpha, 5e-4))
    md = jpme.make_pme_recip_data(grid, 5)
    bsq = [md[k] for k in ("bsq_x", "bsq_y", "bsq_z")]
    # move the atoms off the lattice so no coordinate sits near a cell edge
    pos = pos + np.random.RandomState(8).uniform(-0.02, 0.02, pos.shape)
    return pos, q, box, grid, alpha, bsq


def _jax_dense(pos, q, box, grid, alpha, bsq, dtype, pallas):
    def energy(p):
        return jpme.pme_reciprocal_energy(
            p, jnp.asarray(q, dtype), jnp.asarray(box, dtype), grid, 5, alpha,
            *(jnp.asarray(b, dtype) for b in bsq), dtype, pallas=pallas)
    with pltpu.force_tpu_interpret_mode():
        e, g = jax.value_and_grad(energy)(jnp.asarray(pos, dtype))
    return float(e), -np.asarray(g)


def _port_dense(pos, q, box, grid, alpha, bsq, dtype, plain):
    p = _t(pos, dtype).requires_grad_()
    e = pme_mod.pme_reciprocal_energy(p, _t(q, dtype), _t(box, torch.float64),
                                      grid, 5, alpha,
                                      *(_t(b, dtype) for b in bsq),
                                      plain=plain)
    (g,) = torch.autograd.grad(e, p)
    assert e.dtype == torch.float64
    return float(e.detach()), -g.numpy()


def test_dense_reciprocal_energy_matches_pallas_path(box343):
    pos, q, box, grid, alpha, bsq = box343
    assert grid == (20, 20, 20)
    je, jf = _jax_dense(pos, q, box, grid, alpha, bsq, jnp.float32, True)
    e, f = _port_dense(pos, q, box, grid, alpha, bsq, torch.float32, False)
    assert abs(e - je) < 2e-5 * abs(je)
    assert np.abs(f - jf).max() < 1e-4 * np.abs(jf).max()


def test_dense_reciprocal_energy_float64(box343):
    pos, q, box, grid, alpha, bsq = box343
    je, jf = _jax_dense(pos, q, box, grid, alpha, bsq, jnp.float64, False)
    e, f = _port_dense(pos, q, box, grid, alpha, bsq, torch.float64, True)
    assert abs(e - je) < 1e-10 * abs(je)
    assert np.abs(f - jf).max() < 1e-10 * np.abs(jf).max()


def test_dense_weights_match_jax(box343):
    pos, q, box, grid, _, _ = box343
    binv = geom.box_inverse(_t(box, torch.float64))
    t = _t(np.random.RandomState(4).uniform(size=(50,)), torch.float64)
    np.testing.assert_allclose(
        pme_mod.bspline_weights(t, 5).numpy(),
        np.asarray(jpme.bspline_weights(jnp.asarray(t.numpy()), 5)),
        rtol=1e-14, atol=1e-16)
    a, wy, wz = pme_mod.dense_weights(_t(pos, torch.float64),
                                      _t(q, torch.float64), binv, grid, 5)
    want = jpme.spread_charges_dense(
        jnp.asarray(pos), jnp.asarray(q),
        jgeom.box_inverse(jnp.asarray(box)), grid, 5, jnp.float64)
    got = torch.einsum("ix,iy,iz->xyz", a, wy, wz).numpy()
    assert np.abs(got - np.asarray(want)).max() < 1e-12
    for w in (wy, wz):
        assert torch.allclose(w.sum(dim=1), torch.ones(len(pos),
                                                       dtype=w.dtype))


def test_chip_smoke_kernel_phase_on_cpu():
    """The card's kernel phase and bounds, rehearsed on the CPU, where each
    wrapper takes its plain version."""
    cpu = torch.device("cpu")
    inp = chip_smoke.kernel_inputs(cpu, 343)
    errors = chip_smoke.phase_kernels(cpu, inp, chip_smoke.Deadline(1e9))
    assert set(errors) == {k.name for k in chip_smoke.KERNELS}
    chip_smoke.phase_triple_shapes(cpu, chip_smoke.Deadline(1e9))
    counts = chip_smoke.tile_counts(inp)
    assert str(counts["visited"]) in chip_smoke.tile_sweep_line(inp, counts)
    bounds = chip_smoke.kernel_bounds(inp, counts)
    fwd, bwd, fwd_dense, bwd_dense = chip_smoke.triple_ops(*inp["triple"])
    n = 3 * 343
    assert fwd == n * (25 + 2 * 125)         # 5 nonzero weights per axis
    assert fwd_dense == 2 * n * 20 ** 3 and bwd_dense == 2 * fwd_dense
    for name in ("spread_triple_fwd", "spread_triple_bwd"):
        assert bounds[name][1] == "bytes"
