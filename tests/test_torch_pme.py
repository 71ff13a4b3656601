"""Reciprocal-space PME of openmm_tpu_torch against openmm_tpu on the same
numpy-seeded inputs: the plain spread against pme.spread_charges, the
convolution against pme_zslab.convolve_potential, and the energy and
forces against pme_zslab.pme_recip_ef (Pallas interpreter) and against
jax.grad of the dense pme.pme_reciprocal_energy.

Tolerances: float32 comparisons allow 2e-5 relative on energies and 1e-4
of the largest force (different summation orders over 125 grid points per
atom and a matmul DFT against an FFT); float64 comparisons of the same
formulas allow 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_tpu.ops import geometry as jgeom
from openmm_tpu.ops import pme as jpme
from openmm_tpu.ops import pme_zslab as jzs

from openmm_tpu_torch.ops import geometry as geom
from openmm_tpu_torch.ops import pme as pme_mod
from openmm_tpu_torch.ops import pme_zslab as zs

GRID = (24, 24, 24)
ALPHA = 2.7
BOX = 3.0


@pytest.fixture(scope="module")
def waters():
    rng = np.random.RandomState(11)
    n_mol = 220
    side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    g = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                  axis=-1).reshape(-1, 3)[:n_mol] + 0.5) * (BOX / side)
    centres = g + rng.uniform(-0.06, 0.06, size=(n_mol, 3))
    pos = np.zeros((3 * n_mol, 3))
    pos[0::3] = centres
    pos[1::3] = centres + [0.0957, 0, 0]
    pos[2::3] = centres + [-0.024, 0.0927, 0]
    pos += rng.uniform(-0.5, 0.5, size=pos.shape) * 0.01 - [0.3, 0.0, 0.1]
    q = np.tile([-0.834, 0.417, 0.417], n_mol)
    box = np.diag([BOX, BOX, BOX])
    md = jpme.make_pme_recip_data(GRID, 5)
    bsq = [md[k] for k in ("bsq_x", "bsq_y", "bsq_z")]
    return pos, q, box, bsq


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x), dtype=dtype)


def test_moduli_and_parameters_match_jax():
    for g in (20, 24, 56):
        np.testing.assert_allclose(pme_mod.bspline_moduli(g, 5),
                                   jpme._bspline_moduli(g, 5), rtol=1e-14)
    assert pme_mod.ewald_alpha(0.9, 5e-4) == jpme.ewald_alpha(0.9, 5e-4)
    w = [6.212, 6.212, 6.212]
    assert pme_mod.pme_grid_size(w, 2.92, 5e-4) == \
        jpme.pme_grid_size(w, 2.92, 5e-4) == [56, 56, 56]


def test_spread_matches_jax(waters):
    pos, q, box, _ = waters
    binv = geom.box_inverse(_t(box)).reshape(9)
    got = zs.pme_spread(_t(pos), _t(q), binv.contiguous(), GRID)
    want = jpme.spread_charges(_j(pos), _j(q), jgeom.box_inverse(_j(box)),
                               GRID, 5, jnp.float32)
    want = np.asarray(want).transpose(2, 0, 1)        # (nz, nx, ny)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()
    assert zs.SPREAD.launches == 0     # CPU tensors take the plain version


def test_convolve_matches_jax(waters):
    _, _, box, bsq = waters
    q_grid = np.random.RandomState(2).randn(24, 24, 24)
    phi, e = zs.convolve_potential(_t(q_grid), _t(box), GRID, ALPHA,
                                   *(_t(b) for b in bsq))
    jphi, je = jzs.convolve_potential(_j(q_grid), _j(box), GRID, ALPHA,
                                      *(_j(b) for b in bsq))
    assert abs(float(e) - float(je)) < 2e-5 * abs(float(je))
    jphi = np.asarray(jphi)
    assert np.abs(phi.numpy() - jphi).max() < 1e-4 * np.abs(jphi).max()


def _dense_ef(pos, q, box, bsq, dtype):
    def energy(p):
        return jpme.pme_reciprocal_energy(
            p, _j(q, dtype), _j(box, dtype), GRID, 5, ALPHA,
            *(_j(b, dtype) for b in bsq), dtype)
    e, g = jax.value_and_grad(energy)(_j(pos, dtype))
    return float(e), -np.asarray(g)


def test_recip_ef_matches_zslab_interpreter(waters):
    pos, q, box, bsq = waters
    e, f = zs.pme_recip_ef(_t(pos), _t(q), _t(box), GRID, ALPHA,
                           [_t(b) for b in bsq])
    cfg = jzs.zslab_config(pos.shape[0], GRID)
    state = jzs.build_z_state(_j(pos), _j(box), _j(q), GRID, cfg)
    je, jf = jzs.pme_recip_ef(_j(pos), _j(q), _j(box), GRID, 5, ALPHA,
                              *(_j(b) for b in bsq), state, cfg,
                              interpret=True)
    jf = np.asarray(jf)
    assert abs(float(e) - float(je)) < 2e-5 * abs(float(je))
    assert np.abs(f.numpy() - jf).max() < 1e-4 * np.abs(jf).max()


def test_recip_ef_matches_dense_gradient(waters):
    pos, q, box, bsq = waters
    e, f = zs.pme_recip_ef(_t(pos), _t(q), _t(box), GRID, ALPHA,
                           [_t(b) for b in bsq])
    je, jf = _dense_ef(pos, q, box, bsq, jnp.float32)
    assert abs(float(e) - je) < 2e-5 * abs(je)
    assert np.abs(f.numpy() - jf).max() < 1e-4 * np.abs(jf).max()


def test_recip_ef_float64_plain_matches_dense_gradient(waters):
    pos, q, box, bsq = waters
    f64 = torch.float64
    e, f = zs.pme_recip_ef(_t(pos, f64), _t(q, f64), _t(box, f64), GRID,
                           ALPHA, [_t(b, f64) for b in bsq], plain=True)
    je, jf = _dense_ef(pos, q, box, bsq, jnp.float64)
    assert abs(float(e) - je) < 1e-10 * abs(je)
    assert np.abs(f.numpy() - jf).max() < 1e-10 * np.abs(jf).max()
    assert zs.GATHER.launches == 0


def test_kernel_wrappers_check_their_inputs(waters):
    pos, q, box, _ = waters
    binv = geom.box_inverse(_t(box)).reshape(9).contiguous()
    with pytest.raises(ValueError):
        zs.pme_spread(_t(pos), _t(q)[:-1], binv, GRID)
    with pytest.raises(ValueError):
        zs.pme_gather(_t(pos), _t(q, torch.float64),
                      torch.zeros(24, 24, 24), binv, GRID)
