"""Direct space of openmm_tpu_torch (candidate-state build + the plain
version of the tile kernel) against openmm_tpu on the same numpy-seeded
water-like system of 1,104 atoms: the Pallas tile kernel in interpret mode
(pallas_pairs.build_tile_state + eval_tiles) and the XLA row engine
(pairs.pair_energy_force_rows), in Ewald and reaction-field modes, with and
without the LJ switch. All three run float32 with the Hastings erfc;
summation orders differ, so energies agree to 1e-5 relative and forces to
1e-4 of the largest force. A forced capacity overflow must poison the
energy and every force with NaN, and a Context must grow its capacity,
in a step and in a reading between steps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_tpu.ops import pairs as jpairs
from openmm_tpu.ops import pallas_pairs as jpp

import openmm_tpu_torch as omm
from openmm_tpu_torch.forces.nonbonded import NonbondedModule
from openmm_tpu_torch.models import tip3p_water_box
from openmm_tpu_torch.ops import tile_pairs as tp
from openmm_tpu_torch.unit import plain

# one intra-op thread, as tests/torch_port_helpers.py sets: the runner's
# worker processes would otherwise oversubscribe the cores
torch.set_num_threads(1)

ONE4PI = 138.93545764446428
ALPHA = 3.12341
CUTOFF = 0.7
SWITCH = 0.6
KRF = (1.0 / CUTOFF ** 3) * (78.3 - 1.0) / (2.0 * 78.3 + 1.0)
CRF = (1.0 / CUTOFF) * 3.0 * 78.3 / (2.0 * 78.3 + 1.0)


@pytest.fixture(scope="module")
def water():
    rng = np.random.RandomState(4)
    n_mol = 368
    n = 3 * n_mol
    box_l = (n_mol / 33.37) ** (1.0 / 3.0)
    side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    g = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                  axis=-1).reshape(-1, 3)[:n_mol] + 0.5) * (box_l / side)
    centres = g + rng.uniform(-0.08, 0.08, size=(n_mol, 3))
    pos = np.zeros((n, 3))
    pos[0::3] = centres
    pos[1::3] = centres + [0.09572, 0, 0]
    pos[2::3] = centres + [-0.024, 0.0927, 0]
    q = np.tile([-0.834, 0.417, 0.417], n_mol)
    sig = np.tile([0.315, 1.0, 1.0], n_mol)
    eps = np.tile([0.636, 0.0, 0.0], n_mol)
    pairs = [(3 * m + a, 3 * m + b) for m in range(n_mol)
             for a, b in ((0, 1), (0, 2), (1, 2))]
    return pos, np.diag([box_l] * 3), q, sig, eps, pairs, n


def _jax_row_ef(mode, switch):
    def ef(r2, pi, pj):
        inv_r2 = 1.0 / r2
        r = jnp.sqrt(r2)
        inv_r = 1.0 / r
        s = 0.5 * (pi["sigma"] + pj["sigma"])
        e4 = 4.0 * jnp.sqrt(pi["epsilon"] * pj["epsilon"])
        s6 = (s * s * inv_r2) ** 3
        e_lj = e4 * s6 * (s6 - 1.0)
        de_lj = -3.0 * e4 * s6 * (2.0 * s6 - 1.0) * inv_r2
        if switch:
            t = jnp.clip(r - SWITCH, 0.0, None) / (CUTOFF - SWITCH)
            sw = 1.0 - t * t * t * (10.0 - 15.0 * t + 6.0 * t * t)
            dsw = (-30.0 * t * t * (1.0 - t) * (1.0 - t)
                   / (CUTOFF - SWITCH)) * (0.5 * inv_r)
            de_lj = de_lj * sw + e_lj * dsw
            e_lj = e_lj * sw
        qq = ONE4PI * pi["charge"] * pj["charge"]
        if mode == tp.MODE_EWALD:
            ar = ALPHA * r
            t = 1.0 / (1.0 + 0.3275911 * ar)
            exp2 = jnp.exp(-ar * ar)
            erfc_ar = (0.254829592 + (-0.284496736 + (1.421413741 + (
                -1.453152027 + 1.061405429 * t) * t) * t) * t) * t * exp2
            e_c = qq * inv_r * erfc_ar
            de_c = (-qq * (erfc_ar * inv_r2 + 1.1283791670955126 * ALPHA
                           * exp2 * inv_r)) * (0.5 * inv_r)
        else:
            e_c = qq * (inv_r + KRF * r2 - CRF)
            de_c = qq * (-0.5 * inv_r2 * inv_r + KRF)
        inside = r2 < CUTOFF * CUTOFF
        return (jnp.where(inside, e_lj + e_c, 0.0),
                jnp.where(inside, de_lj + de_c, 0.0))
    return ef


def _port_ef(water, mode, switch):
    pos, box, q, sig, eps, pairs, n = water
    f32 = torch.float32
    pos_t = torch.as_tensor(pos, dtype=f32)
    box_t = torch.as_tensor(box, dtype=f32)
    excl = torch.as_tensor(jpairs.build_exclusion_table(n, pairs))
    nb = tp.pad_to_block(n, tp.BRICK) // tp.BRICK
    st = tp.build_tile_state(
        pos_t, box_t, torch.as_tensor(q, dtype=f32),
        torch.as_tensor(sig, dtype=f32), torch.as_tensor(eps, dtype=f32),
        excl, CUTOFF, nb, 0.6 * (64 * box[0, 0] ** 3 / n) ** (1 / 3))
    assert int(st["overflow"]) == 0
    rs = SWITCH if switch else 0.0
    scalars = torch.tensor([ALPHA, CUTOFF ** 2, KRF, CRF, rs,
                            1.0 / (CUTOFF - SWITCH) if switch else 0.0],
                           dtype=f32)
    e, f = tp.tile_energy_forces(pos_t, box_t, st,
                                 tp.tile_consts(box_t, scalars), mode, switch)
    return float(e), f.numpy()


def _jax_inputs(water):
    pos, box, q, sig, eps, pairs, n = water
    n_pad = ((n + 63) // 64) * 64

    def pad(x, fill):
        return jnp.asarray(np.concatenate(
            [x, np.full((n_pad - n,) + x.shape[1:], fill)]), jnp.float32)

    pos_p = pad(pos, 0.0).at[n:].set(jnp.asarray(pos[0], jnp.float32))
    excl = jnp.asarray(jpairs.build_exclusion_table(n_pad, pairs))
    return (pos_p, jnp.asarray(box, jnp.float32), pad(q, 0.0),
            pad(sig, 1.0), pad(eps, 0.0), excl, n, n_pad)


@pytest.mark.parametrize("switch", [False, True], ids=["plain-lj", "switch"])
@pytest.mark.parametrize("mode", [tp.MODE_EWALD, tp.MODE_RF],
                         ids=["ewald", "rf"])
def test_direct_space_matches_jax(water, mode, switch):
    e, f = _port_ef(water, mode, switch)
    pos, box, q, sig, eps, excl, n, n_pad = _jax_inputs(water)
    st = jpp.build_tile_state(pos, box, q, sig, eps, excl, n, CUTOFF,
                              n_pad // 64, sort_cell=0.7)
    assert int(st["overflow"]) == 0
    e_pl, f_pl = jpp.eval_tiles(
        pos, box, st, n, CUTOFF, mode, alpha=ALPHA, krf=KRF, crf=CRF,
        interpret=True, switch_dist=SWITCH if switch else -1.0)
    per_atom = {"charge": q, "sigma": sig, "epsilon": eps}
    e_rows, f_rows, ov = jpairs.pair_energy_force_rows(
        pos, box, _jax_row_ef(mode, switch), per_atom, excl, n, CUTOFF,
        max_cols=n_pad // 64, block=64, periodic=True, sort_cell=0.7)
    assert int(ov) == 0
    for e_ref, f_ref in ((e_pl, f_pl), (e_rows, f_rows)):
        f_ref = np.asarray(f_ref)[:n]
        assert abs(e - float(e_ref)) < 1e-5 * abs(float(e_ref))
        assert np.abs(f - f_ref).max() < 1e-4 * np.abs(f_ref).max()


def test_kernel_wrapper_on_cpu_is_the_plain_version(water):
    pos, box, q, sig, eps, pairs, n = water
    excl = torch.as_tensor(jpairs.build_exclusion_table(n, pairs))
    f32 = torch.float32
    pos_t, box_t = torch.as_tensor(pos, dtype=f32), torch.as_tensor(box,
                                                                    dtype=f32)
    st = tp.build_tile_state(pos_t, box_t, torch.as_tensor(q, dtype=f32),
                             torch.as_tensor(sig, dtype=f32),
                             torch.as_tensor(eps, dtype=f32), excl, CUTOFF,
                             100, 0.5)
    args = (tp.sorted_positions(pos_t, box_t, st), st["par4"], st["cand"],
            st["count"], st["words"],
            tp.tile_consts(box_t, torch.tensor([ALPHA, CUTOFF ** 2, 0, 0, 0,
                                                0], dtype=f32)))
    before = tp.TILES.launches
    got = tp.nonbonded_tiles(*args, tp.MODE_EWALD, False)
    assert torch.equal(got, tp.nonbonded_tiles_plain(*args, tp.MODE_EWALD,
                                                     False))
    assert tp.TILES.launches == before
    with pytest.raises(TypeError):
        tp.nonbonded_tiles(args[0], args[1], args[2].long(), *args[3:],
                           tp.MODE_EWALD, False)


def test_overflow_poisons_energy_and_forces():
    system, pos = tip3p_water_box(125)
    module = NonbondedModule(system.getForce(0),
                             plain(system.getDefaultPeriodicBoxVectors()),
                             torch.device("cpu"))
    pos_t = torch.as_tensor(pos)
    box_t = torch.as_tensor(plain(system.getDefaultPeriodicBoxVectors()))
    e, f = module(pos_t, box_t)
    assert np.isfinite(float(e)) and torch.isfinite(f).all()
    module.capacity_scale = 0.05
    st = module.build_state(pos_t, box_t)
    assert int(st["overflow"]) > 0
    e, f = module(pos_t, box_t, st)
    assert np.isnan(float(e)) and torch.isnan(f).all()


def test_context_grows_capacity_after_overflow():
    system, pos = tip3p_water_box(125)
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.0005)
    ctx = omm.Context(system, integ, "CPU")
    ctx._nonbonded.capacity_scale = 0.05
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    integ.step(3)
    assert ctx.escalation_count > 0 and ctx.getStepCount() == 3
    st = ctx.getState(getEnergy=True, getForces=True)
    assert np.isfinite(plain(st.getPotentialEnergy()))
    assert np.isfinite(plain(st.getForces(asNumpy=True))).all()


@pytest.mark.parametrize("sheared", [False, True], ids=["cubic", "triclinic"])
def test_cull_keeps_every_pair_inside_the_cutoff(water, sheared):
    """Kernel 1 sweeps only the candidate bricks that tp.cull_mask keeps
    for each row atom. On a state built at cutoff + skin, at positions
    that then moved by up to skin/2 (as between two rebuilds), every pair
    that the plain version counts lies in a kept brick, on the cubic box
    and on the reduced triclinic one of tests/test_torch_triclinic.py;
    and the cull does drop slots."""
    pos, box, q, sig, eps, pairs, n = water
    if sheared:
        edge = box[0, 0]
        box = box + edge * np.array([[0, 0, 0], [2 / 7, 0, 0],
                                     [-1 / 7, 2 / 7, 0]])
    f32 = torch.float32
    box_t = torch.as_tensor(box, dtype=f32)
    excl = torch.as_tensor(jpairs.build_exclusion_table(n, pairs))
    nb = tp.pad_to_block(n, tp.BRICK) // tp.BRICK
    skin = 0.25
    st = tp.build_tile_state(
        torch.as_tensor(pos, dtype=f32), box_t,
        torch.as_tensor(q, dtype=f32), torch.as_tensor(sig, dtype=f32),
        torch.as_tensor(eps, dtype=f32), excl, CUTOFF + skin, nb, 0.5)
    assert int(st["overflow"]) == 0
    step = np.random.RandomState(6).uniform(-1, 1, pos.shape)
    step *= 0.5 * skin / np.linalg.norm(step, axis=1, keepdims=True)
    moved = torch.as_tensor(pos + 0.999 * step, dtype=f32)
    pos4 = tp.sorted_positions(moved, box_t, st)
    consts = tp.tile_consts(box_t, torch.tensor(
        [ALPHA, CUTOFF ** 2, 0, 0, 0, 0], dtype=f32))
    cand, count, words = st["cand"], st["count"], st["words"]
    kept = tp.cull_mask(pos4, cand, count, consts)
    mc = cand.shape[1]
    for r0, r1 in tp._row_chunks(nb, mc):
        ok = tp._chunk_pairs(pos4, cand, count, words, consts, r0, r1)[5]
        hit = ok.view(r1 - r0, tp.BRICK, mc, tp.BRICK).any(dim=-1)
        assert not (hit & ~kept[r0 * tp.BRICK:r1 * tp.BRICK]
                    .view(r1 - r0, tp.BRICK, mc)).any()
    c = tp.count_tile_pairs(pos4, cand, count, words, consts)
    assert c["inside"] <= c["evaluated"] < c["inside"] + 32 * nb * tp.BRICK
    assert c["inside"] <= c["visited"] < c["slots"]
    assert c["evaluated_before"] > c["evaluated"]


def test_reading_grows_capacity_after_overflow():
    """A reading whose rebuild overflows (here the first, before any
    step) grows the capacity and reports what a Context built at a
    sufficient capacity reports, never the NaN poison."""
    system, pos = tip3p_water_box(125)
    readings = []
    for scale in (None, 0.1):
        integ = omm.VerletIntegrator(0.001)
        ctx = omm.Context(system, integ, "CPU")
        if scale is not None:
            ctx._nonbonded.capacity_scale = scale
        ctx.setPositions(pos)
        ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
        t = ctx.temperature()
        st = ctx.getState(getEnergy=True, getForces=True)
        readings.append((ctx.escalation_count, t,
                         plain(st.getPotentialEnergy()),
                         plain(st.getKineticEnergy()), plain(st.getForces(
                             asNumpy=True))))
    (e0, t0, u0, k0, f0), (e1, t1, u1, k1, f1) = readings
    assert e0 == 0 and e1 > 0
    assert np.isfinite([t1, u1, k1]).all() and np.isfinite(f1).all()
    np.testing.assert_allclose([t1, u1, k1], [t0, u0, k0], rtol=1e-9)
    np.testing.assert_allclose(f1, f0, rtol=0, atol=1e-9 * np.abs(f0).max())
