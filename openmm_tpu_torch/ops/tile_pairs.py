"""Direct-space nonbonded terms over 16-atom bricks: the persistent
candidate state, kernel 1 (`nonbonded_tiles`) and its plain version.

Counterpart of openmm_tpu/ops/pallas_pairs.py (build_tile_state,
eval_tiles, _kernel_body/_tile_compute) with the capacity budgets of
openmm_tpu/forces/nonbonded.py. What carries over is what the TPU kernel
computes and its persistence contract: atoms are spatially sorted into
16-atom bricks, each row brick keeps the list of candidate bricks whose
bounding boxes come within cutoff + skin, and the list is rebuilt only when
an atom has moved more than skin/2; a list that did not fit its capacity
is reported as an overflow, which poisons the result with NaN. What does
not carry over are the TPU workarounds: the per-step compacted candidate
slabs (the kernel reads candidates by index), float-parity bit tests and
one-hot matmuls (the exclusion test is an integer bit test). At every call
kernel 1 also culls, per row atom, the candidate bricks whose bounding
boxes lie beyond the cutoff (cull_mask is the plain model of that cull);
the cull drops no pair inside the cutoff, so the plain version needs none.

Layout. `pos4` and `par4` are (n_pad, 4) float tensors in the sorted frame:
(x, y, z, 0) and (sqrt(k_e) q, sigma / 2, 2 sqrt(eps), c6), so that the
Lorentz-Berthelot mixing of a pair is one add and one multiply; c6 =
2 sqrt(eps) sigma^3, whose product over a pair is LJPME's geometric
coefficient, is 0 but in MODE_LJPME. `cand` is
(n_bricks, max_cand) int32, ordered per row [exclusion-carrying | plain |
unused]; `count` is the number of live candidates per row; `words` is
(n_pad, exc_cap) int32 with bit l of words[i, k] set when row atom i must
not interact with atom l of candidate brick k (exclusions and the atom
itself); only the first exc_cap candidates can carry such bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from ..constants import ONE_4PI_EPS0
from . import geometry as geom
from .pairs import (pad_to_block, pair_param_derivative, pair_terms,
                    spatial_sort_keys)

BRICK = 16
EXC_SLOTS = 32          # candidate slots that may carry exclusion bits
MODE_EWALD, MODE_RF, MODE_LJPME = 0, 1, 2
TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

TILES = _build.Kernel(
    name="nonbonded_tiles", source="openmm_tpu_torch/csrc/nonbonded_tiles.cu",
    replaces="openmm_tpu/ops/pallas_pairs.py:541")
# kernel 1's derivative instantiation: dE/dlambda of a global parameter
# that offsets move the parameters by (between steps only)
TILES_DERIV = _build.Kernel(
    name="nonbonded_tiles_deriv", source=TILES.source,
    replaces=TILES.replaces)


def tile_budget(n: int, box_widths, cutoff: float, skin: float,
                scale: float = 1.0) -> dict:
    """Static capacities of the candidate state (the 16-atom-row Pallas
    budget of forces/nonbonded.py): `max_bricks` candidates per row brick,
    the sort cell, and `exc_cap`. `scale` grows after an overflow."""
    vol = float(box_widths[0] * box_widths[1] * box_widths[2])
    nq = pad_to_block(n, BRICK) // BRICK
    block_side = (64.0 * vol / n) ** (1.0 / 3.0)
    s16 = (16.0 * vol / n) ** (1.0 / 3.0)
    r_q = cutoff + skin + 0.85 * s16 + 0.85 * s16
    max_bricks = min(nq, int((nq / vol) * (4.0 / 3.0) * math.pi * r_q ** 3
                             * 1.18 * scale) + 8)
    return {"max_bricks": max_bricks, "sort_cell": 0.6 * block_side,
            "exc_cap": min(max_bricks, int(EXC_SLOTS * scale))}


def tile_params(charge, sigma, epsilon, order, c6=False) -> torch.Tensor:
    """par4 (n_pad, 4) in the sorted frame of `order` from the (n,)
    particle parameters (padding atoms: no charge, sigma 1, eps 0); its
    fourth slot c6 = 2 sqrt(eps) sigma^3 when `c6`, else 0."""
    n_pad = order.shape[0]
    n = charge.shape[0]
    dev, dt = charge.device, charge.dtype

    def padded(x, fill):
        x = torch.cat([x.to(device=dev, dtype=dt),
                       torch.full((n_pad - n,), fill, dtype=dt, device=dev)])
        return x[order]

    sig = padded(sigma, 1.0)
    es = 2.0 * torch.sqrt(padded(epsilon, 0.0))
    fourth = (es * sig ** 3 if c6
              else torch.zeros(n_pad, dtype=dt, device=dev))
    return torch.stack([math.sqrt(ONE_4PI_EPS0) * padded(charge, 0.0),
                        0.5 * sig, es, fourth], dim=1).contiguous()


def tile_param_derivs(charge, sigma, epsilon, dcharge, dsigma, depsilon,
                      order, c6=False) -> torch.Tensor:
    """dpar4 (n_pad, 4): the derivatives in a global parameter lambda of
    tile_params' columns, from the particles' parameters and their
    derivatives (n,): sqrt(k_e) dq, dsigma / 2, d(2 sqrt(eps)) =
    deps / sqrt(eps) (0 where eps is 0) and, when `c6`, d(2 sqrt(eps)
    sigma^3); padding atoms 0."""
    n_pad = order.shape[0]
    n = charge.shape[0]
    dev, dt = charge.device, charge.dtype

    def padded(x):
        x = torch.cat([x.to(device=dev, dtype=dt),
                       torch.zeros(n_pad - n, dtype=dt, device=dev)])
        return x[order]

    eps = padded(epsilon)
    positive = eps > 0
    root = torch.sqrt(torch.where(positive, eps, 1.0))
    des = torch.where(positive, padded(depsilon) / root, 0.0)
    es = torch.where(positive, 2.0 * root, 0.0)
    sig, dsig = padded(sigma), padded(dsigma)
    fourth = (des * sig ** 3 + 3.0 * es * sig * sig * dsig if c6
              else torch.zeros(n_pad, dtype=dt, device=dev))
    return torch.stack([math.sqrt(ONE_4PI_EPS0) * padded(dcharge),
                        0.5 * dsig, des, fourth], dim=1).contiguous()


def build_tile_state(pos, box, charge, sigma, epsilon, exclusions, reach,
                     max_bricks, sort_cell, exc_cap=EXC_SLOTS,
                     box_widths=None, c6=False) -> dict:
    """Candidate state for kernel 1 at positions `pos` (n, 3).

    exclusions: (n, E) int tensor of excluded partners (-1 padded). The
    state's float tensors take pos.dtype. `box_widths`, the box's diagonal
    as Python floats, fixes the sort cells; given, the build has static
    shapes and reads nothing back from the device, so it can be captured
    in a CUDA graph (without, the sort reads the diagonal from `box`).
    Returns a dict of tensors on pos.device; "overflow" counts candidates
    and exclusion slots that did not fit (0 when the state is complete).
    `c6`: par4 carries LJPME's c6 (tile_params).
    """
    dev, dt = pos.device, pos.dtype
    n = pos.shape[0]
    n_pad = pad_to_block(n, BRICK)
    nb = n_pad // BRICK
    boxd = box.to(dt)
    if box_widths is not None and dt == torch.float32:
        # the widths as boxd holds them
        box_widths = [float(np.float32(w)) for w in box_widths]
    binv = geom.box_inverse(boxd)
    posf = torch.cat([pos, pos[:1].expand(n_pad - n, 3)])
    # wrap bookkeeping: pos = pos_w + W @ box with integer W
    wraps = torch.floor(geom.to_fractional(posf, binv))
    pos_w = posf - geom.from_fractional(wraps, boxd)

    order = torch.argsort(spatial_sort_keys(pos_w, boxd, n, sort_cell,
                                            box_widths), stable=True)
    inv_order = torch.argsort(order)
    pos_s = pos_w[order]
    w_s = wraps[order]
    pos_s[n:] = pos_s[n - 1]
    w_s[n:] = w_s[n - 1]
    # image every atom next to its brick's first atom, so a brick that
    # straddles the box edge keeps a tight bounding box
    anchor = pos_s.view(nb, BRICK, 3)[:, :1].expand(nb, BRICK, 3)
    anchor = anchor.reshape(n_pad, 3)
    d = pos_s - anchor
    d_red = geom.periodic_delta(d, boxd)
    pos_s = anchor + d_red
    w_s = w_s + torch.round(geom.to_fractional(d - d_red, binv))

    bricks = pos_s.view(nb, BRICK, 3)
    lo, hi = bricks.amin(dim=1), bricks.amax(dim=1)
    centre, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    dc = geom.periodic_delta(centre[:, None] - centre[None], boxd)
    gap = torch.clamp(dc.abs() - (half[:, None] + half[None]), min=0.0)
    close = (gap * gap).sum(dim=-1) < reach * reach              # (nb, nb)

    mc = min(nb, int(max_bricks))
    cand = torch.argsort((~close).to(torch.int8), dim=1, stable=True)[:, :mc]
    valid = close.gather(1, cand)
    count = valid.sum(dim=1)
    overflow = close.sum() - count.sum()

    # exclusion entries in the sorted frame, plus every atom itself
    table = torch.full((n_pad, exclusions.shape[1]), -1, dtype=torch.int64,
                       device=dev)
    table[:n] = exclusions.to(device=dev, dtype=torch.int64)
    table = table[order]
    slots = torch.where(table >= 0, inv_order[table.clamp(min=0)], -1)
    entries = torch.cat(
        [slots, torch.arange(n_pad, device=dev)[:, None]], dim=1)
    e_brick = torch.where(entries >= 0, entries // BRICK, nb)
    row = (torch.arange(n_pad, device=dev) // BRICK)[:, None].expand_as(
        entries)
    carries = torch.zeros((nb, nb + 1), dtype=torch.bool, device=dev)
    # a device True: a stored Python True is a copy from the host, which a
    # CUDA graph cannot capture
    carries.index_put_((row, e_brick),
                       torch.ones((), dtype=torch.bool, device=dev))
    has_excl = carries.gather(1, cand) & valid
    rank = torch.where(valid, torch.where(has_excl, 0, 1), 2)
    reorder = torch.argsort(rank, dim=1, stable=True)
    cand = cand.gather(1, reorder)
    excl_count = has_excl.sum(dim=1)
    exc_cap = min(int(exc_cap), mc)
    overflow = overflow + torch.clamp(excl_count - exc_cap, min=0).sum()

    slot_of = torch.full((nb, nb + 1), -1, dtype=torch.int64, device=dev)
    slot_of.scatter_(1, cand[:, :exc_cap],
                     torch.arange(exc_cap, device=dev).expand(nb, exc_cap))
    k = slot_of[row, e_brick]
    ok = (entries >= 0) & (k >= 0) & (k < excl_count[row])
    atom = torch.arange(n_pad, device=dev)[:, None].expand_as(entries)
    # static shapes: an entry that sets no bit adds 0 to word 0 (the adds
    # are integer adds of distinct bits, so the words are the same)
    words = torch.zeros(n_pad * exc_cap, dtype=torch.int32, device=dev)
    words.index_add_(0, torch.where(ok, atom * exc_cap + k, 0).reshape(-1),
                     torch.where(ok, 1 << (entries % BRICK), 0)
                     .to(torch.int32).reshape(-1))

    par4 = tile_params(charge.to(dt), sigma.to(dt), epsilon.to(dt), order,
                       c6)
    return {"order": order, "inv_order": inv_order, "wraps": w_s,
            "par4": par4,
            "cand": cand.to(torch.int32).contiguous(),
            "count": count.to(torch.int32).contiguous(),
            "words": words.view(n_pad, exc_cap),
            "overflow": overflow.to(torch.int64)}


def sorted_positions(pos, box, st) -> torch.Tensor:
    """(n_pad, 4) positions in the state's sorted frame, imaged next to
    their brick anchors by the wrap offsets stored at build."""
    order = st["order"]
    n_pad = order.shape[0]
    n = pos.shape[0]
    dt = st["par4"].dtype
    posf = pos.to(dt)
    posf = torch.cat([posf, posf[:1].expand(n_pad - n, 3)])
    ps = posf[order] - geom.from_fractional(st["wraps"], box.to(dt))
    return torch.cat([ps, torch.zeros((n_pad, 1), dtype=dt,
                                      device=ps.device)], dim=1)


def tile_consts(box, scalars) -> torch.Tensor:
    """The kernel's 16 constants: scalars = (alpha, cutoff^2, krf, crf,
    switch distance, 1/(cutoff - switch distance)) as a tensor, and in
    MODE_LJPME a seventh, 1 / cutoff^6, in the last slot (krf and crf then
    hold alpha_LJ^2 and the dispersion shift: forces/nonbonded.py)."""
    b = box.to(scalars.dtype)
    diag = torch.stack([b[0, 0], b[1, 1], b[2, 2]])
    tail = (scalars[6:7] if scalars.shape[0] > 6
            else torch.zeros(1, dtype=b.dtype, device=b.device))
    return torch.cat([scalars[:4], b[0, :1], b[1, :2], b[2, :3],
                      1.0 / diag, scalars[4:6], tail])


def _check_tile_args(pos4, par4, cand, count, words, consts, mode):
    if mode not in (MODE_EWALD, MODE_RF, MODE_LJPME):
        raise ValueError("mode must be MODE_EWALD, MODE_RF or MODE_LJPME")
    n_pad = pos4.shape[0]
    if n_pad % BRICK or pos4.shape != (n_pad, 4) or par4.shape != (n_pad, 4):
        raise ValueError("pos4/par4 must be (n_pad, 4) with n_pad % 16 == 0")
    nb = n_pad // BRICK
    if cand.shape[0] != nb or count.shape != (nb,) or words.shape[0] != n_pad:
        raise ValueError("cand/count/words do not match the row bricks")
    if words.shape[1] > cand.shape[1] or consts.shape != (16,):
        raise ValueError("words wider than cand, or consts not (16,)")
    if cand.dtype != torch.int32 or count.dtype != torch.int32 \
            or words.dtype != torch.int32:
        raise TypeError("cand, count and words must be int32")
    for t in (pos4, par4, cand, count, words, consts):
        if t.device != pos4.device or not t.is_contiguous():
            raise ValueError("tile tensors must be contiguous, one device")
    if par4.dtype != pos4.dtype or consts.dtype != pos4.dtype:
        raise TypeError("pos4, par4 and consts must share one float dtype")


def nonbonded_tiles(pos4, par4, cand, count, words, consts, mode,
                    use_switch) -> torch.Tensor:
    """Kernel 1: per sorted atom (fx, fy, fz, e) as an (n_pad, 4) tensor,
    e the atom's full (not halved) pair energy. A CUDA tensor runs the
    hand-written kernel (float32 only: each brick's bounding box, then the
    culled, compacted sweep); a CPU tensor runs the plain version."""
    _check_tile_args(pos4, par4, cand, count, words, consts, mode)
    if pos4.device.type == "cpu":
        return nonbonded_tiles_plain(pos4, par4, cand, count, words, consts,
                                     mode, use_switch)
    if pos4.device.type != "cuda" or pos4.dtype != torch.float32:
        raise TypeError("the CUDA tile kernel takes float32 CUDA tensors")
    out = torch.empty_like(pos4)
    bounds = torch.empty((count.shape[0], 2, 4), dtype=pos4.dtype,
                         device=pos4.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(pos4.device).cuda_stream
    code = lib.omm_nonbonded_tiles(
        pos4.data_ptr(), par4.data_ptr(), cand.data_ptr(), count.data_ptr(),
        words.data_ptr(), consts.data_ptr(), count.shape[0], cand.shape[1],
        words.shape[1], int(mode), int(bool(use_switch)), bounds.data_ptr(),
        out.data_ptr(), stream)
    _build.check_launch(code, TILES)
    TILES.launches += 1
    return out


def nonbonded_tiles_deriv(pos4, par4, dpar4, cand, count, words, consts,
                          mode, use_switch) -> torch.Tensor:
    """Kernel 1's derivative instantiation: per sorted atom the sum over
    its partners inside the cutoff of the pair energy's derivative in a
    global parameter lambda, at fixed positions, as an (n_pad,) tensor
    (full, not halved): dE/dqq dqq + dE/dsig dsig + dE/deps4 deps4 (+
    dE/dc6g dc6g in MODE_LJPME), from par4 and its derivative dpar4
    (tile_param_derivs). A CUDA tensor runs the hand-written kernel
    (float32 only; each output owned by one warp, its partial sums added
    in a fixed order); a CPU tensor runs the plain version."""
    _check_tile_args(pos4, par4, cand, count, words, consts, mode)
    if dpar4.shape != par4.shape or dpar4.dtype != par4.dtype \
            or dpar4.device != par4.device or not dpar4.is_contiguous():
        raise ValueError("dpar4 must be a contiguous tensor like par4")
    if pos4.device.type == "cpu":
        return nonbonded_tiles_deriv_plain(pos4, par4, dpar4, cand, count,
                                           words, consts, mode, use_switch)
    if pos4.device.type != "cuda" or pos4.dtype != torch.float32:
        raise TypeError("the CUDA tile kernel takes float32 CUDA tensors")
    out = torch.empty_like(pos4)
    bounds = torch.empty((count.shape[0], 2, 4), dtype=pos4.dtype,
                         device=pos4.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(pos4.device).cuda_stream
    code = lib.omm_nonbonded_tiles_deriv(
        pos4.data_ptr(), par4.data_ptr(), dpar4.data_ptr(), cand.data_ptr(),
        count.data_ptr(), words.data_ptr(), consts.data_ptr(),
        count.shape[0], cand.shape[1], words.shape[1], int(mode),
        int(bool(use_switch)), bounds.data_ptr(), out.data_ptr(), stream)
    _build.check_launch(code, TILES_DERIV)
    TILES_DERIV.launches += 1
    return out[:, 3]


def nonbonded_tiles_deriv_plain(pos4, par4, dpar4, cand, count, words,
                                consts, mode, use_switch) -> torch.Tensor:
    """Plain PyTorch version of nonbonded_tiles_deriv (ops/pairs.py
    pair_param_derivative on the pairs of nonbonded_tiles_plain)."""
    _check_tile_args(pos4, par4, cand, count, words, consts, mode)
    n_pad = pos4.shape[0]
    out = torch.zeros(n_pad, dtype=pos4.dtype, device=pos4.device)
    alpha, _, krf, crf = consts[0:4]
    rs, inv_w = consts[13], consts[14]
    for r0, r1 in _row_chunks(n_pad // BRICK, cand.shape[1]):
        cj, _, _, _, r2, ok = _chunk_pairs(pos4, cand, count, words,
                                           consts, r0, r1)
        rows = r1 - r0
        qi = par4[r0 * BRICK:r1 * BRICK].view(rows, BRICK, 1, 4)
        dqi = dpar4[r0 * BRICK:r1 * BRICK].view(rows, BRICK, 1, 4)
        qj = par4[cj][:, None]
        dqj = dpar4[cj][:, None]

        def mixed(k):
            return dqi[..., k] * qj[..., k] + qi[..., k] * dqj[..., k]

        ljpme = ((qi[..., 3] * qj[..., 3], mixed(3), krf, crf, consts[15])
                 if mode == MODE_LJPME else None)
        d = pair_param_derivative(
            torch.clamp(r2, min=2e-6), qi[..., 0] * qj[..., 0], mixed(0),
            qi[..., 1] + qj[..., 1], dqi[..., 1] + dqj[..., 1],
            qi[..., 2] * qj[..., 2], mixed(2),
            "rf" if mode == MODE_RF else "ewald", alpha, krf, crf,
            (rs, inv_w) if use_switch else None, ljpme)
        out[r0 * BRICK:r1 * BRICK] = torch.where(ok, d, 0.0).sum(
            dim=-1).reshape(-1)
    return out


def tile_param_derivative(pos, box, st, consts, mode, use_switch, par4,
                          dpar4, plain=False) -> torch.Tensor:
    """dE/dlambda (float64 scalar) of the direct-space sweep on state
    `st` with parameters par4 and their derivative dpar4 (both in the
    state's frame); plain=True runs the plain version on any device."""
    pos4 = sorted_positions(pos, box, st)
    fn = nonbonded_tiles_deriv_plain if plain else nonbonded_tiles_deriv
    out = fn(pos4, par4, dpar4, st["cand"], st["count"], st["words"],
             consts, mode, use_switch)
    return 0.5 * out.sum(dtype=torch.float64)


# slack of the kernel's brick cull (nm), against rounding
CULL_SLACK = 1e-3


def brick_bounds(pos4) -> torch.Tensor:
    """(n_bricks, 2, 3): the centre and the half extent of each brick's
    bounding box, as kernel 1 takes them at every call."""
    p = pos4[:, :3].reshape(-1, BRICK, 3)
    lo, hi = p.amin(dim=1), p.amax(dim=1)
    return torch.stack([0.5 * (lo + hi), 0.5 * (hi - lo)], dim=1)


def cull_mask(pos4, cand, count, consts) -> torch.Tensor:
    """(n_pad, max_cand) bool: the live candidate bricks that kernel 1
    sweeps for each row atom after its cull. A brick is kept when the
    staged minimum image of (atom - centre), less the half extent on each
    axis, comes within the cutoff (plus CULL_SLACK), or when its half
    extent on some axis is above box/2 - cutoff - CULL_SLACK (there the
    centre's image shift need not be its pairs'). The cull drops no pair
    inside the cutoff."""
    bounds = brick_bounds(pos4)
    c = cand.long()
    centre = bounds[c, 0].repeat_interleave(BRICK, dim=0)   # (n_pad, mc, 3)
    half = bounds[c, 1].repeat_interleave(BRICK, dim=0)
    d = pos4[:, None, :3] - centre
    d = torch.stack(_staged_image(*d.unbind(-1), consts), dim=-1)
    gap = torch.clamp(d.abs() - half, min=0.0)
    rc = torch.sqrt(consts[1])
    near = ~((gap * gap).sum(dim=-1) >= (rc + CULL_SLACK) ** 2)
    diag = torch.stack([consts[4], consts[6], consts[9]])
    wide = (half > 0.5 * diag - rc - CULL_SLACK).any(dim=-1)
    live = torch.arange(cand.shape[1], device=pos4.device)[None] \
        < count.long().repeat_interleave(BRICK)[:, None]
    return (near | wide) & live


def _staged_image(dx, dy, dz, consts):
    """The staged minimum image of displacements (dx, dy, dz) in the
    reduced triclinic box of consts, as kernel 1 takes it."""
    ax, bx, by, cx, cy, cz, iax, iby, icz = consts[4:13]
    sc = torch.round(dz * icz)
    dx, dy, dz = dx - sc * cx, dy - sc * cy, dz - sc * cz
    sb = torch.round(dy * iby)
    dx, dy = dx - sb * bx, dy - sb * by
    dx = dx - torch.round(dx * iax) * ax
    return dx, dy, dz


def _row_chunks(n_bricks, max_cand, budget=1 << 22):
    rows = max(1, budget // (BRICK * BRICK * max(max_cand, 1)))
    for r0 in range(0, n_bricks, rows):
        yield r0, min(n_bricks, r0 + rows)


def _chunk_pairs(pos4, cand, count, words, consts, r0, r1):
    """Displacements, r^2 and the interaction mask of row bricks r0:r1
    against all their candidate atoms: each (rows, 16, max_cand * 16)."""
    rows = r1 - r0
    mc = cand.shape[1]
    exc_cap = words.shape[1]
    dev = pos4.device
    lanes = torch.arange(BRICK, device=dev)
    c = cand[r0:r1].long()
    cj = (c[:, :, None] * BRICK + lanes).reshape(rows, mc * BRICK)
    pj = pos4[cj]
    pi = pos4[r0 * BRICK:r1 * BRICK].view(rows, BRICK, 4)
    dx = pi[:, :, None, 0] - pj[:, None, :, 0]
    dy = pi[:, :, None, 1] - pj[:, None, :, 1]
    dz = pi[:, :, None, 2] - pj[:, None, :, 2]
    dx, dy, dz = _staged_image(dx, dy, dz, consts)
    r2 = dx * dx + dy * dy + dz * dz
    w = torch.zeros((rows, BRICK, mc), dtype=torch.int32, device=dev)
    w[:, :, :exc_cap] = words[r0 * BRICK:r1 * BRICK].view(rows, BRICK,
                                                          exc_cap)
    excluded = ((w[..., None] >> lanes) & 1).reshape(rows, BRICK, mc * BRICK)
    live = (torch.arange(mc, device=dev)[None] < count[r0:r1, None].long())
    live = live[:, None, :, None].expand(rows, BRICK, mc, BRICK)
    ok = (r2 < consts[1]) & (excluded == 0) \
        & live.reshape(rows, BRICK, mc * BRICK)
    return cj, dx, dy, dz, r2, ok


def nonbonded_tiles_plain(pos4, par4, cand, count, words, consts, mode,
                          use_switch) -> torch.Tensor:
    """Plain PyTorch version of kernel 1 on the same inputs (the pair terms
    of ops/pairs.py:pair_terms). In float32 it repeats the kernel's
    arithmetic (Hastings erfc); in float64 it uses the exact erfc and
    serves as the accuracy oracle."""
    _check_tile_args(pos4, par4, cand, count, words, consts, mode)
    n_pad = pos4.shape[0]
    out = torch.zeros((n_pad, 4), dtype=pos4.dtype, device=pos4.device)
    alpha, _, krf, crf = consts[0:4]
    rs, inv_w = consts[13], consts[14]
    for r0, r1 in _row_chunks(n_pad // BRICK, cand.shape[1]):
        cj, dx, dy, dz, r2, ok = _chunk_pairs(pos4, cand, count, words,
                                              consts, r0, r1)
        rows = r1 - r0
        qi = par4[r0 * BRICK:r1 * BRICK].view(rows, BRICK, 1, 4)
        qj = par4[cj][:, None]
        # MODE_LJPME: krf and crf hold alpha_LJ^2 and the shift
        ljpme = ((qi[..., 3] * qj[..., 3], krf, crf, consts[15])
                 if mode == MODE_LJPME else None)
        de, e = pair_terms(
            torch.clamp(r2, min=2e-6), qi[..., 0] * qj[..., 0],
            qi[..., 1] + qj[..., 1], qi[..., 2] * qj[..., 2],
            "rf" if mode == MODE_RF else "ewald", alpha, krf, crf,
            (rs, inv_w) if use_switch else None, ljpme)
        dedr2 = torch.where(ok, de, 0.0)
        e = torch.where(ok, e, 0.0)
        sl = slice(r0 * BRICK, r1 * BRICK)
        out[sl, 0] = (-2.0 * (dedr2 * dx).sum(dim=-1)).reshape(-1)
        out[sl, 1] = (-2.0 * (dedr2 * dy).sum(dim=-1)).reshape(-1)
        out[sl, 2] = (-2.0 * (dedr2 * dz).sum(dim=-1)).reshape(-1)
        out[sl, 3] = e.sum(dim=-1).reshape(-1)
    return out


def count_tile_pairs(pos4, cand, count, words, consts) -> dict:
    """What kernel 1 does on these inputs, full-matrix (each pair counted
    from both atoms): "slots", the candidate pair slots (count x 16 x 16,
    all of which a sweep without the cull tests); "visited", the slots of
    the bricks that survive the cull, which kernel 1 tests; "inside", the
    pairs inside the cutoff and not excluded; "evaluated_before", the lane
    evaluations of the pair terms in a sweep without the cull or the queue
    (a warp of 2 slices x 16 lanes over candidate slots, running the terms
    for all 32 lanes whenever one lane hits); and "evaluated", those of
    kernel 1 (full warps of 32 queued pairs, the last one of each row atom
    padded)."""
    nb = pos4.shape[0] // BRICK
    mc = cand.shape[1]
    slots = int(count.long().sum()) * BRICK * BRICK
    visited = int(cull_mask(pos4, cand, count, consts).sum()) * BRICK
    inside = before = 0
    per_atom = torch.zeros(pos4.shape[0], dtype=torch.long,
                           device=pos4.device)
    steps = -(-mc // 8)
    for r0, r1 in _row_chunks(nb, mc):
        ok = _chunk_pairs(pos4, cand, count, words, consts, r0, r1)[5]
        inside += int(ok.sum())
        per_atom[r0 * BRICK:r1 * BRICK] = ok.sum(dim=-1).reshape(-1)
        # candidate k = 8 t + slice; warp w holds slices 2w and 2w + 1
        hit = torch.zeros((r1 - r0, BRICK, steps * 8, BRICK),
                          dtype=torch.bool, device=pos4.device)
        hit[:, :, :mc] = ok.view(r1 - r0, BRICK, mc, BRICK)
        hit = hit.view(r1 - r0, BRICK, steps, 4, 2, BRICK)
        before += 32 * int(hit.any(dim=4).any(dim=1).sum())
    evaluated = 32 * int(((per_atom + 31) // 32).sum())
    return {"slots": slots, "visited": visited, "inside": inside,
            "evaluated_before": before, "evaluated": evaluated}


def tile_energy_forces(pos, box, st, consts, mode, use_switch,
                       plain=False, par4=None):
    """(energy, forces (n, 3)) of the direct-space sweep on state `st`.
    plain=True runs the plain version on any device (the float64 oracle).
    par4: parameters in the state's frame in place of those of its build
    (tile_params of the effective parameters under offsets)."""
    pos4 = sorted_positions(pos, box, st)
    fn = nonbonded_tiles_plain if plain else nonbonded_tiles
    out = fn(pos4, st["par4"] if par4 is None else par4, st["cand"],
             st["count"], st["words"], consts, mode, use_switch)
    forces = out[st["inv_order"], :3][:pos.shape[0]]
    return 0.5 * out[:, 3].sum(dtype=torch.float64), forces
