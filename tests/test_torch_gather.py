"""Kernel 3's visiting order, on the 343-water box of
tests/test_torch_slice.py (1,029 atoms on a 20^3 grid) and on that box
sheared into a reduced triclinic one (chip_smoke.SHEAR).

csrc/pme_gather.cu runs one thread per atom over the candidate state's
spatial order (its first n entries, as NonbondedModule.forward passes
it). The kernel needs that slice to be a permutation of the atoms, and
gains from it only where the 32 atoms of a warp read few 128-byte lines
of the grid per support point: both are checked here, exactly, from the
plain version's grid indices. That the kernel gives the same bits in any
order is checked on the card (chip_smoke.phase_gather_orders); its CPU
rehearsal runs here."""
import numpy as np
import pytest
import torch

import chip_smoke
from openmm_tpu_torch.ops import pme_zslab as zs

# one intra-op thread, as tests/torch_port_helpers.py sets: the runner's
# worker processes would otherwise oversubscribe the cores
torch.set_num_threads(1)

N_WATERS = 343


@pytest.fixture(scope="module", params=[False, True],
                ids=["cubic", "sheared"])
def inputs(request):
    return chip_smoke.kernel_inputs(torch.device("cpu"), N_WATERS,
                                    sheared=request.param)


def test_state_order_is_a_permutation_of_the_atoms(inputs):
    order = inputs["order"]
    n = inputs["pos"].shape[0]
    assert order.dtype == torch.int64 and order.is_contiguous()
    assert torch.equal(torch.sort(order).values, torch.arange(n))


def _lines_a_warp(inputs, order):
    """Mean count of distinct 128-byte lines of the grid that the 32
    atoms of a warp read at one support point (full warps only)."""
    pos, binv, grid = inputs["pos"], inputs["binv"], inputs["grid"]
    nx, ny, nz = grid
    idx, _, _ = zs._grid_weights(pos, binv, grid)      # (n, 3, 5): x, y, z
    ix, iy, iz = idx[:, 0], idx[:, 1], idx[:, 2]
    flat = ((iz[:, :, None, None] * nx + ix[:, None, :, None]) * ny
            + iy[:, None, None, :]).reshape(pos.shape[0], -1)
    lines = (flat // 32)[order]
    warps = lines[:lines.shape[0] // 32 * 32].view(-1, 32, lines.shape[1])
    srt = torch.sort(warps, dim=1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)
    return float(distinct.double().mean())


def test_state_order_makes_a_warp_read_few_lines(inputs):
    n = inputs["pos"].shape[0]
    state = _lines_a_warp(inputs, inputs["order"])
    random = _lines_a_warp(
        inputs, torch.as_tensor(np.random.RandomState(13).permutation(n)))
    # 32 random atoms on 250 lines hit ~29 distinct ones; 32 atoms of the
    # spatial sort (about a brick of 2x2x2 sort cells) ~17, and the
    # lattice's own order, itself spatial, ~18-20
    assert random > 25.0
    assert state < 0.7 * random
    assert state < _lines_a_warp(inputs, torch.arange(n))


def test_chip_smoke_gather_orders_phase_on_cpu(inputs):
    out = chip_smoke.phase_gather_orders(torch.device("cpu"), inputs,
                                         chip_smoke.Deadline(1e9))
    assert out == {"state": None, "user": None, "random": None}
    assert zs.GATHER.launches == 0     # CPU tensors take the plain version
