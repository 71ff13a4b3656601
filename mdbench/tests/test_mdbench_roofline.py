"""The roofline's pair count against a brute-force count, and its
independence of anything the port decides (atom order, tiles, capacity)."""
import numpy as np
import pytest
import torch

import harness
import roofline


def _brute(pos, widths, rc):
    d = pos[None, :, :] - pos[:, None, :]
    d -= widths * np.round(d / widths)
    r2 = (d * d).sum(-1)
    i, j = np.triu_indices(len(pos), 1)
    return int(np.count_nonzero(r2[i, j] < rc * rc))


@pytest.mark.parametrize("widths", [(3.0, 3.0, 3.0), (2.8, 3.3, 4.1)])
def test_count_pairs_equals_brute_force(widths):
    rng = np.random.default_rng(5)
    widths = np.asarray(widths)
    pos = rng.random((900, 3)) * widths
    pos[::7] -= widths            # images outside the home box
    want = _brute(pos, widths, 0.9)
    assert roofline.count_pairs(pos, widths, 0.9) == want


def test_count_pairs_ignores_atom_order_and_layout():
    config = harness.load("configs", "water_pme")
    tables = harness.load_module(config["inputs"]).build(
        dict(config, n_waters=1000), 99)
    widths = np.diag(tables["box"])
    pos = tables["positions"]
    base = roofline.count_pairs(pos, widths, 0.9)
    perm = np.random.default_rng(1).permutation(len(pos))
    assert roofline.count_pairs(pos[perm], widths, 0.9) == base
    assert roofline.count_pairs(torch.as_tensor(pos), widths, 0.9) == base


def test_count_does_not_follow_the_port_capacity():
    """Two Contexts of one box with other capacity scales of the candidate
    state: the benchmark's count and work read the same."""
    import openmm_tpu_torch as omm

    import program
    config = harness.load("configs", "water_pme")
    tables = harness.load_module(config["inputs"]).build(
        dict(config, n_waters=1000), 7)
    widths = np.diag(tables["box"])
    works = []
    for scale in (1.0, 2.0):
        system, _ = program.build_system(tables, None)
        ctx = omm.Context(system, omm.LangevinMiddleIntegrator(300, 1,
                                                               0.002),
                          omm.Platform.getPlatformByName("CPU"))
        ctx._nonbonded.capacity_scale = scale
        ctx.setPositions(tables["positions"])
        ctx.getState(getForces=True)
        pairs = roofline.count_pairs(tables["positions"], widths, 0.9)
        works.append(roofline.nonbonded_work(len(tables["masses"]), pairs))
    assert works[0] == works[1]


def test_least_seconds_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.least_seconds(1.0, 67e12)
    assert by == "operations" and t == pytest.approx(1.0)
