"""SETTLE of openmm_tpu_torch against openmm_tpu.ops.constraints.make_settle:
the float64 position-correction field and the velocity constraints on the
same numpy-seeded inputs. Both solve the same closed form in float64, so
they agree to 1e-12 nm (rounding of a few dozen float64 operations)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_tpu.models import tip3p_water_box as jax_water_box
from openmm_tpu.ops import constraints as jcons

from openmm_tpu_torch.ops.constraints import Settle, partition_constraints
from torch_port_helpers import system_params


@pytest.fixture(scope="module")
def waters():
    jsys, jpos = jax_water_box(n_waters=64)
    params = system_params(jsys)
    masses = params["masses"]
    cons = [(int(i), int(j), float(d)) for (i, j), d in
            zip(params["constraint_pairs"], params["constraint_distances"])]
    pos = np.array([[p.x, p.y, p.z] for p in jpos])
    return cons, masses, pos


def test_partition_matches_jax(waters):
    cons, masses, _ = waters
    assert partition_constraints(cons, masses) == \
        jcons.partition_constraints(cons, masses)


def test_settle_positions_and_velocities_match_jax(waters):
    cons, masses, pos = waters
    clusters, rest = partition_constraints(cons, masses)
    assert not rest
    j_pos, j_vel, j_corr = jcons.make_settle(clusters, masses, jnp.float64)
    port = Settle(clusters, masses, torch.device("cpu"))
    rng = np.random.RandomState(11)
    ref = np.array(j_pos(jnp.asarray(pos), jnp.asarray(pos)))
    new = ref + 0.004 * rng.randn(*ref.shape)
    vel = rng.randn(*ref.shape)

    want = np.asarray(j_corr(jnp.asarray(ref), jnp.asarray(new)))
    got = port.position_corrections(torch.as_tensor(ref),
                                    torch.as_tensor(new)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the corrected positions satisfy the constraints
    fixed = new + got
    for i, j, d in cons:
        assert abs(np.linalg.norm(fixed[i] - fixed[j]) - d) < 1e-10

    want_v = np.asarray(j_vel(jnp.asarray(fixed), jnp.asarray(vel)))
    got_v = port.apply_velocities(torch.as_tensor(fixed),
                                  torch.as_tensor(vel)).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-10)
    for i, j, _ in cons:
        bond = fixed[i] - fixed[j]
        assert abs(np.dot(bond, got_v[i] - got_v[j])) < 1e-10
