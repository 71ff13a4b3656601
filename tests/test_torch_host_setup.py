"""The host-side set-up a Context runs once, in numpy, against the JAX
package's and against plain references, on seeded random inputs (exact
equality throughout):

- ops/constraints.py partition_constraints against
  openmm_tpu.ops.constraints.partition_constraints on random constraint
  graphs with planted triangles (some SETTLE clusters, some triangles
  whose atoms carry another constraint, unequal distances or masses, a
  massless atom, repeated pairs);
- ops/pairs.py build_exclusion_table against
  openmm_tpu.ops.pairs.build_exclusion_table (repeated pairs, atoms with
  no partner, both pad multiples);
- context.py _first_members against the lowest index of each component
  that scipy.sparse.csgraph.connected_components finds, and on a long
  chain listed from its far end.
"""
import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from openmm_tpu.ops import constraints as jcons
from openmm_tpu.ops import pairs as jpairs

from openmm_tpu_torch.context import _first_members
from openmm_tpu_torch.ops.constraints import partition_constraints
from openmm_tpu_torch.ops.pairs import build_exclusion_table

GRAPHS = 400


def _constraint_graph(rng):
    """(constraints, masses) over a few atoms: random constraints and
    one or two planted triangles at random places, each constraint's
    atoms in either order."""
    n = rng.randint(3, 14)
    masses = rng.choice([0.0, 1.0, 16.0], n, p=[0.1, 0.5, 0.4])
    cons = [(int(i), int(j), float(rng.choice([0.1, 0.15])))
            for i, j in (rng.choice(n, 2, replace=False)
                         for _ in range(rng.randint(0, 6)))]
    for _ in range(rng.randint(1, 3)):
        a, b, c = (int(x) for x in rng.choice(n, 3, replace=False))
        d1, d2 = (float(rng.choice([0.1, 0.15])) for _ in range(2))
        tri = [(a, b, d1), (a, c, d1), (b, c, d2)]
        rng.shuffle(tri)
        tri = [t if rng.rand() < 0.5 else (t[1], t[0], t[2]) for t in tri]
        at = rng.randint(0, len(cons) + 1)
        cons[at:at] = tri
    return cons, masses


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_partition_constraints_matches_jax(seed):
    rng = np.random.RandomState(seed)
    settled = 0
    for _ in range(GRAPHS):
        cons, masses = _constraint_graph(rng)
        ours = partition_constraints(cons, masses)
        assert ours == jcons.partition_constraints(cons, masses), cons
        settled += len(ours[0])
    assert settled >= GRAPHS // 20


@pytest.mark.parametrize("pad", [2, 4])
def test_exclusion_table_matches_jax(pad):
    rng = np.random.RandomState(pad)
    for _ in range(GRAPHS):
        n = rng.randint(1, 40)
        pairs = [tuple(int(x) for x in rng.choice(n, 2))
                 for _ in range(rng.randint(0, 60))]
        assert np.array_equal(build_exclusion_table(n, pairs, pad),
                              jpairs.build_exclusion_table(n, pairs, pad))


def test_first_members_are_each_components_lowest_index():
    rng = np.random.RandomState(5)
    for _ in range(GRAPHS):
        n = rng.randint(1, 60)
        pairs = rng.randint(0, n, (rng.randint(0, 70), 2))
        graph = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                           shape=(n, n))
        _, label = connected_components(graph, directed=False)
        lowest = {}
        for i, c in enumerate(label):
            lowest.setdefault(c, i)
        want = np.asarray([lowest[c] for c in label])
        assert np.array_equal(_first_members(n, pairs.tolist()), want)
    chain = [(i, i + 1) for i in reversed(range(9999))]
    assert not _first_members(10000, chain).any()
