"""Candidate states of configurations beside the Context's own.

A ring polymer's copies (integrators/rpmd.py) have coordinates of their
own, so each needs its own candidate state of the direct space; the JAX
package rebuilds one inline for every copy at every evaluation
(openmm_tpu/integrators/rpmd.py:295-298). Here a set of `count`
configurations, (count, n, 3), keeps a candidate state each, built at
the capacity of the Context's own (Context._candidates), and rebuilds
them all under one gate when any atom of any of them moved more than
skin/2 since the set's build or the box changed: one predicate a set,
decided on the card inside a captured step (step_program.py) and on the
host in the eager loop. A set is keyed by what it holds (the beads, the
configurations of a contracted force group).

At the start of each chunk of steps a set's positions of reference are
set to inf, so that the chunk's first step rebuilds it, in the step
program and in the eager loop alike: both then rebuild on the same steps
and sum the same pairs in the same order, with no snapshot of these
states.
"""
from __future__ import annotations

import math

import torch

from .ops.pairs import needs_rebuild


class ReplicaStates:
    def __init__(self, context):
        self._ctx = context
        self.sets = {}

    def reset(self) -> None:
        """Make each set's next evaluation rebuild it (a chunk's start)."""
        for s in self.sets.values():
            s["ref"].fill_(math.inf)
            s["ref_box"].fill_(math.inf)

    def forces(self, key, pos_all, box, mask, gate, on_rebuild):
        """(count, n, 3) float64 forces of the groups in `mask` at each of
        the configurations pos_all (count, n, 3), through set `key`'s
        candidate states; gate(pred, body) runs the rebuild where pred
        holds, and on_rebuild(overflow) counts each rebuild of the set
        with its states' summed overflow."""
        ctx = self._ctx
        cand = ctx._candidates
        if cand is None:
            return torch.stack([ctx._evaluate(p, box, None, mask)[1]
                                for p in pos_all.unbind(0)])
        s = self.sets.get(key)
        if s is None:
            s = self.sets[key] = {
                "tiles": [cand.build_state(p, box)
                          for p in pos_all.unbind(0)],
                "ref": torch.full_like(pos_all, math.inf),
                "ref_box": torch.full_like(box, math.inf)}

        def rebuild():
            overflow = None
            for p, tiles in zip(pos_all.unbind(0), s["tiles"]):
                st = cand.build_state(p, box)
                for name, buf in tiles.items():
                    buf.copy_(st[name])
                overflow = (st["overflow"] if overflow is None
                            else overflow + st["overflow"])
            s["ref"].copy_(pos_all)
            s["ref_box"].copy_(box)
            on_rebuild(overflow)

        gate(needs_rebuild(pos_all.reshape(-1, 3), s["ref"].reshape(-1, 3),
                           cand.skin, box, s["ref_box"]), rebuild)
        return torch.stack([ctx._evaluate(p, box, tiles, mask)[1]
                            for p, tiles in zip(pos_all.unbind(0),
                                                s["tiles"])])
