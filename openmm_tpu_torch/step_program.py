"""The MD step as one program on the device.

Counterpart of the JAX Context's fused step program
(openmm_tpu/context.py _step_with_cache_key: one lax.fori_loop over the
steps of a chunk, the neighbour-state rebuild a lax.cond on needs_rebuild
inside it, the overflow flag read by the host once a chunk).

A StepProgram keeps what a step reads and writes in static buffers: the
positions, the velocities, the candidate state of the direct space, the
positions at its build, and two counters (the capacity overflow and the
rebuilds of the chunk). `body(gate)` is one step: the rebuild predicate,
the build and commit of a new candidate state under `gate`, then the
integrator's step (forces through kernels 1-3, the FFT convolution, the
exceptions and the exclusion correction; LangevinMiddle with SETTLE),
written back into the buffers. The integrator's parameters are the
Context's device tensor, so new ones need no new program.

On a CUDA device the program captures `body` once into a CUDA graph, and
a step is one replay. The gate is a conditional IF node
(csrc/graph_gate.cu) whose body is a separately captured build and
commit: the card decides each step whether to rebuild, and the host reads
nothing until the Context reads the counters at the end of the chunk. A
capture that fails raises; there is no eager fallback. On the CPU the same
body runs eagerly with the plain kernel versions, the gate a host `if`.
The programs of a Context are cached by what fixes their shapes, the
capacity scale and the box widths.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from . import _build
from .ops.pairs import needs_rebuild

# how the rebuild is gated on the card: (a) a conditional node, (b) two
# graphs and a host read of the predicate a step, (c) a build every step
GATING = "(a) conditional IF node"


class StepProgram:
    def __init__(self, context):
        self._ctx = context
        state = context._state
        self.box = state["box"]
        self.pos = state["positions"].clone()
        self.vel = state["velocities"].clone()
        self.ref_pos = torch.full_like(self.pos, math.inf)
        # buffers of the candidate state's shapes at this capacity
        self.tiles = context._nonbonded.build_state(self.pos, self.box)
        # [capacity overflow, rebuilds] of the chunk
        self.counters = torch.zeros(2, dtype=torch.int64,
                                    device=self.pos.device)
        self._step_fn = context._integrator._make_step_fn(
            dataclasses.replace(context._deps, force_fn=self._forces))
        self.graph = None
        self.launches = []      # (Kernel, its launches per replay)
        self.capture_seconds = 0.0  # warm-up, two captures, instantiation
        if self.pos.device.type == "cuda":
            t0 = time.perf_counter()
            self._capture()
            self.capture_seconds = time.perf_counter() - t0

    def _forces(self, pos, box):
        return self._ctx._nonbonded(pos, box, self.tiles)

    def rebuild(self) -> None:
        """Build a candidate state at the current positions and commit it."""
        st = self._ctx._nonbonded.build_state(self.pos, self.box)
        for key, buf in self.tiles.items():
            buf.copy_(st[key])
        self.ref_pos.copy_(self.pos)
        self.counters[0].add_(st["overflow"])
        self.counters[1].add_(1)

    def body(self, gate) -> None:
        """One MD step; gate(pred) runs rebuild() where pred holds."""
        gate(needs_rebuild(self.pos, self.ref_pos, self._ctx._nonbonded.skin))
        pos, vel = self._step_fn(self.pos, self.vel, self.box)
        self.pos.copy_(pos)
        self.vel.copy_(vel)

    def gate_host(self, pred) -> None:
        """The CPU's gate: the predicate read on the host."""
        if bool(pred):
            self.rebuild()

    def gate_always(self, pred) -> None:
        """Build whatever the predicate says (the warm-up before a capture
        runs both sides of the gate)."""
        self.rebuild()

    def _gate_node(self, pred) -> None:
        code = _build.library().omm_graph_if(
            pred.data_ptr(), self._rebuild_graph.raw_cuda_graph(),
            torch.cuda.current_stream(pred.device).cuda_stream)
        if code != 0:
            raise RuntimeError("graph_gate: CUDA error %d adding the "
                               "rebuild's conditional node" % code)

    def _capture(self) -> None:
        dev = self.pos.device
        gen = self._ctx._generator
        before = [k.launches for k in _build.KERNELS]
        gen_state = gen.get_state()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # builds the kernel library, cuFFT's plans and the allocator's
            # blocks before capture; its step is undone by the next load()
            self.body(self.gate_always)
        torch.cuda.current_stream(dev).wait_stream(stream)
        gen.set_state(gen_state)
        warm = [k.launches for k in _build.KERNELS]
        self._rebuild_graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self._rebuild_graph, stream=stream):
            self.rebuild()
        if [k.launches for k in _build.KERNELS] != warm:
            raise RuntimeError("a counted kernel launches under the rebuild "
                               "gate: its launches per replay are unknown")
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=stream):
            self.body(self._gate_node)
        self.launches = [(k, k.launches - w)
                         for k, w in zip(_build.KERNELS, warm)
                         if k.launches != w]
        for k, b in zip(_build.KERNELS, before):
            k.launches = b
        self.graph = graph

    def load(self) -> None:
        """Copy the Context's state into the buffers (where it is not
        already there) and start the chunk's counters: the overflow at that
        of the candidate state the chunk starts from, as the eager loop
        does; no candidate state makes the first step rebuild."""
        ctx = self._ctx
        state = ctx._state
        for buf, value in ((self.pos, state["positions"]),
                           (self.vel, state["velocities"])):
            if value is not buf:
                buf.copy_(value)
        self.counters.zero_()
        if ctx._tiles is None:
            self.ref_pos.fill_(math.inf)
            return
        if ctx._tiles is not self.tiles:
            for key, buf in self.tiles.items():
                buf.copy_(ctx._tiles[key])
        if ctx._ref_pos is not self.ref_pos:
            self.ref_pos.copy_(ctx._ref_pos)
        self.counters[0].copy_(self.tiles["overflow"])

    def run(self, steps: int) -> None:
        """`steps` steps: graph replays on a card, the body on the CPU."""
        if self.graph is None:
            for _ in range(steps):
                self.body(self.gate_host)
            return
        for _ in range(steps):
            self.graph.replay()
        for kern, per_replay in self.launches:
            kern.launches += per_replay * steps

    def store(self) -> None:
        """Point the Context's state at the buffers."""
        ctx = self._ctx
        ctx._state["positions"] = self.pos
        ctx._state["velocities"] = self.vel
        ctx._tiles, ctx._ref_pos = self.tiles, self.ref_pos
