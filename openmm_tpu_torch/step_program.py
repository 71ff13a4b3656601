"""The MD step as one program on the device.

Counterpart of the JAX Context's fused step program
(openmm_tpu/context.py _step_with_cache_key: one lax.fori_loop over the
steps of a chunk, the neighbour-state rebuild a lax.cond on needs_rebuild
inside it, the overflow flag read by the host once a chunk).

A StepProgram keeps what a step reads and writes in static buffers: the
positions, the velocities, the candidate state of the direct space, the
positions and the box at its build, each barostat's uniforms, and two
counters (the capacity overflow and the rebuilds of the chunk); the box,
the global parameters and the barostats' statistics are the Context's
own tensors, written in place. `body(gate)` is one step, the integrator's
(Verlet, the Langevin family): the update hooks, where a barostat draws
its uniforms and, under `gate`, runs its attempt (two candidate states
and two energies through kernels 1-2, the Metropolis test by
torch.where) on the steps it fires on, and an Andersen thermostat
redraws velocities (by torch.where, no gate); then, inside the force
evaluation of the integration force groups, the rebuild
predicate (an atom moved more than skin/2, or the box changed) and the
build and commit of a new candidate state under `gate` (where the
NonbondedForce keeps one: a method that takes every pair has no gate);
the forces (kernels 1-3, the FFT convolution, the exceptions and the
exclusion correction, the bonded forces; by method, forces/nonbonded.py);
the constraints; all written back into
the buffers. So the graph decides the rebuild after the hooks, on the
steps the eager loop does. The integrator's parameters are the Context's
device tensor, so new ones need no new program.

On a CUDA device the program captures `body` once into a CUDA graph, and
a step is one replay. Each gate is a conditional IF node
(csrc/graph_gate.cu) whose body is a separately captured graph (the
build and commit; a barostat's attempt): the card decides each step
whether to run it, and the host reads nothing until the Context reads the
counters at the end of the chunk. A capture that fails raises; there is
no eager fallback. On the CPU the same body runs eagerly with the plain
kernel versions, the gate a host `if`. The programs of a Context are
cached by what fixes their shapes, the capacity scale, and by the
integration force groups they evaluate.
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
    def __init__(self, context, groups=-1):
        self._ctx = context
        self._groups = groups       # the integration force groups' mask
        state = context._state
        self.box = context._box
        self.pos = state["positions"].clone()
        self.vel = state["velocities"].clone()
        self.ref_pos = torch.full_like(self.pos, math.inf)
        self.ref_box = torch.full_like(self.box, math.inf)
        # the NonbondedModule that keeps a candidate state, or None (no
        # NonbondedForce, or one whose direct space takes every pair)
        self._candidates = context._candidates
        # each barostat's uniforms of the step, which its attempt reads
        self.uniforms = [torch.zeros(b.n_uniforms, dtype=torch.float64,
                                     device=self.pos.device)
                         for b in context._barostats]
        # the gated bodies: 0 the rebuild, 1 + k barostat k's attempt
        self._bodies = [self.rebuild] + [
            (lambda k=k: self.attempt(k))
            for k in range(len(context._barostats))]
        self._gate = self.gate_host
        self._first_step = 0        # the step count at load()
        # buffers of the candidate state's shapes at this capacity
        self.tiles = (None if self._candidates is None
                      else self._candidates.build_state(self.pos, self.box))
        # [capacity overflow, rebuilds] of the chunk
        self.counters = torch.zeros(2, dtype=torch.int64,
                                    device=self.pos.device)
        self._step_fn = context._integrator._make_step_fn(
            dataclasses.replace(
                context._deps, force_fn=self._forces,
                update_hooks=context._make_hooks(self._attempt_gate)))
        self.graph = None
        self.launches = []      # (Kernel, its launches per replay)
        # (Kernel, its launches per attempt) of each barostat
        self.attempt_launches = [[] for _ in context._barostats]
        self.capture_seconds = 0.0  # warm-up, two captures, instantiation
        if self.pos.device.type == "cuda":
            t0 = time.perf_counter()
            self._capture()
            self.capture_seconds = time.perf_counter() - t0

    def _forces(self, pos, box):
        """The force evaluation of the step, after the hooks: the rebuild
        gate first. `pos` is the positions buffer, which a barostat's
        attempt wrote in place."""
        if self._candidates is not None:
            self._gate(needs_rebuild(pos, self.ref_pos, self._candidates.skin,
                                     box, self.ref_box), 0)
        return self._ctx._evaluate(pos, box, self.tiles, self._groups)

    def _attempt_gate(self, k, step, pos, box, u):
        """A barostat hook's gate: keep the step's uniforms, run attempt k
        under the gate on the steps it fires on; the attempt moves the
        positions buffer in place."""
        self.uniforms[k].copy_(u)
        self._gate(self._ctx._barostats[k].fires(step), 1 + k)
        return self.pos

    def rebuild(self) -> None:
        """Build a candidate state at the current positions and box and
        commit it."""
        st = self._candidates.build_state(self.pos, self.box)
        for key, buf in self.tiles.items():
            buf.copy_(st[key])
        self.ref_pos.copy_(self.pos)
        self.ref_box.copy_(self.box)
        self.counters[0].add_(st["overflow"])
        self.counters[1].add_(1)

    def attempt(self, k) -> None:
        """Barostat k's attempt from the buffered uniforms, written into
        the positions buffer, the box and the statistics; its trial
        states' overflow adds to the chunk's."""
        pos, overflow = self._ctx._run_attempt(k, self.pos, self.box,
                                               self.uniforms[k])
        self.pos.copy_(pos)
        self.counters[0].add_(overflow)

    def body(self, gate) -> None:
        """One MD step; gate(pred, i) runs gated body i (0 the rebuild,
        1 + k barostat k's attempt) where pred holds."""
        self._gate = gate
        pos, vel = self._step_fn(self.pos, self.vel, self.box)
        self.pos.copy_(pos)
        self.vel.copy_(vel)

    def gate_host(self, pred, i=0) -> None:
        """The CPU's gate: the predicate read on the host."""
        if bool(pred):
            self._bodies[i]()

    def gate_always(self, pred, i=0) -> None:
        """Run the body whatever the predicate says (the warm-up before a
        capture runs both sides of every gate)."""
        self._bodies[i]()

    def _gate_node(self, pred, i=0) -> None:
        code = _build.library().omm_graph_if(
            pred.data_ptr(), self._body_graphs[i].raw_cuda_graph(),
            torch.cuda.current_stream(pred.device).cuda_stream)
        if code != 0:
            raise RuntimeError("graph_gate: CUDA error %d adding the "
                               "conditional node of gated body %d"
                               % (code, i))

    def _capture(self) -> None:
        dev = self.pos.device
        ctx = self._ctx
        gen = ctx._generator
        before = [k.launches for k in _build.KERNELS]
        gen_state = gen.get_state()
        shared = [t.clone() for t in ctx._step_tensors()]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # builds the kernel library, cuFFT's plans and the allocator's
            # blocks before capture; its step is undone by the next load()
            # and by writing back the shared tensors it moved
            self.body(self.gate_always)
        torch.cuda.current_stream(dev).wait_stream(stream)
        gen.set_state(gen_state)
        for t, value in zip(ctx._step_tensors(), shared):
            t.copy_(value)
        warm = [k.launches for k in _build.KERNELS]
        self._body_graphs = []
        for i, fn in enumerate(self._bodies):
            if i == 0 and self._candidates is None:
                self._body_graphs.append(None)
                continue
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g, stream=stream):
                fn()
            self._body_graphs.append(g)
            counts = [k.launches - w
                      for k, w in zip(_build.KERNELS, warm)]
            for k, w in zip(_build.KERNELS, warm):
                k.launches = w
            if i == 0 and any(counts):
                raise RuntimeError("a counted kernel launches under the "
                                   "rebuild gate: its launches per replay "
                                   "are unknown")
            if i > 0:
                # counted at capture, added per attempt by run()
                self.attempt_launches[i - 1] = [
                    (k, c) for k, c in zip(_build.KERNELS, counts) if c]
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
        does; no candidate state makes the first step rebuild. The
        Context's device step counter starts at its host count."""
        ctx = self._ctx
        state = ctx._state
        for buf, value in ((self.pos, state["positions"]),
                           (self.vel, state["velocities"])):
            if value is not buf:
                buf.copy_(value)
        ctx._deps.step.fill_(state["step"])
        self._first_step = state["step"]
        self.counters.zero_()
        if self._candidates is None:
            return
        if ctx._tiles is None:
            self.ref_pos.fill_(math.inf)
            return
        if ctx._tiles is not self.tiles:
            for key, buf in self.tiles.items():
                buf.copy_(ctx._tiles[key])
        for buf, value in ((self.ref_pos, ctx._ref_pos),
                           (self.ref_box, ctx._ref_box)):
            if value is not buf:
                buf.copy_(value)
        self.counters[0].copy_(self.tiles["overflow"])

    def run(self, steps: int) -> None:
        """`steps` steps from the step count load() read: graph replays on
        a card, the body on the CPU. The host knows how many of them
        attempt a barostat move, so it counts the attempts' launches."""
        if self.graph is None:
            for _ in range(steps):
                self.body(self.gate_host)
            return
        for _ in range(steps):
            self.graph.replay()
        for kern, per_replay in self.launches:
            kern.launches += per_replay * steps
        for baro, launches in zip(self._ctx._barostats,
                                  self.attempt_launches):
            attempts = baro.attempts_in(self._first_step, steps)
            for kern, per_attempt in launches:
                kern.launches += per_attempt * attempts

    def store(self) -> None:
        """Point the Context's state at the buffers."""
        ctx = self._ctx
        ctx._state["positions"] = self.pos
        ctx._state["velocities"] = self.vel
        if self._candidates is not None:
            ctx._tiles, ctx._ref_pos = self.tiles, self.ref_pos
            ctx._ref_box = self.ref_box
