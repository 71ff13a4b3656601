"""The MD step as one program on the device.

Counterpart of the JAX Context's fused step program
(openmm_tpu/context.py _step_with_cache_key: one lax.fori_loop over the
steps of a chunk, the neighbour-state rebuild a lax.cond on needs_rebuild
inside it, a CustomIntegrator's blocks lax.cond and lax.while_loop, the
overflow flag read by the host once a chunk).

A StepProgram keeps what a step reads and writes in static buffers: the
positions, the velocities, the candidate state of the direct space, the
positions and the box at its build, and two counters (the capacity overflow and the rebuilds of the chunk); the box,
the clock, the integrator's parameters, the global parameters, the
barostats' statistics and the integrator's own state are the Context's
tensors, written in place. `body(gate)` is one step, the integrator's:
the update hooks, where a barostat draws its uniforms and, under a gate,
runs its attempt (two candidate states and two energies through kernels
1-2, the Metropolis test by torch.where) on the steps it fires on, and an
Andersen thermostat redraws velocities (by torch.where, no gate); then,
inside each force evaluation (of the integration force groups, or of
another mask through deps.forces_by_groups), the rebuild predicate (an
atom moved more than skin/2, or the box changed) and the build and commit
of a new candidate state under a gate (where the NonbondedForce keeps
one: a method that takes every pair has no gate); the forces (kernels
1-3, the FFT convolution, the exceptions and the exclusion correction,
the bonded forces; by method, forces/nonbonded.py); the constraints; all
written back into the buffers; last, the clock advances by the step size
in the parameters. The integrator's own branches (deps.branch) and loops
(deps.loop) are gates too. So the graph decides each gate on the steps
the eager loop does. New parameters need no new program.

On a CUDA device the program captures `body` once into a CUDA graph, and
a step is one replay. A warm-up step on a side stream runs every gated
body once (a loop's body once), and is undone through the Context's
shared tensors and the generator. The capture then turns each gate into
a conditional node (csrc/graph_gate.cu): an IF node for a branch, a WHILE
node for a loop, whose body is captured straight into the node's body
graph on a stream of its own, so gates inside gated bodies (the rebuild
inside a CustomIntegrator's block) nest. The card decides each step
whether, and how often, each body runs; each body adds one to its own
device counter when it runs, and the host reads the counters (overflow,
rebuilds, the bodies' runs, from which it counts the launches of kernels
inside bodies) once at the end of the chunk. A capture that fails
raises; there is no eager fallback. Under a mesh (parallel/mesh.py) the
gather of each direct sweep is captured at the graph's top level, the
communicator warmed up before; inside a conditional body the mesh is
replicated (every rank sweeps every row, no collective), which gives
the same bits. A mesh whose backend a graph cannot capture (gloo) raises
at capture: such a Context steps through Context._step_eager. On the CPU the same body runs eagerly
with the plain kernel versions, each gate a host `if` or `while`. The
programs of a Context are cached by what fixes their shapes, the capacity
scale, by the integration force groups they evaluate, and by the
integrator's program key (a CompoundIntegrator's member).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
import time

import torch

from . import _build
from .ops.pairs import needs_rebuild
from .replicas import ReplicaStates

# how the rebuild is gated on the card: (a) a conditional node, (b) two
# graphs and a host read of the predicate a step, (c) a build every step
GATING = "(a) conditional IF node (WHILE nodes for loops)"


def branch_host(pred, body) -> None:
    """A branch of the eager loop and the CPU: the predicate read on the
    host."""
    if bool(pred):
        body()


def loop_host(cond, body) -> None:
    """A loop of the eager loop and the CPU: the condition read on the
    host."""
    while bool(cond()):
        body()


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
        self._gate = self.gate_host
        # gated bodies in the order a step meets them: the next index, the
        # nesting depth, the deepest nesting, each loop's predicate
        self._next = 0
        self._depth = 0
        self._max_depth = 0
        self._flags = {}
        # buffers of the candidate state's shapes at this capacity
        self.tiles = (None if self._candidates is None
                      else self._candidates.build_state(self.pos, self.box))
        # [capacity overflow, rebuilds] of the chunk
        self.counters = torch.zeros(2, dtype=torch.int64,
                                    device=self.pos.device)
        self.runs = None            # each gated body's runs in the chunk
        # the candidate states of configurations beside the step's own (a
        # ring polymer's copies), rebuilt under the gate too
        self._replicas = ReplicaStates(context)
        self._step_fn = context._integrator._make_step_fn(
            dataclasses.replace(
                context._deps, force_fn=self._forces,
                forces_by_groups=self._forces_groups, branch=self._branch,
                loop=self._loop,
                update_hooks=context._make_hooks(self._attempt_gate),
                replica_forces=self._replica_forces))
        self._dt = context._step_size_tensor()
        self.graph = None
        self.launches = []      # (Kernel, its launches per replay)
        # (Kernel, its launches per run) of each gated body
        self.body_launches = []
        self.capture_seconds = 0.0  # warm-up, capture, instantiation
        if self.pos.device.type == "cuda":
            t0 = time.perf_counter()
            self._capture()
            self.capture_seconds = time.perf_counter() - t0

    def _forces_groups(self, pos, box, mask):
        """A force evaluation of the step, after the hooks, of the groups
        in `mask`: the rebuild gate first."""
        if self._candidates is not None:
            self._gate(needs_rebuild(pos, self.ref_pos, self._candidates.skin,
                                     box, self.ref_box),
                       lambda: self.rebuild(pos))
        return self._ctx._evaluate(pos, box, self.tiles, mask)

    def _forces(self, pos, box):
        return self._forces_groups(pos, box, self._groups)

    def _replica_forces(self, key, pos_all, box, mask):
        """Forces at several configurations (replicas.py), each set's
        rebuild under the gate, counted with the step's own."""

        def on_rebuild(overflow):
            self.counters[0].add_(overflow)
            self.counters[1].add_(1)

        return self._replicas.forces(key, pos_all, box, mask, self._gate,
                                     on_rebuild)

    def _attempt_gate(self, k, step, pos, box, u):
        """A barostat hook's gate: run attempt k from the step's uniforms
        `u` under the gate on the steps it fires on; the attempt moves the
        positions buffer `pos` in place."""
        self._gate(self._ctx._barostats[k].fires(step),
                   lambda: self.attempt(k, pos, u))
        return pos

    def rebuild(self, pos) -> None:
        """Build a candidate state at `pos` and the current box and commit
        it."""
        st = self._candidates.build_state(pos, self.box)
        for key, buf in self.tiles.items():
            buf.copy_(st[key])
        self.ref_pos.copy_(pos)
        self.ref_box.copy_(self.box)
        self.counters[0].add_(st["overflow"])
        self.counters[1].add_(1)

    def attempt(self, k, pos, u) -> None:
        """Barostat k's attempt from the uniforms u, written into the
        positions buffer `pos`, the box and the statistics; its trial
        states' overflow adds to the chunk's."""
        new, overflow = self._ctx._run_attempt(k, pos, self.box, u)
        pos.copy_(new)
        self.counters[0].add_(overflow)

    def body(self, gate) -> None:
        """One MD step; gate(pred, body) runs a gated body where the
        device bool pred holds: gate_host reads it on the host,
        gate_always runs every body (the warm-up), _gate_node adds a
        conditional node (the capture). Loops follow the gate's kind."""
        self._gate = gate
        self._next = 0
        pos, vel = self._step_fn(self.pos, self.vel, self.box)
        self.pos.copy_(pos)
        self.vel.copy_(vel)
        self._ctx._time.add_(self._dt)

    def _branch(self, pred, body) -> None:
        self._gate(pred, body)

    def _loop(self, cond, body) -> None:
        if self._gate == self.gate_host:
            loop_host(cond, body)
            return
        i = self._next_body()
        if self._gate == self.gate_always:
            flag = self._flags.setdefault(i, torch.empty(
                (), dtype=torch.bool, device=self.pos.device))
        else:
            flag = self._flags[i]
        flag.copy_(cond())

        def once():
            body()
            flag.copy_(cond())

        if self._gate == self.gate_always:
            self._enter(once)
        else:
            self._capture_body(flag, 1, i, once)

    def _next_body(self) -> int:
        i = self._next
        self._next += 1
        return i

    def _enter(self, fn) -> None:
        """fn() as a gated body of the warm-up or the capture: a mesh is
        replicated inside."""
        self._depth += 1
        self._max_depth = max(self._max_depth, self._depth)
        mesh = self._ctx._mesh
        try:
            with (contextlib.nullcontext() if mesh is None
                  else mesh.replicated()):
                fn()
        finally:
            self._depth -= 1

    # the CPU's gate: the predicate read on the host
    gate_host = staticmethod(branch_host)

    def gate_always(self, pred, body) -> None:
        """Run the body whatever the predicate says (the warm-up before a
        capture runs every gated body once)."""
        self._next_body()
        self._enter(body)

    def _gate_node(self, pred, body) -> None:
        self._capture_body(pred, 0, self._next_body(), body)

    def _capture_body(self, pred, is_while, i, fn) -> None:
        """Add a conditional node (IF, or WHILE when is_while) gated by
        the device bool `pred` to the graph being captured, and capture
        fn() as its body on the stream of the next depth; the kernels fn
        launches count per run of body i, not per replay."""
        dev = self.pos.device
        lib = _build.library()
        stream = torch.cuda.current_stream(dev)
        body_stream = self._streams[self._depth]
        handle = ctypes.c_ulonglong()
        code = lib.omm_graph_body_begin(
            pred.data_ptr(), is_while, stream.cuda_stream,
            body_stream.cuda_stream, ctypes.byref(handle))
        if code != 0:
            raise RuntimeError("graph_gate: CUDA error %d adding the "
                               "conditional node of gated body %d"
                               % (code, i))
        outer = [k.launches for k in _build.KERNELS]
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.stream(body_stream))
            if self._depth == 0:
                stack.enter_context(torch.cuda.use_mem_pool(self._pool))
            self.runs[i].add_(1)
            self._enter(fn)
        self.body_launches[i] = [
            (k, k.launches - o) for k, o in zip(_build.KERNELS, outer)
            if k.launches != o]
        for k, o in zip(_build.KERNELS, outer):
            k.launches = o
        code = lib.omm_graph_body_end(pred.data_ptr(), is_while,
                                      handle.value, body_stream.cuda_stream)
        if code != 0:
            raise RuntimeError("graph_gate: CUDA error %d ending the capture "
                               "of gated body %d" % (code, i))

    def _capture(self) -> None:
        dev = self.pos.device
        ctx = self._ctx
        if ctx._mesh is not None:
            ctx._mesh.check_capture()
            ctx._mesh.warm_up(dev)
        gen = ctx._generator
        before = [k.launches for k in _build.KERNELS]
        gen_state = gen.get_state()
        shared = [t.clone() for t in ctx._step_tensors()]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # builds the kernel library, cuFFT's plans, the loops'
            # predicates and the allocator's blocks before capture; its
            # step is undone by the next load() and by writing back the
            # shared tensors it moved
            self.body(self.gate_always)
        torch.cuda.current_stream(dev).wait_stream(stream)
        gen.set_state(gen_state)
        for t, value in zip(ctx._step_tensors(), shared):
            t.copy_(value)
        n_bodies = self._next
        self.runs = torch.zeros(max(n_bodies, 1), dtype=torch.int64,
                                device=dev)
        self.body_launches = [[] for _ in range(n_bodies)]
        self._streams = [torch.cuda.Stream(dev)
                         for _ in range(self._max_depth)]
        # the bodies' memory: a pool of the program's own, kept while the
        # graph lives
        self._pool = torch.cuda.MemPool() if n_bodies else None
        warm = [k.launches for k in _build.KERNELS]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=stream):
            self.body(self._gate_node)
        if self._next != n_bodies:
            raise RuntimeError("the step met %d gated bodies at capture and "
                               "%d in its warm-up" % (self._next, n_bodies))
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
        self.counters.zero_()
        self._replicas.reset()
        if self.runs is not None:
            self.runs.zero_()
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
        a card, the body on the CPU."""
        if self.graph is None:
            for _ in range(steps):
                self.body(self.gate_host)
            return
        for _ in range(steps):
            self.graph.replay()

    def finish(self, steps: int) -> tuple:
        """The chunk's one read of the device: (overflow, rebuilds). On a
        card it also counts the chunk's kernel launches: those of a replay
        per step, and those of each gated body per run."""
        if self.graph is None:
            overflow, rebuilds = self.counters.tolist()
            return overflow, rebuilds
        values = torch.cat([self.counters, self.runs]).tolist()
        for kern, per_replay in self.launches:
            kern.launches += per_replay * steps
        for launches, runs in zip(self.body_launches, values[2:]):
            for kern, per_run in launches:
                kern.launches += per_run * runs
        return values[0], values[1]

    def store(self) -> None:
        """Point the Context's state at the buffers."""
        ctx = self._ctx
        ctx._state["positions"] = self.pos
        ctx._state["velocities"] = self.vel
        if self._candidates is not None:
            ctx._tiles, ctx._ref_pos = self.tiles, self.ref_pos
            ctx._ref_box = self.ref_box
