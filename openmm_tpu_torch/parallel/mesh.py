"""The device mesh: a process group whose ranks split the direct-space
rows.

Counterpart of openmm_tpu/parallel/mesh.py, and through it of OpenMM's
CUDA force decomposition (CudaParallelKernels.cpp:66-248): positions are
replicated, the direct sweep's row bricks are split over the ranks, the
forces are gathered, and everything else runs replicated on every rank.
In PyTorch that is SPMD over torch.distributed: one process a card (NCCL)
or a CPU (gloo), the process group initialised by the caller (torchrun,
or init_process_group), and a Context built after
set_default_mesh(make_mesh()) sweeps its rank's rows.

The split is JAX's static uniform one (openmm_tpu/ops/pairs.py:464-466):
of nb row blocks rank r takes [r ceil(nb/D), min(nb, (r+1) ceil(nb/D))).
The gather is exact. Each output row of a sweep is owned by one rank (one
warp of kernel 1), so a rank zero-fills the rows outside its range and
the ranks add their outputs as integers (int32 for float32, int64 for
float64): disjoint rows add to the single-rank bits, -0.0 included.
Energies are formed from the gathered rows in the single-rank order,
never as per-rank partial sums reduced afterwards (that order differs,
and so do the bits). Every rank then holds the single-process forces bit
for bit, and the replicated integrator, with the same seeds, and the
rebuild gates decided on each rank stay in lockstep.

The gather is the step's one collective: NCCL can capture it in a CUDA
graph, and gloo runs it on CUDA tensors (gloo's CUDA support covers
all_reduce and broadcast). Inside a conditional body of a captured step
(a barostat's attempt, a custom program's blocks) the mesh is
`replicated()`: every rank sweeps every row and launches no collective,
which gives the same bits.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

_DEFAULT_MESH = None
# the integer view a gathered float tensor is added in
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}
# backends whose collectives a CUDA graph can capture
CAPTURABLE = ("nccl",)


def row_split(n: int, rank: int, size: int) -> tuple:
    """(begin, end): rank `rank`'s share of n row blocks over `size`
    ranks, JAX's static uniform shards."""
    step = -(-n // size)
    return min(n, rank * step), min(n, (rank + 1) * step)


class Mesh:
    """The ranks of a process group over which the direct sweeps split
    their rows: `rank`, `size`, `backend`, `group`, and `device`, the
    card an NCCL rank drives (None for gloo)."""

    def __init__(self, group, rank: int, size: int, backend: str,
                 device=None):
        self.group = group
        self.rank = rank
        self.size = size
        self.backend = backend
        self.device = device
        self._replicated = 0

    def __repr__(self) -> str:
        return "Mesh(%s: rank %d of %d)" % (self.backend, self.rank,
                                            self.size)

    def rows(self, n: int) -> tuple:
        """The row blocks of n this rank sweeps now: its share
        (row_split), or all n while the mesh is replicated."""
        return (0, n) if self._replicated else row_split(n, self.rank,
                                                          self.size)

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `out` (zero outside this rank's, float32 or
        float64, contiguous) added in place as integers: the single-rank
        bits on every rank. Nothing while the mesh is replicated."""
        if self._replicated:
            return out
        if out.dtype not in _INT_VIEW:
            raise TypeError("a gathered tensor must be float32 or float64, "
                            "not %s" % out.dtype)
        if not out.is_contiguous():
            raise ValueError("a gathered tensor must be contiguous (its "
                             "integer view is reduced in place), not of "
                             "strides %s" % (out.stride(),))
        dist.all_reduce(out.view(_INT_VIEW[out.dtype]), op=dist.ReduceOp.SUM,
                        group=self.group)
        return out

    @contextlib.contextmanager
    def replicated(self):
        """Inside: every rank sweeps every row and gathers nothing (a
        conditional body of a captured step)."""
        self._replicated += 1
        try:
            yield self
        finally:
            self._replicated -= 1

    def check_device(self, device) -> None:
        """A Context's device must be one this mesh reduces on: an NCCL
        rank's card (DeviceIndex = its local rank)."""
        if self.backend == "nccl" and torch.device(device) != self.device:
            raise ValueError(
                "a Context on %s cannot join an NCCL mesh whose rank %d "
                "drives %s: set the platform's DeviceIndex to the local "
                "rank" % (device, self.rank, self.device))

    def check_capture(self) -> None:
        """Raises unless a CUDA graph can capture this mesh's gather."""
        if self.backend not in CAPTURABLE:
            raise RuntimeError(
                "a CUDA graph cannot capture the %s backend's collectives: "
                "step a Context on a %s mesh through its eager loop "
                "(Context._step_eager), or build the mesh on an NCCL group"
                % (self.backend, self.backend))

    def warm_up(self, device) -> None:
        """One collective outside capture, which creates the
        communicator a captured gather then uses."""
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        dist.all_reduce(flag, group=self.group)


def make_mesh(n_devices=None, group=None) -> Mesh:
    """A mesh over the default process group (or `group`), which the
    caller has initialised; raises if `n_devices` is given and differs
    from the group's size. An NCCL rank drives cuda:LOCAL_RANK (torchrun
    sets it; else the rank modulo the cards)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or torch.distributed."
                           "init_process_group)")
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError("a mesh of %d devices asked for on a process group "
                         "of %d ranks" % (n_devices, size))
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group)).lower()
    device = None
    if backend == "nccl":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(),
                                                1)))
        device = torch.device("cuda", local)
    return Mesh(group, rank, size, backend, device)


def set_default_mesh(mesh) -> None:
    """Install a mesh; Contexts created afterwards split their direct
    sweeps over it. Pass None to return to single-device execution."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_default_mesh():
    return _DEFAULT_MESH


def sharded_pair_energy(mesh, sweep, n_blocks: int) -> torch.Tensor:
    """The row output of a direct sweep on every rank: sweep(begin, end)
    computes the rows of row blocks [begin, end) of mesh's split of
    n_blocks (the others zero), and the ranks' rows are gathered
    (Mesh.gather). Counterpart of the JAX function of this name, whose
    per-device partial energies are psum'd: here the caller forms the
    energy from the gathered rows, in the single-rank order. A mesh of
    None sweeps every row."""
    if mesh is None:
        return sweep(0, n_blocks)
    return mesh.gather(sweep(*mesh.rows(n_blocks)))
