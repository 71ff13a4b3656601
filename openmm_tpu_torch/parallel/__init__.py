"""Multi-device parallelism: the direct-space rows split over a mesh of
ranks (torch.distributed: NCCL on cards, gloo on CPUs).

Counterpart of openmm_tpu/parallel (the shard_map force decomposition of
the JAX package) and of the reference's multi-GPU scheme
(platforms/cuda/src/CudaParallelKernels.cpp:66-248): positions are
replicated, each rank sweeps its share of the direct space's row bricks,
the rows are gathered exactly, and everything else runs replicated.
Static, uniform shares replace the reference's dynamic rebalancing, as in
the JAX package. The caller initialises the process group; a Context
built after set_default_mesh(make_mesh()) splits its sweeps.
"""
from .mesh import (get_default_mesh, make_mesh, set_default_mesh,
                   sharded_pair_energy)

__all__ = ["get_default_mesh", "set_default_mesh", "make_mesh",
           "sharded_pair_energy"]
