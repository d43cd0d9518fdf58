"""Fingerprint-sharded checking over a mesh of shards.

The port of the JAX package's ``parallel`` package: each shard owns a
slice of the visited set (``owner = hi mod n``) and a slice of the
frontier; waves exchange candidate keys with their owners, in one process
as a permutation on the device, across processes through
``torch.distributed`` collectives (``parallel/sharded.py``).
"""

from .base_mesh import (
    AXIS,
    ShardMesh,
    bootstrap_mesh,
    default_mesh,
    distributed_mesh,
    initialize_distributed,
)

__all__ = [
    "AXIS",
    "ShardMesh",
    "ShardedGpuBfsChecker",
    "bootstrap_mesh",
    "default_mesh",
    "distributed_mesh",
    "initialize_distributed",
]


def __getattr__(name):
    # Lazy, as in the JAX package: a process of a multi-process run can
    # import ``bootstrap_mesh`` before anything builds a checker.
    if name == "ShardedGpuBfsChecker":
        from .sharded import ShardedGpuBfsChecker

        return ShardedGpuBfsChecker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
