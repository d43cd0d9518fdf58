"""The shard mesh of the sharded checker, in one process or many.

The port of the JAX package's ``parallel/base_mesh.py``. The JAX mesh is a
1-D ``jax.sharding.Mesh`` over devices, one shard a device; the port's
``ShardMesh`` counts shards, not devices: a process holds ``local`` shards
on its one device (``n`` shards in one process on one card, as the JAX
package's tests and its multichip bench leg run on a virtual 8-device CPU
mesh), and ``world`` processes joined by ``torch.distributed`` hold
``n = world * local`` shards in all. Global shard ``d = rank * local + j``
is the JAX mesh's ``jax.devices()`` order, process-major.

- ``default_mesh(n_shards, device)``: one process, ``n_shards`` shards on
  one device (default: the largest power of two of the devices the
  process has, as in the JAX package).
- ``initialize_distributed(...)``: idempotent ``init_process_group`` from
  torch's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, ``nccl``
  for a CUDA device and ``gloo`` for the CPU, with an explicit timeout so
  that a hang fails.
- ``distributed_mesh(shards_per_process, device)`` and
  ``bootstrap_mesh(...)``: the mesh over every process of the group.

The device resolves as every entry point of the port does
(``checker/gpu.py::resolve_device``): ``cuda`` unless ``"cpu"`` is asked
for, raising without CUDA.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch

AXIS = "fp"

# Seconds a collective may wait before the group fails the run.
DEFAULT_TIMEOUT_S = 300.0


def _pow2floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``n`` shards in all, ``local`` of them in this process (global shards
    ``rank * local`` to ``rank * local + local - 1``), on ``device``;
    ``group`` is the ``torch.distributed`` process group joining the
    ``world`` processes, or None for a mesh of one process. ``device``
    resolves as every entry point's does: ``cuda`` unless ``"cpu"`` is
    asked for, raising without CUDA."""

    n: int
    local: int
    rank: int = 0
    world: int = 1
    device: Any = None
    group: Any = None

    def __post_init__(self):
        if self.local < 1 or self.n != self.world * self.local:
            raise ValueError(
                f"a mesh of {self.world} process(es) x {self.local} shard(s) "
                f"cannot hold {self.n} shards"
            )
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is outside a world of {self.world}")
        object.__setattr__(self, "device", _resolve(self.device, "ShardMesh"))

    @property
    def distributed(self) -> bool:
        """True when the shards' exchanges go through collectives."""
        return self.group is not None

    @property
    def shards(self) -> range:
        """This process's global shard indices."""
        return range(self.rank * self.local, (self.rank + 1) * self.local)


def _resolve(device, entry):
    from ..checker.gpu import resolve_device

    return resolve_device(device, entry=entry)


def default_mesh(n_shards: Optional[int] = None, device=None) -> ShardMesh:
    """A mesh of ``n_shards`` shards in this process, all on one device.
    ``n_shards=None`` takes the largest power of two of the devices the
    process has (CUDA devices; 1 on the CPU); any count works, the owner
    function being a modulo."""
    dev = _resolve(device, "default_mesh")
    if n_shards is None:
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        n_shards = _pow2floor(count)
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return ShardMesh(n=int(n_shards), local=int(n_shards), device=dev)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Idempotent ``torch.distributed.init_process_group``. Arguments not
    passed come from torch's environment convention (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); the backend is ``nccl`` for
    a CUDA device and ``gloo`` for the CPU; ``timeout_s`` bounds every
    collective, so that a peer that never arrives fails the run. Returns
    True if this call made the group, False if one existed."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    dev = _resolve(device, "initialize_distributed")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError(
                "initialize_distributed needs MASTER_PORT (or init_method) to "
                "reach the group's rendezvous"
            )
        init_method = f"tcp://{addr}:{port}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def distributed_mesh(shards_per_process: int = 1, device=None) -> ShardMesh:
    """The mesh over every process of the initialized group, each holding
    ``shards_per_process`` shards on its device (for CUDA, the current
    device ``initialize_distributed`` set)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("distributed_mesh needs initialize_distributed() first")
    dev = _resolve(device, "distributed_mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(shards_per_process)
    return ShardMesh(n=world * local, local=local, rank=rank, world=world, device=dev,
                     group=dist.group.WORLD)


def bootstrap_mesh(shards_per_process: int = 1, device=None, **kwargs) -> ShardMesh:
    """One-call entry for a process of a multi-process run: initializes
    the group (idempotently; ``kwargs`` go to ``initialize_distributed``)
    and returns the mesh over every process."""
    initialize_distributed(device=device, **kwargs)
    return distributed_mesh(shards_per_process, device=device)
