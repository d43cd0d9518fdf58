"""A process of the two-process sharded run over gloo, importing only the
port.

Each of two processes holds 4 shards on the CPU; ``bootstrap_mesh`` joins
them from torch's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
(set here from the arguments) into one 8-shard mesh, and both run the
same host loop of ``spawn_sharded_gpu_bfs``. The last line carries the
results that the two processes and the one-process 8-shard run must share.

Usage: ``python torch_multiprocess_child.py <rank> <port> <mode> [path]``,
mode ``plain`` (2pc-3), ``sieve`` (2pc-3 with the comm sieve),
``checkpoint`` (2pc-3 stopped at 100 states with a checkpoint every chunk
at ``path``, which process 0 writes) or ``evict_exchange`` (the eviction's
exchange, ``_allgather_evicted_keys``, over a table of known keys a shard:
an empty shard, a key with a zero high word and the largest key among
them; the line carries the decoded keys and the bytes on the wire).
"""

import json
import os
import sys

rank, port, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from stateright_tpu_torch.parallel import bootstrap_mesh  # noqa: E402

mesh = bootstrap_mesh(shards_per_process=4, device="cpu", timeout_s=60)

from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.parallel.sharded import run_summary  # noqa: E402

assert (mesh.n, mesh.local, mesh.world, mesh.rank) == (8, 4, 2, rank), mesh


def evict_exchange():
    """Both processes decode every shard's keys from their tables' rows."""
    import numpy as np

    from stateright_tpu_torch.parallel.sharded import ShardedGpuBfsChecker
    from stateright_tpu_torch.telemetry import CommsInstruments, metrics_registry

    n, rows = mesh.n, 256
    mult = np.uint64(0x9E3779B97F4A7C15)  # odd: a bijection mod 2^64
    full = np.zeros((n, rows, 2), np.uint32)
    truth = []
    for d in range(n):
        if d == 5:
            truth.append(np.zeros(0, np.uint64))  # an empty shard
            continue
        count = 40 + 17 * d
        keys = (np.arange(1, count + 1, dtype=np.uint64) + np.uint64(d * 1000)) * mult
        if d == 0:
            keys[0], keys[1] = np.uint64(1), np.uint64(2**64 - 1)
        slots = (np.arange(count) * 7) % rows
        full[d, slots, 0] = (keys >> np.uint64(32)).astype(np.uint32)
        full[d, slots, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        truth.append(np.sort(keys))
    mine = full[mesh.rank * mesh.local : (mesh.rank + 1) * mesh.local]
    table = torch.from_numpy(mine.view(np.int32).copy())
    obj = object.__new__(ShardedGpuBfsChecker)
    obj._n, obj._L, obj._mesh, obj._device = n, mesh.local, mesh, mesh.device
    obj._ci = CommsInstruments("sharded_bfs", registry=metrics_registry(f"tmp-evict-{rank}"))
    got = obj._allgather_evicted_keys(table)
    assert [k.tolist() for k in got] == [k.tolist() for k in truth]
    wire = metrics_registry(f"tmp-evict-{rank}").snapshot()["sharded_bfs.comms.evict_wire_bytes"]
    return {"keys": [[str(x) for x in k] for k in got], "wire_bytes": wire,
            "raw_bytes": int(full.nbytes)}


if mode == "evict_exchange":
    result = evict_exchange()
else:
    builder = TwoPhaseSys(3).checker()
    kw = dict(frontier_per_device=32, table_capacity_per_device=512, sieve=(mode == "sieve"))
    if mode == "checkpoint":
        builder = builder.target_state_count(100)
        kw.update(checkpoint_path=sys.argv[4], checkpoint_every_chunks=1)
    checker = builder.spawn_sharded_gpu_bfs(mesh=mesh, run_id=f"tmp-{mode}-{rank}", **kw).join()
    if mode != "checkpoint":
        checker.assert_properties()
    result = run_summary(checker)
# The child stands on the port alone.
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "stateright_tpu"))
assert not bad, bad
print("SHARDED-RESULT " + json.dumps(result, sort_keys=True), flush=True)
torch.distributed.destroy_process_group()
