"""A process of the two-process sharded run over gloo, importing only the
port.

Each of two processes holds 4 shards on the CPU; ``bootstrap_mesh`` joins
them from torch's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
(set here from the arguments) into one 8-shard mesh, and both run the
same host loop of ``spawn_sharded_gpu_bfs``. The last line carries the
results that the two processes and the one-process 8-shard run must share.

Usage: ``python torch_multiprocess_child.py <rank> <port> <mode> [path]``,
mode ``plain`` (2pc-3), ``sieve`` (2pc-3 with the comm sieve) or
``checkpoint`` (2pc-3 stopped at 100 states with a checkpoint every chunk
at ``path``, which process 0 writes).
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
builder = TwoPhaseSys(3).checker()
kw = dict(frontier_per_device=32, table_capacity_per_device=512, sieve=(mode == "sieve"))
if mode == "checkpoint":
    builder = builder.target_state_count(100)
    kw.update(checkpoint_path=sys.argv[4], checkpoint_every_chunks=1)
checker = builder.spawn_sharded_gpu_bfs(mesh=mesh, run_id=f"tmp-{mode}-{rank}", **kw).join()
if mode != "checkpoint":
    checker.assert_properties()
# The child stands on the port alone.
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "stateright_tpu"))
assert not bad, bad
print("SHARDED-RESULT " + json.dumps(run_summary(checker), sort_keys=True), flush=True)
torch.distributed.destroy_process_group()
