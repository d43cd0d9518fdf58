"""The per-shard host tiers of the port's sharded BFS against the JAX
package's, on the CPU.

Under ``hbm_budget_mib`` each shard's table is capped, growth past the cap
evicts every shard's keys into that shard's own ``TieredVisitedStore``, and
the fresh rows of each wave probe the union of the tiers. Here, as in the
JAX package's ``test_storage_equivalence.py:347`` and
``test_comm_sieve.py:381``: budgeted runs at 1, 2 and 8 shards equal
``spawn_sharded_tpu_bfs`` at the same knobs in counts, depth, discoveries,
paths, lanes shipped, sieve kills and rungs, and the storage ledger
(evictions, keys evicted, probes, hits, spills), and equal the unbounded
run in their results; one run spills to disk under a host budget (each
shard's files tagged by its shard), one runs with the sieve on (each
eviction flushes the receipts, so its kills equal the JAX run's). A budget
binds only once the visited set outgrows the shards' 2,048-row tables (the
insert kernel's tile), so 2 and 8 shards check 2pc-5. A budgeted run
preempted after its first eviction resumes on another shard count (8 to 4
and 4 to 8): each key of the runs goes to its owner's tier under the new
mesh and the run ends with the unbounded run's counts and discoveries. The
eviction's exchange across processes (``_allgather_evicted_keys``, the
JAX package's ``test_multihost.py:130``): two gloo processes decode every
shard's keys of a table of known keys and count the bytes on the wire,
and a budgeted run of a one-rank group, which takes the same path, equals
the one-process mesh's. Everything compared is an integer or a string:
the tolerance is 0.
"""

import json
import os

import numpy as np
import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.parallel.sharded import ShardedGpuBfsChecker, run_summary
from stateright_tpu_torch.storage import FingerprintRun, table_budget_mib

from test_torch_multiprocess import _free_port, _two_ranks
from torch_sharded_parity import discard, jax_run, paths_replay, port_run


@pytest.fixture(scope="module", autouse=True)
def _fresh_registries():
    yield
    discard()
    jax_metrics_registry().reset()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# name: (shards, two-phase commit size, frontier_per_device, rows a shard,
# sieve, host budget and spill directory)
CASES = {
    "n1_2pc4": (1, 4, 8, 2048, False, False),
    "n2_2pc5_spill": (2, 5, 16, 4096, False, True),
    "n8_2pc5_sieve": (8, 5, 8, 2048, True, False),
}
STORAGE = ("evictions", "evicted_fps", "merges", "spills", "probe_batches", "probe_keys",
           "probe_hits.l1", "probe_hits.l2")


def _results(s):
    return {k: s[k] for k in ("unique", "states", "depth", "discoveries", "paths")}


def _storage(registry):
    snap = registry.snapshot()
    return {k: snap.get(f"sharded_bfs.storage.{k}", 0) for k in STORAGE}


def _knobs(case, spill_dir=None):
    n, rm, f, rows, sieve, spill = CASES[case]
    kw = dict(frontier_per_device=f, table_capacity_per_device=rows,
              hbm_budget_mib=table_budget_mib(rows), sieve=sieve)
    if spill:
        kw.update(host_budget_mib=0.02, spill_dir=str(spill_dir))
    return n, rm, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_budget_equals_jax_and_the_unbounded_run(case, tmp_path):
    n, rm, kw = _knobs(case, tmp_path / "port")
    jax_ck, want = jax_run(JaxTwoPhaseSys(rm).checker(), n,
                           **{**kw, **({"spill_dir": str(tmp_path / "jax")}
                                       if "spill_dir" in kw else {})})
    port, got = port_run(TwoPhaseSys(rm).checker(), n, **kw)
    assert got == want
    assert _storage(port.metrics()) == _storage(jax_metrics_registry(jax_ck.run_id))
    assert port.evictions >= 1 and port.stale_lanes > 0
    _, unbounded = port_run(TwoPhaseSys(rm).checker(), n, frontier_per_device=kw[
        "frontier_per_device"], table_capacity_per_device=1 << 14, max_drain_waves=1,
        sieve=kw["sieve"])
    assert _results(got) == _results(unbounded)
    assert got["unique"] == {4: 1568, 5: 8832}[rm]
    if kw["sieve"]:
        # Each eviction flushed the receipts: the kills equal the JAX run's.
        assert got["killed"] > 0
    if "spill_dir" in kw:
        assert _storage(port.metrics())["spills"] >= 1
        files = os.listdir(kw["spill_dir"])
        assert files and {f.split("_")[0] for f in files} <= {f"s{d}" for d in range(n)}
    paths_replay(port)


class _PreemptAfterEvict(ShardedGpuBfsChecker):
    """Stops at the wave boundary after its first eviction, asked from the
    worker, so the boundary does not depend on timing."""

    def _evict_shards(self, *a, **kw):
        table = super()._evict_shards(*a, **kw)
        self.request_preempt()
        return table


@pytest.mark.parametrize("shards", [(8, 4), (4, 8)], ids=["8to4", "4to8"])
def test_elastic_restore_under_budget(shards):
    src, dst = shards
    kw = dict(frontier_per_device=8, table_capacity_per_device=2048,
              hbm_budget_mib=table_budget_mib(2048))
    cut = _PreemptAfterEvict(TwoPhaseSys(5).checker(), mesh=default_mesh(src, device="cpu"),
                             run_id="tsh-port-elastic-cut", **kw).join()
    payload = cut.preempt_payload()
    assert cut.preempted and cut.evictions == 1
    assert payload["n_shards"] == src and len(payload["storage"]) == src
    resumed, got = port_run(TwoPhaseSys(5).checker(), dst, resume_from=payload, **kw)
    _, want = port_run(TwoPhaseSys(5).checker(), dst, frontier_per_device=8,
                       table_capacity_per_device=1 << 14, max_drain_waves=1)
    assert {k: got[k] for k in ("unique", "states")} == {k: want[k] for k in ("unique", "states")}
    assert set(got["discoveries"]) == set(want["discoveries"])
    assert got["unique"] == 8832 and resumed.restore_inserts > 0
    # Every key of a tier is its owner's under the new mesh.
    for d, tier in enumerate(resumed._tiers):
        keys = np.concatenate([FingerprintRun.from_state(r).decode_all()
                               for r in tier.export_state()["l1"]] or [np.zeros(0, np.uint64)])
        assert len(keys) and ((keys >> np.uint64(32)) % np.uint64(dst) == d).all()
    paths_replay(resumed)


def test_two_processes_decode_the_evicted_keys():
    ranks = _two_ranks("evict_exchange")
    assert ranks[0] == ranks[1]
    # 40 + 17 d keys on each of the seven shards but the empty fifth.
    assert sum(len(k) for k in ranks[0]["keys"]) == 671
    assert 0 < ranks[0]["wire_bytes"] < ranks[0]["raw_bytes"]


def test_one_rank_group_evicts_through_the_exchange():
    import torch.distributed as dist

    from stateright_tpu_torch.parallel import bootstrap_mesh

    kw = dict(frontier_per_device=8, table_capacity_per_device=2048,
              hbm_budget_mib=table_budget_mib(2048))
    mesh = bootstrap_mesh(8, device="cpu", init_method=f"tcp://localhost:{_free_port()}",
                          world_size=1, rank=0, timeout_s=60)
    try:
        checker = TwoPhaseSys(5).checker().spawn_sharded_gpu_bfs(
            mesh=mesh, run_id="tsh-port-one-rank-budget", **kw).join()
        got = json.loads(json.dumps(run_summary(checker)))
        wire = checker.metrics().snapshot()["sharded_bfs.comms.evict_wire_bytes"]
    finally:
        dist.destroy_process_group()
    one, _ = port_run(TwoPhaseSys(5).checker(), 8, **kw)
    assert checker.evictions >= 1 and wire > 0
    assert got == json.loads(json.dumps(run_summary(one)))
