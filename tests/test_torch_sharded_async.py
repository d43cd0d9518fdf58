"""The async pipeline of the port's sharded BFS (``async_pipeline=True``, one
process) against the JAX package's, on the CPU.

Each wave's harvest (the row pulls, the tier probe, the survivors' return
to the pool), each deferred eviction's absorbs and each deferred
checkpoint's pickle run on one ``HostPipeline`` worker while the next wave
runs; the loop dispatches ahead only while the pool holds a full chunk
without the verdicts in flight. Here, as in the JAX package's
``test_storage_equivalence.py:347`` with ``async_on=True``: budgeted async
runs at 1, 2 and 8 shards (the 2-shard one spilling under a host budget,
the 8-shard one sieved) equal the JAX async run at the same knobs and the
port's synchronous run in counts, depth, discoveries, paths, lanes
shipped, sieve kills, rungs and evictions. What depends on timing in both
packages (the stale lanes a verdict finds, how far the loop ran ahead) is
not compared. Also: coverage and device liveness under the pipeline equal
the synchronous run's report, verdicts and relation; the ledger of an
attributed async run is in overlap mode and within tolerance; checkpoints
pickled on the worker resume to the whole space; a preempt under the
pipeline resumes bit-identically; and the run stays the synchronous one
when the interpreter switches threads every microsecond. Everything
compared is an integer or a string: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import torch_host_fixtures as tf
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.parallel.sharded import ShardedGpuBfsChecker

from test_torch_sharded_tiers import CASES, _knobs
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_budget_equals_jax_and_the_synchronous_run(case, tmp_path):
    n, rm, kw = _knobs(case, tmp_path / "port")
    jax_kw = {**kw, **({"spill_dir": str(tmp_path / "jax")} if "spill_dir" in kw else {})}
    _, want = jax_run(JaxTwoPhaseSys(rm).checker(), n, async_pipeline=True, **jax_kw)
    port, got = port_run(TwoPhaseSys(rm).checker(), n, async_pipeline=True, **kw)
    sync, same = port_run(TwoPhaseSys(rm).checker(), n,
                          **{**kw, **({"spill_dir": str(tmp_path / "sync")}
                                      if "spill_dir" in kw else {})})
    assert got == want == same
    assert port.evictions == sync.evictions >= 1
    assert port._pipe is not None and port._inflight_verdicts == 0
    if "spill_dir" in kw:
        assert port.metrics().snapshot()["sharded_bfs.storage.spills"] >= 1
    paths_replay(port)


def _cov_live_model():
    # A cycle beside an absence region: a lasso verdict and a report.
    return tf.PackedDGraph([0, 2, 4, 2], [0, 6], [6, 8, 10, 6], [0, 12, 14, 16, 18, 21])


@pytest.mark.parametrize("n", [1, 2, 8])
def test_coverage_and_liveness_under_the_pipeline(n):
    kw = dict(frontier_per_device=1, coverage=True, liveness="device")
    on, got = port_run(_cov_live_model().checker(), n, async_pipeline=True, **kw)
    off, want = port_run(_cov_live_model().checker(), n, **kw)
    assert got == want
    assert on.coverage_report() == off.coverage_report()
    assert on.liveness_report()["outcomes"].keys() == off.liveness_report()["outcomes"].keys()
    for name, rec in off.liveness_report()["outcomes"].items():
        assert {k: v for k, v in on.liveness_report()["outcomes"][name].items()
                if k != "seconds"} == {k: v for k, v in rec.items() if k != "seconds"}
    assert on._live_store.stats() == off._live_store.stats()
    np.testing.assert_array_equal(on._live_store.edge_rows(), off._live_store.edge_rows())
    assert {k: p.into_states() for k, p in on.discoveries().items()} == {
        k: p.into_states() for k, p in off.discoveries().items()}
    assert "odd" in on.discoveries()


def test_attributed_async_run_is_in_overlap_mode():
    kw = dict(frontier_per_device=8, table_capacity_per_device=2048,
              hbm_budget_mib=_knobs("n1_2pc4")[2]["hbm_budget_mib"])
    checker, got = port_run(TwoPhaseSys(4).checker(), 1, async_pipeline=True,
                            attribution=True, **kw)
    _, want = port_run(TwoPhaseSys(4).checker(), 1, **kw)
    assert got == want
    rep = checker.attribution_report()
    assert rep["overlap_mode"] and rep["within_tolerance"], rep
    assert rep["phases_s"].get("device", 0) > 0 and rep["phase_windows"].get("evict") == 2
    # The host probe and the absorbs ran on the worker.
    assert rep["overlapped_s"].get("host_probe", 0) > 0 and "evict" in rep["overlapped_s"]


def test_checkpoints_pickled_on_the_worker_resume(tmp_path):
    path = tmp_path / "async.ckpt"
    kw = dict(frontier_per_device=32, table_capacity_per_device=512)
    cut, _ = port_run(TwoPhaseSys(4).checker().target_state_count(600), 4, async_pipeline=True,
                      checkpoint_path=str(path), checkpoint_every_chunks=1, **kw)
    assert path.exists() and cut.checkpoints_written >= 1
    resumed, got = port_run(TwoPhaseSys(4).checker(), 8, resume_from=str(path),
                            async_pipeline=True, **kw)
    assert got["unique"] == 1568
    resumed.assert_properties()


class _PreemptAfter(ShardedGpuBfsChecker):
    """Asks for preemption from the worker after its fourth wave."""

    def _call_wave(self, *a, **kw):
        out = super()._call_wave(*a, **kw)
        if self.waves == 4:
            self.request_preempt()
        return out


def test_preempt_under_the_pipeline_resumes_bit_identically():
    kw = dict(frontier_per_device=32, table_capacity_per_device=512, async_pipeline=True,
              max_drain_waves=1)
    whole, want = port_run(TwoPhaseSys(4).checker(), 4, **kw)
    cut = _PreemptAfter(TwoPhaseSys(4).checker(), mesh=default_mesh(4, device="cpu"),
                        run_id="tsh-port-async-cut", **kw).join()
    assert cut.preempted
    resumed, got = port_run(TwoPhaseSys(4).checker(), 4, resume_from=cut.preempt_payload(),
                            **kw)
    assert {k: got[k] for k in ("unique", "states", "depth", "discoveries", "paths")} == {
        k: want[k] for k in ("unique", "states", "depth", "discoveries", "paths")}
    paths_replay(resumed)


def test_pipeline_under_a_short_switch_interval():
    # The worker and this thread share the pool and the counters: with the
    # interpreter switching threads every microsecond, a lost pool append
    # or count would change the run.
    import sys

    kw = _knobs("n1_2pc4")[2]
    _, want = port_run(TwoPhaseSys(4).checker(), 1, **kw)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        checker, got = port_run(TwoPhaseSys(4).checker(), 1, async_pipeline=True, **kw)
    finally:
        sys.setswitchinterval(interval)
    assert got == want and checker.evictions == 2
