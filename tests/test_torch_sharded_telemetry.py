"""Coverage and attribution on the port's sharded BFS against the JAX
package's, on the CPU.

``coverage=True`` reduces each shard's coverage vector on the device and the
host sums them at the reads the waves already make. As in the JAX package's
``test_coverage.py:329``: 2pc-3 at 1, 2 and 8 shards, wave at a time and
through the drain, gives the JAX sharded run's ``coverage_report()`` field
for field (prefix ``sharded_bfs``), leaves the run bit-identical to its
coverage-off twin, and, against the solo ``spawn_gpu_bfs(coverage=True)``
report, differs only where the lane that claims a key first does (the
per-action fresh counts and a drain's near-miss depths); under symmetry
(2pc-3, 2 shards) the in-wave distinct fingerprints and orbits are each
shard's, summed, as in the JAX package. ``attribution=True``, as in
``test_attribution.py:283``: at 1, 2 and 8 shards the ledger is within
tolerance, has device time and probe-length counts over every key, and
the run equals the unattributed one and the JAX run at its knobs; a
budgeted run attributes one evict window an eviction and its host probe.
Everything compared is an integer or a string, but the ledger's seconds:
the tolerance is 0 on the counts.
"""

import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

from torch_sharded_parity import discard, jax_run, paths_replay, port_run

KW = dict(frontier_per_device=1 << 5, table_capacity_per_device=1 << 10)
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}


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


@pytest.fixture(scope="module")
def jax_coverage():
    """The JAX sharded coverage runs of 2pc-3, by (shards, mode), each run
    once in this module: ``(checker, summary)``."""
    runs = {}

    def get(n, mode):
        if (n, mode) not in runs:
            runs[n, mode] = jax_run(JaxTwoPhaseSys(3).checker(), n, coverage=True,
                                    **KW, **MODES[mode])
        return runs[n, mode]

    return get


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [1, 2, 8])
def test_coverage_report_equals_jax(n, mode, jax_coverage):
    kw = dict(KW, **MODES[mode])
    jax_ck, want = jax_coverage(n, mode)
    port, got = port_run(TwoPhaseSys(3).checker(), n, coverage=True, **kw)
    _, bare = port_run(TwoPhaseSys(3).checker(), n, **kw)
    assert got == want == bare
    rep = port.coverage_report()
    assert rep == jax_ck.coverage_report()
    assert rep["prefix"] == "sharded_bfs" and rep["unique"] == 288
    assert sum(rep["shape"]["depth_hist"]) == 288 and not rep["vacuous"]
    solo = TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu", coverage=True,
                                                  frontier_capacity=32).join()
    a, b = _flat(rep), _flat(solo.coverage_report())
    assert {k for k in a if a[k] != b.get(k)} <= {"prefix", "actions.never_new"} | {
        k for k in a if k.endswith((".fresh", ".near_miss_depth"))}
    paths_replay(port)


def test_coverage_under_symmetry_equals_jax():
    kw = dict(KW, coverage=True)
    jax_ck, want = jax_run(JaxTwoPhaseSys(3).checker().symmetry(), 2, **kw)
    port, got = port_run(TwoPhaseSys(3).checker().symmetry(), 2, **kw)
    assert got == want
    rep = port.coverage_report()
    assert rep == jax_ck.coverage_report()
    assert rep["symmetry"]["wave_distinct_orbits"] > 0


@pytest.mark.parametrize("n", [1, 2, 8])
def test_attribution_ledger_and_identical_counts(n, jax_coverage):
    # The JAX run's counts: attribution and coverage leave a run's alone.
    _, want = jax_coverage(n, "drain")
    port, got = port_run(TwoPhaseSys(3).checker(), n, attribution=True, **KW)
    _, bare = port_run(TwoPhaseSys(3).checker(), n, **KW)
    assert got == bare == want
    rep = port.attribution_report()
    assert rep["within_tolerance"], rep
    assert rep["phases_s"].get("device", 0) > 0 and rep["drains"] >= 1
    assert sum(rep["probe_length_counts"]) == 288


def test_budgeted_run_attributes_evictions_and_the_host_probe():
    from test_torch_sharded_tiers import _knobs

    n, rm, kw = _knobs("n1_2pc4")
    port, got = port_run(TwoPhaseSys(rm).checker(), n, attribution=True, **kw)
    _, bare = port_run(TwoPhaseSys(rm).checker(), n, **kw)
    assert got == bare
    rep = port.attribution_report()
    assert rep["within_tolerance"] and not rep["overlap_mode"], rep
    assert rep["phase_windows"]["evict"] == port.evictions == 2
    assert rep["phases_s"]["host_probe"] > 0 and rep["waves"] == port.waves
    # The table holds the keys claimed since the last eviction.
    assert sum(rep["probe_length_counts"]) == port._l0_count
