"""Device liveness (``liveness="device"``) on the port's sharded BFS against
the JAX package's, on the CPU.

Each wave builds its lanes' condition-false edge and terminal rows on the
device; every wave attempt's rows are absorbed into one
``LivenessEdgeStore``, and the trim and reach decide the ``eventually``
properties at the end. As in the JAX package's
``test_device_liveness.py:156`` and ``:174`` (the ``sharded`` cases):
every graph shape of ``GRAPH_CASES`` and the cycler and diamond fixtures,
across 1, 2 and 8 shards, give the JAX sharded run's verdicts, outcome
records (their seconds aside), edge-store statistics and certificates,
state for state by fingerprint. Also: the knob composes with the budget
and the async pipeline (a ``LevelDag`` large enough to evict on one shard:
the same verdict and relation as the plain run), and a run preempted at a
wave boundary resumes from its version 3 payload to the uninterrupted
run's relation and verdict. Everything compared is an integer or a
string: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from stateright_tpu.core.fingerprint import fingerprint as jax_fingerprint
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch.configs import LevelDag
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.parallel.sharded import ShardedGpuBfsChecker
from stateright_tpu_torch.storage import table_budget_mib

from test_torch_device_liveness import CASES, _relation, _same_relation, _summary
from torch_sharded_parity import discard, jax_run, port_run

# The JAX tables never grow here: its wave path cannot run a grown table.
KW = dict(frontier_per_device=16, table_capacity_per_device=1 << 12, liveness="device")
# (case, shards): each graph shape once, every shard count twice or more.
RUNS = [("cycle", 1), ("dag_join_terminal", 2), ("terminal_init", 8),
        ("cycle_through_odd", 1), ("terminal_preferred", 2), ("absence_chain", 8),
        ("cycler", 2), ("diamond", 8)]


@pytest.fixture(scope="module", autouse=True)
def _fresh_registries():
    """The JAX runs count into the JAX package's process-wide registry,
    which its own liveness tests read exactly: leave it empty."""
    yield
    discard()
    jax_metrics_registry().reset()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case,n", RUNS, ids=[f"{c}-n{n}" for c, n in RUNS])
def test_verdicts_and_certificates_equal_jax(case, n):
    make, make_jax, _spawn = CASES[case]
    jax_ck, want = jax_run(make_jax().checker(), n, **KW)
    port, got = port_run(make().checker(), n, **KW)
    assert got == want
    summary = _summary(port)
    assert summary == _summary(jax_ck, jax_fingerprint)
    store = summary["edge_store"]
    assert summary["mode"] == "device" and store["edges_logged"] + store["terminals"] > 0
    model = port.model()
    for name, path in port.discoveries().items():
        prop = model.property(name)
        assert not any(prop.condition(model, s) for s in path.into_states())


def test_budget_and_the_pipeline_compose():
    # 1,535 states on one shard outgrow a 2,048-row table at load 0.5.
    kw = dict(frontier_per_device=8, table_capacity_per_device=2048, liveness="device")
    plain, want = port_run(LevelDag(8, 12).checker(), 1, max_drain_waves=1, **kw)
    for extra in (dict(hbm_budget_mib=table_budget_mib(2048)),
                  dict(hbm_budget_mib=table_budget_mib(2048), async_pipeline=True)):
        composed, got = port_run(LevelDag(8, 12).checker(), 1, **kw, **extra)
        assert composed.evictions >= 1
        assert got == want and got["unique"] == 1535
        assert _summary(composed)["outcomes"] == _summary(plain)["outcomes"]
        _same_relation(_relation(composed), _relation(plain))
    assert plain.liveness_report()["outcomes"]["done"]["verdict"] == "absent"


class _PreemptAfter(ShardedGpuBfsChecker):
    """Asks for preemption from the worker after its third wave."""

    def _call_wave(self, *a, **kw):
        out = super()._call_wave(*a, **kw)
        if self.waves == 3:
            self.request_preempt()
        return out


@pytest.mark.parametrize("n", [2, 8])
def test_preempt_resume_carries_the_edge_store(n):
    kw = dict(frontier_per_device=4, liveness="device")
    whole, _ = port_run(LevelDag(6, 10).checker(), n, **kw)
    cut = _PreemptAfter(LevelDag(6, 10).checker(), mesh=default_mesh(n, device="cpu"),
                        run_id="tsh-port-live-cut", **kw).join()
    payload = cut.preempt_payload()
    assert cut.preempted and payload["version"] == 3 and "liveness" in payload
    resumed, got = port_run(LevelDag(6, 10).checker(), n, resume_from=payload, **kw)
    assert got["unique"] == whole.unique_state_count() == 383
    _same_relation(_relation(resumed), _relation(whole))
    assert _summary(resumed)["outcomes"] == _summary(whole)["outcomes"]
    np.testing.assert_array_equal(resumed._live_store.edge_rows(), whole._live_store.edge_rows())
