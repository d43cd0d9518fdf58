"""Device liveness (``liveness="device"``) in the port against the JAX package.

``spawn_gpu_bfs(device="cpu", liveness="device")`` beside the JAX
``spawn_tpu_bfs(liveness="device", wave_dedup="sort")``, both wave at a time
(``max_drain_waves=1``): every graph shape of ``test_device_liveness.py``,
the cycler, the diamond, raft-3 check-live and a small ``LevelDag`` give the
same discoveries, certificates state for state, outcome records and edge
store statistics. Then the port alone: the drain logs the relation the wave
path logs, a tiny edge log evicts mid-run, a preempted run resumes from its
version 3 payload, mode mismatches and unsound configurations are refused,
and a budgeted run that hands the drain to the wave path keeps its verdict.
"""

import numpy as np
import pytest

import bench
import torch_host_fixtures as tf
from stateright_tpu.core.batch import BatchableModel as JaxBatchableModel
from stateright_tpu.core.fingerprint import fingerprint as jax_fingerprint
from stateright_tpu.core.model import Model as JaxModel
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch import fingerprint
from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.configs import LIVENESS_CONFIGS, LevelDag
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from test_device_liveness import GRAPH_CASES as JAX_GRAPH_CASES
from test_liveness import _Cycler as JaxCycler
from test_liveness import _Diamond as JaxDiamond


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs here count into the JAX package's process-wide metrics
    registry, which ``test_device_liveness.py`` reads exactly: leave it
    empty, as a fresh process has it."""
    yield
    jax_metrics_registry().reset()


class _JaxLevelDag(bench._LevelDag, JaxModel, JaxBatchableModel):
    W, WB, L = 1 << 6, 6, 10


SMALL = dict(frontier_capacity=16)
GRAPHS = {
    "cycle": lambda: tf.PackedDGraph([0, 2, 4, 2]),
    "dag_join_terminal": lambda: tf.PackedDGraph([0, 1, 4], [0, 2, 4]),
    "terminal_init": lambda: tf.PackedDGraph([2]),
    "cycle_through_odd": lambda: tf.PackedDGraph([0, 1, 2, 0]),
    "terminal_preferred": lambda: tf.PackedDGraph([0, 2]),
    "absence_chain": lambda: tf.chain(64),
}
# name: (port model, JAX model, spawn settings both take)
CASES = {
    **{name: (make, JAX_GRAPH_CASES[name], SMALL) for name, make in GRAPHS.items()},
    "cycler": (tf.Cycler, JaxCycler, SMALL),
    "diamond": (tf.Diamond, JaxDiamond, SMALL),
    "level_dag_small": (lambda: LevelDag(6, 10), _JaxLevelDag, SMALL),
    "raft3_check_live": (
        LIVENESS_CONFIGS["raft3_check_live"].make,
        lambda: JaxRaftModelCfg(server_count=3, max_term=1, lossy=True).into_model()
        .retain_properties("stable leader"),
        dict(frontier_capacity=1 << 10),
    ),
}


def _port(make, spawn, **kw):
    kw = {"device": "cpu", "table_capacity": 1 << 14, "liveness": "device",
          "max_drain_waves": 1, **spawn, **kw}
    return make().checker().spawn_gpu_bfs(**kw).join()


def _summary(checker, fp=fingerprint):
    """What the two packages must agree on: the unique count, each
    discovery's states (by their host fingerprints, ``fp`` of the checker's
    package), each outcome record (its seconds left out) and the edge
    store's statistics."""
    rep = checker.liveness_report()
    outcomes = {name: {k: v for k, v in rec.items() if k != "seconds"}
                for name, rec in rep.get("outcomes", {}).items()}
    return {
        "unique": checker.unique_state_count(),
        "discoveries": {k: [fp(s) for s in p.into_states()]
                        for k, p in checker.discoveries().items()},
        "mode": rep["mode"],
        "outcomes": outcomes,
        "edge_store": rep["edge_store"],
    }


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, (_make, make_jax, spawn) in CASES.items():
        ck = make_jax().checker().spawn_tpu_bfs(
            liveness="device", wave_dedup="sort", hashset_impl="xla", max_drain_waves=1,
            table_capacity=1 << 14, **spawn).join()
        assert ck.worker_error() is None
        out[name] = _summary(ck, jax_fingerprint)
    return out


@pytest.fixture(scope="module")
def port_raft3():
    make, _make_jax, spawn = CASES["raft3_check_live"]
    return _port(make, spawn)


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdicts_certificates_and_records_match_jax(case, jax_runs, port_raft3):
    make, _make_jax, spawn = CASES[case]
    port = port_raft3 if case == "raft3_check_live" else _port(make, spawn)
    assert port.worker_error() is None
    got, want = _summary(port), jax_runs[case]
    assert got == want
    assert got["mode"] == "device"
    model = port.model()
    for name, path in port.discoveries().items():
        prop = model.property(name)
        states = path.into_states()
        assert not any(prop.condition(model, s) for s in states)


def test_expected_verdicts(jax_runs):
    """The shapes' verdicts, as the host pass gives them: a lasso on the
    cycles, absence on the chain, the DAG, and the cycle through an odd
    state."""
    outcome = {name: r["outcomes"].get("odd", r["outcomes"].get("three", {})).get("verdict")
               for name, r in jax_runs.items()}
    assert outcome["cycle"] == outcome["cycler"] == "counterexample"
    assert outcome["absence_chain"] == outcome["cycle_through_odd"] == "absent"
    assert jax_runs["level_dag_small"]["outcomes"]["done"]["verdict"] == "absent"
    assert jax_runs["level_dag_small"]["outcomes"]["done"]["trim_rounds"] == 10
    assert jax_runs["cycle"]["discoveries"] == {"odd": [jax_fingerprint(s) for s in (0, 2, 4, 2)]}


def _relation(checker):
    """The logged distinct relation of each eventually property, array for
    array (``property_slice``), and the edge store's counters."""
    rows = checker._live_store.edge_rows()
    return {b: checker._live_store.property_slice(b, rows=rows)
            for b in checker._ebit.values()}


def _same_relation(a, b):
    assert a.keys() == b.keys()
    for bit in a:
        for x, y in zip(a[bit], b[bit]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["cycle", "dag_join_terminal", "level_dag_small", "diamond"])
def test_drain_logs_the_wave_paths_relation(case):
    make, _make_jax, spawn = CASES[case]
    waves = _port(make, spawn)
    drained = _port(make, spawn, max_drain_waves=100_000)
    assert drained.drains >= 1
    _same_relation(_relation(waves), _relation(drained))
    assert _summary(drained)["outcomes"] == _summary(waves)["outcomes"]
    assert drained.unique_state_count() == waves.unique_state_count()


@pytest.mark.parametrize("max_drain_waves", [1, 100_000], ids=["waves", "drain"])
def test_tiny_edge_log_evicts_mid_run(max_drain_waves):
    """An edge log of one worst-case wave (F (A + 1) = 24 rows, rounded to
    32) evicts many times mid-run; the relation, the verdict and the counts
    are those of the default log. Through the drain the log's headroom
    check stops drains ("edge log full")."""
    spawn = dict(frontier_capacity=8, max_drain_waves=max_drain_waves)
    base = _port(lambda: LevelDag(6, 10), spawn)
    tiny = _port(lambda: LevelDag(6, 10), spawn, edge_log_capacity=24)
    assert tiny._elog_capacity == 32
    assert tiny._live_store.stats()["evictions"] > base._live_store.stats()["evictions"] >= 1
    assert tiny._live_store.stats()["evictions"] >= 5
    _same_relation(_relation(base), _relation(tiny))
    assert _summary(tiny)["outcomes"] == _summary(base)["outcomes"]
    assert tiny.unique_state_count() == base.unique_state_count() == 383
    if max_drain_waves > 1:
        assert tiny.drain_exits["edge log full"] >= 1
    # A counterexample keeps its certificate under evictions too.
    cyc = tf.PackedDGraph([0, 2, 4, 2], [0, 6], [6, 8, 10, 6])
    small = _port(lambda: cyc, dict(frontier_capacity=4), edge_log_capacity=12)
    ref = _port(lambda: cyc, dict(frontier_capacity=4))
    assert small._elog_capacity == 16
    assert _summary(small)["discoveries"] == _summary(ref)["discoveries"]


def _preempted(make, live, **kw):
    spawn = dict(device="cpu", frontier_capacity=8, table_capacity=2048, max_drain_waves=2,
                 liveness="device" if live else None, **kw)
    ck = make().checker().spawn_gpu_bfs(**spawn)
    ck.request_preempt()
    for h in ck.handles():
        h.join()
    assert ck.worker_error() is None
    assert ck.preempted, "the run ended before the preempt landed"
    return ck.preempt_payload()


def _resumed(make, payload, live):
    return make().checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=8, table_capacity=2048,
        liveness="device" if live else None, resume_from=payload)


def test_preempt_resume_carries_the_edge_store():
    make = lambda: tf.chain(48)  # noqa: E731
    baseline = _port(make, dict(frontier_capacity=8), max_drain_waves=2)
    assert baseline._live_outcomes["odd"]["verdict"] == "absent"
    payload = _preempted(make, live=True)
    assert payload["version"] == 3
    assert "liveness" in payload
    resumed = _resumed(make, payload, live=True).join()
    assert resumed.worker_error() is None
    assert resumed.unique_state_count() == baseline.unique_state_count() == 49
    assert resumed._live_outcomes["odd"] == {**baseline._live_outcomes["odd"],
                                             "seconds": resumed._live_outcomes["odd"]["seconds"]}
    _same_relation(_relation(resumed), _relation(baseline))
    # Without the knob the payload stays version 2 and carries no store.
    plain = _preempted(make, live=False)
    assert plain["version"] == 2 and "liveness" not in plain


@pytest.mark.parametrize("direction", ["device_payload_without_knob",
                                       "plain_payload_with_knob"])
def test_mode_mismatch_is_refused(direction):
    make = lambda: tf.chain(48)  # noqa: E731
    live_payload = direction == "device_payload_without_knob"
    payload = _preempted(make, live=live_payload)
    ck = _resumed(make, payload, live=not live_payload)
    with pytest.raises(RuntimeError):
        ck.join()
    err = ck.worker_error()
    assert isinstance(err, ValueError) and "liveness" in str(err)
    want = ("checkpoint carries a liveness edge store" if live_payload
            else "liveness='device' cannot resume a checkpoint written without it")
    assert str(err).startswith(want)


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("case", ["capped", "expand_fps", "symmetry", "fused", "both",
                                  "small_capacity"])
def test_unsound_configurations_are_refused_as_in_jax(case):
    cyc, jcyc = tf.PackedDGraph([0, 2, 4, 2]), JAX_GRAPH_CASES["cycle"]()
    port_kw, jax_kw = dict(device="cpu"), {}
    port_b, jax_b = cyc.checker(), jcyc.checker()
    live = "device"
    if case == "capped":
        port_b, jax_b = port_b.target_max_depth(3), jax_b.target_max_depth(3)
    elif case == "expand_fps":
        # An actor model, which has the fingerprint-only expansion.
        port_b = CASES["raft3_check_live"][0]().checker()
        jax_b = CASES["raft3_check_live"][1]().checker()
        port_kw["expand_fps"] = jax_kw["expand_fps"] = True
    elif case == "symmetry":
        port_b, jax_b = TwoPhaseSys(3).checker().symmetry(), JaxTwoPhaseSys(3).checker().symmetry()
    elif case == "fused":
        port_kw["wave_kernel"] = jax_kw["wave_kernel"] = "fused"
    elif case == "both":
        live = "both"
    else:
        # A log smaller than one worst-case wave (F (A + 1) = 32 rows).
        for kw in (port_kw, jax_kw):
            kw.update(frontier_capacity=16, table_capacity=2048, edge_log_capacity=16)
    got = _error(lambda: port_b.spawn_gpu_bfs(liveness=live, **port_kw))
    want = _error(lambda: jax_b.spawn_tpu_bfs(liveness=live, **jax_kw))
    assert got == want


def test_defaults_resolve_to_the_staged_materializing_wave(port_raft3):
    """``wave_kernel=None`` resolves to the staged wave and says so, and
    ``expand_fps=None`` resolves off for an actor model, which the staged
    default otherwise puts on the fingerprint-only wave."""
    assert port_raft3._wave_kernel == "staged"
    assert port_raft3.config_notes == [
        "wave_kernel resolved to 'staged' (liveness='device' runs on the staged wave)"]
    assert port_raft3._use_fps is False
    assert port_raft3.liveness_mode == "device"
    assert port_raft3.state_digest()["liveness_mode"] == "device"
    assert port_raft3.state_digest()["liveness_edge_store"]["terminals"] == 3


def test_knob_leaves_counts_depths_and_default_discoveries_alone():
    """With the knob and without it, through the drain: the same count,
    depth, waves and default-semantics discoveries; the knob adds only the
    device verdict, and its "edge log full" exits may add drains."""
    for make in (tf.Cycler, lambda: LevelDag(6, 10), lambda: tf.PackedDGraph([0, 1, 4], [0, 2, 4])):
        live = _port(make, SMALL, max_drain_waves=100_000)
        plain = _port(make, SMALL, max_drain_waves=100_000, liveness=None)
        assert plain.liveness_mode == "default"
        assert live.unique_state_count() == plain.unique_state_count()
        assert live.state_count() == plain.state_count()
        assert live.max_depth() == plain.max_depth()
        # The log's headroom check may stop drains early; the waves stay.
        assert live.waves == plain.waves
        assert live.drains >= plain.drains
        got = {k: p.into_states() for k, p in live.discoveries().items()}
        base = {k: p.into_states() for k, p in plain.discoveries().items()}
        assert {k: got[k] for k in base} == base
        added = set(got) - set(base)
        assert all(live._live_outcomes[k]["verdict"] == "counterexample" for k in added)


def test_out_of_core_handoff_keeps_the_verdict():
    """Under the smallest HBM budget the drain evicts its table, hands the
    run to the wave path, and that path goes on logging: the same relation
    and verdict as the unbudgeted run."""
    make = lambda: LevelDag(11, 12)  # noqa: E731
    spawn = dict(frontier_capacity=64, table_capacity=2048, max_drain_waves=100_000)
    base = _port(make, spawn)
    budget = min_admissible_hbm_budget_mib(make(), 64)
    tight = _port(make, spawn, hbm_budget_mib=budget)
    assert tight.evictions >= 1 and tight.handoff_wave is not None
    assert tight.unique_state_count() == base.unique_state_count() == 6143
    _same_relation(_relation(base), _relation(tight))
    assert _summary(tight)["outcomes"] == _summary(base)["outcomes"]
    assert tight._live_outcomes["done"]["verdict"] == "absent"
