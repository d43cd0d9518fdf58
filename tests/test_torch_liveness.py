"""``complete_liveness()`` in the port against the JAX package.

The cases of ``tests/test_liveness.py`` run on the port's ``spawn_bfs``,
``spawn_dfs`` and ``spawn_gpu_bfs(device="cpu")`` beside the JAX
``spawn_bfs``, ``spawn_dfs`` and ``spawn_tpu_bfs``: the same lasso or
maximal-path certificates state for state, the same ``liveness_report()``,
the capped-run refusal on every engine, a bounded pass that ends
``inconclusive``, and a crashed run that signals the skipped pass.
"""

import io
import re

import pytest
import torch

import fixtures as jf
import torch_host_fixtures as tf
from stateright_tpu import Property as JaxProperty
from stateright_tpu.core.fingerprint import fingerprint as jax_fingerprint
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch import Property, WriteReporter, fingerprint
from stateright_tpu_torch.checker.liveness import INCONCLUSIVE, find_eventually_lasso
from test_liveness import _Cycler as JaxCycler
from test_liveness import _Diamond as JaxDiamond


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs here count into the JAX package's process-wide metrics
    registry, some of whose counters that package's own tests read
    exactly: leave the registry empty, as a fresh process has it."""
    yield
    jax_metrics_registry().reset()


GPU = dict(device="cpu", frontier_capacity=16, table_capacity=2048)
# The JAX device checker as the port mirrors it: the sorted in-wave dedup.
TPU = dict(hashset_impl="xla", wave_dedup="sort", frontier_capacity=16,
           table_capacity=1 << 9)


def graph(prop_cls, graph_cls, *paths):
    g = graph_cls.with_property(prop_cls.eventually("odd", lambda _, s: s % 2 == 1))
    for p in paths:
        g.with_path(list(p))
    return g


def states_of(checker):
    return {name: path.into_states() for name, path in checker.discoveries().items()}


GRAPHS = {
    "cycle": ([0, 2, 4, 2],),
    "dag_join_terminal": ([0, 1, 4], [0, 2, 4]),
    "terminal_false_init": ([2],),
    "cycle_through_satisfying": ([0, 1, 2, 0],),
    "terminal_preferred": ([0, 2],),
}
EXPECTED = {
    "cycle": [0, 2, 4, 2],
    "dag_join_terminal": [0, 2, 4],
    "terminal_false_init": [2],
    "cycle_through_satisfying": None,
    "terminal_preferred": [0, 2],
}


@pytest.mark.parametrize("engine", ["spawn_bfs", "spawn_dfs"])
@pytest.mark.parametrize("case", list(GRAPHS))
def test_host_engines_lasso_matches_jax(case, engine):
    port = getattr(graph(Property, tf.DGraph, *GRAPHS[case]).checker()
                   .complete_liveness(), engine)().join()
    ref = getattr(graph(JaxProperty, jf.DGraph, *GRAPHS[case]).checker()
                  .complete_liveness(), engine)().join()
    got = states_of(port)
    assert got == states_of(ref)
    want = EXPECTED[case]
    assert got == ({} if want is None else {"odd": want})
    if want is not None:
        assert all(s % 2 == 0 for s in want)
        with pytest.raises(AssertionError):
            port.assert_properties()
    assert port.liveness_report() == ref.liveness_report() == {"mode": "host_pass"}


def test_default_semantics_keep_the_dag_join_false_negative():
    port = graph(Property, tf.DGraph, *GRAPHS["dag_join_terminal"]).checker().spawn_bfs().join()
    ref = graph(JaxProperty, jf.DGraph, *GRAPHS["dag_join_terminal"]).checker().spawn_bfs().join()
    assert port.discoveries() == ref.discoveries() == {}
    assert port.liveness_report() == ref.liveness_report() == {"mode": "default"}


@pytest.mark.parametrize("engine", ["spawn_bfs", "spawn_dfs", "spawn_gpu_bfs"])
def test_capped_run_is_refused(engine):
    kwargs = GPU if engine == "spawn_gpu_bfs" else {}
    for cap in ("target_max_depth", "target_state_count"):
        builder = getattr(tf.Cycler().checker().complete_liveness(), cap)(3)
        with pytest.raises(ValueError, match="uncapped"):
            getattr(builder, engine)(**kwargs)
    jax_engine = "spawn_tpu_bfs" if engine == "spawn_gpu_bfs" else engine
    with pytest.raises(ValueError):
        getattr(JaxCycler().checker().complete_liveness().target_max_depth(3), jax_engine)()


@pytest.mark.parametrize("wave_kernel", [None, "staged", "fused"])
def test_gpu_checker_lasso_matches_jax_device_and_host(wave_kernel):
    """The lasso pass on the GPU checker fires after the device run; the
    path equals the JAX device checker's and the host engines'."""
    port = tf.Cycler().checker().complete_liveness().spawn_gpu_bfs(
        wave_kernel=wave_kernel, **GPU).join()
    ref = JaxCycler().checker().complete_liveness().spawn_tpu_bfs(**TPU).join()
    host = tf.Cycler().checker().complete_liveness().spawn_bfs().join()
    dfs = tf.Cycler().checker().complete_liveness().spawn_dfs().join()
    assert port.worker_error() is None
    got = states_of(port)
    assert got == states_of(ref) == states_of(host) == states_of(dfs)
    states = got["three"]
    assert states[-1] in states[:-1] and 3 not in states
    assert port.liveness_report() == ref.liveness_report() == {"mode": "host_pass"}
    # Without the flag both keep the reference's false negative.
    plain = tf.Cycler().checker().spawn_gpu_bfs(wave_kernel=wave_kernel, **GPU).join()
    jplain = JaxCycler().checker().spawn_tpu_bfs(**TPU).join()
    assert plain.discoveries() == jplain.discoveries() == {}
    assert plain.liveness_report() == {"mode": "default"}


@pytest.mark.parametrize("flag", [False, True], ids=["default", "complete_liveness"])
def test_gpu_checker_dag_join_matches_jax_device(flag):
    """The diamond on the sorted in-wave dedup: its wave keeps the lower
    lane (parent 2), so the terminal's path 0 -> 2 -> 4 is found by the
    default semantics on both, and the pass leaves it as it is."""
    pb, jb = tf.Diamond().checker(), JaxDiamond().checker()
    if flag:
        pb, jb = pb.complete_liveness(), jb.complete_liveness()
    port = pb.spawn_gpu_bfs(**GPU).join()
    ref = jb.spawn_tpu_bfs(**TPU).join()
    assert port.unique_state_count() == ref.unique_state_count() == 4
    assert states_of(port) == states_of(ref) == {"odd": [0, 2, 4]}


def _raft3(pkg):
    if pkg == "port":
        from stateright_tpu_torch.models.raft import RaftModelCfg
    else:
        from stateright_tpu.models.raft import RaftModelCfg
    return (RaftModelCfg(server_count=3, max_term=1, lossy=True).into_model()
            .retain_properties("stable leader"))


def test_raft3_stable_leader_lasso_matches_jax():
    """raft-3 lossy, "stable leader": the port's pass gives the JAX pass's
    certificate, state for state (by fingerprint), with the condition false
    along it. The GPU checker's CPU twin under ``complete_liveness()``
    stops at the default semantics' terminal counterexample, as the JAX
    device checker does, with the same path."""
    port, ref = _raft3("port"), _raft3("jax")
    prop = port.properties()[0]
    path = find_eventually_lasso(port, prop)
    jpath = find_eventually_lasso(ref, ref.properties()[0])
    fps = [fingerprint(s) for s in path.into_states()]
    assert fps == [jax_fingerprint(s) for s in jpath.into_states()]
    assert not any(prop.condition(port, s) for s in path.into_states())
    spawn = dict(frontier_capacity=256, table_capacity=1 << 12)
    gpu = _raft3("port").checker().complete_liveness().spawn_gpu_bfs(
        device="cpu", **spawn).join()
    dev = _raft3("jax").checker().complete_liveness().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", **spawn).join()
    assert gpu.worker_error() is None
    assert gpu.unique_state_count() == dev.unique_state_count()
    got = gpu.discoveries()["stable leader"].into_states()
    want = dev.discoveries()["stable leader"].into_states()
    assert [fingerprint(s) for s in got] == [jax_fingerprint(s) for s in want]
    assert not any(prop.condition(port, s) for s in got)


def _report(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


@pytest.mark.parametrize("engine", ["spawn_bfs", "spawn_gpu_bfs"])
def test_budget_exhausted_pass_is_inconclusive(engine):
    kwargs = dict(GPU, wave_kernel="staged") if engine == "spawn_gpu_bfs" else {}
    jax_engine = "spawn_tpu_bfs" if engine == "spawn_gpu_bfs" else engine
    jkwargs = TPU if engine == "spawn_gpu_bfs" else {}
    port = getattr(tf.Cycler().checker().complete_liveness(budget_states=1), engine)(
        **kwargs).join()
    ref = getattr(JaxCycler().checker().complete_liveness(budget_states=1), jax_engine)(
        **jkwargs).join()
    assert port.discoveries() == ref.discoveries() == {}
    want = {"mode": "host_pass", "inconclusive": ["three"]}
    assert port.liveness_report() == ref.liveness_report() == want
    text = _report(port, WriteReporter)
    assert 'Liveness "three" inconclusive' in text
    assert text == _report(ref, JaxWriteReporter)
    # A budget that covers the region certifies the lasso.
    full = getattr(tf.Cycler().checker().complete_liveness(budget_states=100), engine)(
        **kwargs).join()
    assert "three" in full.discoveries()
    assert full.liveness_report() == {"mode": "host_pass"}


class _CrashingCycler(tf.Cycler):
    def packed_expand(self, states):
        if bool((states["s"] == 2).any()):
            raise RuntimeError("crash in packed_expand")
        return super().packed_expand(states)


class _Crashing(tf.Panicker):
    def properties(self):
        return [Property.eventually("six", lambda _m, s: s == 6)]


class _JaxCrashing(jf.Panicker):
    def properties(self):
        return [JaxProperty.eventually("six", lambda _m, s: s == 6)]


@pytest.mark.parametrize("engine", ["spawn_bfs", "spawn_gpu_bfs"])
def test_crashed_run_signals_the_skipped_pass(engine):
    if engine == "spawn_gpu_bfs":
        checker = _CrashingCycler().checker().complete_liveness().spawn_gpu_bfs(
            wave_kernel="staged", max_drain_waves=1, **GPU)
    else:
        checker = _Crashing().checker().complete_liveness().spawn_bfs()
    buf = io.StringIO()
    with pytest.raises(RuntimeError, match="worker thread failed"):
        checker.join_and_report(WriteReporter(buf))
    assert checker.worker_error() is not None
    assert "Liveness pass skipped: run crashed" in buf.getvalue()
    assert checker.discoveries() == {}
    assert checker.liveness_report() == {"mode": "host_pass", "skipped_crashed_run": True}
    ref = _JaxCrashing().checker().complete_liveness().spawn_bfs()
    jbuf = io.StringIO()
    with pytest.raises(RuntimeError):
        ref.join_and_report(JaxWriteReporter(jbuf))
    assert ref.liveness_report() == checker.liveness_report()
    assert jbuf.getvalue().splitlines()[-1] == buf.getvalue().splitlines()[-1]


def test_absence_is_certified_over_a_long_chain():
    """No counterexample: the pass exhausts a 100,000-state region, as in
    the JAX package's test, and a budget below it ends inconclusive."""
    n = 100_000
    g = tf.DGraph.with_property(Property.eventually("odd", lambda _, s: s % 2 == 1))
    g.inits.add(0)
    for i in range(n - 1):
        g.edges[2 * i] = {2 * (i + 1)}
    g.edges[2 * (n - 1)] = {2 * n + 1}
    assert find_eventually_lasso(g, g.prop) is None
    assert find_eventually_lasso(g, g.prop, budget_states=n // 2) is INCONCLUSIVE


def test_reporter_line_shapes_match_jax():
    for kw in (dict(inconclusive=["b", "a"]), dict(skipped_crashed=True)):
        buf, jbuf = io.StringIO(), io.StringIO()
        WriteReporter(buf).report_liveness(**kw)
        JaxWriteReporter(jbuf).report_liveness(**kw)
        assert buf.getvalue() == jbuf.getvalue() != ""


def test_gpu_packed_cycler_matches_jax_packing():
    """The port's packed twin of the cycler fingerprints every state as the
    JAX twin does (the parity above rests on it)."""
    import jax
    import jax.numpy as jnp

    for s in (0, 1, 2, 3):
        hi, lo = tf.Cycler().packed_fingerprint({"s": torch.tensor([s])})
        jhi, jlo = jax.vmap(JaxCycler().packed_fingerprint)({"s": jnp.asarray([s], jnp.uint32)})
        assert (int(hi[0]), int(lo[0])) == (int(jhi[0]), int(jlo[0]))
