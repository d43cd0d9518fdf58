"""The port's host engines (``spawn_bfs`` with threads, ``spawn_dfs``,
``spawn_on_demand``, ``spawn_simulation``) against the JAX package's.

Each case runs the same model through the JAX engine and the port's copy
and compares them exactly: visiting order, counts, depths, discovery paths,
the coverage ledger and, for simulation, the walked states for one seed.
Threaded runs join with a timeout and fail with a message rather than hang.
"""

import threading

import pytest

import fixtures as jf
import torch_host_fixtures as tf
from stateright_tpu import StateRecorder as JaxStateRecorder
from stateright_tpu import fingerprint as jax_fingerprint
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch import Property, StateRecorder, fingerprint
from stateright_tpu_torch.checker.job_market import JobBroker
from stateright_tpu_torch.checker.simulation import UniformChooser
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.telemetry import metrics_registry

JOIN_TIMEOUT_S = 60


def joined(checker, timeout=JOIN_TIMEOUT_S):
    """``checker.join()`` with a bound: a worker still alive after
    ``timeout`` seconds fails the test instead of hanging it."""
    handles = checker.handles()
    for h in handles:
        h.join(timeout)
    alive = [h.name for h in handles if h.is_alive()]
    assert not alive, f"workers {alive} still running after {timeout} s"
    err = checker.worker_error()
    if err is not None:
        raise RuntimeError("checker worker thread failed") from err
    return checker


def same_run(port, ref, paths=True):
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    pd, rd = port.discoveries(), ref.discoveries()
    assert set(pd) == set(rd)
    if paths:
        for name in rd:
            assert pd[name].encode() == rd[name].encode(), name
            assert pd[name].into_actions() == rd[name].into_actions(), name


# -- DFS (the cases of tests/test_dfs.py) ----------------------------------------


def test_dfs_visits_states_in_dfs_order():
    rec, jrec = StateRecorder(), JaxStateRecorder()
    tf.LinearEquation(2, 10, 14).checker().visitor(rec).spawn_dfs().join()
    jf.LinearEquation(2, 10, 14).checker().visitor(jrec).spawn_dfs().join()
    assert rec.states == jrec.states == [(0, 0)] + [(0, y) for y in range(1, 28)]


@pytest.mark.slow
def test_dfs_can_complete_by_enumerating_all_states():
    port = tf.LinearEquation(2, 4, 7).checker().spawn_dfs().join()
    ref = jf.LinearEquation(2, 4, 7).checker().spawn_dfs().join()
    assert port.is_done()
    port.assert_no_discovery("solvable")
    assert port.unique_state_count() == 256 * 256
    same_run(port, ref)


def test_dfs_can_complete_by_eliminating_properties():
    port = tf.LinearEquation(2, 10, 14).checker().spawn_dfs().join()
    ref = jf.LinearEquation(2, 10, 14).checker().spawn_dfs().join()
    port.assert_properties()
    assert port.unique_state_count() == 55
    assert port.discovery("solvable").into_actions() == ["IncreaseY"] * 27
    port.assert_discovery("solvable", ["IncreaseX", "IncreaseY", "IncreaseX"])
    same_run(port, ref)


def test_dfs_handles_panics_gracefully():
    with pytest.raises(RuntimeError):
        joined(tf.Panicker().checker().threads(2).spawn_dfs())


def _two_counters(model_cls, property_cls):
    class TwoCounters(model_cls):
        def init_states(self):
            return [(0, 0)]

        def actions(self, state, actions):
            a, b = state
            if a < 3:
                actions.append("IncA")
            if b < 3:
                actions.append("IncB")

        def next_state(self, state, action):
            a, b = state
            return (a + 1, b) if action == "IncA" else (a, b + 1)

        def properties(self):
            return [property_cls.always("bounded", lambda _, s: max(s) <= 3)]

    return TwoCounters()


@pytest.mark.parametrize("symmetric", [False, True], ids=["full", "reduced"])
def test_dfs_symmetry_reduction(symmetric):
    from stateright_tpu import Model as JaxModel
    from stateright_tpu import Property as JaxProperty
    from stateright_tpu_torch import Model

    runs = []
    for model in (_two_counters(Model, Property), _two_counters(JaxModel, JaxProperty)):
        b = model.checker()
        if symmetric:
            b = b.symmetry_fn(lambda s: tuple(sorted(s)))
        runs.append(b.spawn_dfs().join())
    port, ref = runs
    assert port.unique_state_count() == (10 if symmetric else 16)
    port.assert_properties()
    same_run(port, ref)


@pytest.mark.parametrize("symmetric", [False, True], ids=["8832", "665"])
def test_dfs_2pc5_matches_jax(symmetric):
    """2pc-5 on DFS: 8,832 states, and 665 with the reference's sort
    heuristic as the representative (not the GPU checker's 314 orbits)."""
    runs = []
    for make in (TwoPhaseSys, JaxTwoPhaseSys):
        b = make(5).checker()
        runs.append((b.symmetry() if symmetric else b).spawn_dfs().join())
    port, ref = runs
    assert port.unique_state_count() == (665 if symmetric else 8832)
    port.assert_properties()
    same_run(port, ref)


# -- BFS with the job market ------------------------------------------------------


def test_bfs_one_thread_order_paths_and_coverage_match_jax():
    rec, jrec = StateRecorder(), JaxStateRecorder()
    port = TwoPhaseSys(3).checker().visitor(rec).spawn_bfs().join()
    ref = JaxTwoPhaseSys(3).checker().visitor(jrec).spawn_bfs().join()
    assert port.unique_state_count() == 288
    assert [fingerprint(s) for s in rec.states] == [
        jax_fingerprint(s) for s in jrec.states]
    same_run(port, ref)
    assert port.coverage_report() == ref.coverage_report()


@pytest.mark.parametrize("n,expected", [(3, 288), (4, 1568)])
def test_bfs_two_threads_counts_match_jax(n, expected):
    port = joined(TwoPhaseSys(n).checker().threads(2).spawn_bfs())
    ref = JaxTwoPhaseSys(n).checker().threads(2).spawn_bfs().join()
    one = TwoPhaseSys(n).checker().spawn_bfs().join()
    assert port.unique_state_count() == ref.unique_state_count() == expected
    assert port.state_count() == ref.state_count() == one.state_count()
    assert set(port.discoveries()) == set(ref.discoveries())
    port.assert_properties()


def test_bfs_records_block_instruments():
    before = metrics_registry().snapshot().get("bfs.blocks", 0)
    TwoPhaseSys(3).checker().spawn_bfs().join()
    snap = metrics_registry().snapshot()
    assert snap["bfs.blocks"] > before
    assert snap["bfs.states_evaluated"] > 0
    assert snap["bfs.coverage.states_evaluated"] > 0


def test_job_market_quiescence_closes():
    broker = JobBroker(2)
    broker.push([1, 2, 3])
    got = []

    def worker():
        while True:
            jobs = broker.pop()
            if not jobs:
                return
            got.extend(jobs)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == [1, 2, 3] and broker.is_closed()


# -- on-demand --------------------------------------------------------------------


def test_on_demand_run_to_completion_matches_jax():
    runs = []
    for model in (tf.LinearEquation(2, 10, 14), jf.LinearEquation(2, 10, 14)):
        checker = model.checker().spawn_on_demand()
        assert not checker.is_done()
        checker.run_to_completion()
        runs.append(joined(checker))
    port, ref = runs
    port.assert_properties()
    assert port.unique_state_count() == 12
    same_run(port, ref)


def test_on_demand_2pc3_runs_to_288():
    port = TwoPhaseSys(3).checker().spawn_on_demand()
    port.run_to_completion()
    ref = JaxTwoPhaseSys(3).checker().spawn_on_demand()
    ref.run_to_completion()
    same_run(joined(port), joined(ref), paths=False)
    assert port.unique_state_count() == 288


def _wait_for(checker, count, timeout=10.0):
    import time

    deadline = time.monotonic() + timeout
    while checker.unique_state_count() < count and time.monotonic() < deadline:
        time.sleep(0.01)
    return checker.unique_state_count()


def test_on_demand_check_fingerprint_expands_one_state():
    port = tf.LinearEquation(2, 4, 7).checker().spawn_on_demand()
    ref = jf.LinearEquation(2, 4, 7).checker().spawn_on_demand()
    for state, count in (((0, 0), 3), ((1, 0), 5)):
        assert fingerprint(state) == jax_fingerprint(state)
        port.check_fingerprint(fingerprint(state))
        ref.check_fingerprint(jax_fingerprint(state))
        assert _wait_for(port, count) == _wait_for(ref, count) == count
    assert port.state_count() == ref.state_count()
    assert not port.is_done()
    port.run_to_completion()
    ref.run_to_completion()
    same_run(joined(port), joined(ref), paths=False)


# -- simulation -------------------------------------------------------------------


def test_simulation_eliminates_properties_like_jax():
    port = tf.LinearEquation(2, 10, 14).checker().spawn_simulation(0).join()
    ref = jf.LinearEquation(2, 10, 14).checker().spawn_simulation(0).join()
    port.assert_properties()
    port.assert_discovery("solvable", ["IncreaseX", "IncreaseY", "IncreaseX"])
    same_run(port, ref)


@pytest.mark.parametrize("seed", [7, 2024])
def test_simulation_walks_the_same_states_for_a_seed(seed):
    """One thread, the same seed and the uniform chooser: both packages
    walk the same states in the same order and report the same
    discoveries, paths included."""
    rec, jrec = StateRecorder(), JaxStateRecorder()
    port = (TwoPhaseSys(3).checker().visitor(rec).target_state_count(400)
            .spawn_simulation(seed, UniformChooser()).join())
    ref = (JaxTwoPhaseSys(3).checker().visitor(jrec).target_state_count(400)
           .spawn_simulation(seed).join())
    assert len(rec.states) >= 400
    assert [fingerprint(s) for s in rec.states] == [
        jax_fingerprint(s) for s in jrec.states]
    same_run(port, ref)


def test_simulation_respects_target_state_count():
    class Unsolvable(tf.LinearEquation):
        def properties(self):
            return [Property.sometimes("never", lambda _m, _s: False)]

    checker = Unsolvable(2, 4, 7).checker().target_state_count(500).spawn_simulation(7)
    assert joined(checker).state_count() >= 500
