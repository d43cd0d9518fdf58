"""Out-of-core equivalence of the port's GPU checker (on the CPU): a run at
the smallest admissible ``hbm_budget_mib`` (several table evictions, the
host probe on every later wave) is bit-identical to the unbounded run, and
equal to the JAX package's bounded run at the same budget.

Mirrors the JAX package's ``tests/test_storage_equivalence.py`` (its
asynchronous-pipeline twins wait for the port's pipeline). Wave at a time
(``max_drain_waves=1``) the port's bounded run equals its own unbounded
run (counts, depth, discovery fingerprints, the golden report lines) and
the JAX package's bounded run (its staged wave with the XLA insert and
``wave_dedup="sort"``): counts, depth, discoveries, the evictions and the
keys held in the host runs, and, on the staged engine, the golden report
(the fingerprint-only case is held to its own unbounded run, which
``test_torch_actor_raft.py`` holds to the JAX package).
Covered: the default engine (fused), the fused and staged engines, 2pc-6
under symmetry (the orbit-key probe), the fingerprint-only wave of raft, a
host budget that spills runs to disk (L2), the drain's handoff to the wave
path at its first eviction (against the port's unbounded drain), and a
checkpoint written after evictions, resumed. Everything compared is an
integer: the tolerance is 0.
"""

import io
import pickle
import re

import pytest

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs here count into the JAX package's process-wide metrics
    registry, some of whose counters that package's own tests read
    exactly: leave the registry empty, as a fresh process has it."""
    yield
    jax_metrics_registry().reset()


def _golden(checker):
    out = io.StringIO()
    checker.report(WriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


def _jax_golden(checker):
    from stateright_tpu import WriteReporter as JaxWriteReporter

    out = io.StringIO()
    checker.report(JaxWriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


RAFT3 = dict(server_count=3, max_term=1, lossy=True)

# name: (port model, JAX model, symmetry, spawn options)
CASES = {
    "2pc4": (lambda: TwoPhaseSys(4), lambda: JaxTwoPhaseSys(4), False,
             dict(frontier_capacity=16, table_capacity=1 << 12)),
    "2pc6_symmetry": (lambda: TwoPhaseSys(6), lambda: JaxTwoPhaseSys(6), True,
                      dict(frontier_capacity=32, table_capacity=1 << 12,
                           wave_kernel="staged")),
    "raft3_fps": (lambda: RaftModelCfg(**RAFT3).into_model(), None, False,
                  dict(frontier_capacity=16, table_capacity=1 << 12)),
}


def _budget(name):
    make, _, _, spawn = CASES[name]
    return min_admissible_hbm_budget_mib(make(), spawn["frontier_capacity"])


def _port(name, budget=None, **kw):
    make, _, sym, spawn = CASES[name]
    b = make().checker()
    if sym:
        b = b.symmetry()
    kw = dict(spawn, **kw)
    if budget is not None:
        kw["hbm_budget_mib"] = budget
    return b.spawn_gpu_bfs(device="cpu", **kw).join()


_JAX = {}


def _jax_bounded(name):
    """The JAX package's bounded run at the port's budget, wave at a time,
    with its evictions (run once a case)."""
    if name not in _JAX:
        _, make, sym, spawn = CASES[name]
        b = make().checker()
        if sym:
            b = b.symmetry()
        evictions = jax_metrics_registry().counter("tpu_bfs.storage.evictions")
        before = evictions.snapshot()
        checker = b.spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort", max_drain_waves=1,
                                  hbm_budget_mib=_budget(name), **spawn).join()
        _JAX[name] = (checker, evictions.snapshot() - before)
    return _JAX[name]


def _assert_identical(budgeted, unbounded, min_evictions):
    assert budgeted.unique_state_count() == unbounded.unique_state_count()
    assert budgeted.state_count() == unbounded.state_count()
    assert budgeted.max_depth() == unbounded.max_depth()
    assert budgeted._discoveries_fp == unbounded._discoveries_fp
    assert _golden(budgeted) == _golden(unbounded)
    assert budgeted.evictions >= min_evictions, budgeted.evictions
    assert budgeted.storage_fps > 0 and budgeted.stale_lanes > 0
    assert budgeted.table_capacity() <= budgeted._max_capacity
    peak = budgeted.state_digest()["storage"]["peak_l0_resident"]
    assert 0 < peak <= 0.55 * budgeted._max_capacity


def _assert_equals_jax(budgeted, name, golden=False):
    theirs, evictions = _jax_bounded(name)
    assert budgeted.unique_state_count() == theirs.unique_state_count()
    assert budgeted.state_count() == theirs.state_count()
    assert budgeted.max_depth() == theirs.max_depth()
    assert budgeted._discoveries_fp == theirs._discoveries_fp
    assert budgeted.evictions == evictions
    assert budgeted.storage_fps == theirs._tier.total_fps
    if golden:
        assert _golden(budgeted) == _jax_golden(theirs)


@pytest.mark.parametrize("wave_kernel", [None, "fused", "staged"])
def test_budget_identical_2pc4_waves(wave_kernel):
    budgeted = _port("2pc4", _budget("2pc4"), wave_kernel=wave_kernel, max_drain_waves=1)
    unbounded = _port("2pc4", wave_kernel=wave_kernel, max_drain_waves=1)
    _assert_identical(budgeted, unbounded, min_evictions=2)
    _assert_equals_jax(budgeted, "2pc4", golden=wave_kernel == "staged")
    assert budgeted.unique_state_count() == 1568
    assert budgeted.handoff_wave is None
    budgeted.assert_properties()


def test_budget_identical_2pc6_symmetry():
    """The orbit-key probe: under symmetry the tiers hold canonical keys."""
    budgeted = _port("2pc6_symmetry", _budget("2pc6_symmetry"), max_drain_waves=1)
    unbounded = _port("2pc6_symmetry", max_drain_waves=1)
    _assert_identical(budgeted, unbounded, min_evictions=2)
    _assert_equals_jax(budgeted, "2pc6_symmetry", golden=True)
    assert budgeted.unique_state_count() == 553


def test_budget_identical_raft3_expand_fps():
    """The fingerprint-only wave takes only the survivors' children."""
    budgeted = _port("raft3_fps", _budget("raft3_fps"), max_drain_waves=1, expand_fps=True)
    unbounded = _port("raft3_fps", max_drain_waves=1, expand_fps=True)
    assert budgeted._use_fps
    assert budgeted.host_take_rows == budgeted.unique_state_count() - 1
    _assert_identical(budgeted, unbounded, min_evictions=1)
    # The unbounded fps run is held to the JAX package's in
    # test_torch_actor_raft.py.
    assert (budgeted.unique_state_count(), budgeted.state_count(),
            budgeted.max_depth()) == (665, 2044, 10)


def test_budget_with_disk_spill_identical(tmp_path):
    budgeted = _port("2pc4", _budget("2pc4"), wave_kernel="staged", max_drain_waves=1,
                     host_budget_mib=0.001, spill_dir=str(tmp_path))
    unbounded = _port("2pc4", wave_kernel="staged", max_drain_waves=1)
    _assert_identical(budgeted, unbounded, min_evictions=2)
    assert budgeted._tier.l2 and not budgeted._tier.l1
    assert list(tmp_path.iterdir())
    assert budgeted._tier.instruments.bench_stats()["probe_hits_l2"] > 0


@pytest.mark.parametrize("wave_kernel", ["fused", "staged"])
def test_budget_drain_hands_off_to_the_wave_path(wave_kernel):
    """The first eviction ends the drain: the ring, then the host queue,
    go on wave at a time."""
    budgeted = _port("2pc4", _budget("2pc4"), wave_kernel=wave_kernel)
    unbounded = _port("2pc4", wave_kernel=wave_kernel)
    assert budgeted.drains > 0 and budgeted.handoff_wave is not None
    assert budgeted.waves > budgeted.handoff_wave
    assert budgeted._drain is None and budgeted._graphs == {}
    _assert_identical(budgeted, unbounded, min_evictions=2)


def test_checkpoint_after_evictions_resumes(tmp_path):
    """A checkpoint written after evictions carries the runs (format v2)
    and restores them; the table is rebuilt from the keys no run holds."""
    path = tmp_path / "2pc4-oob.ckpt"
    budget = _budget("2pc4")
    first = TwoPhaseSys(4).checker().target_state_count(5000).spawn_gpu_bfs(
        device="cpu", frontier_capacity=16, table_capacity=1 << 12, hbm_budget_mib=budget,
        checkpoint_path=str(path), checkpoint_every_chunks=4).join()
    assert first.evictions >= 1 and first.unique_state_count() < 1568
    payload = pickle.loads(path.read_bytes())
    assert payload["version"] == 2
    assert payload["storage"]["l1"] or payload["storage"]["l2"]
    resumed = _port("2pc4", budget, resume_from=str(path))
    unbounded = _port("2pc4")
    assert resumed._l0_count <= resumed._max_capacity
    assert resumed.unique_state_count() == 1568
    assert resumed.state_count() == unbounded.state_count()
    assert resumed._discoveries_fp == unbounded._discoveries_fp
    resumed.assert_properties()
    # Resumed without the budget: the runs stay probed, the table grows.
    free = _port("2pc4", resume_from=str(path))
    assert free.unique_state_count() == 1568 and free._max_capacity is None
    assert free.state_count() == unbounded.state_count()


def test_budgeted_resume_of_an_unbounded_checkpoint(tmp_path):
    """A checkpoint written with no budget, whose keys outnumber what the
    smallest budget's table holds, resumes under that budget: the restore
    inserts its keys in batches that fit a freshly evicted table and evicts
    when a batch overflows, as the JAX package's restore does. The resumed
    run equals the JAX package's resumed run, evictions included."""
    spawn = dict(frontier_capacity=64, table_capacity=1 << 12, max_drain_waves=1)
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(5), 64)
    ours, theirs = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    TwoPhaseSys(5).checker().target_state_count(35000).spawn_gpu_bfs(
        device="cpu", wave_kernel="staged", checkpoint_path=str(ours),
        checkpoint_every_chunks=8, **spawn).join()
    JaxTwoPhaseSys(5).checker().target_state_count(35000).spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", checkpoint_path=str(theirs),
        checkpoint_every_chunks=8, **spawn).join()
    payload = pickle.loads(ours.read_bytes())
    cap_rows = int(budget * (1 << 20) / 8)
    assert "storage" not in payload and payload["unique_count"] > cap_rows

    resumed = TwoPhaseSys(5).checker().spawn_gpu_bfs(
        device="cpu", wave_kernel="staged", hbm_budget_mib=budget, resume_from=str(ours),
        **spawn).join()
    evictions = jax_metrics_registry().counter("tpu_bfs.storage.evictions")
    before = evictions.snapshot()
    jax_resumed = JaxTwoPhaseSys(5).checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", hbm_budget_mib=budget,
        resume_from=str(theirs), **spawn).join()
    assert resumed.worker_error() is None
    assert resumed.restore_inserts >= 2 and resumed.evictions >= 1
    assert resumed.unique_state_count() == jax_resumed.unique_state_count() == 8832
    assert resumed.state_count() == jax_resumed.state_count()
    assert resumed.max_depth() == jax_resumed.max_depth()
    assert resumed._discoveries_fp == jax_resumed._discoveries_fp
    assert resumed.evictions == evictions.snapshot() - before
    assert resumed.storage_fps == jax_resumed._tier.total_fps
    assert _golden(resumed) == _jax_golden(jax_resumed)
    assert resumed.table_capacity() <= resumed._max_capacity
    resumed.assert_properties()
