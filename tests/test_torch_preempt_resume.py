"""Preempt and resume of the port's GPU checker (on the CPU): a run stopped
by ``request_preempt()`` and resumed from its ``preempt_payload()`` is
bit-identical to the uninterrupted run — unique and generated counts,
depth, discovery fingerprints and the golden report lines.

Mirrors the JAX package's ``tests/test_preempt_resume.py``. The preempt is
requested deterministically, from the worker thread at a known drain,
wave or eviction (subclasses below, as the JAX package's
``_PreemptDuringEviction`` does), never by polling the wall clock. Covered:
2pc-4 through the drain on both engines, a drain on the bucket ladder
(the payload carries the rung selector's state), a double preempt, a
preempt during an eviction (the payload carries the host runs), ABD with
the fingerprint-only wave, and a preempt wave at a time. The uninterrupted
drain is held to the JAX package's drain at the same settings. Everything
compared is an integer: the tolerance is 0.
"""

import io
import re

import pytest

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker.gpu import GpuBfsChecker, min_admissible_hbm_budget_mib
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs here count into the JAX package's process-wide metrics
    registry, some of whose counters that package's own tests read
    exactly: leave the registry empty, as a fresh process has it."""
    yield
    jax_metrics_registry().reset()


SPAWN_2PC4 = dict(frontier_capacity=16, table_capacity=1 << 12, max_drain_waves=2)


def _golden(checker):
    out = io.StringIO()
    checker.report(WriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


def _assert_bit_identical(resumed, reference):
    assert resumed.worker_error() is None and reference.worker_error() is None
    assert resumed.unique_state_count() == reference.unique_state_count()
    assert resumed.state_count() == reference.state_count()
    assert resumed.max_depth() == reference.max_depth()
    assert resumed._discoveries_fp == reference._discoveries_fp
    assert _golden(resumed) == _golden(reference)


class _PreemptAfterDrain(GpuBfsChecker):
    """Requests the preempt from the worker once its ``n``-th drain is
    done; the run stops at the next drain boundary."""

    def __init__(self, *a, after, **kw):
        self._after = after
        super().__init__(*a, **kw)

    def _deep_drain(self, *a):
        out = super()._deep_drain(*a)
        if self.drains == self._after:
            self.request_preempt()
        return out


class _PreemptAfterWave(GpuBfsChecker):
    """Requests the preempt from the worker after its ``n``-th wave."""

    def __init__(self, *a, after, **kw):
        self._after = after
        super().__init__(*a, **kw)

    def _consume_wave(self, *a, **kw):
        out = super()._consume_wave(*a, **kw)
        if self.waves >= self._after:
            self.request_preempt()
        return out


class _PreemptDuringEviction(GpuBfsChecker):
    """Requests the preempt from inside the first eviction: the eviction
    completes, the next boundary honors the request, and the payload
    carries the runs it wrote."""

    def _evict_l0(self, table):
        self.request_preempt()
        return super()._evict_l0(table)


def _stopped(cls, builder, **kw):
    checker = cls(builder, device="cpu", **kw)
    for h in checker.handles():
        h.join()
    assert checker.worker_error() is None
    assert checker.preempted and checker.is_done()
    payload = checker.preempt_payload()
    assert payload["version"] == 2 and payload["kind"] == "gpu_bfs"
    return checker, payload


_UNINTERRUPTED = {}


def _uninterrupted(wave_kernel):
    if wave_kernel not in _UNINTERRUPTED:
        _UNINTERRUPTED[wave_kernel] = TwoPhaseSys(4).checker().spawn_gpu_bfs(
            device="cpu", wave_kernel=wave_kernel, **SPAWN_2PC4).join()
    return _UNINTERRUPTED[wave_kernel]


def test_uninterrupted_drain_equals_jax():
    theirs = JaxTwoPhaseSys(4).checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", **SPAWN_2PC4).join()
    for wave_kernel in ("staged", "fused"):
        ours = _uninterrupted(wave_kernel)
        assert ours.unique_state_count() == theirs.unique_state_count() == 1568
        assert ours.state_count() == theirs.state_count()
        assert ours.max_depth() == theirs.max_depth()
        assert ours._discoveries_fp == theirs._discoveries_fp


@pytest.mark.parametrize("after", [1, 3, 7])
@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
def test_preempt_resume_2pc4_drained(wave_kernel, after):
    first, payload = _stopped(_PreemptAfterDrain, TwoPhaseSys(4).checker(), after=after,
                              wave_kernel=wave_kernel, **SPAWN_2PC4)
    assert first.drains == after and first.unique_state_count() < 1568
    assert "drain" in payload and "storage" not in payload
    resumed = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", wave_kernel=wave_kernel, resume_from=payload, **SPAWN_2PC4).join()
    _assert_bit_identical(resumed, _uninterrupted(wave_kernel))
    resumed.assert_properties()


def test_preempt_resume_on_the_bucket_ladder():
    """Narrow rungs: the payload's rung state makes the resumed drains take
    the same waves as the uninterrupted ones."""
    spawn = dict(frontier_capacity=128, table_capacity=1 << 12, bucket_ladder=2,
                 max_drain_waves=2)
    whole = TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert len(whole.rungs) > 1
    for after in (2, 4, 6):
        first, payload = _stopped(_PreemptAfterDrain, TwoPhaseSys(3).checker(),
                                  after=after, **spawn)
        resumed = TwoPhaseSys(3).checker().spawn_gpu_bfs(
            device="cpu", resume_from=payload, **spawn).join()
        _assert_bit_identical(resumed, whole)
        assert first.rungs + resumed.rungs == whole.rungs


def test_double_preempt_resume_2pc4():
    stage1, payload1 = _stopped(_PreemptAfterDrain, TwoPhaseSys(4).checker(), after=4,
                                **SPAWN_2PC4)
    stage2, payload2 = _stopped(_PreemptAfterDrain, TwoPhaseSys(4).checker(), after=6,
                                resume_from=payload1, **SPAWN_2PC4)
    assert stage1.unique_state_count() < stage2.unique_state_count() < 1568
    final = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", resume_from=payload2, **SPAWN_2PC4).join()
    _assert_bit_identical(final, _uninterrupted(None))


@pytest.mark.parametrize("max_drain_waves", [1, 2])
def test_preempt_mid_eviction_resume(max_drain_waves):
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
    spawn = dict(SPAWN_2PC4, max_drain_waves=max_drain_waves, hbm_budget_mib=budget)
    first, payload = _stopped(_PreemptDuringEviction, TwoPhaseSys(4).checker(), **spawn)
    assert first.evictions == 1 and first.unique_state_count() < 1568
    assert payload.get("storage"), "a preempt during an eviction carries the runs"
    resumed = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", resume_from=payload, **spawn).join()
    assert resumed.unique_state_count() == 1568
    reference = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", **dict(spawn, hbm_budget_mib=None)).join()
    _assert_bit_identical(resumed, reference)
    resumed.assert_properties()


def test_preempt_resume_abd_expand_fps():
    """The fingerprint-only wave's frontier survives the payload."""
    spawn = dict(frontier_capacity=32, table_capacity=1 << 12, max_drain_waves=2,
                 expand_fps=True)
    model = AbdModelCfg(2, 2).into_model
    whole = model().checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert whole._use_fps and whole.unique_state_count() == 544
    first, payload = _stopped(_PreemptAfterDrain, model().checker(), after=3, **spawn)
    assert first.unique_state_count() < 544
    resumed = model().checker().spawn_gpu_bfs(device="cpu", resume_from=payload,
                                              **spawn).join()
    _assert_bit_identical(resumed, whole)
    resumed.assert_properties()


def test_preempt_wave_at_a_time():
    spawn = dict(SPAWN_2PC4, max_drain_waves=1, wave_kernel="staged")
    whole = TwoPhaseSys(4).checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    first, payload = _stopped(_PreemptAfterWave, TwoPhaseSys(4).checker(), after=40, **spawn)
    assert first.waves == 40 and "drain" not in payload
    resumed = TwoPhaseSys(4).checker().spawn_gpu_bfs(device="cpu", resume_from=payload,
                                                     **spawn).join()
    _assert_bit_identical(resumed, whole)


def test_preempt_surface():
    finished = TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu").join()
    finished.request_preempt()  # after the run: nothing to stop
    assert finished.supports_preempt and not finished.preempted
    assert finished.preempt_payload() is None
    assert finished.state_digest()["preempted"] is False
    host = TwoPhaseSys(3).checker().spawn_bfs().join()
    assert not host.supports_preempt
    with pytest.raises(NotImplementedError):
        host.request_preempt()


@pytest.mark.parametrize("frontier_capacity, max_drain_waves", [(4, 2), (4, 1), (64, 2)])
def test_resume_with_another_frontier_capacity(frontier_capacity, max_drain_waves):
    """A payload's chunks hold up to the writer's ``frontier_capacity``
    live lanes. A checker with a narrower frontier splits them (the ring's
    push bound and the wave's width assume at most its own width a chunk),
    and one of another width drops the writer's rung state. The space
    completes with the uninterrupted run's counts."""
    _, payload = _stopped(_PreemptAfterDrain, TwoPhaseSys(4).checker(), after=3,
                          wave_kernel="fused", **SPAWN_2PC4)
    assert max(c["hi"].shape[0] for c in payload["chunks"]) == SPAWN_2PC4["frontier_capacity"]
    resumed = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", wave_kernel="fused", resume_from=payload,
        frontier_capacity=frontier_capacity, table_capacity=1 << 12,
        max_drain_waves=max_drain_waves).join()
    reference = _uninterrupted("fused")
    assert resumed.worker_error() is None
    assert resumed.unique_state_count() == reference.unique_state_count() == 1568
    assert resumed.state_count() == reference.state_count()
    assert resumed.max_depth() == reference.max_depth()
    assert resumed._resume_drain is None
    resumed.assert_properties()
