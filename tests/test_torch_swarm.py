"""The port's swarm (``spawn_swarm``, ``SwarmEngine``, ``SwarmPackedEngine``;
``stateright_tpu_torch/checker/swarm.py``) on the CPU: the counterparts of
the JAX package's ``tests/test_swarm.py`` (its service tests and metric
lint wait for the port's service). The exact parity with the JAX swarm is
in ``tests/test_torch_swarm_parity.py``.

The determinism contract: the same seed gives the same discoveries and
counts whatever ``wave_steps`` is, across preempt and resume, and packed or
solo."""

import functools
import io

import pytest
import torch

from stateright_tpu_torch import FnModel
from stateright_tpu_torch.checker.gpu import GpuBfsChecker
from stateright_tpu_torch.checker.swarm import (
    SwarmPackedEngine,
    frontier_seeds_from_payload,
)
from stateright_tpu_torch.models.sharded_kv import ShardedKv
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.report import WriteReporter
from stateright_tpu_torch.telemetry import metrics_registry

# One model instance a module: the wave cache keys on the model's identity,
# so same-shape runs share one built kernel.
MODEL_2PC3 = TwoPhaseSys(3)
SWARM_KW = dict(lanes=64, sample_capacity=1 << 12, aot_cache="t-swarm")
PORT_KW = dict(SWARM_KW, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The walks' steps are many small operations, which the intra-op
    thread pool only slows down on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fingerprint_result(ck):
    """What the determinism contract covers, as one value: walk steps, the
    sample, depth, discovery trails and saturation."""
    return (
        ck.state_count(),
        ck.unique_state_count(),
        ck.max_depth(),
        dict(ck._discoveries_fps),
        ck.coverage_estimate()["saturated"],
    )


@functools.lru_cache(maxsize=None)
def _solo(seed, wave_steps=32, target=20_000):
    ck = (MODEL_2PC3.checker().target_state_count(target)
          .spawn_swarm(seed=seed, wave_steps=wave_steps, **PORT_KW).join())
    assert ck.worker_error() is None
    return ck


def _stopped_after_first_wave(builder, **kw):
    """A run preempted at its first wave boundary: the request is in before
    the first wave's stats are read, so it lands there."""
    ck = builder.spawn_swarm(**kw)
    ck.request_preempt()
    ck.join()
    assert ck.preempted
    return ck


def test_swarm_finds_sometimes_properties():
    paths = _solo(7).discoveries()
    assert "abort agreement" in paths and "commit agreement" in paths
    for name, path in paths.items():
        final = path.last_state()
        if name == "abort agreement":
            assert all(s == "Aborted" for s in final.rm_state)
        if name == "commit agreement":
            assert all(s == "Committed" for s in final.rm_state)


def test_swarm_unique_sample_is_honest():
    # 2pc-3 has 288 reachable states; an unsaturated sample never exceeds
    # that, and the walk-step total is not the unique count.
    ck = _solo(7)
    assert not ck.coverage_estimate()["saturated"]
    assert 0 < ck.unique_state_count() <= 288
    assert ck.state_count() >= 20_000 > ck.unique_state_count()


def test_swarm_deterministic_across_wave_steps():
    assert _fingerprint_result(_solo(11, 16)) == _fingerprint_result(_solo(11, 128))


def test_swarm_deterministic_across_preempt_resume():
    first = _stopped_after_first_wave(MODEL_2PC3.checker().target_state_count(20_000),
                                      seed=11, wave_steps=16, **PORT_KW)
    payload = first.preempt_payload()
    assert payload["kind"] == "gpu_swarm" and payload["version"] == 3
    resumed = (MODEL_2PC3.checker().target_state_count(20_000)
               .spawn_swarm(seed=11, wave_steps=16, resume_from=payload, **PORT_KW).join())
    assert resumed.worker_error() is None
    assert _fingerprint_result(resumed) == _fingerprint_result(_solo(11, 16))


def test_swarm_packed_vs_solo_bit_identical():
    eng = SwarmPackedEngine(MODEL_2PC3, lanes=64, wave_steps=16, max_trace_len=512,
                            sample_capacity=1 << 12, max_tenants=2, device="cpu")
    v1 = eng.admit("j1", seed=11, target_state_count=20_000)
    v2 = eng.admit("j2", seed=12, target_state_count=20_000)
    done = set()
    for _ in range(500):
        done |= set(eng.step())
        if len(done) == 2:
            break
    assert done == {"j1", "j2"}
    for view, seed in ((v1, 11), (v2, 12)):
        solo = _solo(seed, 16)
        assert (view.state_count(), view.unique_state_count(), view.max_depth(),
                dict(view._fps)) == (solo.state_count(), solo.unique_state_count(),
                                     solo.max_depth(), dict(solo._discoveries_fps))
        for path in view.discoveries().values():
            assert len(path) >= 1
    eng.release("j1")
    eng.release("j2")
    assert eng.free_slots() == 2


def test_swarm_pack_drop_resumes_solo_bit_identical():
    eng = SwarmPackedEngine(MODEL_2PC3, lanes=64, wave_steps=16, max_trace_len=512,
                            sample_capacity=1 << 12, max_tenants=2, device="cpu")
    eng.admit("j1", seed=11, target_state_count=20_000)
    eng.step()  # one wave in the pack
    payload = eng.drop("j1")
    assert payload is not None and payload["kind"] == "gpu_swarm"
    resumed = (MODEL_2PC3.checker().target_state_count(20_000)
               .spawn_swarm(seed=11, wave_steps=16, resume_from=payload, **PORT_KW).join())
    assert resumed.worker_error() is None
    assert _fingerprint_result(resumed) == _fingerprint_result(_solo(11, 16))


@functools.lru_cache(maxsize=None)
def _skv_unguarded():
    ck = (ShardedKv(2, 2, 1, guarded=False).checker().target_state_count(100_000)
          .spawn_swarm(seed=5, wave_steps=32, **PORT_KW).join())
    assert ck.worker_error() is None
    return ck


def test_swarm_finds_violation_exhaustive_confirms():
    # The unguarded sharded KV's torn-write race: the swarm finds it, the
    # exhaustive checker agrees, and the counterexample replays to a torn
    # state.
    path = _skv_unguarded().discoveries().get("no torn writes")
    assert path is not None, "swarm missed the torn-write violation"
    assert any(path.last_state().torn)
    exhaustive = ShardedKv(2, 2, 1, guarded=False).checker().spawn_bfs().join()
    assert "no torn writes" in exhaustive.discoveries()


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


def test_swarm_hybrid_frontier_seeding():
    # A preempted exhaustive run hands its live frontier to the swarm as
    # restart seeds; seeded discoveries replay as fragments from their seed.
    bfs = _PreemptAfterWave(MODEL_2PC3.checker(), after=3, device="cpu",
                            frontier_capacity=1 << 6, table_capacity=1 << 12,
                            max_drain_waves=1)
    bfs.join()
    assert bfs.preempted
    payload = bfs.preempt_payload()
    seeds = frontier_seeds_from_payload(MODEL_2PC3, payload)
    n_seeds = len(next(iter(seeds.values())))
    assert n_seeds == sum(len(next(iter(c["states"].values()))) for c in payload["chunks"])
    ck = (MODEL_2PC3.checker().target_state_count(10_000)
          .spawn_swarm(seed=9, wave_steps=32, seeds=seeds, **PORT_KW).join())
    assert ck.worker_error() is None
    # Spawning straight from the payload dict is the one-line form.
    ck2 = (MODEL_2PC3.checker().target_state_count(2_000)
           .spawn_swarm(seed=9, wave_steps=32, seeds=payload, **PORT_KW).join())
    assert ck2.worker_error() is None
    paths = ck.discoveries()
    assert paths
    for path in paths.values():
        assert len(path) >= 1  # replays from its seed state
    with pytest.raises(ValueError, match="gpu_bfs payload"):
        frontier_seeds_from_payload(MODEL_2PC3, {**payload, "kind": "tpu_bfs"})


def test_swarm_trace_overflow_counted_and_reported():
    ck = (MODEL_2PC3.checker().target_state_count(5_000)
          .spawn_swarm(seed=3, wave_steps=32, max_trace_len=4, lanes=64,
                       sample_capacity=1 << 12, device="cpu").join())
    assert ck.worker_error() is None
    assert ck._trace_overflows > 0
    assert ck.metrics().snapshot().get("swarm.trace_overflow", 0) > 0
    out = io.StringIO()
    ck.report(WriteReporter(out))
    assert "truncated at the trace buffer" in out.getvalue()


def test_swarm_no_overflow_under_semantic_depth_cap():
    ck = (MODEL_2PC3.checker().target_max_depth(4).target_state_count(3_000)
          .spawn_swarm(seed=3, wave_steps=16, **PORT_KW).join())
    assert ck.worker_error() is None
    assert ck.max_depth() <= 4
    assert ck._trace_overflows == 0


def _fired_total():
    return sum(v for name, v in metrics_registry().snapshot().items()
               if name.startswith("swarm.coverage.action_fired."))


def test_swarm_coverage_ledger_counts_walk_actions():
    ck = (MODEL_2PC3.checker().target_state_count(10_000)
          .spawn_swarm(seed=7, wave_steps=32, coverage=True, **PORT_KW).join())
    assert ck.worker_error() is None
    rep = ck.coverage_report()
    table = rep["actions"]["table"]
    assert table["TmAbort"]["fired"] > 0
    assert table["RmPrepare_0"]["fired"] > 0
    assert rep["vacuity"]["dead_actions"] == []


def test_swarm_coverage_resume_does_not_double_count():
    # The restored carry's coverage vector is cumulative and the run before
    # the preempt already recorded it: the resumed run counts from it.
    # (The port has one process registry; the runs' deltas are compared.)
    before = _fired_total()
    ck = (MODEL_2PC3.checker().target_state_count(5_000)
          .spawn_swarm(seed=13, wave_steps=16, coverage=True, **PORT_KW).join())
    assert ck.worker_error() is None
    reference = _fired_total() - before
    assert reference > 0
    before = _fired_total()
    first = _stopped_after_first_wave(MODEL_2PC3.checker().target_state_count(5_000),
                                      seed=13, wave_steps=16, coverage=True, **PORT_KW)
    resumed = (MODEL_2PC3.checker().target_state_count(5_000)
               .spawn_swarm(seed=13, wave_steps=16, coverage=True,
                            resume_from=first.preempt_payload(), **PORT_KW).join())
    assert resumed.worker_error() is None
    assert _fired_total() - before == reference


def test_swarm_rejections():
    with pytest.raises(NotImplementedError):
        MODEL_2PC3.checker().symmetry().spawn_swarm(seed=1, device="cpu")

    def fn(prev, out):
        if prev is None:
            out.append(0)

    with pytest.raises(TypeError):
        FnModel(fn).checker().spawn_swarm(seed=1, device="cpu")
    ck = _stopped_after_first_wave(MODEL_2PC3.checker().target_state_count(2_000),
                                   seed=1, wave_steps=8, **PORT_KW)
    payload = ck.preempt_payload()
    # Resuming into another fleet shape is refused.
    with pytest.raises(ValueError, match="lanes"):
        MODEL_2PC3.checker().spawn_swarm(seed=1, wave_steps=8, lanes=128,
                                         sample_capacity=1 << 12, resume_from=payload,
                                         device="cpu")
    # ... as are the JAX package's swarm payloads and exhaustive payloads.
    with pytest.raises(ValueError, match="'swarm' does not match"):
        MODEL_2PC3.checker().spawn_swarm(seed=1, wave_steps=8, resume_from={
            **payload, "kind": "swarm"}, **PORT_KW)
    with pytest.raises(ValueError, match="frontier_seeds_from_payload"):
        MODEL_2PC3.checker().spawn_swarm(seed=1, wave_steps=8, resume_from={
            **payload, "kind": "gpu_bfs"}, **PORT_KW)


def test_swarm_pack_same_wave_fault_does_not_lose_completion():
    # Tenant A finishes in the same wave whose harvest faults for B: the
    # raised TenantFaultError discards that step's done list, so A must
    # stay reportable and keep counting as live.
    from stateright_tpu_torch.utils.faults import FaultSpec, TenantFaultError, inject

    eng = SwarmPackedEngine(MODEL_2PC3, lanes=64, wave_steps=64, max_trace_len=512,
                            sample_capacity=1 << 12, max_tenants=2, device="cpu")
    eng.admit("A", seed=11, target_state_count=100)  # stops in wave 1
    eng.admit("B", seed=12, target_state_count=1_000_000)
    with inject(FaultSpec("swarm.tenant.verdict", at=0, tenant="B")):
        with pytest.raises(TenantFaultError):
            eng.step()
    assert eng.faulted_keys() == ["B"]
    eng.drop("B")  # what a caller's blast-radius handler does
    assert eng.live_count() >= 1
    assert "A" in eng.step()
    eng.release("A")
    assert eng.free_slots() == 2


def test_swarm_wave_fault_seam_fires():
    from stateright_tpu_torch.utils.faults import DeviceWaveFault, FaultSpec, inject

    with inject(FaultSpec("swarm.wave", at=0)) as inj:
        ck = (MODEL_2PC3.checker().target_state_count(1_000)
              .spawn_swarm(seed=2, wave_steps=8, **PORT_KW))
        for h in ck.handles():
            h.join()
    assert inj.triggered("swarm.wave") == 1
    assert isinstance(ck.worker_error(), DeviceWaveFault)


def test_swarm_rejects_int32_overflowing_target():
    with pytest.raises(ValueError):
        MODEL_2PC3.checker().target_state_count(2**31).spawn_swarm(seed=1, **PORT_KW)


def test_swarm_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for call in (lambda: MODEL_2PC3.checker().target_state_count(100).spawn_swarm(seed=1),
                 lambda: SwarmPackedEngine(MODEL_2PC3, lanes=64)):
        with pytest.raises(RuntimeError, match="spawn_swarm runs on a CUDA device"):
            call()


def test_sample_capacity_rounds_up_to_a_tile():
    ck = (MODEL_2PC3.checker().target_state_count(500)
          .spawn_swarm(seed=1, wave_steps=8, lanes=64, sample_capacity=256,
                       device="cpu").join())
    assert ck.coverage_estimate()["sample_capacity"] == 2048
    out = io.StringIO()
    ck.report(WriteReporter(out))
    assert "sample_capacity 256 rounded up to 2048" in out.getvalue()


def test_simulation_backends_report_capabilities():
    from stateright_tpu_torch.checker.gpu_simulation import GpuSimulationChecker
    from stateright_tpu_torch.checker.simulation import SimulationChecker
    from stateright_tpu_torch.checker.swarm import SwarmChecker

    assert SwarmChecker.supports_preempt is True
    assert SwarmChecker.supports_packing is True
    for cls in (SimulationChecker, GpuSimulationChecker):
        assert cls.supports_preempt is False
        assert cls.supports_packing is False
        assert cls.packing_reason


def test_swarm_wave_cache_keys_on_model_identity():
    # ``aot_cache`` is accepted for the JAX API and caches nothing: two
    # engines of one namespace and one set of packed shapes but other
    # transitions (guarded vs unguarded ShardedKv) each walk their own model.
    unguarded = (ShardedKv(2, 2, 1, guarded=False).checker().target_state_count(50_000)
                 .spawn_swarm(seed=5, wave_steps=32, aot_cache="t-collide", lanes=64,
                              sample_capacity=1 << 12, device="cpu").join())
    assert "no torn writes" in unguarded._discoveries_fps
    guarded = (ShardedKv(2, 2, 1, guarded=True).checker().target_state_count(3_000)
               .spawn_swarm(seed=5, wave_steps=32, aot_cache="t-collide", lanes=64,
                            sample_capacity=1 << 12, device="cpu").join())
    assert guarded.engine._k is not unguarded.engine._k
    assert guarded.engine._k._model is guarded.model()
    assert unguarded.engine._k._model is unguarded.model()
    assert "no torn writes" not in guarded._discoveries_fps
    assert "no total tear" not in guarded._discoveries_fps


def test_sharded_kv_host_device_parity_guarded():
    # Guarded, the always-property holds: both engines explore the whole
    # space, with equal counts and discoveries.
    host = ShardedKv(2, 2, 1, guarded=True).checker().spawn_bfs().join()
    dev = (ShardedKv(2, 2, 1, guarded=True).checker()
           .spawn_gpu_bfs(device="cpu", frontier_capacity=1 << 8, table_capacity=1 << 12)
           .join())
    assert host.unique_state_count() == dev.unique_state_count() == 64
    assert sorted(host.discoveries()) == sorted(dev.discoveries()) == [
        "fully migrated", "saturated writes"]


def test_sharded_kv_vacuity_clean_coverage():
    ck = (ShardedKv(2, 2, 1, guarded=True).checker()
          .spawn_gpu_bfs(device="cpu", frontier_capacity=1 << 8, table_capacity=1 << 12,
                         coverage=True).join())
    vac = ck.coverage_report()["vacuity"]
    assert vac["dead_actions"] == []
    assert vac["unexercised_always"] == []
    assert vac["undiscovered_sometimes"] == []


def test_sharded_kv_retain_filters_consistently():
    m = ShardedKv(2, 2, 1, retain=("no total tear",))
    assert [p.name for p in m.properties()] == ["no total tear"]
    assert len(m.packed_conditions()) == 1
    assert len(m.packed_antecedents()) == 1
    with pytest.raises(ValueError):
        ShardedKv(2, 2, 1, retain=("no such property",)).properties()
    # The deep violation is reachable in the small configuration too, and
    # the retained model's run ends at that discovery.
    ck = (m.checker().target_state_count(200_000)
          .spawn_swarm(seed=5, wave_steps=32, **PORT_KW).join())
    assert ck.worker_error() is None
    path = ck.discoveries().get("no total tear")
    assert path is not None and all(path.last_state().torn)
