"""The port's check service (``stateright_tpu_torch/service/``) on the CPU,
against the JAX package: the twins of ``tests/test_service.py``'s
scheduling, preemption, namespace, budget, validation, retention and
run-scoping cases (its monitor and HTTP cases wait for the port of the
HTTP front end).

Every verdict is held to a JAX ``spawn_tpu_bfs`` reference of the same
configuration (``torch_service_refs.jax_ref``): a solo job to the
``wave_dedup="sort"`` run, a packed tenant to the ``"scatter"`` run (the
pack's lane order), on counts, depth, discovery names and path lengths and
the golden report with its paths. A JAX ``CheckService`` runs only where
the service's own output is compared: the keys of ``status()`` and
``result()``, and the refusals of the same bad submissions. Quanta are
stepped through ``CheckService(clock=ManualClock())`` while an injected
``wave.stall`` parks the running job, so no case depends on a wall-clock
race; every service closes in a ``finally``. Everything compared is an
integer or a string: the tolerance is 0.
"""

import pytest

from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.service import CheckService
from stateright_tpu_torch.service.jobs import CheckJob
from stateright_tpu_torch.telemetry import get_tracer, metrics_registry
from stateright_tpu_torch.telemetry.metrics import run_registries
from stateright_tpu_torch.utils.faults import FaultSpec, inject

from torch_service_refs import (
    SPAWN,
    UNIQUE,
    ManualClock,
    assert_verdict,
    golden,
    jax_ref,
    wait_for,
    wait_stalled,
)

# Solo services pin the engine, as the JAX reference pins its wave.
SOLO_SPAWN = dict(SPAWN, wave_kernel="fused")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX service counts into the JAX package's process-wide
    registry, some of whose counters that package's own tests read: leave
    it empty, as a fresh process has it."""
    yield
    from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

    jax_metrics_registry().reset()


def _service(**kw):
    kw.setdefault("quantum_s", 5.0)
    kw.setdefault("default_spawn", dict(SPAWN))
    kw.setdefault("device", "cpu")
    return CheckService(**kw)


def test_single_job_full_verdict():
    svc = _service()
    try:
        handle = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        result = handle.result(timeout=180)
    finally:
        svc.close()
    assert_verdict(result, jax_ref(3, "scatter"))
    assert result["properties_hold"] is True
    assert "Done." in result["report"]
    status = handle.status()
    assert status["state"] == "done"
    assert status["packed"] is True
    lat = status["latency"]
    assert lat["wall_s"] is not None and lat["wall_s"] > 0
    assert lat["queued_s"] is not None
    assert lat["ttfv_s"] is not None


def test_status_and_result_keys_match_jax():
    """The service's own output, key for key: one packed and one solo job
    on both services give the same ``status()`` and ``result()`` keys, and
    the same packing and preemptibility facts."""
    from stateright_tpu.service import CheckService as JaxCheckService

    def run(svc):
        packed = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        solo = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                          spawn={"checkpoint_every_chunks": 32})
        out = []
        for h in (packed, solo):
            r = h.result(timeout=300)
            st = h.status()
            out.append((set(st), set(st["latency"]), set(r), st["packed"],
                        st["packable"], st["preemptible"], st["packable_reason"]))
        return out

    jsvc = JaxCheckService(quantum_s=5.0, default_spawn=dict(SPAWN, aot_cache="t-tsvc"))
    try:
        theirs = run(jsvc)
    finally:
        jsvc.close()
    svc = _service()
    try:
        ours = run(svc)
    finally:
        svc.close()
    assert ours == theirs


def test_concurrent_jobs_preempt_and_stay_exact():
    """The time-slice path (packing off): the running job is preempted at
    its quantum for an equal-priority peer, both resume, and both verdicts
    equal the JAX reference and each other."""
    clock = ManualClock()
    svc = _service(quantum_s=1.0, default_spawn=dict(SOLO_SPAWN), packing=False, clock=clock)
    try:
        with inject(FaultSpec("wave.stall", at=2, stall_s=0.5)) as inj:
            h1 = svc.submit(model_name="2pc", model_args={"rm_count": 4})
            h2 = svc.submit(model_name="2pc", model_args={"rm_count": 4})
            wait_stalled(inj)
            clock.advance(2.0)  # h1's quantum is over, h2 waits
            r1 = h1.result(timeout=300)
            r2 = h2.result(timeout=300)
    finally:
        svc.close()
    ref = jax_ref(4, "sort")
    assert_verdict(r1, ref)
    assert_verdict(r2, ref)
    assert golden(r1["report"]) == golden(r2["report"])
    assert h1.status()["preempts"] == 1
    assert h2.status()["preempts"] == 0


def test_high_priority_job_overtakes_running_low():
    clock = ManualClock()
    svc = _service(quantum_s=1.0, default_spawn=dict(SOLO_SPAWN), clock=clock)
    try:
        with inject(FaultSpec("wave.stall", at=2, stall_s=0.5)) as inj:
            low = svc.submit(model_name="2pc", model_args={"rm_count": 4})
            wait_stalled(inj)
            high = svc.submit(model_name="2pc", model_args={"rm_count": 3}, priority=5)
            clock.advance(2.0)
            r_high = high.result(timeout=180)
            r_low = low.result(timeout=300)
    finally:
        svc.close()
    assert_verdict(r_high, jax_ref(3, "sort"))
    assert_verdict(r_low, jax_ref(4, "sort"))
    assert svc.job(high.job_id).finished_t <= svc.job(low.job_id).finished_t
    assert low.status()["preempts"] == 1


def test_second_job_of_a_namespace_builds_no_kernel():
    """The port's form of the JAX ``test_second_job_shares_aot_cache_zero
    _compiles``: a namespace shares the kernels' build, and each job's
    compile phase is its own graph captures. On the CPU there is neither a
    build nor a capture: both jobs record zero compile seconds and zero
    kernel builds, and equal verdicts (the card's twin,
    ``test_torch_service_cuda.py``, shows the first job's captures)."""
    svc = _service(default_spawn=dict(SOLO_SPAWN, aot_cache="t-ns"))
    try:
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                        spawn={"attribution": True})
        r1 = h1.result(timeout=180)
        h2 = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                        spawn={"attribution": True})
        r2 = h2.result(timeout=180)
    finally:
        svc.close()
    for h, r in ((h1, r1), (h2, r2)):
        attr = r["attribution"]
        assert attr["phases_s"].get("compile", 0.0) == 0.0
        assert r["compile_s_total"] == 0.0
        assert metrics_registry(h.job_id).snapshot()["gpu_bfs.kernel_builds"] == 0
        assert_verdict(r, jax_ref(3, "sort"))


def test_zoo_aliases_share_one_aot_namespace():
    svc = _service()
    try:
        ns = []
        for name in ("2pc", "two_phase_commit"):
            h = svc.submit(model_name=name, model_args={"rm_count": 3})
            ns.append(svc.job(h.job_id).aot_namespace)
            h.cancel()
    finally:
        svc.close()
    assert ns[0] == ns[1]


def test_cancel_running_job():
    svc = _service(default_spawn=dict(SOLO_SPAWN))
    try:
        with inject(FaultSpec("wave.stall", at=2, stall_s=0.3)) as inj:
            victim = svc.submit(model_name="2pc", model_args={"rm_count": 4})
            wait_stalled(inj)
            assert victim.cancel() is True
            with pytest.raises(RuntimeError, match="cancelled"):
                victim.result(timeout=120)
        assert victim.status()["state"] == "cancelled"
        after = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        assert_verdict(after.result(timeout=180), jax_ref(3, "sort"))
    finally:
        svc.close()


def test_per_tenant_hbm_budget():
    """A tenant's budget reaches the tiered store: the job completes
    exactly despite forced evictions, counted in its own registry."""
    from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib

    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
    svc = _service()
    try:
        handle = svc.submit(model_name="2pc", model_args={"rm_count": 4},
                            hbm_budget_mib=budget, tenant="small-tenant")
        result = handle.result(timeout=300)
    finally:
        svc.close()
    assert_verdict(result, jax_ref(4, "sort"))
    snap = metrics_registry(svc.job(handle.job_id).run_id).snapshot()
    assert snap.get("gpu_bfs.storage.evictions", 0) >= 1


# The same bad submissions to both services, refused with the same text.
BAD_SUBMISSIONS = [
    dict(model_name="nope"),
    dict(),
    dict(model_name="2pc", options={"bogus": 1}),
    dict(model_name="2pc", deadline_s="soon"),
    dict(model_name="2pc", hbm_budget_mib="lots"),
    dict(model_name="2pc", mode="nope"),
    dict(model_name="2pc", mode="swarm"),
    dict(model_name="2pc", mode="swarm", hbm_budget_mib=1.0),
    dict(model_name="2pc", mode="swarm", options={"symmetry": True}),
    dict(model_name="2pc", mode="swarm", options={"target_state_count": 2 ** 31}),
    dict(model_name="2pc", seed="x"),
    dict(model_name="2pc", spawn=[1]),
    dict(model_name="2pc", retry_policy={"max_retries": 1, "oops": 2}),
    dict(model_name="2pc", retry_policy=3),
]


@pytest.mark.parametrize("index", range(len(BAD_SUBMISSIONS)))
def test_submit_validation_matches_jax(index):
    from stateright_tpu.service import CheckService as JaxCheckService

    kwargs = BAD_SUBMISSIONS[index]
    messages = []
    for make in (lambda: JaxCheckService(default_spawn=dict(SPAWN)), lambda: _service()):
        svc = make()
        try:
            with pytest.raises(ValueError) as err:
                svc.submit(**kwargs)
            messages.append(str(err.value))
        finally:
            svc.close()
    assert messages[0] == messages[1]


def test_quantum_preempts_only_when_peer_would_be_picked():
    """The quantum-expiry guard compares real reschedule order: a
    finite-deadline job keeps the device over a deadline-less peer, while
    an earlier-deadline or higher-priority peer preempts."""
    svc = _service(quantum_s=0.1)
    try:
        def add(jid, seq, **kw):
            job = CheckJob(jid, lambda: None, seq=seq, **kw)
            svc._jobs[jid] = job
            return job

        # Park the scheduler's picks: the jobs added here never run.
        svc._admission_hold = True
        edf = add("edf", 0, deadline_s=60.0)
        edf.state = "running"
        plain = add("plain", 1)
        assert svc._should_preempt_for_peer(edf) is False
        add("sooner", 2, deadline_s=1.0)
        assert svc._should_preempt_for_peer(edf) is True
        plain.state = "running"
        del svc._jobs["edf"], svc._jobs["sooner"]
        add("low", 3, priority=-1)
        assert svc._should_preempt_for_peer(plain) is False
        add("high", 4, priority=1)
        assert svc._should_preempt_for_peer(plain) is True
    finally:
        svc.close()


def test_finished_job_retention():
    svc = _service()
    try:
        svc.max_finished_jobs = 1
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        r1 = h1.result(timeout=180)
        h2 = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        h2.result(timeout=180)
        wait_for(lambda: svc.job(h1.job_id) is None, 30, "the oldest job's eviction")
        assert svc.job(h2.job_id) is not None
        assert h1.job_id not in run_registries()
        assert h1.status()["state"] == "done"
        assert r1["unique"] == UNIQUE[3]
    finally:
        svc.close()


def test_run_scoped_registries_do_not_collide():
    """Two checkers in one process with distinct run ids each count their
    own waves and uniques; the default registry sees neither."""
    base = metrics_registry().snapshot().get("gpu_bfs.states_unique", 0)
    a = TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu", run_id="tsvc-iso-a",
                                               **SPAWN).join()
    b = TwoPhaseSys(4).checker().spawn_gpu_bfs(device="cpu", run_id="tsvc-iso-b",
                                               **SPAWN).join()
    snap_a = metrics_registry("tsvc-iso-a").snapshot()
    snap_b = metrics_registry("tsvc-iso-b").snapshot()
    assert snap_a["gpu_bfs.states_unique"] == UNIQUE[3]
    assert snap_b["gpu_bfs.states_unique"] == UNIQUE[4]
    assert snap_a["gpu_bfs.waves"] == a.waves
    assert a.metrics() is metrics_registry("tsvc-iso-a")
    assert b.metrics() is metrics_registry("tsvc-iso-b")
    assert metrics_registry().snapshot().get("gpu_bfs.states_unique", 0) == base


def test_run_scoped_tracer_stamps_spans():
    tracer = get_tracer("tsvc-stamp")
    with tracer.span("x.wave", foo=1):
        pass
    ev = [e for e in tracer.events() if e["name"] == "x.wave"][-1]
    assert ev["args"]["run_id"] == "tsvc-stamp"
    assert ev["args"]["foo"] == 1


def test_service_runs_on_cuda_or_raises():
    """``device=None`` is ``cuda``: without a CUDA device the constructor
    raises, and no scheduler thread starts."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; test_torch_service_cuda.py covers it")
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckService()
