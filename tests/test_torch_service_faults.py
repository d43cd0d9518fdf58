"""The chaos suite of the port's service on the CPU: the twins of
``tests/test_faults.py`` (deterministic fault injection through the
self-healing service layer) against the JAX package.

``classify_fault``, ``tenant_fault_of``, ``seeded_specs``, the
``RetryPolicy`` round trip and the fault-site set give exactly the JAX
outputs for the same inputs. Every fault class retries to the fault-free
verdict: a job that ran solo equals the JAX ``wave_dedup="sort"`` reference
(``torch_service_refs.jax_ref``) and a packed tenant the ``"scatter"`` one,
on counts, depth, discovery names and path lengths and the golden report.
A tenant that faulted out of a pack resumes solo from its lane-dropped
slice, in key order where the pack ran in lane order, so its paths may be
either order's: it is held to the counts, depth and discoveries (the JAX
package's pack and solo runs share one order; ROADMAP Queue 3). Budgets
bind from 2pc-4 in the port (its table is at least one 2,048-row tile), so
the host-probe, spill and pipeline cases run 2pc-4 where the JAX ones run
2pc-3. Stalls, quanta and timeouts are stepped through a ``ManualClock``
while an injected ``wave.stall`` parks the worker; every service closes in
a ``finally``. The tolerance is 0.
"""

import json
import os
import threading

import pytest

from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.checker.pipeline import PipelinePoisonedError
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.service import CheckService, JobHandle, QueueFullError, RetryPolicy
from stateright_tpu_torch.telemetry import metrics_registry, registry_hygiene_problems
from stateright_tpu_torch.utils import faults as port_faults
from stateright_tpu_torch.utils.faults import (
    FAULT_SITES,
    DeviceWaveFault,
    FaultInjector,
    FaultSpec,
    inject,
)

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

SOLO_SPAWN = dict(SPAWN, wave_kernel="fused")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    yield
    from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

    jax_metrics_registry().reset()


def _service(**kw):
    """A CPU service whose clock moves only when a test steps it (no
    quantum ends by itself, so no slice is preempted for a peer by the
    host's load) and whose retries wait no backoff."""
    kw.setdefault("quantum_s", 5.0)
    kw.setdefault("default_spawn", dict(SPAWN))
    kw.setdefault("device", "cpu")
    kw.setdefault("clock", ManualClock())
    kw.setdefault("retry_policy", RetryPolicy(backoff_s=0.0))
    return CheckService(**kw)


def _budget(rm):
    return min_admissible_hbm_budget_mib(TwoPhaseSys(rm), 16)


# -- the taxonomy, against the JAX package ------------------------------------


def test_fault_sites_are_the_jax_set():
    from stateright_tpu.utils.faults import FAULT_SITES as JAX_SITES

    assert FAULT_SITES == JAX_SITES


def _chains(f):
    """The same exception shapes, built from one package's fault module
    ``f`` and its pipeline error ``poisoned``."""
    def wrapped(inner):
        outer = RuntimeError("wrapped")
        outer.__cause__ = inner
        return outer

    def context(inner):
        try:
            raise inner
        except Exception:
            try:
                raise KeyError("later")
            except KeyError as e:
                return e

    return [
        lambda m, P: m.SpillFault(),
        lambda m, P: OSError(28, "No space left on device"),
        lambda m, P: OSError(5, "I/O error"),
        lambda m, P: wrapped(m.DeviceWaveFault()),
        lambda m, P: context(m.HostProbeFault()),
        lambda m, P: P(ValueError("worker died")),
        lambda m, P: wrapped(P(m.CheckpointWriteFault())),
        lambda m, P: ValueError("x"),
        lambda m, P: m.TenantFaultError("t-1", m.PackTenantFault()),
        lambda m, P: wrapped(m.TenantFaultError("t-2", ValueError("y"), pre_dispatch=True)),
        lambda m, P: m.SeedLoadFault(),
        lambda m, P: m.LivenessEvictFault(),
        lambda m, P: m.ConformanceBatchFault(),
        lambda m, P: m.WorkerDeathFault(),
        lambda m, P: None,
    ]


def test_classify_fault_and_tenant_fault_of_equal_jax():
    from stateright_tpu.checker.pipeline import PipelinePoisonedError as JaxPoisoned
    from stateright_tpu.utils import faults as jax_faults

    for make in _chains(None):
        ours = make(port_faults, PipelinePoisonedError)
        theirs = make(jax_faults, JaxPoisoned)
        assert port_faults.classify_fault(ours) == jax_faults.classify_fault(theirs)
        tf_ours = port_faults.tenant_fault_of(ours)
        tf_theirs = jax_faults.tenant_fault_of(theirs)
        assert (tf_ours is None) == (tf_theirs is None)
        if tf_ours is not None:
            assert (tf_ours.tenant_key, tf_ours.pre_dispatch) == (
                tf_theirs.tenant_key, tf_theirs.pre_dispatch)


@pytest.mark.parametrize("seed", [0, 7, 99, 1234])
def test_seeded_specs_equal_jax(seed):
    from stateright_tpu.utils import faults as jax_faults

    sites = sorted(FAULT_SITES - {"wave.stall"})
    for max_at in (1, 8, 100):
        ours = port_faults.seeded_specs(seed, sites, max_at=max_at)
        theirs = jax_faults.seeded_specs(seed, sites, max_at=max_at)
        assert [(s.site, s.at, s.count) for s in ours] == [
            (s.site, s.at, s.count) for s in theirs]


def test_injector_fires_at_exact_hit_indices():
    inj = FaultInjector(FaultSpec("device.wave", at=2))
    inj.fire("device.wave")
    inj.fire("device.wave")
    with pytest.raises(DeviceWaveFault):
        inj.fire("device.wave")
    inj.fire("device.wave")
    assert inj.hits("device.wave") == 4
    assert inj.triggered() == 1


def test_injector_tenant_filter_counts_only_matching_hits():
    inj = FaultInjector(FaultSpec("storage.host_probe", at=1, tenant="b"))
    inj.fire("storage.host_probe", tenant="a")
    inj.fire("storage.host_probe", tenant="b")
    with pytest.raises(Exception):
        inj.fire("storage.host_probe", tenant="b")
    assert inj.triggered() == 1


def test_spec_refusals():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("no.such.site")
    with pytest.raises(ValueError, match="stall_s"):
        FaultSpec("wave.stall")
    assert FaultSpec("wave.stall", stall_s=0.1).stall_s == 0.1
    assert FaultSpec("warmstart.seed_load").exc is port_faults.SeedLoadFault


def test_retry_policy_filter_backoff_and_dict_equal_jax():
    from stateright_tpu.service import RetryPolicy as JaxRetryPolicy

    kw = dict(max_retries=2, backoff_s=0.5, backoff_factor=2.0, max_backoff_s=10.0,
              retry_on={"device_wave"})
    p, q = RetryPolicy(**kw), JaxRetryPolicy(**kw)
    assert p.allows("device_wave", 0) and p.allows("device_wave", 1)
    assert not p.allows("device_wave", 2)
    assert not p.allows("spill", 0)
    assert [p.delay_s(i) for i in range(8)] == [q.delay_s(i) for i in range(8)]
    assert p.to_dict() == q.to_dict()
    assert RetryPolicy.from_dict(p.to_dict()).to_dict() == p.to_dict()
    with pytest.raises(ValueError, match="unknown retry-policy keys"):
        RetryPolicy.from_dict({"oops": 1})


# -- per-fault-class recovery ---------------------------------------------------


def test_device_wave_fault_retries_bit_identical():
    """The fault hits the pack's second shared wave: the non-attributable
    engine fault retries the job solo from scratch."""
    svc = _service()
    try:
        with inject(FaultSpec("device.wave", at=1)) as inj:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 3})
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["retries"] == 1
    assert st["faults"][0]["class"] == "device_wave"
    assert st["packable"] is False and "solo" in st["packable_reason"]
    assert_verdict(r, jax_ref(3, "sort"))


@pytest.mark.parametrize("site,klass", [("storage.host_probe", "host_probe"),
                                        ("storage.spill", "spill")])
def test_host_probe_and_spill_faults_retry_bit_identical(site, klass, tmp_path):
    extra = {}
    if site == "storage.spill":
        extra = {"host_budget_mib": 0.0001, "spill_dir": str(tmp_path / "spill")}
    svc = _service()
    try:
        with inject(FaultSpec(site, at=0)) as inj:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 4},
                           hbm_budget_mib=_budget(4), spawn=extra or None)
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["retries"] == 1, st["faults"]
    assert st["faults"][0]["class"] == klass
    assert_verdict(r, jax_ref(4, "sort"))


def test_checkpoint_write_fault_retries_bit_identical(tmp_path):
    svc = _service()
    try:
        with inject(FaultSpec("checkpoint.write", at=0)) as inj:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                           spawn={"checkpoint_path": str(tmp_path / "c.ckpt"),
                                  "checkpoint_every_chunks": 1})
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["retries"] == 1
    assert st["faults"][0]["class"] == "checkpoint_write"
    assert_verdict(r, jax_ref(3, "sort"))


def _step_past_stall(clock, deadline):
    """Steps the clock past the watchdog's deadline twice, a few polls
    apart: the first step may land before the scheduler's poll that sees
    the last drain's counts (a pet), the second is then seen idle."""
    clock.advance(2 * deadline)
    threading.Event().wait(0.05)
    clock.advance(2 * deadline)


def test_stall_watchdog_auto_preempts_and_recovers():
    """A wedged drain loop (an injected one-second stall) trips the stall
    watchdog once the clock passes its deadline; the default hook
    auto-preempts, the job suspends at its next boundary, resumes and
    finishes exactly."""
    clock = ManualClock()
    svc = _service(packing=False, stall_deadline_s=30.0, quantum_s=1e6, clock=clock)
    try:
        with inject(FaultSpec("wave.stall", at=2, stall_s=1.0)) as inj:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 3})
            wait_stalled(inj)
            _step_past_stall(clock, 30.0)
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["stall_preempts"] == 1
    assert st["preempts"] >= 1
    assert_verdict(r, jax_ref(3, "sort"))


def test_pipeline_worker_death_fault_retries_bit_identical():
    svc = _service()
    try:
        with inject(FaultSpec("pipeline.worker", at=1)) as inj:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 4},
                           hbm_budget_mib=_budget(4), spawn={"async_pipeline": True})
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["retries"] == 1
    assert st["faults"][0]["class"] == "pipeline_worker"
    assert_verdict(r, jax_ref(4, "sort"))


def test_retry_resumes_from_snapshot_not_scratch():
    """A fault on a resumed slice hands the pre-slice payload back, so the
    retry resumes from the last good boundary. Driven through
    ``_run_slice`` on this thread with the scheduler parked."""
    svc = _service(packing=False, quantum_s=30.0)
    svc._closing.set()
    svc._wake()
    svc._scheduler.join(timeout=30)
    svc._closing.clear()
    try:
        h = svc.submit(model_name="2pc", model_args={"rm_count": 4})
        job = svc.job(h.job_id)
        with inject(FaultSpec("wave.stall", at=2, stall_s=0.2)) as inj:
            t = threading.Thread(target=svc._run_slice, args=(job,))
            t.start()
            wait_stalled(inj)
            svc._active_checker.request_preempt()
            t.join(timeout=180)
        assert job.state == "suspended", job.state
        mid_unique = job.payload["unique_count"]
        assert 0 < mid_unique < UNIQUE[4]
        with inject(FaultSpec("device.wave", at=0)):
            svc._run_slice(job)
        assert job.state == "faulted", job.state
        assert job.payload is not None
        assert job.payload["unique_count"] == mid_unique
        job.not_before = None
        svc._run_slice(job)
        assert job.state == "done", (job.state, job.error)
        assert job.retries == 1
        assert_verdict(job.result, jax_ref(4, "sort"))
    finally:
        svc.close()


def test_quarantine_after_exhausted_retries():
    svc = _service()
    try:
        with inject(FaultSpec("device.wave", at=0, count=10 ** 6)):
            h = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                           retry_policy=RetryPolicy(max_retries=1, backoff_s=0.0))
            with pytest.raises(RuntimeError, match="quarantined"):
                h.result(timeout=300)
    finally:
        svc.close()
    st = h.status()
    assert st["state"] == "quarantined"
    assert st["retries"] == 1
    assert len(st["faults"]) == 2
    assert st["flight"]["fault_class"] == "device_wave"
    assert "DeviceWaveFault" in st["flight"]["traceback"]
    assert st["error_traceback"] is not None


def test_no_retry_policy_fails_first_fault_with_traceback():
    svc = _service(retry_policy=None)
    try:
        with inject(FaultSpec("device.wave", at=0)):
            h = svc.submit(model_name="2pc", model_args={"rm_count": 3})
            with pytest.raises(RuntimeError, match="failed"):
                h.result(timeout=300)
    finally:
        svc.close()
    st = h.status()
    assert st["state"] == "failed"
    assert st["retries"] == 0
    assert "DeviceWaveFault" in st["error_traceback"]
    assert "Traceback" in st["error_traceback"]
    assert st["flight"]["traceback"] == st["error_traceback"]


# -- pack-local blast radius ----------------------------------------------------


def test_pack_fault_blast_radius_is_one_tenant():
    svc = _service()
    jids = ("tsf-blast-0", "tsf-blast-1", "tsf-blast-2", "tsf-blast-3")
    try:
        with inject(FaultSpec("pack.tenant.verdict", tenant="tsf-blast-2", at=0)) as inj:
            handles = {jid: svc.submit(model_name="2pc", model_args={"rm_count": 3},
                                       job_id=jid) for jid in jids}
            results = {jid: h.result(timeout=300) for jid, h in handles.items()}
    finally:
        svc.close()
    assert inj.triggered() == 1
    stats = {jid: h.status() for jid, h in handles.items()}
    faulted = stats.pop("tsf-blast-2")
    assert faulted["retries"] == 1
    assert faulted["faults"][0]["class"] == "pack_tenant"
    assert_verdict(results["tsf-blast-2"], jax_ref(3, "scatter"), report=False)
    for jid, st in stats.items():
        assert st["preempts"] == 0, (jid, st)
        assert st["retries"] == 0 and not st["faults"], (jid, st)
        assert st["packed"] is True, jid
        assert_verdict(results[jid], jax_ref(3, "scatter"))


def test_two_tenants_faulting_same_wave_both_drop_no_livelock():
    svc = _service()
    jids = ("tsf-multi-0", "tsf-multi-1", "tsf-multi-2")
    try:
        with inject(FaultSpec("pack.tenant.verdict", tenant="tsf-multi-0", at=0),
                    FaultSpec("pack.tenant.verdict", tenant="tsf-multi-1", at=0)) as inj:
            handles = {jid: svc.submit(model_name="2pc", model_args={"rm_count": 3},
                                       job_id=jid) for jid in jids}
            results = {jid: h.result(timeout=120) for jid, h in handles.items()}
    finally:
        svc.close()
    assert inj.triggered() == 2
    for jid, r in results.items():
        assert_verdict(r, jax_ref(3, "scatter"), report=(jid == "tsf-multi-2"))
    stats = {jid: h.status() for jid, h in handles.items()}
    assert stats["tsf-multi-0"]["retries"] == 1
    assert stats["tsf-multi-1"]["retries"] == 1
    assert stats["tsf-multi-2"]["retries"] == 0
    assert stats["tsf-multi-2"]["preempts"] == 0


def test_pack_engine_fault_retries_all_members_solo():
    svc = _service()
    try:
        with inject(FaultSpec("device.wave", at=1)) as inj:
            handles = [svc.submit(model_name="2pc", model_args={"rm_count": 3})
                       for _ in range(2)]
            results = [h.result(timeout=300) for h in handles]
    finally:
        svc.close()
    assert inj.triggered() == 1
    assert any(h.status()["retries"] >= 1 for h in handles)
    for h, r in zip(handles, results):
        st = h.status()
        if st["retries"]:
            assert st["packable"] is False
            assert "solo" in st["packable_reason"]
            # Retried solo from the pre-admit snapshot (scratch).
            assert_verdict(r, jax_ref(3, "sort"))
        else:
            assert_verdict(r, jax_ref(3, "scatter"))


# -- durable recovery -----------------------------------------------------------


def _journal(path):
    with open(os.path.join(path, "journal.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _schema(records):
    """Each journal event's keys, and a finished result's keys."""
    out = {}
    for rec in records:
        keys = set(rec)
        if rec.get("ev") == "state" and "result" in rec:
            keys |= {f"result.{k}" for k in rec["result"]}
        out.setdefault((rec["ev"], rec.get("state")), set()).update(keys)
    return out


def test_durable_recovery_resumes_bit_identical(tmp_path):
    """Kill and recover: a finished job's record comes back from the
    journal, a custom-model job is surfaced ``durable: false``, and a job
    closed mid-run resumes from its durable checkpoint to the fault-free
    verdict. The journal's records have the JAX service's schema."""
    d = str(tmp_path / "svc")
    svc = _service(service_dir=d, default_spawn=dict(SOLO_SPAWN))
    try:
        done = svc.submit(model_name="2pc", model_args={"rm_count": 3}, job_id="tsf-rec-done")
        r_done = done.result(timeout=300)
        assert svc.job("tsf-rec-done").durable is True
        custom = svc.submit(model=TwoPhaseSys(3), job_id="tsf-rec-custom")
        assert custom.status()["durable"] is False
        custom.result(timeout=300)
        with inject(FaultSpec("wave.stall", at=2, stall_s=0.3)) as inj:
            svc.submit(model_name="2pc", model_args={"rm_count": 4}, job_id="tsf-rec-mid")
            wait_stalled(inj)
            out = svc.close()
    finally:
        svc.close()
    assert out["closed"] is True
    assert svc.job("tsf-rec-mid").state == "suspended"
    assert os.path.exists(os.path.join(d, "jobs", "tsf-rec-mid.ckpt"))
    ours = _journal(d)

    svc2 = CheckService.recover(d, quantum_s=5.0, default_spawn=dict(SOLO_SPAWN), device="cpu")
    try:
        j_done = svc2.job("tsf-rec-done")
        assert j_done.state == "done"
        assert j_done.result["unique"] == r_done["unique"]
        assert golden(j_done.result["report"]) == golden(r_done["report"])
        r_mid = JobHandle(svc2.job("tsf-rec-mid"), svc2).result(timeout=300)
    finally:
        svc2.close()
    assert_verdict(r_mid, jax_ref(4, "sort"))
    assert_verdict(r_done, jax_ref(3, "sort"))

    # The JAX service's journal of the same finished job.
    from stateright_tpu.service import CheckService as JaxCheckService

    jd = str(tmp_path / "jax-svc")
    jsvc = JaxCheckService(service_dir=jd, quantum_s=5.0, warm_start=False,
                           default_spawn=dict(SPAWN, aot_cache="t-tsf"))
    try:
        jsvc.submit(model_name="2pc", model_args={"rm_count": 3},
                    job_id="tsf-jax-done").result(timeout=300)
    finally:
        jsvc.close()
    theirs = _schema(_journal(jd))
    mine = _schema(ours)
    for key, keys in theirs.items():
        assert mine.get(key) == keys, key


def test_recover_surfaces_lost_nondurable_job(tmp_path):
    d = str(tmp_path / "svc")
    os.makedirs(os.path.join(d, "jobs"), exist_ok=True)
    with open(os.path.join(d, "journal.jsonl"), "w") as f:
        f.write(json.dumps({"ev": "submit", "t": 0.0, "job_id": "tsf-lost-1",
                            "durable": False, "spec": None}) + "\n")
    svc = CheckService.recover(d, default_spawn=dict(SPAWN), device="cpu")
    try:
        j = svc.job("tsf-lost-1")
        assert j is not None and j.state == "failed"
        assert "durable: false" in j.error
    finally:
        svc.close()


def test_recover_bypasses_admission_bound(tmp_path):
    d = str(tmp_path / "svc")
    os.makedirs(os.path.join(d, "jobs"), exist_ok=True)
    with open(os.path.join(d, "journal.jsonl"), "w") as f:
        for i in range(3):
            f.write(json.dumps({
                "ev": "submit", "t": 0.0, "job_id": f"tsf-rb-{i}", "durable": True,
                "spec": {"model_name": "2pc", "model_args": {"rm_count": 3}},
            }) + "\n")
    svc = CheckService.recover(d, max_queued_jobs=1, default_spawn=dict(SPAWN),
                               quantum_s=5.0, device="cpu")
    try:
        for i in range(3):
            job = svc.job(f"tsf-rb-{i}")
            assert job is not None and job.state != "failed", (i, job and job.error)
        with pytest.raises(QueueFullError):
            svc.submit(model_name="2pc", model_args={"rm_count": 3})
        for i in range(3):
            JobHandle(svc.job(f"tsf-rb-{i}"), svc).cancel()
    finally:
        svc.close()


# -- graceful degradation -------------------------------------------------------


def test_timeout_on_nonpreemptible_backend_keeps_finished_verdict():
    clock = ManualClock()
    svc = CheckService(quantum_s=30.0, packing=False, spawn_method="spawn_bfs",
                       default_spawn={}, clock=clock, device="cpu")
    try:
        h = svc.submit(model_name="2pc", model_args={"rm_count": 3}, timeout_s=1.0)
        wait_for(lambda: svc.job(h.job_id).state == "running", 60, "the slice")
        clock.advance(5.0)
        r = h.result(timeout=300)
    finally:
        svc.close()
    assert r["unique"] == UNIQUE[3]
    assert h.status()["state"] == "done"
    assert h.status()["preemptible"] is False


def test_bounded_admission_queue():
    svc = _service(max_queued_jobs=2, quantum_s=0.5)
    try:
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 4})
        h2 = svc.submit(model_name="2pc", model_args={"rm_count": 4})
        with pytest.raises(QueueFullError, match="queue full"):
            svc.submit(model_name="2pc", model_args={"rm_count": 4})
        h1.cancel()
        h2.cancel()
    finally:
        svc.close()


def test_timeout_fails_with_partial_progress_evidence():
    clock = ManualClock()
    svc = _service(packing=False, quantum_s=1e6, clock=clock)
    try:
        with inject(FaultSpec("wave.stall", at=2, stall_s=0.3)) as inj:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 5}, timeout_s=1.0)
            wait_stalled(inj)
            clock.advance(2.0)
            with pytest.raises(RuntimeError, match="timeout"):
                h.result(timeout=300)
    finally:
        svc.close()
    st = h.status()
    assert st["state"] == "failed"
    flight = st["flight"]
    assert flight["reason"] == "timeout"
    assert flight["partial_progress"]["unique_state_count"] > 0
    assert flight["resumable_payload"] is True


# -- pipeline poison hygiene ----------------------------------------------------


def test_pipeline_poison_typed_error_no_hang_no_held_lock():
    checker = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=16, table_capacity=1 << 12,
        hbm_budget_mib=_budget(4), async_pipeline=True, max_drain_waves=1,
    )
    with inject(FaultSpec("pipeline.worker", at=1)) as inj:
        for t in checker.handles():
            t.join(timeout=180)
            assert not t.is_alive(), "worker hung after poisoning"
    assert inj.triggered() == 1
    err = checker.worker_error()
    chain, e = [], err
    while e is not None:
        chain.append(e)
        e = e.__cause__ or e.__context__
    assert any(isinstance(x, PipelinePoisonedError) for x in chain), chain
    assert port_faults.classify_fault(err) == "pipeline_worker"
    poisoned = next(x for x in chain if isinstance(x, PipelinePoisonedError))
    assert poisoned.cause is not None
    assert checker._tier._fence.acquire(timeout=2.0)
    checker._tier._fence.release()
    assert not checker._pipe._thread.is_alive()


def test_fault_metric_families_are_hygiene_clean():
    reg = metrics_registry()
    for cls in ("host_probe", "spill", "pipeline_worker", "device_wave",
                "checkpoint_write", "pack_tenant", "seed_load", "unknown"):
        reg.counter(f"fault.by_class.{cls}")
    for site in sorted(FAULT_SITES):
        reg.counter(f"fault.injected.{site}")
    reg.counter("service.recovery.jobs_resumed")
    problems = [p for p in registry_hygiene_problems(reg)
                if "fault" in p or "retry" in p or "service" in p]
    assert problems == []


def test_close_reports_stuck_scheduler():
    svc = _service()
    svc._closing.set()
    svc._wake()
    svc._scheduler.join(timeout=30)
    release = threading.Event()
    svc._scheduler = threading.Thread(target=release.wait, daemon=True)
    svc._scheduler.start()
    before = metrics_registry().snapshot().get("service.close.stuck", 0)
    out = svc.close(timeout=0.1)
    assert out == {"closed": False, "stuck": True}
    assert metrics_registry().snapshot().get("service.close.stuck", 0) == before + 1
    release.set()


# -- the device liveness edge store under adversity ----------------------------

_LIVE_SPAWN = {
    "frontier_capacity": 16,
    "table_capacity": 2048,
    "liveness": "device",
    "edge_log_capacity": 64,
}


def _live_graph():
    from torch_host_fixtures import PackedDGraph

    return PackedDGraph([2 * i for i in range(24)] + [2], [0, 46])


@pytest.fixture(scope="module")
def live_ref():
    """The JAX device-liveness run of the same graph and knobs."""
    import io

    from stateright_tpu import WriteReporter as JaxWriteReporter
    from test_device_liveness import PackedDGraph as JaxPackedDGraph

    c = JaxPackedDGraph([2 * i for i in range(24)] + [2], [0, 46]).checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", **_LIVE_SPAWN).join()
    out = io.StringIO()
    c.report(JaxWriteReporter(out))
    return {
        "unique": c.unique_state_count(),
        "discoveries": set(c.discoveries()),
        "verdict": c.liveness_report()["outcomes"]["odd"]["verdict"],
        "golden": golden(out.getvalue()),
    }


def _check_live(r, ref):
    assert r["unique"] == ref["unique"]
    assert set(r["discoveries"]) == ref["discoveries"]
    assert r["liveness"]["outcomes"]["odd"]["verdict"] == ref["verdict"] == "counterexample"
    assert golden(r["report"]) == ref["golden"]


def test_liveness_edge_evict_fault_retries_bit_identical(live_ref):
    svc = _service()
    try:
        with inject(FaultSpec("liveness.edge_evict", at=1)) as inj:
            h = svc.submit(_live_graph, spawn=dict(_LIVE_SPAWN))
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["retries"] == 1
    assert st["faults"][0]["class"] == "liveness_evict"
    assert st["liveness_mode"] == "device"
    _check_live(r, live_ref)


def test_liveness_survives_stall_preempt_resume(live_ref):
    clock = ManualClock()
    svc = _service(packing=False, stall_deadline_s=30.0, quantum_s=1e6, clock=clock)
    try:
        with inject(FaultSpec("wave.stall", at=2, stall_s=1.0)) as inj:
            h = svc.submit(_live_graph, spawn=dict(_LIVE_SPAWN))
            wait_stalled(inj)
            _step_past_stall(clock, 30.0)
            r = h.result(timeout=300)
    finally:
        svc.close()
    assert inj.triggered() == 1
    st = h.status()
    assert st["stall_preempts"] == 1
    assert st["preempts"] >= 1
    _check_live(r, live_ref)


def test_liveness_metric_family_is_hygiene_clean():
    reg = metrics_registry()
    reg.counter("fault.by_class.liveness_evict")
    reg.counter("fault.injected.liveness.edge_evict")
    reg.counter("liveness.inconclusive")
    reg.counter("liveness.skipped_crashed_run")
    assert [p for p in registry_hygiene_problems(reg) if "liveness" in p] == []
