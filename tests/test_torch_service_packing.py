"""The port's service over its packed engines and its conformance plane, on
the CPU, against the JAX package: the service cases of
``tests/test_packed_tenancy.py`` (packing, joining a live pack, a full pack
yielding, the honest non-packable reasons, admission of budgets),
``tests/test_swarm.py`` (swarm jobs packing, their refusals, a tenant's
blast radius) and ``tests/test_conformance.py`` (conformance jobs: the
verdicts, the refusals, a fault retried, journal recovery, preempt and
resume).

Packed exhaustive tenants are held to the JAX ``wave_dedup="scatter"``
reference (the pack's lane order), swarm jobs to the JAX solo swarm run at
the service's fleet shape (the port draws JAX's threefry walks), and
conformance jobs to the JAX ``ConformanceChecker``'s report on the same
upload. Every service closes in a ``finally``. The tolerance is 0.
"""

import json
import os
import threading
import time

import pytest

from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.conformance import decode_lines
from stateright_tpu_torch.conformance.audit import pack_history
from stateright_tpu_torch.conformance.wire import WireRefusal
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.service import CheckService, JobHandle, RetryPolicy
from stateright_tpu_torch.storage import max_table_rows_for_budget
from stateright_tpu_torch.telemetry import (
    TenantInstruments,
    WaveInstruments,
    metrics_registry,
    registry_hygiene_problems,
)
from stateright_tpu_torch.telemetry.metrics import MetricsRegistry
from stateright_tpu_torch.utils.faults import FaultSpec, inject

from torch_service_refs import (
    SPAWN,
    UNIQUE,
    ManualClock,
    assert_verdict,
    golden,
    jax_ref,
    wait_for,
)

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_CORPUS = os.path.join(REPO_DIR, "examples", "conformance_corpus.jsonl")
# A small fleet shape for the swarm jobs (the service's default is 512 lanes
# of 256 steps; the JAX reference compiles whichever it is given).
SWARM_SPAWN = dict(lanes=64, wave_steps=64, max_trace_len=128, sample_capacity=1 << 12,
                   sample_stride=1)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    yield
    from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

    jax_metrics_registry().reset()


def _service(**kw):
    kw.setdefault("quantum_s", 5.0)
    kw.setdefault("default_spawn", dict(SPAWN))
    kw.setdefault("default_swarm_spawn", dict(SWARM_SPAWN))
    kw.setdefault("device", "cpu")
    return CheckService(**kw)


# -- tenant-packed exhaustive jobs ---------------------------------------------


def test_service_packs_same_shape_jobs():
    svc = _service()
    try:
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        h2 = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        r1 = h1.result(timeout=180)
        r2 = h2.result(timeout=180)
    finally:
        svc.close()
    for h, r in ((h1, r1), (h2, r2)):
        assert_verdict(r, jax_ref(3, "scatter"))
        st = h.status()
        assert st["packed"] is True
        assert st["packable"] is True and st["packable_reason"] is None
        assert st["preemptible"] is True
        assert st["preempts"] == 0
        assert st["slices"] == 1
        assert st["latency"]["ttfv_s"] is not None
    snap = metrics_registry(h1.job_id).snapshot()
    assert snap.get("pack.tenant.states_unique", 0) + 1 >= UNIQUE[3]
    assert snap.get("pack.tenant.joins") == 1


def test_service_join_live_pack():
    svc = _service()
    try:
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 5})
        wait_for(lambda: svc.job(h1.job_id).state == "running", 60, "the pack")
        h2 = svc.submit(model_name="2pc", model_args={"rm_count": 5})
        r1 = h1.result(timeout=300)
        r2 = h2.result(timeout=300)
    finally:
        svc.close()
    assert r1["unique"] == r2["unique"] == UNIQUE[5]
    assert golden(r1["report"]) == golden(r2["report"])
    s2 = h2.status()
    assert s2["packed"] is True
    assert s2["slices"] == 1 and s2["preempts"] == 0


def test_full_pack_yields_to_higher_priority_same_shape():
    """A full pack counts a higher-priority same-shape arrival as a
    contender once its quantum is over: the members are lane-dropped and
    resume into later packs, still exact."""
    clock = ManualClock()
    svc = _service(quantum_s=1.0, max_pack_tenants=2, clock=clock)
    try:
        lows = [svc.submit(model_name="2pc", model_args={"rm_count": 5}) for _ in range(2)]
        wait_for(lambda: all(svc.job(h.job_id).state == "running" for h in lows), 60,
                 "the full pack")
        high = svc.submit(model_name="2pc", model_args={"rm_count": 4}, priority=5)
        clock.advance(2.0)
        wait_for(lambda: svc.job(high.job_id).state != "queued", 120, "the high job")
        lows_running = all(svc.job(h.job_id).finished_t is None for h in lows)
        r_high = high.result(timeout=300)
        r_lows = [h.result(timeout=300) for h in lows]
    finally:
        svc.close()
    assert r_high["unique"] == UNIQUE[4]
    assert_verdict(r_high, jax_ref(4, "scatter"))
    for r in r_lows:
        assert r["unique"] == UNIQUE[5]
    if lows_running:
        assert sum(svc.job(h.job_id).preempts for h in lows) >= 1


def test_service_surfaces_non_packable_reasons():
    svc = _service()
    try:
        for kwargs, needle in [
            (dict(spawn={"attribution": True}), "spawn overrides"),
            (dict(options={"symmetry": True}), "symmetry"),
            (dict(options={"target_state_count": 50}), "target_state_count"),
        ]:
            h = svc.submit(model_name="2pc", model_args={"rm_count": 3}, **kwargs)
            st = h.status()
            assert st["packable"] is False
            assert needle in st["packable_reason"], st["packable_reason"]
            h.cancel()
    finally:
        svc.close()
    svc2 = _service(default_spawn=dict(SPAWN, expand_fps=False))
    try:
        h = svc2.submit(model_name="2pc", model_args={"rm_count": 3})
        st = h.status()
        assert st["packable"] is False
        assert "default_spawn" in st["packable_reason"]
        h.cancel()
    finally:
        svc2.close()


def test_service_non_preemptible_backend_surfaced():
    svc = _service(spawn_method="spawn_bfs", packing=False)
    svc.default_spawn = {}
    try:
        h = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        assert h.result(timeout=180)["unique"] == UNIQUE[3]
        assert h.status()["preemptible"] is False
    finally:
        svc.close()


def test_budget_rejected_at_admission():
    svc = _service()
    try:
        with pytest.raises(ValueError, match="rejected at admission"):
            svc.submit(model_name="2pc", model_args={"rm_count": 4}, hbm_budget_mib=0.001)
        budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
        h = svc.submit(model_name="2pc", model_args={"rm_count": 4}, hbm_budget_mib=budget)
        job = svc.job(h.job_id)
        assert job.derived_table_capacity == max_table_rows_for_budget(budget)
        assert job.packable is False
        h.cancel()
    finally:
        svc.close()


def test_tenant_metric_family_hygiene():
    reg = MetricsRegistry()
    TenantInstruments("pack", registry=reg)
    wi = WaveInstruments("pack", registry=reg)
    wi.bucket_dispatch(16)
    assert registry_hygiene_problems(reg) == []


# -- swarm jobs -----------------------------------------------------------------


def _jax_swarm(seed, target):
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    return JaxTwoPhaseSys(3).checker().target_state_count(target).spawn_swarm(
        seed=seed, **SWARM_SPAWN).join()


def _assert_swarm(r, jax_ck):
    assert r["states"] == jax_ck.state_count()
    assert r["unique"] == jax_ck.unique_state_count()
    assert r["max_depth"] == jax_ck.max_depth()
    assert sorted(r["discoveries"]) == sorted(jax_ck._discoveries_fps)


def test_service_swarm_jobs_pack_and_match_solo():
    svc = _service(quantum_s=10.0)
    try:
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                        options={"target_state_count": 10_000}, mode="swarm", seed=21)
        h2 = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                        options={"target_state_count": 10_000}, mode="swarm", seed=22)
        r1 = h1.result(timeout=180)
        r2 = h2.result(timeout=180)
    finally:
        svc.close()
    s1, s2 = h1.status(), h2.status()
    assert s1["mode"] == "swarm" and s1["seed"] == 21
    assert s1["packable"] and s2["packable"]
    assert s1["packed"] or s2["packed"]
    assert s1["preemptible"] is True
    _assert_swarm(r1, _jax_swarm(21, 10_000))
    _assert_swarm(r2, _jax_swarm(22, 10_000))


def test_service_swarm_classification_and_rejections():
    svc = _service()
    try:
        for kwargs in (dict(mode="warm"), dict(mode="swarm", hbm_budget_mib=64),
                       dict(mode="swarm", options={"symmetry": True}), dict(mode="swarm"),
                       dict(mode="swarm", options={"target_state_count": 2 ** 31})):
            with pytest.raises(ValueError):
                svc.submit(model_name="2pc", **kwargs)
        svc.submit(model_name="2pc", mode="swarm", timeout_s=30.0).cancel()
        h = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                       options={"target_state_count": 2_000},
                       spawn={"lanes": 32, "sample_capacity": 1 << 10}, mode="swarm", seed=1)
        st = h.status()
        assert st["packable"] is False
        assert "spawn overrides" in st["packable_reason"]
        assert h.result(timeout=120)["states"] > 0
    finally:
        svc.close()


def test_swarm_pack_tenant_fault_blast_radius():
    """A per-tenant harvest fault drops only that tenant, which retries
    from its wave boundary to the exact solo verdict."""
    svc = _service(quantum_s=10.0)
    try:
        with inject(FaultSpec("swarm.tenant.verdict", at=0, tenant="tsp-fault-job")):
            h1 = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                            options={"target_state_count": 10_000}, mode="swarm", seed=21,
                            job_id="tsp-fault-job")
            h2 = svc.submit(model_name="2pc", model_args={"rm_count": 3},
                            options={"target_state_count": 10_000}, mode="swarm", seed=22)
            r1 = h1.result(timeout=180)
            r2 = h2.result(timeout=180)
    finally:
        svc.close()
    assert h1.status()["retries"] >= 1
    assert h2.status()["retries"] == 0
    _assert_swarm(r1, _jax_swarm(21, 10_000))
    _assert_swarm(r2, _jax_swarm(22, 10_000))


# -- conformance jobs ------------------------------------------------------------


def _seed_lines():
    with open(SEED_CORPUS, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    records, refusals = decode_lines(lines)
    assert not refusals
    return lines, records


@pytest.fixture(scope="module")
def jax_conformance():
    """The JAX ``ConformanceChecker``'s report on the seed corpus, with and
    without the host parity gate."""
    from stateright_tpu.conformance import ConformanceChecker as JaxConformanceChecker
    from stateright_tpu.conformance import decode_lines as jax_decode_lines
    from stateright_tpu.service.zoo import default_zoo as jax_default_zoo

    lines, _ = _seed_lines()
    records, _ = jax_decode_lines(lines)
    out = {}
    for parity in (False, True):
        ck = JaxConformanceChecker(records, jax_default_zoo(), parity=parity)
        deadline = time.monotonic() + 300
        while not ck.is_done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ck.worker_error() is None
        out[parity] = ck.conformance_report()["records"]
    return out


def test_service_conformance_job_end_to_end(tmp_path, jax_conformance):
    lines, records = _seed_lines()
    svc = _service(service_dir=str(tmp_path / "svc"), warm_start=False)
    try:
        h = svc.submit(conformance=lines, spawn={"parity": True})
        res = h.result(timeout=300)
        conf = res["conformance"]
        assert conf["records"] == jax_conformance[True]
        n_refuse = sum(1 for r in records
                       if r["kind"] == "history" and pack_history(r)[1] is not None)
        assert conf["refusals"] == n_refuse > 0
        assert conf["divergences"] >= 1
        st = h.status()
        assert st["mode"] == "conformance"
        assert st["packable"] is False
        svc.corpus_store.save("seed", lines)
        assert svc.corpus_store.list() == ["seed"]
        with pytest.raises(ValueError, match="invalid corpus name"):
            svc.corpus_store.load("../../etc/passwd")
    finally:
        svc.close()


def test_service_conformance_rejects_model_surface():
    from stateright_tpu.service import CheckService as JaxCheckService

    bad = [dict(conformance=["{}"], model_name="2pc", mode="conformance"),
           dict(conformance=["{}"], spawn={"resume_from": "/tmp/evil"}),
           dict(conformance=['{"v": 1, "kind": "trace"}'])]
    svc = _service(warm_start=False)
    jsvc = JaxCheckService(warm_start=False)
    try:
        for kwargs in bad:
            with pytest.raises(ValueError) as ours:
                svc.submit(**kwargs)
            with pytest.raises(ValueError) as theirs:
                jsvc.submit(**kwargs)
            assert str(ours.value) == str(theirs.value)
        with pytest.raises(WireRefusal):
            svc.submit(conformance=['{"v": 1, "kind": "trace"}'])
    finally:
        svc.close()
        jsvc.close()


def test_service_conformance_fault_retry_bit_identical(tmp_path, jax_conformance):
    lines, _ = _seed_lines()
    svc = _service(service_dir=str(tmp_path / "svc"), warm_start=False)
    try:
        with inject(FaultSpec("conformance.batch", at=0)):
            h = svc.submit(conformance=lines,
                           retry_policy=RetryPolicy(max_retries=2, backoff_s=0.01))
            res = h.result(timeout=300)
    finally:
        svc.close()
    assert h.status()["retries"] >= 1
    assert h.status()["faults"][0]["class"] == "conformance_batch"
    assert res["conformance"]["records"] == jax_conformance[False]


def test_service_conformance_journal_recovery(tmp_path, jax_conformance):
    lines, _ = _seed_lines()
    d = str(tmp_path / "svc")
    os.makedirs(os.path.join(d, "jobs"), exist_ok=True)
    spec = {"mode": "conformance", "records": lines, "spawn": {"parity": False},
            "priority": 0, "deadline_s": None, "tenant": None, "timeout_s": None,
            "retry_policy": None}
    with open(os.path.join(d, "journal.jsonl"), "w") as f:
        f.write(json.dumps({"ev": "submit", "t": 0.0, "job_id": "tsp-conf-rec",
                            "durable": True, "spec": spec}) + "\n")
    svc = CheckService.recover(d, warm_start=False, device="cpu")
    try:
        job = svc.job("tsp-conf-rec")
        assert job is not None and job.state != "failed", (job and job.error)
        r_rec = JobHandle(job, svc).result(timeout=300)
    finally:
        svc.close()
    assert r_rec["conformance"]["records"] == jax_conformance[False]


def test_service_conformance_preempt_resume_bit_identical(tmp_path, jax_conformance):
    lines, _ = _seed_lines()
    svc = _service(service_dir=str(tmp_path / "svc"), warm_start=False, quantum_s=30.0)
    svc._closing.set()
    svc._wake()
    svc._scheduler.join(timeout=30)
    svc._closing.clear()
    try:
        h = svc.submit(conformance=lines, spawn={"batch_lanes": 4})
        job = svc.job(h.job_id)
        t = threading.Thread(target=svc._run_slice, args=(job,))
        t.start()
        wait_for(lambda: svc._active_checker is not None, 60, "the slice")
        svc._active_checker.request_preempt()
        t.join(timeout=180)
        if job.state == "suspended":
            svc._run_slice(job)
        assert job.state == "done", (job.state, job.error)
        assert job.result["conformance"]["records"] == jax_conformance[False]
    finally:
        svc.close()
