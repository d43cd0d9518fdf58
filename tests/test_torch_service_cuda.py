"""The check service on the card, against the port's CPU twin: packed,
solo (the drain's captured graphs), budgeted synchronous and async, seeded
and faulted jobs give the CPU service's verdicts; a namespace builds its
kernels once while each job captures its own graphs; graph captures on two
threads (a drain and a conformance replay) serialize on the process's one
capture lock and both stay exact; a closed service leaves
``torch.cuda.memory_allocated()`` where it found it. Tolerance is exact
equality.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs on a machine with only PyTorch; there, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_service_cuda.py
"""

import gc
import io
import re
import threading

import pytest
import torch

from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker import gpu
from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.service import CheckService
from stateright_tpu_torch.telemetry import metrics_registry
from stateright_tpu_torch.utils.faults import FaultSpec, inject

SPAWN = {"frontier_capacity": 16, "table_capacity": 1 << 12, "max_drain_waves": 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _golden(text):
    return re.sub(r"sec=\d+", "sec=_", text)


def _results(device, jobs, **svc_kw):
    """Runs ``jobs`` (submit kwargs) on one service of ``device``; returns
    each job's result and status."""
    svc_kw.setdefault("default_spawn", dict(SPAWN))
    svc = CheckService(quantum_s=600.0, device=device, **svc_kw)
    try:
        handles = [svc.submit(**kw) for kw in jobs]
        return [(h.result(timeout=600), h.status()) for h in handles]
    finally:
        svc.close()


def _same(card, cpu):
    for (rc, sc), (rp, sp) in zip(card, cpu):
        for k in ("unique", "states", "max_depth", "properties_hold"):
            assert rc[k] == rp[k], k
        assert rc["discoveries"] == rp["discoveries"]
        assert _golden(rc["report"]) == _golden(rp["report"])
        assert (sc["packed"], sc["retries"], sc["warm_start"]) == (
            sp["packed"], sp["retries"], sp["warm_start"])


@pytest.mark.cuda
def test_cuda_packed_and_solo_jobs_match_cpu(cuda_device):
    jobs = [dict(model_name="2pc", model_args={"rm_count": 4}),
            dict(model_name="2pc", model_args={"rm_count": 4}),
            dict(model_name="2pc", model_args={"rm_count": 5}, spawn={"max_drain_waves": 8})]
    card, cpu = _results("cuda", jobs), _results("cpu", jobs)
    _same(card, cpu)
    assert [s["packed"] for _r, s in card] == [True, True, False]


@pytest.mark.cuda
@pytest.mark.parametrize("rm", [4, 5])
def test_cuda_budgeted_async_job_matches_sync_and_cpu(cuda_device, rm):
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(rm), 16)
    jobs = [dict(model_name="2pc", model_args={"rm_count": rm}, hbm_budget_mib=budget,
                 spawn={"async_pipeline": a}) for a in (False, True)]
    card, cpu = _results("cuda", jobs), _results("cpu", jobs)
    _same(card, cpu)
    _same(card[1:], card[:1])


@pytest.mark.cuda
def test_cuda_faulted_and_seeded_jobs_match_cpu(cuda_device, tmp_path):
    out = {}
    for device in ("cuda", "cpu"):
        with inject(FaultSpec("device.wave", at=2)):
            faulted = _results(device, [dict(model_name="2pc", model_args={"rm_count": 4},
                                             spawn={"max_drain_waves": 4})], packing=False)
        d = str(tmp_path / device)
        cold = _results(device, [dict(model_name="2pc", model_args={"rm_count": 4})],
                        service_dir=d)
        seeded = _results(device, [dict(model_name="2pc", model_args={"rm_count": 4})],
                          service_dir=d)
        assert faulted[0][1]["retries"] == 1
        assert seeded[0][1]["warm_start"] is True
        out[device] = faulted + cold + seeded
    _same(out["cuda"], out["cpu"])


@pytest.mark.cuda
def test_cuda_namespace_builds_kernels_once_and_each_job_captures(cuda_device):
    """The port's form of the JAX ``test_second_job_shares_aot_cache_zero
    _compiles``: the second job of a namespace builds no kernel, and each
    job's compile phase is its own drain captures."""
    svc = CheckService(quantum_s=600.0, device="cuda",
                       default_spawn=dict(SPAWN, aot_cache="t-cuda-ns", wave_kernel="fused"))
    try:
        hs = []
        for _ in range(2):
            h = svc.submit(model_name="2pc", model_args={"rm_count": 4},
                           spawn={"attribution": True})
            h.result(timeout=600)
            hs.append(h)
    finally:
        svc.close()
    r1, r2 = (h.status()["result"] for h in hs)
    assert r1["compile_s_total"] > 0 and r2["compile_s_total"] > 0
    assert r1["attribution"]["phase_windows"]["compile"] >= 2
    assert r2["attribution"]["phase_windows"]["compile"] >= 2
    assert metrics_registry(hs[1].job_id).snapshot()["gpu_bfs.kernel_builds"] == 0
    assert _golden(r1["report"]) == _golden(r2["report"])


class _CountingLock:
    """The capture lock, counting who holds it: the most holders at once
    and the threads that took it."""

    def __init__(self, lock):
        self._lock = lock
        self._mu = threading.Lock()
        self.holders = 0
        self.most = 0
        self.threads = set()

    def __enter__(self):
        self._lock.acquire()
        with self._mu:
            self.holders += 1
            self.most = max(self.most, self.holders)
            self.threads.add(threading.get_ident())
        return self

    def __exit__(self, *exc):
        with self._mu:
            self.holders -= 1
        self._lock.release()


@pytest.mark.cuda
def test_cuda_captures_on_two_threads_serialize_and_stay_exact(cuda_device, monkeypatch):
    """A drain captured on one thread while another thread captures
    conformance replay graphs (the service's scheduler and its warm pool):
    the process's one capture lock serializes them, since the collector
    pause around a capture is process-wide, and both results equal the
    CPU twin's."""
    from stateright_tpu_torch.conformance.replay import clear_replay_kernels, warm_replay
    from stateright_tpu_torch.service import aot_namespace, default_zoo

    lock = _CountingLock(gpu._CAPTURE_LOCK)
    monkeypatch.setattr(gpu, "_CAPTURE_LOCK", lock)
    zoo = default_zoo()
    ns = aot_namespace("2pc", {"rm_count": 3})
    stop = threading.Event()
    errors, replays = [], []

    def replayer():
        try:
            model = zoo["2pc"](rm_count=3)
            for lanes in range(8, 48):
                if stop.is_set():
                    break
                fn = warm_replay(model, ns, 16, lanes, device="cuda")
                replays.append((lanes, fn.captures))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    clear_replay_kernels()
    t = threading.Thread(target=replayer)
    t.start()
    try:
        card = TwoPhaseSys(5).checker().spawn_gpu_bfs(
            device="cuda", frontier_capacity=64, table_capacity=1 << 14,
            max_drain_waves=8).join()
    finally:
        stop.set()
        t.join(timeout=600)
    clear_replay_kernels()
    assert not errors, errors
    assert replays and card.graph_captures >= 2
    assert lock.most == 1 and len(lock.threads) == 2, (lock.most, lock.threads)
    cpu = TwoPhaseSys(5).checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=64, table_capacity=1 << 14, max_drain_waves=8).join()
    for k in ("unique_state_count", "state_count", "max_depth"):
        assert getattr(card, k)() == getattr(cpu, k)()
    out = [io.StringIO(), io.StringIO()]
    card.report(WriteReporter(out[0]))
    cpu.report(WriteReporter(out[1]))
    assert _golden(out[0].getvalue()) == _golden(out[1].getvalue())


@pytest.mark.cuda
def test_cuda_closed_service_releases_device_memory(cuda_device):
    from stateright_tpu_torch.conformance.replay import clear_replay_kernels

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
    jobs = [dict(model_name="2pc", model_args={"rm_count": 4}),
            dict(model_name="2pc", model_args={"rm_count": 4}, spawn={"max_drain_waves": 8}),
            dict(model_name="2pc", model_args={"rm_count": 4}, hbm_budget_mib=budget,
                 spawn={"async_pipeline": True})]
    with inject(FaultSpec("device.wave", at=5)):
        _results("cuda", jobs)
    svc = CheckService(quantum_s=600.0, device="cuda", default_spawn=dict(SPAWN))
    try:
        h = svc.submit(model_name="2pc", model_args={"rm_count": 5},
                       spawn={"max_drain_waves": 8})
        h.cancel()
    finally:
        svc.close()
    clear_replay_kernels()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= before + (1 << 20)
