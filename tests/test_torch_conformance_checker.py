"""The port's ``ConformanceChecker`` (``conformance/checker.py`` with
``device="cpu"``) against the JAX package's, on the seed corpus
(``examples/conformance_corpus.jsonl``: 12 traces of increment_lock and
2pc, 24 histories, one of them past the register DP bound).

With the host parity gate on, the port's ``conformance_report()`` equals
JAX's on every record, count and bucket (``traces_per_s`` is a timing and
is never compared), and so do the run's ``conformance.*`` counters. A
preempt after the first chunk resumes to the same report; a
``conformance.batch`` fault ends the run with ``ConformanceBatchFault``.
"""

import os
import time

import pytest

from stateright_tpu.conformance import ConformanceChecker as JaxConformanceChecker
from stateright_tpu.conformance import decode_lines as jax_decode_lines
from stateright_tpu.service.zoo import default_zoo as jax_default_zoo
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu.telemetry.metrics import discard_run_registry as jax_discard
from stateright_tpu_torch.conformance import (
    ConformanceChecker,
    bucket_key,
    bucket_label,
    decode_lines,
)
from stateright_tpu_torch.conformance.audit import pack_history
from stateright_tpu_torch.service import default_zoo
from stateright_tpu_torch.telemetry import (
    discard_run_registry,
    metrics_registry,
    registry_hygiene_problems,
)
from stateright_tpu_torch.utils.faults import ConformanceBatchFault, FaultSpec, inject

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_CORPUS = os.path.join(REPO_DIR, "examples", "conformance_corpus.jsonl")
RUN_IDS = ("tcf-port-seed", "tcf-jax-seed")
COUNTERS = ("conformance.traces", "conformance.histories", "conformance.batches",
            "conformance.divergences", "conformance.violations", "conformance.refusals")


@pytest.fixture(scope="module", autouse=True)
def _fresh_registries():
    """Drop the runs' registries and leave the JAX package's process-wide
    registry empty, as a fresh process has it, for that package's tests."""
    yield
    for run_id in RUN_IDS:
        discard_run_registry(run_id)
        jax_discard(run_id)
    jax_metrics_registry().reset()


def _records():
    with open(SEED_CORPUS, encoding="utf-8") as f:
        lines = [ln for ln in f if ln.strip()]
    records, refusals = decode_lines(lines)
    assert not refusals and (records, refusals) == jax_decode_lines(lines)
    return records


def _joined(ck, timeout_s=300):
    deadline = time.monotonic() + timeout_s
    while not ck.is_done() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ck.is_done()
    for h in ck.handles():
        h.join(timeout=30)
    return ck


def _untimed(report):
    return {k: v for k, v in report.items() if k != "traces_per_s"}


@pytest.fixture(scope="module")
def seed_runs():
    records = _records()
    jax_ck = _joined(JaxConformanceChecker(records, jax_default_zoo(), run_id=RUN_IDS[1],
                                           parity=True, batch_lanes=32))
    assert jax_ck.worker_error() is None
    port_ck = _joined(ConformanceChecker(records, default_zoo(), run_id=RUN_IDS[0],
                                         parity=True, batch_lanes=32, device="cpu"))
    return records, port_ck, jax_ck


def test_seed_corpus_report_matches_jax(seed_runs):
    records, ck, jax_ck = seed_runs
    assert ck.worker_error() is None
    rep = ck.conformance_report()
    assert _untimed(rep) == _untimed(jax_ck.conformance_report())
    assert rep["traces_per_s"] > 0
    # The labels hold; the one over-bound history is an honest refusal.
    refuse_ids = {r["id"] for r in records
                  if r["kind"] == "history" and pack_history(r)[1] is not None}
    assert rep["refusals"] == len(refuse_ids) == 1
    assert rep["traces"] + rep["histories"] + rep["refusals"] == len(records) == 36
    assert rep["divergences"] == sum(
        1 for r in records if r["kind"] == "trace" and r["meta"].get("expect") == "divergent")
    for rec, v in zip(records, rep["records"]):
        if rec["kind"] == "trace" and rec["meta"].get("expect") == "divergent":
            assert v["divergence_index"] == rec["meta"]["divergence_index"], rec["id"]
        elif rec["kind"] == "trace":
            assert v["conforms"], rec["id"]


def test_seed_corpus_checker_surface_matches_jax(seed_runs):
    _records_, ck, jax_ck = seed_runs
    assert ck.state_count() == jax_ck.state_count()
    assert ck.unique_state_count() == jax_ck.unique_state_count() == 36
    assert ck.max_depth() == jax_ck.max_depth() == 12
    assert sorted(ck._discovery_names()) == sorted(jax_ck._discovery_names())
    assert ck.discoveries() == {} and ck.model().properties() == []
    with pytest.raises(AssertionError, match="failed conformance"):
        ck.assert_properties()
    assert not ck.preempted and ck.supports_preempt and not ck.supports_packing


def test_seed_corpus_metrics_match_jax_and_pass_the_lint(seed_runs):
    _records_, _ck, _jax_ck = seed_runs
    port, ref = metrics_registry(RUN_IDS[0]), jax_metrics_registry(RUN_IDS[1])
    for name in COUNTERS:
        assert port.counter(name).snapshot() == ref.counter(name).snapshot(), name
    assert port.histogram("conformance.bucket_lanes").snapshot()["count"] == (
        ref.histogram("conformance.bucket_lanes").snapshot()["count"])
    assert port.gauge("conformance.traces_per_s").snapshot() > 0
    assert registry_hygiene_problems(port) == []


def test_bucket_labels_match_jax(seed_runs):
    records, ck, jax_ck = seed_runs
    labels = list(ck.conformance_report()["buckets"])
    assert labels == list(jax_ck.conformance_report()["buckets"])
    assert labels == list(dict.fromkeys(bucket_label(bucket_key(r)) for r in records))
    assert "trace:increment_lock()[T=16]" in labels
    assert "history:register/linearizability[C=2,O=2,default=a]" in labels


@pytest.mark.parametrize("rec,reason", [
    ({"kind": "trace", "id": "t", "model": "no-such-model", "model_args": {}, "init": 0,
      "actions": [0], "meta": {}}, "unknown zoo model 'no-such-model'"),
    ({"kind": "trace", "id": "t", "model": "2pc", "model_args": {"colour": 1}, "init": 0,
      "actions": [0], "meta": {}}, "model '2pc' rejected args"),
    ({"kind": "trace", "id": "t", "model": "2pc", "model_args": {}, "init": 9,
      "actions": [0], "meta": {}}, "init index 9 out of range"),
], ids=["unknown_model", "bad_args", "bad_init"])
def test_checker_refuses_like_jax(rec, reason):
    ck = _joined(ConformanceChecker([rec], default_zoo(), device="cpu"), 60)
    ref = _joined(JaxConformanceChecker([rec], jax_default_zoo()), 60)
    rep = ck.conformance_report()
    assert rep == ref.conformance_report()
    assert rep["refusals"] == 1 and reason in rep["records"][0]["refused"]


class _PreemptAfterFirstChunk(ConformanceChecker):
    """Asks for a preempt when the second chunk starts: the run stops at
    that chunk boundary with the first chunk's verdicts in its payload."""

    def _maybe_preempt(self):
        self._chunks = getattr(self, "_chunks", 0) + 1
        if self._chunks == 2:
            self.request_preempt()
        super()._maybe_preempt()


def test_preempt_after_the_first_chunk_resumes_to_the_same_report(seed_runs):
    records, full, _jax_ck = seed_runs
    first = _joined(_PreemptAfterFirstChunk(records, default_zoo(), batch_lanes=4,
                                            parity=True, device="cpu"))
    assert first.worker_error() is None and first.preempted
    payload = first.preempt_payload()
    assert len(payload["verdicts"]) == 4 and first.unique_state_count() == 4
    resumed = _joined(ConformanceChecker(records, default_zoo(), batch_lanes=4,
                                         resume_from=payload, parity=True, device="cpu"))
    assert resumed.worker_error() is None and not resumed.preempted
    assert _untimed(resumed.conformance_report()) == _untimed(full.conformance_report())


def test_conformance_batch_fault_ends_the_run():
    records = _records()
    with inject(FaultSpec("conformance.batch", at=1)) as inj:
        ck = _joined(ConformanceChecker(records, default_zoo(), batch_lanes=8, device="cpu"))
    assert isinstance(ck.worker_error(), ConformanceBatchFault)
    assert inj.triggered("conformance.batch") == 1
    # The first chunk's verdicts (increment_lock's 6 traces) stand; the
    # run stopped before the second (2pc's).
    assert ck.unique_state_count() == 6


def test_checker_runs_on_cuda_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="ConformanceChecker runs on a CUDA device"):
        ConformanceChecker(_records(), default_zoo())
