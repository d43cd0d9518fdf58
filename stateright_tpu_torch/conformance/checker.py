"""The conformance checker: uploaded recordings as a traffic class.

The port of the JAX package's ``conformance/checker.py``: the same
buckets, chunks, metrics, fault seam, parity gate, preemption and report,
with every batch on the run's device (``"cuda"`` unless ``device="cpu"``).

``ConformanceChecker`` wears the ``Checker`` interface so the service's
entire machinery — journal, retries, fault classes, preempt/resume, SLO
ledger, monitor/SSE — applies to conformance jobs without a parallel
code path. A "run" is the deterministic processing of one upload:

- records are shape-bucketed (``wire.bucket_records`` keys) and each
  bucket streams through the device in fixed ``batch_lanes`` chunks —
  one batched dispatch per chunk (``replay_batch`` for traces: a replayed
  CUDA Graph on the card; ``audit_batch`` for histories). Short chunks
  pad to the fixed lane count so a resident process reuses the bucket's
  graph.
- every chunk crosses the ``conformance.batch`` fault seam. Verdicts
  are a pure function of the upload, so a journaled retry recovers
  bit-identically — the acceptance gate the fault tests pin.
- preemption suspends at a chunk boundary into a payload of finished
  verdicts; the resumed incarnation skips them (same verdicts — they
  ride the payload verbatim).
- the ``Checker`` counters are reinterpreted honestly: ``state_count``
  = replay steps + audited events, ``unique_state_count`` = records
  finalized, ``max_depth`` = longest trace. ``_discovery_names`` are
  the ids of non-conforming/violating records, so the service's
  time-to-first-violation probe works unchanged.

``parity=True`` arms the per-batch host gate: every device verdict is
recomputed with the host oracles (``replay_host`` /
``host_is_consistent``) and any mismatch kills the run — the seed
corpus rides through the tier-1 smoke with this on.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from ..checker.base import Checker
from ..checker.gpu import resolve_device
from ..utils.faults import fault_point
from .audit import audit_batch, host_is_consistent
from .replay import replay_batch, replay_host, validate_trace
from .wire import bucket_key

_TRACE_VERDICT_KEYS = (
    "conforms", "divergence_index", "offending_action", "steps",
    "fingerprint",
)


class _NullModel:
    """The property surface of a run with no model: conformance verdicts
    are per-record, not per-property, so the base reporter/assertion
    machinery sees an empty property list (``assert_properties`` is
    overridden with the real per-record gate)."""

    def properties(self):
        return []

    def property(self, name):
        raise KeyError(name)


class _Preempted(Exception):
    """Internal worker unwind for a preempt request — not an error."""


def bucket_label(key: tuple) -> str:
    """Human-readable bucket key for reports and histograms."""
    if key[0] == "trace":
        _kind, model, args, T = key
        arg_s = ",".join(f"{k}={v}" for k, v in args)
        return f"trace:{model}({arg_s})[T={T}]"
    _kind, spec, semantics, C, O, default = key
    shape = f"C={C},O={O}"
    if default is not None:
        shape += f",default={default}"
    return f"history:{spec}/{semantics}[{shape}]"


class ConformanceChecker(Checker):
    supports_preempt = True
    supports_packing = False
    packing_reason = (
        "conformance batches are internally lane-packed (lanes = "
        "traces/histories); cross-tenant packing would break the "
        "per-upload verdict determinism the retry gate pins"
    )

    def __init__(
        self,
        records: Sequence[dict],
        zoo: Optional[dict] = None,
        *,
        run_id: Optional[str] = None,
        batch_lanes: int = 64,
        resume_from: Optional[dict] = None,
        parity: bool = False,
        tenant=None,
        device=None,
    ):
        self._device = resolve_device(device, "ConformanceChecker")
        self._records = list(records)
        if zoo is None:
            from ..service.zoo import default_zoo

            zoo = default_zoo()
        self._zoo = zoo
        self.run_id = run_id
        if run_id is not None:
            from ..telemetry import metrics_registry

            self._registry = metrics_registry(run_id)
        self._batch_lanes = max(1, int(batch_lanes))
        self._parity = bool(parity)
        self._tenant = tenant
        self._model_obj = _NullModel()
        self._lock = threading.Lock()
        # record index -> verdict dict; index keys (not ids) because
        # uploaded ids may collide.
        self._verdicts: Dict[int, dict] = {}
        self._counts = {"steps": 0, "events": 0, "max_depth": 0}
        self._trace_secs = 0.0
        self._traces_done = 0
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._preempt = threading.Event()
        if resume_from:
            self._verdicts.update(
                {int(k): v for k, v in resume_from["verdicts"].items()}
            )
            self._counts.update(resume_from.get("counts") or {})
            self._trace_secs = resume_from.get("trace_secs", 0.0)
            self._traces_done = resume_from.get("traces_done", 0)
        m = self.metrics()
        self._m_traces = m.counter("conformance.traces")
        self._m_histories = m.counter("conformance.histories")
        self._m_batches = m.counter("conformance.batches")
        self._m_divergences = m.counter("conformance.divergences")
        self._m_violations = m.counter("conformance.violations")
        self._m_refusals = m.counter("conformance.refusals")
        self._m_lanes = m.histogram("conformance.bucket_lanes")
        self._m_secs = m.histogram("conformance.batch_seconds")
        self._m_rate = m.gauge("conformance.traces_per_s")
        self._worker = threading.Thread(
            target=self._run, name="conformance-worker", daemon=True
        )
        self._handles: List[threading.Thread] = [self._worker]
        self._worker.start()

    # -- worker -------------------------------------------------------------

    def _run(self) -> None:
        try:
            self._process()
        except _Preempted:
            pass
        except BaseException as e:  # noqa: BLE001 - surfaced as worker_error
            self._error = e
        finally:
            if self._trace_secs > 0:
                self._m_rate.set(self._traces_done / self._trace_secs)
            self._done.set()

    def _maybe_preempt(self) -> None:
        if not self._preempt.is_set():
            return
        with self._lock:
            self._preempt_payload = {
                "verdicts": dict(self._verdicts),
                "counts": dict(self._counts),
                "trace_secs": self._trace_secs,
                "traces_done": self._traces_done,
            }
        raise _Preempted

    def _process(self) -> None:
        buckets: Dict[tuple, List[int]] = {}
        for i, rec in enumerate(self._records):
            buckets.setdefault(bucket_key(rec), []).append(i)
        self._bucket_sizes = {
            bucket_label(k): len(v) for k, v in buckets.items()
        }
        for key, indices in buckets.items():
            pending = [i for i in indices if i not in self._verdicts]
            if not pending:
                continue
            if key[0] == "trace":
                self._trace_bucket(key, pending)
            else:
                self._history_bucket(key, pending)
        self._maybe_preempt()

    def _finish(self, idx: int, verdict: dict, events: int = 0,
                steps: int = 0, depth: int = 0) -> None:
        with self._lock:
            self._verdicts[idx] = verdict
            self._counts["steps"] += steps
            self._counts["events"] += events
            self._counts["max_depth"] = max(
                self._counts["max_depth"], depth
            )
        if verdict.get("refused") is not None:
            self._m_refusals.inc()
        elif verdict["kind"] == "trace":
            if not verdict["conforms"]:
                self._m_divergences.inc()
        elif not verdict["consistent"]:
            self._m_violations.inc()

    def _refuse_bucket(self, pending: List[int], reason: str,
                       kind: str) -> None:
        for i in pending:
            self._finish(i, {
                "id": self._records[i]["id"], "kind": kind,
                "refused": reason,
            })

    def _trace_bucket(self, key: tuple, pending: List[int]) -> None:
        from ..service.zoo import aot_namespace

        _kind, model_name, _args_key, T = key
        args = self._records[pending[0]]["model_args"]
        factory = self._zoo.get(model_name)
        if factory is None:
            self._refuse_bucket(
                pending, f"unknown zoo model {model_name!r}", "trace"
            )
            return
        try:
            model = factory(**args)
        except Exception as e:  # noqa: BLE001 - bad args are a refusal
            self._refuse_bucket(
                pending,
                f"model {model_name!r} rejected args {args!r}: {e}",
                "trace",
            )
            return
        namespace = aot_namespace(model_name, args)
        runnable: List[int] = []
        for i in pending:
            reason = validate_trace(self._records[i], model)
            if reason is not None:
                self._finish(i, {
                    "id": self._records[i]["id"], "kind": "trace",
                    "refused": reason,
                })
            else:
                runnable.append(i)
        L = self._batch_lanes
        for lo in range(0, len(runnable), L):
            self._maybe_preempt()
            chunk = runnable[lo: lo + L]
            recs = [self._records[i] for i in chunk]
            fault_point("conformance.batch", tenant=self._tenant)
            t0 = time.perf_counter()
            verdicts = replay_batch(
                recs, model, namespace, T, lanes=L, device=self._device
            )
            dt = time.perf_counter() - t0
            self._m_batches.inc()
            self._m_lanes.observe(len(chunk))
            self._m_secs.observe(dt)
            self._m_traces.inc(len(chunk))
            self._trace_secs += dt
            self._traces_done += len(chunk)
            for i, rec, v in zip(chunk, recs, verdicts):
                if self._parity:
                    host = replay_host(rec, model)
                    if any(
                        v[k] != host[k] for k in _TRACE_VERDICT_KEYS
                    ):
                        raise RuntimeError(
                            f"conformance parity gate: device verdict "
                            f"{v!r} != host {host!r} for record "
                            f"{rec['id']!r}"
                        )
                self._finish(
                    i, v, steps=v["steps"], depth=len(rec["actions"])
                )

    def _history_bucket(self, key: tuple, pending: List[int]) -> None:
        L = self._batch_lanes
        for lo in range(0, len(pending), L):
            self._maybe_preempt()
            chunk = pending[lo: lo + L]
            recs = [self._records[i] for i in chunk]
            fault_point("conformance.batch", tenant=self._tenant)
            t0 = time.perf_counter()
            verdicts = audit_batch(recs, lanes=L, device=self._device)
            dt = time.perf_counter() - t0
            self._m_batches.inc()
            self._m_lanes.observe(len(chunk))
            self._m_secs.observe(dt)
            self._m_histories.inc(len(chunk))
            for i, rec, v in zip(chunk, recs, verdicts):
                if self._parity and v.get("refused") is None:
                    host = host_is_consistent(rec)
                    if v["consistent"] != host:
                        raise RuntimeError(
                            f"conformance parity gate: device "
                            f"consistent={v['consistent']} != host "
                            f"{host} for record {rec['id']!r}"
                        )
                self._finish(i, v, events=len(rec["events"]))

    # -- Checker surface ----------------------------------------------------

    def model(self):
        return self._model_obj

    def state_count(self) -> int:
        with self._lock:
            return self._counts["steps"] + self._counts["events"]

    def unique_state_count(self) -> int:
        with self._lock:
            return len(self._verdicts)

    def max_depth(self) -> int:
        with self._lock:
            return self._counts["max_depth"]

    def discoveries(self):
        return {}

    def _discovery_names(self) -> List[str]:
        with self._lock:
            return [
                v["id"] for v in self._verdicts.values()
                if self._failing(v)
            ]

    @staticmethod
    def _failing(v: dict) -> bool:
        if v.get("refused") is not None:
            return False
        if v["kind"] == "trace":
            return not v["conforms"]
        return not v["consistent"]

    def handles(self) -> List[threading.Thread]:
        out, self._handles = self._handles, []
        return out

    def is_done(self) -> bool:
        return self._done.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._error

    def request_preempt(self) -> None:
        self._preempt.set()

    def assert_properties(self) -> None:
        failing = self._discovery_names()
        if failing:
            raise AssertionError(
                f"{len(failing)} record(s) failed conformance: "
                f"{sorted(failing)[:8]}"
            )

    def conformance_report(self) -> dict:
        """The verdict block the service attaches to the job result:
        one verdict per uploaded record, in upload order, plus batch
        accounting (records always sum to the upload)."""
        with self._lock:
            verdicts = [
                self._verdicts.get(i) for i in range(len(self._records))
            ]
        traces = sum(
            1 for v in verdicts
            if v and v["kind"] == "trace" and v.get("refused") is None
        )
        histories = sum(
            1 for v in verdicts
            if v and v["kind"] == "history" and v.get("refused") is None
        )
        refused = sum(
            1 for v in verdicts if v and v.get("refused") is not None
        )
        divergences = sum(
            1 for v in verdicts
            if v and v["kind"] == "trace" and v.get("refused") is None
            and not v["conforms"]
        )
        violations = sum(
            1 for v in verdicts
            if v and v["kind"] == "history" and v.get("refused") is None
            and not v["consistent"]
        )
        out = {
            "records": verdicts,
            "traces": traces,
            "histories": histories,
            "refusals": refused,
            "divergences": divergences,
            "violations": violations,
            "buckets": dict(getattr(self, "_bucket_sizes", {})),
        }
        if self._trace_secs > 0:
            out["traces_per_s"] = self._traces_done / self._trace_secs
        return out
