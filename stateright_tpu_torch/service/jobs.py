"""Job objects for the check service: the admission-queue entry and the
caller-facing handle. The port's copy of the JAX package's
``service/jobs.py``.

A job's lifecycle::

    queued ──schedule──▶ running ──complete──▶ done
       ▲                  │ │ │────fail───────▶ failed
       │                  │ │ │────cancel─────▶ cancelled
       │                  │ │ └───fault───▶ faulted ──backoff──▶ (requeue)
       │                  │ │                  └─retries exhausted─▶
       │                  │ │                               quarantined
       └─────suspended ◀──┘ (preempted at a wave boundary; the
             checkpoint payload re-enters the queue)

``faulted`` is the self-healing state: a slice died (host probe, spill,
device wave, pipeline worker, checkpoint write — see
``utils/faults.classify_fault``), the scheduler harvested the best
checkpoint payload it could (the job's pre-slice resume snapshot, or a
fresher preempt payload when one landed), and the job re-enters the
queue after an exponential backoff. A job that exhausts its
:class:`RetryPolicy` lands in ``quarantined`` — terminal, with a
flight-recorder-style dump (fault history, tracebacks, last state
digest) attached to its status so the forensics survive the job.

All mutation happens on the scheduler thread; readers (``status()``, the
HTTP front end, once ported) take the job lock only for the multi-field snapshots so a
mid-transition read never mixes two states' fields.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_SUSPENDED = "suspended"
JOB_FAULTED = "faulted"
JOB_DONE = "done"
JOB_FAILED = "failed"
JOB_CANCELLED = "cancelled"
JOB_QUARANTINED = "quarantined"

_TERMINAL = (JOB_DONE, JOB_FAILED, JOB_CANCELLED, JOB_QUARANTINED)


class RetryPolicy:
    """Checkpointed-retry policy for faulted jobs: up to ``max_retries``
    requeues with exponential backoff (``backoff_s`` doubling by
    ``backoff_factor`` up to ``max_backoff_s``), optionally filtered to
    a set of fault classes (``retry_on`` — names from
    ``utils/faults.classify_fault``; None retries every class)."""

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.25,
                 backoff_factor: float = 2.0, max_backoff_s: float = 30.0,
                 retry_on=None):
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_s = float(max_backoff_s)
        self.retry_on = None if retry_on is None else frozenset(retry_on)

    def allows(self, fault_class: str, attempt: int) -> bool:
        """Whether retry number ``attempt`` (0-based) may run for a
        fault of this class."""
        if attempt >= self.max_retries:
            return False
        return self.retry_on is None or fault_class in self.retry_on

    def delay_s(self, attempt: int) -> float:
        return min(
            self.backoff_s * (self.backoff_factor ** attempt),
            self.max_backoff_s,
        )

    def to_dict(self) -> dict:
        return {
            "max_retries": self.max_retries,
            "backoff_s": self.backoff_s,
            "backoff_factor": self.backoff_factor,
            "max_backoff_s": self.max_backoff_s,
            "retry_on": (
                sorted(self.retry_on) if self.retry_on is not None else None
            ),
        }

    _FIELDS = ("max_retries", "backoff_s", "backoff_factor",
               "max_backoff_s", "retry_on")

    @classmethod
    def from_dict(cls, d: dict) -> "RetryPolicy":
        d = d or {}
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            # A typo'd key must be an error, not a silently-defaulted
            # policy the operator never asked for.
            raise ValueError(
                f"unknown retry-policy keys {sorted(unknown)} "
                f"(supported: {list(cls._FIELDS)})"
            )
        return cls(**d)


class CheckJob:
    """One submitted check: the model factory + builder options + spawn
    kwargs, the tenant's scheduling class (``priority`` high-first,
    ``deadline_s`` earliest-first within a priority, FIFO within a
    deadline), the per-tenant ``hbm_budget_mib``, the fault-tolerance
    envelope (``retry_policy``, ``timeout_s``), and the run state the
    scheduler threads through preempt/resume/retry cycles."""

    def __init__(
        self,
        job_id: str,
        model_factory: Callable,
        *,
        model_name: Optional[str] = None,
        options: Optional[dict] = None,
        spawn: Optional[dict] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        hbm_budget_mib: Optional[float] = None,
        aot_namespace: Optional[str] = None,
        retry_policy: Optional[RetryPolicy] = None,
        timeout_s: Optional[float] = None,
        mode: str = "exhaustive",
        seed: int = 0,
        seq: int = 0,
        clock=time.monotonic,
    ):
        self.job_id = job_id
        self.run_id = job_id
        self.model_factory = model_factory
        self.model_name = model_name
        self.options = dict(options or {})
        self.spawn = dict(spawn or {})
        self.priority = int(priority)
        self.deadline_s = deadline_s
        self.tenant = tenant
        self.hbm_budget_mib = hbm_budget_mib
        self.aot_namespace = aot_namespace
        self.retry_policy = retry_policy
        self.timeout_s = timeout_s
        # Verification mode: "exhaustive" (device BFS over the full
        # space) or "swarm" (device-width randomized walks — state
        # spaces beyond the store; ``seed`` keys the reproducible walk
        # streams and rides the journal/status).
        self.mode = mode
        self.seed = int(seed)
        self.seq = seq
        self._clock = clock
        self._lock = threading.Lock()

        self.state = JOB_QUEUED
        self.payload: Optional[dict] = None  # suspended checkpoint
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.error_traceback: Optional[str] = None
        self.preempts = 0
        self.slices = 0
        # Fault-tolerance ledger: ``retries`` counts requeues after a
        # fault, ``faults`` is the per-fault history (class, error,
        # time), ``flight`` the forensic dump attached on
        # quarantine/failure, ``not_before`` the backoff gate a faulted
        # job waits behind, ``stall_preempts`` watchdog auto-preempts.
        self.retries = 0
        self.faults: list = []
        self.flight: Optional[dict] = None
        self.not_before: Optional[float] = None
        self.stall_preempts = 0
        # Durability (service_dir mode): True when the submission is
        # journalable (zoo name + JSON-safe spec) and would survive a
        # process crash via CheckService.recover().
        self.durable = False
        # Honest backend surfacing (the service fills these at admission
        # and corrects them from the live checker): ``preemptible`` —
        # the spawn method yields resumable preempt payloads (a False
        # here means this job SERIALIZES the device for its whole run);
        # ``packable`` — the job qualifies for tenant-packed waves
        # (``packable_reason`` says why not); ``packed`` — it actually
        # ran co-scheduled in at least one pack.
        self.preemptible: Optional[bool] = None
        self.packable = False
        self.packable_reason: Optional[str] = None
        self.packed = False
        # Liveness honesty (device-liveness PR): how this job's
        # `eventually` verdicts are produced ("device" / "host_pass" /
        # "default"), and — when the service downgraded the request —
        # the reason (e.g. a backend without device liveness).
        self.liveness_mode: Optional[str] = None
        self.liveness_reason: Optional[str] = None
        # Warm-start plane: ``warm_pool`` marks the service's internal
        # pre-compile jobs (excluded from SLO rows and the seed store);
        # ``warm_start`` means this run was seeded from a persisted
        # finished run (``seeded_from`` names the seed signature and
        # tier counts); ``warm_start_reason`` records why a seed was
        # NOT used (the honest conservative-fallback evidence).
        self.warm_pool = False
        self.warm_start = False
        self.seeded_from: Optional[dict] = None
        self.warm_start_reason: Optional[str] = None
        # Budget-derived device table sizing (None = service default).
        self.derived_table_capacity: Optional[int] = None
        # Pack-membership clock: join time of the current packed slice.
        self.pack_join_t: Optional[float] = None
        self.active_s = 0.0  # device-holding wall across slices
        self.warmup_s = 0.0  # summed compile warmup across incarnations
        self.submitted_t = clock()
        # Round-robin clock: a slice bumps it, so within one
        # (priority, deadline) class the scheduler always picks the
        # least-recently-run job — preempting a job only to re-pick it
        # would be pure checkpoint/restore churn.
        self.last_run_t = self.submitted_t
        self.started_t: Optional[float] = None
        self.first_discovery_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.seen_discoveries: set = set()
        self.cancel_event = threading.Event()
        self.done_event = threading.Event()

    # -- scheduler-side helpers --------------------------------------------

    def sort_key(self, last_run_override=None):
        """Admission order: priority high-first, then earliest absolute
        deadline, then round-robin (least recently run; FIFO among
        never-run jobs, whose clock is their submission time).
        ``last_run_override`` evaluates the key as if the job had just
        run — the quantum-expiry preemption test compares peers against
        the running job's REENTRY position with this, so the two always
        use one key shape."""
        deadline = (
            self.submitted_t + self.deadline_s
            if self.deadline_s is not None
            else float("inf")
        )
        last_run = (
            self.last_run_t if last_run_override is None else last_run_override
        )
        return (-self.priority, deadline, last_run, self.seq)

    def runnable(self) -> bool:
        if self.state in (JOB_QUEUED, JOB_SUSPENDED):
            return True
        if self.state == JOB_FAULTED:
            # Backoff gate: a faulted job re-enters the queue only once
            # its retry delay has elapsed.
            return (
                self.not_before is None
                or self._clock() >= self.not_before
            )
        return False

    def finish(self, state: str) -> None:
        with self._lock:
            self.state = state
            self.finished_t = self._clock()
        self.done_event.set()

    # State transitions take the job lock so a concurrent status() never
    # reads mixed fields (e.g. state "running" with a verdict attached).

    def suspend(self, payload: dict) -> None:
        with self._lock:
            self.payload = payload
            self.preempts += 1
            self.state = JOB_SUSPENDED

    def complete(self, result: dict) -> None:
        # Verdict and terminal state land under ONE lock acquisition —
        # a reader must never see state "running" with a result attached.
        with self._lock:
            self.result = result
            self.state = JOB_DONE
            self.finished_t = self._clock()
        self.done_event.set()

    def fail(self, error: str, traceback_text: Optional[str] = None,
             flight: Optional[dict] = None) -> None:
        with self._lock:
            self.error = error
            self.error_traceback = traceback_text
            if flight is not None:
                self.flight = flight
            self.payload = None
            self.state = JOB_FAILED
            self.finished_t = self._clock()
        self.done_event.set()

    def fault(self, fault_class: str, error: str,
              traceback_text: Optional[str] = None,
              payload: Optional[dict] = None,
              digest: Optional[dict] = None) -> str:
        """Routes one slice fault through the retry policy. Returns the
        resulting state: ``faulted`` (requeued after backoff, resuming
        from ``payload`` — the last good wave boundary the scheduler
        harvested), ``quarantined`` (retries exhausted; the flight dump
        lands on the job), or ``failed`` (no retry policy). The caller
        counts the metrics — this object only owns the transition."""
        now = self._clock()
        record = {
            "t": now,
            "class": fault_class,
            "error": error,
            "retry": self.retries,
        }
        with self._lock:
            self.faults.append(record)
            policy = self.retry_policy
            if policy is not None and policy.allows(
                fault_class, self.retries
            ):
                delay = policy.delay_s(self.retries)
                self.retries += 1
                self.payload = payload
                self.not_before = now + delay
                self.state = JOB_FAULTED
                return JOB_FAULTED
            # Terminal: quarantine when retries were exhausted (the
            # self-healing path gave up — keep the forensics), plain
            # failure when no retry was ever on the table.
            self.error = error
            self.error_traceback = traceback_text
            self.payload = None
            self.flight = {
                "error": error,
                "traceback": traceback_text,
                "fault_class": fault_class,
                "faults": list(self.faults),
                "retries": self.retries,
                "digest": digest,
            }
            if policy is not None and self.retries >= policy.max_retries:
                self.state = JOB_QUARANTINED
            else:
                self.state = JOB_FAILED
            self.finished_t = now
        self.done_event.set()
        return self.state

    # -- views --------------------------------------------------------------

    def latency(self) -> Dict[str, Optional[float]]:
        """The latency block every status/bench record carries:
        ``queued_s`` (submit -> first schedule), ``ttfv_s`` (submit ->
        first property discovery — time-to-first-violation for
        falsifiable workloads, time-to-first-witness for ``sometimes``),
        ``wall_s`` (submit -> terminal state, live runs: so far), and
        ``active_s`` (device-holding time across slices)."""
        now = self._clock()
        end = self.finished_t if self.finished_t is not None else now
        return {
            # A never-scheduled job's queue wait ends at its terminal
            # time (a cancelled-while-queued job must not report a
            # forever-growing queued_s).
            "queued_s": (self.started_t or end) - self.submitted_t,
            "ttfv_s": (
                self.first_discovery_t - self.submitted_t
                if self.first_discovery_t is not None
                else None
            ),
            "wall_s": end - self.submitted_t,
            "active_s": self.active_s,
        }

    def status(self) -> dict:
        with self._lock:
            out = {
                "job_id": self.job_id,
                "run_id": self.run_id,
                "model": self.model_name,
                "tenant": self.tenant,
                "priority": self.priority,
                "deadline_s": self.deadline_s,
                "hbm_budget_mib": self.hbm_budget_mib,
                "timeout_s": self.timeout_s,
                "mode": self.mode,
                "seed": self.seed,
                "state": self.state,
                "durable": self.durable,
                "preemptible": self.preemptible,
                "packable": self.packable,
                "packable_reason": self.packable_reason,
                "packed": self.packed,
                "liveness_mode": self.liveness_mode,
                "liveness_reason": self.liveness_reason,
                "warm_pool": self.warm_pool,
                "warm_start": self.warm_start,
                "seeded_from": self.seeded_from,
                "warm_start_reason": self.warm_start_reason,
                "preempts": self.preempts,
                "slices": self.slices,
                "retries": self.retries,
                "faults": [dict(f) for f in self.faults],
                "stall_preempts": self.stall_preempts,
                "discoveries_so_far": sorted(self.seen_discoveries),
                "latency": self.latency(),
                "result": self.result,
                "error": self.error,
                "error_traceback": self.error_traceback,
                "flight": self.flight,
            }
        return out

    # The scalar result fields the job-list view keeps; the heavy ones
    # (golden report text, attribution/coverage ledgers, per-discovery
    # detail) stay on the single-job view.
    _SUMMARY_RESULT_FIELDS = (
        "unique", "states", "max_depth", "properties_hold", "rate",
    )

    def summary(self) -> dict:
        """``status()`` minus the heavy result payload — what the
        job listing renders. Full verdicts (and the flight dump /
        traceback forensics) stay on ``status()``."""
        out = self.status()
        result = out.get("result")
        if isinstance(result, dict):
            out["result"] = {
                k: result.get(k) for k in self._SUMMARY_RESULT_FIELDS
            }
        out.pop("flight", None)
        out.pop("error_traceback", None)
        return out


class JobHandle:
    """The caller's view of a submitted job (the Python-API surface an
    HTTP front end mirrors)."""

    def __init__(self, job: CheckJob, service):
        self._job = job
        self._service = service

    @property
    def job_id(self) -> str:
        return self._job.job_id

    def done(self) -> bool:
        return self._job.done_event.is_set()

    def status(self) -> dict:
        return self._job.status()

    def cancel(self) -> bool:
        """Requests cancellation; True unless the job already reached a
        terminal state. A running job is preempted at its next wave
        boundary and its payload discarded."""
        if self._job.state in _TERMINAL:
            return False
        self._job.cancel_event.set()
        self._service._wake()
        return True

    def result(self, timeout: Optional[float] = None) -> dict:
        """Blocks for the verdict. Raises ``TimeoutError`` on timeout,
        ``RuntimeError`` for a failed, quarantined, or cancelled job."""
        if not self._job.done_event.wait(timeout):
            raise TimeoutError(
                f"job {self._job.job_id} not done within {timeout}s"
            )
        if self._job.state in (JOB_FAILED, JOB_QUARANTINED):
            raise RuntimeError(
                f"job {self._job.job_id} {self._job.state}: "
                f"{self._job.error}"
            )
        if self._job.state == JOB_CANCELLED:
            raise RuntimeError(f"job {self._job.job_id} was cancelled")
        return self._job.result
