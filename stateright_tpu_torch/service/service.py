"""The persistent check scheduler: one device, many jobs, packed waves.

The port's ``CheckService``, a copy of the JAX package's
``service/service.py`` over the port's checkers. It owns the card the way a
database owns its disk: a scheduler thread admits :class:`CheckJob` s
(priority high-first, EDF within a priority, FIFO within a deadline) and
multiplexes the device two ways:

- **Tenant-packed waves (the default for qualifying jobs).** Same-shape
  jobs (same zoo configuration, no spawn overrides, no symmetry, target
  caps or budget) share one physical wave through
  ``checker/packed_tenancy.TenantPackedEngine``: one visited table under
  tenant-salted fingerprints (the insert kernel's salted claims), per-lane
  tenant ids, per-tenant result reductions. Admission is "claim a free
  lane slot", late arrivals join the live pack, and preemption is "drop
  the tenant's lanes": its survivors hand back as a checkpoint payload.
  Swarm jobs pack the same way over ``checker/swarm.SwarmPackedEngine``.
- **Wave-granular time-slicing (the fallback).** Other jobs are suspended
  by ``request_preempt()`` (the wave state drains to a host-side payload at
  the next wave or drain boundary) and resumed later with
  ``resume_from=<payload>``, bit-identical to an uninterrupted run. Jobs
  whose backend cannot preempt run their slice to completion, surfaced as
  ``preemptible: false`` in ``status()``.

Every job runs on ``device`` (``cuda`` unless the service is built with
``device="cpu"``, which runs the plain twin of every kernel; with no CUDA
device and no ``device="cpu"`` the constructor raises). Each job runs under
its own ``run_id``: its own metrics registry and run-stamped trace spans.
Jobs of one zoo configuration share an ``aot_cache`` namespace: the
kernels build once per process, while each job's CUDA Graph captures are
its own compile phase (a captured graph binds one checker's buffers, so
none is shared across jobs). With ``service_dir`` the service adds a
write-ahead job journal with per-job checkpoints (``recover``), the disk
record of each namespace's kernels (``aot/``) and the
finished-run seeds (``seeds/``) that let a resubmitted model complete in
verify-only mode.

Single-device by design: slices (packed or solo) are strictly serialized
on the scheduler thread, so the device never has two claimants. The warm
pool's thread submits ordinary jobs and prepares conformance replay graphs,
whose captures ``conformance/replay.py`` serializes with its own lock.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..checker.gpu import resolve_device
from ..report import WriteReporter
from ..utils.faults import classify_fault, tenant_fault_of
from .jobs import (
    JOB_CANCELLED,
    JOB_DONE,
    JOB_FAILED,
    JOB_FAULTED,
    JOB_QUARANTINED,
    JOB_QUEUED,
    JOB_RUNNING,
    JOB_SUSPENDED,
    CheckJob,
    JobHandle,
    RetryPolicy,
)
from .zoo import aot_namespace as zoo_namespace
from .zoo import default_zoo


class QueueFullError(RuntimeError):
    """Admission rejected: the service's bounded queue is full
    (``retry_after_s`` is the hint an HTTP front end sends as 429's
    Retry-After)."""

    def __init__(self, limit: int, retry_after_s: float):
        super().__init__(
            f"admission queue full ({limit} jobs pending); retry in "
            f"~{retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s


def _format_exc(exc: BaseException) -> str:
    """The full formatted traceback chain for one exception — what
    status()['error_traceback'] and the flight dumps carry (repr(e)
    alone loses the stack, which is the whole point of the dump)."""
    return "".join(
        traceback.format_exception(type(exc), exc, exc.__traceback__)
    )

# Builder options submit(options=...) accepts.
_BUILDER_OPTIONS = ("target_state_count", "target_max_depth", "symmetry")

# Spawn kwargs the service defaults for every job: a bounded drain cap is
# what makes preemption latency a few waves instead of a whole drain (the
# same clamp checkpoint durability applies), and modest capacities fit
# many tenants on one device.
_DEFAULT_SPAWN = {
    "frontier_capacity": 1 << 10,
    "table_capacity": 1 << 16,
    "max_drain_waves": 8,
}

# Spawn kwargs for mode="swarm" jobs (checker/swarm.py): one fleet shape
# for every swarm job on the service, which is what lets them pack into
# one stacked dispatch — and what makes a packed tenant's walks
# bit-identical to the same job run solo.
_DEFAULT_SWARM_SPAWN = {
    "lanes": 512,
    "wave_steps": 256,
    "max_trace_len": 128,
    "sample_capacity": 1 << 14,
    "sample_stride": 1,
}

_JOB_MODES = ("exhaustive", "swarm", "conformance")

# mode="conformance" spawn surface (conformance/checker.py knobs); any
# other key is a known-at-admission error, not a mid-run TypeError.
_CONFORMANCE_SPAWN_KEYS = frozenset({"batch_lanes", "parity"})

# The warm pool's conformance geometry: the replay graph captured per warm
# shape (padded trace length x lane count), the checker's default
# batch_lanes and the smallest trace bucket.
_CONFORMANCE_WARM_T = 16
_CONFORMANCE_WARM_L = 64


def _normalize_conformance(payload):
    """A conformance submission payload -> ``(canonical wire lines,
    decoded records)``, strictly validated (the first bad frame raises
    ``WireRefusal``, a ``ValueError``: refused at admission). Accepts
    JSONL text, a list of frame lines, or a list of frame objects (raw
    frames with ``"v"``, or already-decoded records)."""
    import json as _json

    from ..conformance.wire import decode_lines, encode_record

    if isinstance(payload, str):
        lines = payload.splitlines()
    elif isinstance(payload, (list, tuple)):
        lines = []
        for item in payload:
            if isinstance(item, str):
                lines.append(item)
            elif isinstance(item, dict):
                try:
                    lines.append(encode_record(item))
                except (KeyError, TypeError, ValueError):
                    # Not frame-shaped at all: serialize as-is and let
                    # the strict decode refuse it with a line number.
                    lines.append(_json.dumps(item))
            else:
                raise ValueError(
                    "conformance frames must be JSONL lines or frame "
                    f"objects, got {type(item).__name__}"
                )
    else:
        raise ValueError(
            "conformance payload must be JSONL text, a list of frame "
            f"lines, or a list of frame objects, got "
            f"{type(payload).__name__}"
        )
    lines = [ln for ln in (s.strip() for s in lines) if ln]
    if not lines:
        raise ValueError("conformance payload is empty")
    records, _refusals = decode_lines(lines, strict=True)
    return lines, records

# Default job ids are unique across every service in the process (the
# id is also the run_id, which keys process-global registries).
_GLOBAL_JOB_SEQ = itertools.count()

# Spawn methods whose checkers yield resumable preempt payloads
# (``Checker.supports_preempt``). The admission-time guess; corrected
# from the live checker after the first spawn.
_PREEMPTIBLE_SPAWNS = frozenset({"spawn_gpu_bfs", "spawn_sharded_gpu_bfs"})

# Spawn methods whose checkers honor liveness="device"
# (``Checker.supports_device_liveness``) — the admission-time guess for
# the honest liveness_mode/downgrade-reason surface, corrected from the
# live checker after the first spawn.
_DEVICE_LIVENESS_SPAWNS = frozenset(
    {"spawn_gpu_bfs", "spawn_sharded_gpu_bfs"}
)


class CheckService:
    """A long-lived, in-process checking service.

    ::

        svc = CheckService()
        h1 = svc.submit(model_name="2pc", model_args={"rm_count": 5})
        h2 = svc.submit(model_name="abd", priority=1)   # runs first
        print(h1.result()["unique"], h1.status()["latency"]["ttfv_s"])
        svc.close()

    ``quantum_s`` is the scheduling quantum: a running job is preempted
    once its slice exceeds it *and* another job is runnable (a sole job
    runs uninterrupted — preemption exists for sharing, not ceremony).
    ``default_hbm_budget_mib`` is the per-tenant device budget applied to
    jobs that don't set their own (the tiered store enforces it).
    ``device`` is where every job runs: ``cuda`` unless ``"cpu"`` is
    passed; with no CUDA device and no ``device="cpu"`` the constructor
    raises. ``clock`` drives every scheduling decision (quanta, deadlines,
    backoff, timeouts, the stall watchdog), so tests can step it.
    """

    def __init__(
        self,
        *,
        quantum_s: float = 1.0,
        poll_interval_s: float = 0.005,
        zoo: Optional[Dict[str, Callable]] = None,
        default_spawn: Optional[dict] = None,
        default_hbm_budget_mib: Optional[float] = None,
        spawn_method: str = "spawn_gpu_bfs",
        default_swarm_spawn: Optional[dict] = None,
        max_finished_jobs: int = 256,
        packing: bool = True,
        max_pack_tenants: int = 8,
        pack_async: bool = False,
        retry_policy: Optional[RetryPolicy] = "default",
        max_queued_jobs: Optional[int] = None,
        service_dir: Optional[str] = None,
        stall_deadline_s: Optional[float] = None,
        on_stall: Optional[Callable] = None,
        slo_targets: Optional[dict] = None,
        max_run_registries: int = 64,
        warm_pool=None,
        warm_start: bool = True,
        clock=time.monotonic,
        device=None,
    ):
        self.device = resolve_device(device, "CheckService")
        self.quantum_s = float(quantum_s)
        self.poll_interval_s = float(poll_interval_s)
        self.zoo = dict(zoo) if zoo is not None else default_zoo()
        self.default_spawn = dict(_DEFAULT_SPAWN)
        if default_spawn:
            self.default_spawn.update(default_spawn)
        self.default_hbm_budget_mib = default_hbm_budget_mib
        self.spawn_method = spawn_method
        # mode="swarm" fleet shape (see _DEFAULT_SWARM_SPAWN).
        self.default_swarm_spawn = dict(_DEFAULT_SWARM_SPAWN)
        if default_swarm_spawn:
            self.default_swarm_spawn.update(default_swarm_spawn)
        # Tenant-packed waves (checker/packed_tenancy.py): qualifying
        # same-shape jobs share one physical dispatch instead of
        # time-slicing. ``packing=False`` restores the pure time-slicer;
        # ``max_pack_tenants`` is the lane-slot count K;
        # ``pack_async=True`` runs the pack's host half (per-tenant
        # probes, parent logs, survivor re-entry) on a pipeline worker
        # overlapped with the next dispatch.
        self.packing = bool(packing)
        self.max_pack_tenants = max(1, int(max_pack_tenants))
        self.pack_async = bool(pack_async)
        # Zoo-configuration model cache: one model instance per AOT
        # namespace, shared by admission-time budget validation and the
        # packed engines (models are pure packed-array containers).
        self._pack_models: Dict[str, object] = {}
        # Retention: terminal jobs (and their run registries) beyond
        # this count are evicted oldest-first, so a long-lived service
        # does not accrete one registry + result blob per finished job
        # forever. Live JobHandles keep working — they hold the job
        # object, not the index entry.
        self.max_finished_jobs = max(0, int(max_finished_jobs))
        # Fault tolerance (the self-healing layer): the default retry
        # policy applied to jobs that don't bring their own — pass
        # retry_policy=None to restore fail-on-first-fault.
        self.retry_policy = (
            RetryPolicy() if retry_policy == "default" else retry_policy
        )
        # Graceful degradation: ``max_queued_jobs`` bounds the pending
        # backlog (submit raises QueueFullError past it);
        # ``stall_deadline_s`` arms a per-slice stall watchdog whose
        # action hook (``on_stall(job, checker, idle_s)``; default:
        # auto-preempt so the job retries from its wave boundary) fires
        # when a slice makes no progress for that long.
        self.max_queued_jobs = (
            None if max_queued_jobs is None else max(1, int(max_queued_jobs))
        )
        self.stall_deadline_s = stall_deadline_s
        self.on_stall = on_stall
        # Durable recovery: ``service_dir`` adds a write-ahead JSONL job
        # journal plus atomic per-job checkpoint pickles, so
        # ``CheckService.recover(service_dir)`` rebuilds the queue after
        # a process crash.
        self.service_dir = service_dir
        self._journal_lock = threading.Lock()
        self._journal_fh = None
        if service_dir is not None:
            os.makedirs(os.path.join(service_dir, "jobs"), exist_ok=True)
            self._journal_fh = open(
                os.path.join(service_dir, "journal.jsonl"), "a",
                encoding="utf-8",
            )
        # Warm-start plane: with a service_dir, each namespace's record of
        # its kernels persists under ``aot/`` (fenced,
        # content-addressed) and finished exhaustive runs seed ``seeds/``
        # so a resubmitted model completes in O(verify). ``warm_start=False``
        # keeps the directories untouched (cold semantics).
        self.warm_start = bool(warm_start)
        self.aot_store = None
        self.seed_store = None
        if service_dir is not None and self.warm_start:
            from ..storage.persist import AotDiskStore, SeedStore

            self.aot_store = AotDiskStore(os.path.join(service_dir, "aot"))
            self.seed_store = SeedStore(os.path.join(service_dir, "seeds"))
        # Conformance corpus persistence: named JSONL uploads under
        # ``corpus/``, so clients submit by name (never by server-side
        # path) and re-audit a stored corpus after restarts.
        self.corpus_store = None
        if service_dir is not None:
            from ..storage.corpus import CorpusStore

            self.corpus_store = CorpusStore(
                os.path.join(service_dir, "corpus")
            )
        from ..telemetry import metrics_registry

        reg = metrics_registry()
        self._m_faults = reg.counter("fault.jobs")
        self._m_retries = reg.counter("retry.scheduled")
        self._m_recovered = reg.counter("retry.recovered")
        self._m_quarantined = reg.counter("retry.quarantined")
        self._m_stall_preempts = reg.counter("service.stall.auto_preempts")
        self._m_rejected = reg.counter("service.admission.rejected")
        self._m_timeouts = reg.counter("service.timeouts")
        self._m_close_stuck = reg.counter("service.close.stuck")
        self._m_ckpt_errors = reg.counter(
            "service.recovery.checkpoint_errors"
        )
        self._fault_class_counter = (
            lambda cls: reg.counter(f"fault.by_class.{cls}")
        )
        # SLO ledger (service/slo.py): per-mode ttfv/verdict percentiles
        # + queue/compile/explore decomposition, fed at the two verdict
        # sites; ``slo_targets`` arms the burn-rate gauges.
        from .slo import SLOLedger

        self.slo = SLOLedger(targets=slo_targets, registry=reg)
        # Registry retention, tighter than job retention: a RETAINED
        # terminal job's run registry (hundreds of instruments) costs
        # far more than its summary row, so registries beyond this cap
        # are dropped oldest-first while the job records stay (their
        # /jobs views keep working — results are snapshotted on the job).
        self.max_run_registries = max(0, int(max_run_registries))
        self._m_registry_evicted = reg.counter("service.registry_evicted")
        # Warm-start observability (global registry: plane-level, not
        # per-run). Per-job aot_cache.* counters live in run registries.
        self._m_seed_saved = reg.counter("warmstart.seed_saved")
        self._m_seed_loaded = reg.counter("warmstart.seed_loaded")
        self._m_seed_refused = reg.counter("warmstart.seed_refused")
        self._g_pool_ready = reg.gauge("warmstart.pool_ready")
        self._g_pool_pending = reg.gauge("warmstart.pool_pending")
        self._clock = clock
        self._admission_hold = False  # recover() gates scheduling
        self._cond = threading.Condition()
        self._jobs: Dict[str, CheckJob] = {}
        self._seq = itertools.count()
        self._closing = threading.Event()
        self._active_checker = None
        self._scheduler = threading.Thread(
            target=self._run_scheduler, name="check-service", daemon=True
        )
        self._scheduler.start()
        # Warm pool: prepare registered shapes on a background thread at
        # service start (build the kernels, and with a disk record before
        # the first wave; capture the conformance replay graphs), so a
        # fresh process serves its first real job without building a
        # kernel. ``warm_pool=True`` warms the zoo's
        # registered shapes; an iterable of ``(model_name, model_args)``
        # pairs warms exactly those. Warm jobs ride the normal scheduler
        # at rock-bottom priority (they never starve real work — the
        # admission order is priority-high-first) and are excluded from
        # the SLO ledger and the seed store.
        self.warm_pool_status: Dict[str, dict] = {}
        self._warm_pool_thread = None
        if warm_pool:
            shapes = self._warm_shapes(warm_pool)
            for ns, name, args in shapes:
                self.warm_pool_status[ns] = {
                    "model": name, "args": dict(args), "state": "pending",
                }
            self._g_pool_pending.set(len(shapes))
            self._warm_pool_thread = threading.Thread(
                target=self._warm_pool_worker, args=(shapes,),
                name="check-service-warm-pool", daemon=True,
            )
            self._warm_pool_thread.start()

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        model=None,
        *,
        model_name: Optional[str] = None,
        model_args: Optional[dict] = None,
        options: Optional[dict] = None,
        spawn: Optional[dict] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        hbm_budget_mib: Optional[float] = None,
        aot_namespace: Optional[str] = None,
        job_id: Optional[str] = None,
        timeout_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = "default",
        mode: str = "exhaustive",
        seed: int = 0,
        conformance=None,
        _warm_pool: bool = False,
    ) -> JobHandle:
        """Admits one check job; returns immediately with a handle.

        Either ``model_name`` (a zoo entry; ``model_args`` forwarded to
        its factory — this route shares the AOT cache automatically) or
        ``model`` (a ``BatchableModel`` instance or zero-arg factory;
        pass ``aot_namespace=`` yourself iff submissions under that
        namespace are configured identically). ``options`` takes the
        builder knobs (``target_state_count``, ``target_max_depth``,
        ``symmetry``); ``spawn`` any ``spawn_gpu_bfs`` kwarg;
        ``hbm_budget_mib`` the tenant's device budget. ``mode="swarm"``
        runs device-width randomized walks instead of exhaustive BFS
        (state spaces beyond the store; ``seed`` keys the reproducible
        walk streams — same seed, same verdict, packed or solo)."""
        if self._closing.is_set():
            raise RuntimeError("CheckService is closed")
        if conformance is not None and mode == "exhaustive":
            mode = "conformance"
        if mode not in _JOB_MODES:
            raise ValueError(
                f"unknown mode {mode!r} (supported: {list(_JOB_MODES)})"
            )
        conformance_lines = conformance_records = None
        if mode == "conformance":
            # Conformance jobs audit recorded executions, not a model:
            # the payload is wire frames (see conformance/wire.py), the
            # only tuning surface is the batch geometry, and every other
            # check-job knob that presupposes exploration is a
            # known-at-admission error.
            if conformance is None:
                raise ValueError(
                    "mode='conformance' needs conformance= (wire frames: "
                    "JSONL text, a list of frame lines, or a list of "
                    "frame objects)"
                )
            if model is not None or model_name is not None:
                raise ValueError(
                    "conformance jobs audit recorded frames; trace "
                    "frames name their zoo model inline — do not pass "
                    "model/model_name"
                )
            if options:
                raise ValueError(
                    "conformance jobs take no builder options; tune "
                    f"spawn={sorted(_CONFORMANCE_SPAWN_KEYS)} instead"
                )
            if hbm_budget_mib is not None:
                raise ValueError(
                    "conformance jobs have no tiered visited store to "
                    "budget; size batches via spawn={'batch_lanes': ...}"
                )
            bad_spawn = set(spawn or {}) - _CONFORMANCE_SPAWN_KEYS
            if bad_spawn:
                raise ValueError(
                    f"unknown conformance spawn keys {sorted(bad_spawn)} "
                    f"(supported: {sorted(_CONFORMANCE_SPAWN_KEYS)})"
                )
            # Strict decode at admission: a malformed frame is a 400 at
            # the door (WireRefusal is a ValueError), not a burned retry
            # mid-run. The canonical re-encoded lines are what the
            # durable journal carries.
            conformance_lines, conformance_records = (
                _normalize_conformance(conformance)
            )
        try:
            seed = int(seed)
        except (TypeError, ValueError):
            raise ValueError("seed must be an integer") from None
        if mode == "swarm" and hbm_budget_mib is not None:
            raise ValueError(
                "mode='swarm' has no tiered visited store to budget; "
                "size the walk sample via default_swarm_spawn/"
                "spawn={'sample_capacity': ...} instead"
            )
        if mode == "swarm" and (options or {}).get("symmetry"):
            # Known-at-admission conflict: SwarmChecker refuses
            # symmetry at spawn (cycle checks are host-only) — reject
            # HERE, not as a mid-run failure burning retries.
            raise ValueError(
                "mode='swarm' does not support symmetry reduction "
                "(walk cycle detection is host-only; use "
                "spawn_simulation for symmetric models)"
            )
        if mode == "swarm":
            # The walk carry holds targets as int32 runtime scalars —
            # an out-of-range value is a known-at-admission config
            # error (mid-run it would burn the retry budget on the
            # packed path), same convention as the checks above.
            for knob in ("target_state_count", "target_max_depth"):
                v = (options or {}).get(knob)
                if v is None:
                    continue
                try:
                    v = int(v)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{knob} must be an integer"
                    ) from None
                if not 0 < v < 2**31:
                    raise ValueError(
                        f"{knob}={v} is outside the int32 range the "
                        "walk carry uses; split the budget across "
                        "resumed runs"
                    )
        if mode == "swarm" and not (
            (options or {}).get("target_state_count")
            or timeout_s is not None
        ):
            # Another known-at-admission conflict: simulation semantics
            # only stop when EVERY property has a discovery, so a model
            # with a holding always-property samples forever — a job
            # with no stop bound would occupy the device indefinitely,
            # suspended and resumed every quantum.
            raise ValueError(
                "mode='swarm' needs a stop bound (a holding property "
                "is never 'discovered', so an unbounded walk samples "
                "forever): pass options={'target_state_count': N} "
                "and/or timeout_s"
            )
        for field_name, value in (
            ("model_args", model_args),
            ("options", options),
            ("spawn", spawn),
        ):
            if value is not None and not isinstance(value, dict):
                raise ValueError(
                    f"{field_name} must be an object/dict, "
                    f"got {type(value).__name__}"
                )
        model_args = dict(model_args or {})
        if model_name is not None:
            if model is not None:
                raise ValueError("pass model or model_name, not both")
            try:
                factory_fn = self.zoo[model_name]
            except KeyError:
                raise ValueError(
                    f"unknown model {model_name!r} "
                    f"(zoo has: {sorted(self.zoo)})"
                ) from None
            def factory(fn=factory_fn, kw=model_args):
                return fn(**kw)
            if aot_namespace is None:
                # Canonicalize zoo aliases ("2pc"/"two_phase_commit" map
                # to one factory): namespace on the factory's first zoo
                # name, so aliases share one namespace instead of
                # recompiling per spelling.
                canonical = min(
                    k for k, v in self.zoo.items() if v is factory_fn
                )
                aot_namespace = zoo_namespace(canonical, model_args)
        elif model is not None:
            if callable(model) and not hasattr(model, "packed_init_states"):
                factory = model
            else:
                def factory(m=model):
                    return m
        elif mode == "conformance":
            # No model to build: trace frames resolve their zoo entry
            # inside the checker, histories need none at all.
            def factory():
                return None
        else:
            raise ValueError("one of model / model_name is required")
        bad = set(options or {}) - set(_BUILDER_OPTIONS)
        if bad:
            raise ValueError(
                f"unknown options {sorted(bad)} "
                f"(supported: {list(_BUILDER_OPTIONS)})"
            )
        # Coerce the scheduling inputs HERE, not in the scheduler: a
        # non-numeric deadline (say, from a JSON body) reaching sort_key()
        # would kill the scheduler thread and hang every job.
        try:
            priority = int(priority)
            deadline_s = None if deadline_s is None else float(deadline_s)
            hbm_budget_mib = (
                None if hbm_budget_mib is None else float(hbm_budget_mib)
            )
            timeout_s = None if timeout_s is None else float(timeout_s)
        except (TypeError, ValueError) as e:
            raise ValueError(
                "priority must be an int; deadline_s / hbm_budget_mib / "
                f"timeout_s must be numbers or null ({e})"
            ) from None
        if retry_policy == "default":
            retry_policy = self.retry_policy
        if retry_policy is not None and not isinstance(
            retry_policy, RetryPolicy
        ):
            if isinstance(retry_policy, dict):
                try:
                    retry_policy = RetryPolicy.from_dict(retry_policy)
                except (TypeError, ValueError) as e:
                    raise ValueError(f"bad retry policy: {e}") from None
            else:
                raise ValueError(
                    "retry_policy must be a RetryPolicy, a dict of its "
                    "fields, or None"
                )
        if hbm_budget_mib is None and mode not in ("swarm", "conformance"):
            # The service-wide default budget never applies to swarm or
            # conformance jobs — their device footprint is a fixed lane
            # shape, not a growing visited table.
            hbm_budget_mib = self.default_hbm_budget_mib
        # Budget-derived table sizing, validated AT ADMISSION: an
        # over-budget request (the budget cannot fit even one worst-case
        # wave of this model at the configured frontier) is rejected
        # here with a clear error, not discovered as an OOM/ValueError
        # on the scheduler thread mid-slice.
        derived_table_capacity = None
        if hbm_budget_mib is not None:
            derived_table_capacity = self._validate_budget(
                factory, aot_namespace, spawn, hbm_budget_mib
            )
        if mode == "conformance":
            packable, packable_reason = False, (
                "conformance batches are internally lane-packed (lanes "
                "= traces/histories); cross-tenant packing would break "
                "per-upload verdict determinism"
            )
        elif mode == "swarm":
            packable, packable_reason = self._classify_packable_swarm(
                aot_namespace=aot_namespace, options=options, spawn=spawn
            )
        else:
            packable, packable_reason = self._classify_packable(
                aot_namespace=aot_namespace,
                options=options,
                spawn=spawn,
                hbm_budget_mib=hbm_budget_mib,
            )
        if (
            packable
            and not _warm_pool
            and self.seed_store is not None
            and mode == "exhaustive"
            and self.spawn_method == "spawn_gpu_bfs"
            and not (options or {}).get("target_state_count")
            and not (options or {}).get("target_max_depth")
            and not (options or {}).get("complete_liveness")
        ):
            # Warm-start plane: seed artifacts ride the SOLO checkpoint
            # format (one visited-tier payload, empty frontier) — the
            # packed engine's per-tenant lanes cannot restore a
            # storage-seeded L1. A seed-eligible job therefore runs
            # solo; the reason is surfaced, not silent.
            packable = False
            packable_reason = (
                "warm-start plane: runs solo (seeds ride the solo "
                "checkpoint format)"
            )
        with self._cond:
            if self.max_queued_jobs is not None:
                # Bounded admission: graceful 429-style degradation
                # beats an unbounded backlog silently growing past any
                # deadline the tenants could still meet.
                backlog = sum(
                    1
                    for j in self._jobs.values()
                    if j.state
                    in (JOB_QUEUED, JOB_SUSPENDED, JOB_FAULTED, JOB_RUNNING)
                )
                if backlog >= self.max_queued_jobs:
                    self._m_rejected.inc()
                    raise QueueFullError(
                        self.max_queued_jobs,
                        retry_after_s=max(self.quantum_s, 1.0),
                    )
            seq = next(self._seq)
            # Default ids draw from the PROCESS-global sequence, not the
            # per-service one: the id doubles as the run_id keying the
            # process-global metrics registries, so two services in one
            # process (common in tests, possible in embedders) must
            # never mint the same "job-0" and merge two jobs' counters.
            jid = job_id or f"job-{next(_GLOBAL_JOB_SEQ)}"
            if jid in self._jobs:
                raise ValueError(f"duplicate job_id {jid!r}")
            job = CheckJob(
                jid,
                factory,
                model_name=model_name,
                options=options,
                spawn=spawn,
                priority=priority,
                deadline_s=deadline_s,
                tenant=tenant,
                hbm_budget_mib=hbm_budget_mib,
                aot_namespace=aot_namespace,
                retry_policy=retry_policy,
                timeout_s=timeout_s,
                mode=mode,
                seed=seed,
                seq=seq,
                clock=self._clock,
            )
            job.preemptible = (
                True
                # SwarmChecker / ConformanceChecker .supports_preempt
                if mode in ("swarm", "conformance")
                else self.spawn_method in _PREEMPTIBLE_SPAWNS
            )
            job.packable = packable
            job.packable_reason = packable_reason
            job.liveness_mode, job.liveness_reason = (
                self._classify_liveness(options, spawn, mode=mode)
            )
            job.derived_table_capacity = derived_table_capacity
            if _warm_pool:
                # Internal warm-up job from the warm pool: never packed
                # (packing would skip the solo path real jobs take), never
                # SLO-observed, never seeded.
                job.warm_pool = True
                job.packable = False
                job.packable_reason = "warm-pool precompile job"
            # The zoo kwargs, kept for the durable journal's
            # resubmission spec (the factory closure hides them).
            job._journal_model_args = (
                dict(model_args) if model_name is not None else None
            )
            if mode == "conformance":
                # Canonical wire lines for the journal; decoded records
                # for the checker (decoding is deterministic, so both
                # incarnations see identical inputs).
                job._conformance_lines = conformance_lines
                job._conformance_records = conformance_records
            self._jobs[jid] = job
            self._cond.notify_all()
        self._journal_submit(job)
        return JobHandle(job, self)

    # -- admission policy ---------------------------------------------------

    # Model-cache cap: a long-lived service fed many distinct zoo
    # configurations must not pin a packed-array model instance per
    # namespace forever (same retention rule as max_finished_jobs).
    _PACK_MODEL_CACHE_MAX = 32

    def _model_for(self, factory: Callable, aot_namespace: Optional[str]):
        """The job's model instance — cached per AOT namespace (the
        namespace asserts identical configuration, so one instance
        serves budget validation and every pack under that key);
        oldest-inserted entries evict past the cap."""
        if aot_namespace is None:
            return factory()
        model = self._pack_models.get(aot_namespace)
        if model is None:
            model = factory()
            self._pack_models[aot_namespace] = model
            while len(self._pack_models) > self._PACK_MODEL_CACHE_MAX:
                self._pack_models.pop(next(iter(self._pack_models)))
        return model

    def _validate_budget(
        self, factory, aot_namespace, spawn, hbm_budget_mib
    ) -> int:
        """Derives the tenant's device table capacity from its
        ``hbm_budget_mib`` (the budget IS the tenant's paid allocation —
        the fixed ``_DEFAULT_SPAWN`` constant both over-allocated poor
        tenants and growth-churned rich ones) and rejects inadmissible
        budgets up front. Returns the capacity in rows."""
        from ..checker.gpu import min_admissible_hbm_budget_mib
        from ..storage import max_table_rows_for_budget

        frontier = (spawn or {}).get(
            "frontier_capacity",
            self.default_spawn.get("frontier_capacity", 1 << 10),
        )
        model = self._model_for(factory, aot_namespace)
        min_budget = min_admissible_hbm_budget_mib(model, frontier)
        if hbm_budget_mib < min_budget:
            raise ValueError(
                f"hbm_budget_mib={hbm_budget_mib} rejected at admission: "
                f"one worst-case wave at frontier_capacity={frontier} "
                f"needs at least {min_budget:.3f} MiB for this model; "
                "raise the budget or shrink frontier_capacity"
            )
        return max_table_rows_for_budget(hbm_budget_mib)

    # default_spawn keys the packed engine either honors directly
    # (frontier/table shape, async pipelining) or that cannot change
    # packed semantics (max_drain_waves bounds SOLO preemption latency —
    # the engine is wave-granular by construction; aot_cache names the
    # SOLO namespace — packs use their own "pack:" one). Any
    # other service-wide default (budgets, expand_fps, hashset_impl,
    # checkpointing, ...) would be silently dropped by packing, so its
    # presence honestly disqualifies packing instead.
    _PACK_SAFE_DEFAULT_SPAWN = frozenset({
        "frontier_capacity",
        "table_capacity",
        "max_drain_waves",
        "aot_cache",
        "async_pipeline",
        # The packed engine honors device liveness directly (per-tenant
        # edge partitions; checker/packed_tenancy.py).
        "liveness",
    })

    def _classify_liveness(self, options, spawn, mode="exhaustive"):
        """The job's ``eventually``-verdict mode and, when the service
        must downgrade the request (backend without device liveness),
        the honest reason — the ``packable_reason`` pattern, so
        unsound-by-default semantics are visible in ``status()`` rather
        than discovered from a missed counterexample."""
        if mode == "conformance":
            # Verdicts are per-record replay/audit, not temporal
            # properties — there is nothing for a liveness mode to mean.
            return "default", None
        requested = (spawn or {}).get(
            "liveness", self.default_spawn.get("liveness")
        )
        host_pass = bool((options or {}).get("complete_liveness"))
        if mode == "swarm":
            if requested == "device" or host_pass:
                return "default", (
                    "swarm walks are sampling-based: eventually "
                    "verdicts come from walk-local traces (no edge "
                    "store, no lasso pass) — absence is never certified"
                )
            return "default", None
        if requested == "device":
            if self.spawn_method in _DEVICE_LIVENESS_SPAWNS:
                return "device", None
            reason = (
                f"backend {self.spawn_method!r} has no device liveness; "
                + (
                    "downgraded to the host post-pass"
                    if host_pass
                    else "downgraded to default (reference-parity) "
                    "semantics — eventually verdicts keep the "
                    "documented false negatives"
                )
            )
            return ("host_pass" if host_pass else "default"), reason
        if host_pass:
            return "host_pass", None
        return "default", None

    def _classify_packable(self, *, aot_namespace, options, spawn,
                           hbm_budget_mib):
        """Whether a submission qualifies for tenant-packed waves, and
        the honest reason when it does not (surfaced via ``status()`` so
        operators can see which jobs serialize the device)."""
        if not self.packing:
            return False, "packing disabled on this service"
        if self.spawn_method != "spawn_gpu_bfs":
            return False, f"spawn_method {self.spawn_method!r}"
        if aot_namespace is None:
            return False, "custom model (no AOT namespace to pack under)"
        if spawn:
            return False, f"spawn overrides {sorted(spawn)}"
        unsafe = set(self.default_spawn) - self._PACK_SAFE_DEFAULT_SPAWN
        if unsafe:
            return False, (
                f"service default_spawn overrides {sorted(unsafe)} "
                "(the packed engine cannot honor them)"
            )
        opts = options or {}
        if opts.get("symmetry"):
            return False, "symmetry reduction (orbit keys cannot salt)"
        if opts.get("target_state_count"):
            return False, "target_state_count (per-wave overshoot cap)"
        if hbm_budget_mib is not None:
            return False, "hbm_budget_mib (solo tiered run)"
        return True, None

    def _classify_packable_swarm(self, *, aot_namespace, options, spawn):
        """Swarm packability: lane blocks over one stacked dispatch
        (``checker/swarm.SwarmPackedEngine``). Per-tenant depth caps
        and state targets are runtime scalars, so — unlike exhaustive
        packing — they do NOT disqualify; only a fleet-shape override
        or symmetry does."""
        if not self.packing:
            return False, "packing disabled on this service"
        if aot_namespace is None:
            return False, "custom model (no AOT namespace to pack under)"
        if spawn:
            return False, (
                f"spawn overrides {sorted(spawn)} (a packed swarm "
                "shares one fleet shape)"
            )
        if (options or {}).get("symmetry"):
            return False, "symmetry (host-only for walk cycle checks)"
        return True, None

    # -- durable recovery (service_dir mode) --------------------------------

    def _durable_spec(self, job: CheckJob) -> Optional[dict]:
        """The JSON-safe resubmission spec for one job, or None when the
        job cannot be journaled (a custom ``model_factory`` has no
        serializable identity — surfaced honestly as ``durable: false``
        instead of silently losing the job in a crash)."""
        if job.mode == "conformance":
            # The canonical wire lines ARE the job's identity: decoding
            # is deterministic, so a journal-resubmitted incarnation
            # audits the exact same records (bit-identical verdicts).
            spec = {
                "mode": "conformance",
                "records": list(getattr(job, "_conformance_lines", [])),
                "spawn": job.spawn or None,
                "priority": job.priority,
                "deadline_s": job.deadline_s,
                "tenant": job.tenant,
                "timeout_s": job.timeout_s,
                "retry_policy": (
                    job.retry_policy.to_dict()
                    if job.retry_policy is not None
                    else None
                ),
            }
            try:
                json.dumps(spec)
            except (TypeError, ValueError):
                return None
            return spec
        if job.model_name is None:
            return None
        spec = {
            "model_name": job.model_name,
            "model_args": getattr(job, "_journal_model_args", None),
        }
        spec.update(
            options=job.options or None,
            spawn=job.spawn or None,
            mode=job.mode,
            seed=job.seed,
            priority=job.priority,
            deadline_s=job.deadline_s,
            tenant=job.tenant,
            hbm_budget_mib=job.hbm_budget_mib,
            timeout_s=job.timeout_s,
            retry_policy=(
                job.retry_policy.to_dict()
                if job.retry_policy is not None
                else None
            ),
        )
        try:
            json.dumps(spec)
        except (TypeError, ValueError):
            return None
        return spec

    def _journal_write(self, record: dict) -> None:
        if self._journal_fh is None:
            return
        try:
            line = json.dumps(record, sort_keys=True)
        except (TypeError, ValueError):
            return
        with self._journal_lock:
            try:
                self._journal_fh.write(line + "\n")
                self._journal_fh.flush()
            except (OSError, ValueError):
                # A dead journal degrades durability, not the service.
                self._m_ckpt_errors.inc()

    def _journal_submit(self, job: CheckJob) -> None:
        if self._journal_fh is None:
            return
        spec = self._durable_spec(job)
        job.durable = spec is not None
        self._journal_write({
            "ev": "submit",
            "t": time.time(),
            "job_id": job.job_id,
            "durable": job.durable,
            "spec": spec,
        })

    def _journal_state(self, job: CheckJob) -> None:
        """One WAL line per externally-meaningful transition (suspend /
        fault / terminal): recover() replays these to rebuild the
        queue."""
        if self._journal_fh is None:
            return
        record = {
            "ev": "state",
            "t": time.time(),
            "job_id": job.job_id,
            "state": job.state,
            "preempts": job.preempts,
            "retries": job.retries,
            "error": job.error,
        }
        if job.state == JOB_DONE and isinstance(job.result, dict):
            # The finished-job record recover() must reconstruct: the
            # scalar verdict plus the golden report (bit-identity
            # evidence) — the heavy ledgers stay in memory only.
            record["result"] = {
                k: job.result.get(k)
                for k in (
                    "unique", "states", "max_depth", "properties_hold",
                    "rate", "report", "discoveries",
                )
            }
        self._journal_write(record)

    def _checkpoint_path_for(self, job_id: str) -> Optional[str]:
        if self.service_dir is None:
            return None
        return os.path.join(self.service_dir, "jobs", f"{job_id}.ckpt")

    def _checkpoint_job(self, job: CheckJob) -> None:
        """Atomic per-job durable checkpoint (rides ``atomic_pickle``):
        written at every suspend/fault boundary so a process crash
        resumes the job from its last good wave boundary instead of
        from scratch. Best-effort — a failed write degrades durability
        and counts ``service.recovery.checkpoint_errors``, it never
        fails the job."""
        path = self._checkpoint_path_for(job.job_id)
        if path is None or job.payload is None or not job.durable:
            return
        from ..checker.gpu import atomic_pickle

        try:
            atomic_pickle(path, job.payload)
        except Exception:  # noqa: BLE001 - durability is best-effort
            self._m_ckpt_errors.inc()

    def _drop_checkpoint(self, job_id: str) -> None:
        path = self._checkpoint_path_for(job_id)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    @classmethod
    def recover(cls, service_dir: str, **kwargs) -> "CheckService":
        """Rebuilds a service from its crash remains: replays the WAL
        journal, reconstructs finished/failed/quarantined job records
        (handles keep answering), and RESUBMITS every unfinished
        durable job under its original id — resuming from its last
        durable checkpoint pickle when one exists, from scratch
        otherwise (both bit-identical to an uninterrupted run).
        Unfinished jobs that were submitted as ``durable: false`` are
        surfaced as failed records, never silently dropped."""
        import pickle

        journal_path = os.path.join(service_dir, "journal.jsonl")
        records: List[dict] = []
        if os.path.exists(journal_path):
            with open(journal_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # torn tail from the crash itself
        svc = cls(service_dir=service_dir, **kwargs)
        # Gate the scheduler while payloads are being re-attached: a
        # resubmitted job must not be spawned before its checkpoint is
        # restored onto it (it would re-explore from scratch AND race
        # the payload write).
        svc._admission_hold = True
        from ..telemetry import metrics_registry

        reg = metrics_registry()
        c_restored = reg.counter("service.recovery.jobs_restored")
        c_resumed = reg.counter("service.recovery.jobs_resumed")
        c_lost = reg.counter("service.recovery.jobs_unrecoverable")
        reg.counter("service.recovery.journal_records").inc(len(records))

        submits: Dict[str, dict] = {}
        last_state: Dict[str, dict] = {}
        for rec in records:
            jid = rec.get("job_id")
            if rec.get("ev") == "submit":
                submits[jid] = rec
            elif rec.get("ev") == "state":
                last_state[jid] = rec
        for jid, sub in submits.items():
            state_rec = last_state.get(jid, {})
            state = state_rec.get("state", JOB_QUEUED)
            if state in (JOB_DONE, JOB_FAILED, JOB_CANCELLED,
                         JOB_QUARANTINED):
                # Terminal: reconstruct the record (no re-run).
                job = CheckJob(
                    jid, lambda: None,
                    model_name=(sub.get("spec") or {}).get("model_name"),
                    seq=next(svc._seq), clock=svc._clock,
                )
                job.durable = bool(sub.get("durable"))
                job.state = state
                job.preempts = int(state_rec.get("preempts") or 0)
                job.retries = int(state_rec.get("retries") or 0)
                job.result = state_rec.get("result")
                job.error = state_rec.get("error")
                job.finished_t = svc._clock()
                job.done_event.set()
                with svc._cond:
                    svc._jobs[jid] = job
                c_restored.inc()
                continue
            if not sub.get("durable") or not sub.get("spec"):
                # An unfinished non-journalable job: lost with the
                # process, and said so.
                job = CheckJob(
                    jid, lambda: None, seq=next(svc._seq),
                    clock=svc._clock,
                )
                job.state = JOB_FAILED
                job.error = (
                    "lost in service crash: submitted with a custom "
                    "model (durable: false), cannot be re-spawned from "
                    "the journal"
                )
                job.finished_t = svc._clock()
                job.done_event.set()
                with svc._cond:
                    svc._jobs[jid] = job
                c_lost.inc()
                continue
            spec = dict(sub["spec"])
            retry = spec.pop("retry_policy", None)
            # Replay bypasses the admission bound: these jobs were
            # already admitted before the crash — bouncing the backlog
            # overflow with QueueFullError mid-replay would abort the
            # very recovery the journal exists for.
            saved_limit, svc.max_queued_jobs = svc.max_queued_jobs, None
            try:
                retry_kw = (
                    RetryPolicy.from_dict(retry)
                    if retry is not None
                    else None
                )
                if spec.get("mode") == "conformance":
                    handle = svc.submit(
                        conformance=spec.pop("records"),
                        job_id=jid,
                        retry_policy=retry_kw,
                        **{
                            k: v for k, v in spec.items() if v is not None
                        },
                    )
                else:
                    handle = svc.submit(
                        model_name=spec.pop("model_name"),
                        model_args=spec.pop("model_args", None) or {},
                        job_id=jid,
                        retry_policy=retry_kw,
                        **{
                            k: v for k, v in spec.items() if v is not None
                        },
                    )
            except (ValueError, RuntimeError) as e:
                # One rotten journal entry must not abort the rest of
                # the replay — surface it as an explicit failed record.
                job = CheckJob(
                    jid, lambda: None,
                    model_name=(sub.get("spec") or {}).get("model_name"),
                    seq=next(svc._seq), clock=svc._clock,
                )
                job.state = JOB_FAILED
                job.error = f"journal replay failed: {e!r}"
                job.finished_t = svc._clock()
                job.done_event.set()
                with svc._cond:
                    svc._jobs.setdefault(jid, job)
                c_lost.inc()
                continue
            finally:
                svc.max_queued_jobs = saved_limit
            job = svc.job(handle.job_id)
            job.preempts = int(state_rec.get("preempts") or 0)
            job.retries = int(state_rec.get("retries") or 0)
            ckpt = svc._checkpoint_path_for(jid)
            if ckpt and os.path.exists(ckpt):
                try:
                    with open(ckpt, "rb") as f:
                        job.payload = pickle.load(f)
                    job.state = JOB_SUSPENDED
                except Exception:  # noqa: BLE001 - corrupt ckpt = restart
                    svc._m_ckpt_errors.inc()
            c_resumed.inc()
        svc._admission_hold = False
        svc._wake()
        return svc

    # -- introspection ------------------------------------------------------

    def job(self, job_id: str) -> Optional[CheckJob]:
        with self._cond:
            return self._jobs.get(job_id)

    def jobs(self) -> List[CheckJob]:
        with self._cond:
            return sorted(self._jobs.values(), key=lambda j: j.seq)

    def status(self) -> dict:
        js = self.jobs()
        out = {
            "quantum_s": self.quantum_s,
            "closing": self._closing.is_set(),
            "jobs": [j.status() for j in js],
            "counts": {
                state: sum(1 for j in js if j.state == state)
                for state in (
                    JOB_QUEUED, JOB_RUNNING, JOB_SUSPENDED, JOB_FAULTED,
                    JOB_DONE, JOB_FAILED, JOB_CANCELLED, JOB_QUARANTINED,
                )
            },
        }
        out["warm_start"] = {
            "enabled": self.warm_start and self.aot_store is not None,
        }
        if self.warm_pool_status:
            out["warm_start"]["pool"] = {
                ns: dict(entry)
                for ns, entry in self.warm_pool_status.items()
            }
        return out

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    # -- the scheduler loop -------------------------------------------------

    def _pick(self) -> Optional[CheckJob]:
        """Highest-priority runnable job (the admission order
        ``CheckJob.sort_key``); reaps cancelled queued jobs in passing.
        Caller holds the condition lock."""
        if self._admission_hold:
            return None
        best = None
        for job in self._jobs.values():
            if not job.runnable():
                continue
            if job.cancel_event.is_set():
                job.payload = None
                job.finish(JOB_CANCELLED)
                continue
            if best is None or job.sort_key() < best.sort_key():
                best = job
        return best

    def _should_preempt_for_peer(self, current: CheckJob) -> bool:
        """Whether suspending the current job at quantum expiry would
        actually hand the device to someone else: some other runnable
        job must sort AHEAD of where the current job would re-enter the
        queue (its round-robin clock stamped to "just ran"). Comparing
        the real sort keys — not just priority — keeps EDF jobs honest
        too: a finite-deadline job sorts first within its class
        regardless of recency, so a priority-only guard would preempt
        it every quantum only to re-pick it (pure checkpoint/restore
        churn) while its peers starve behind the respawn overhead."""
        current_key = current.sort_key(last_run_override=self._clock())
        with self._cond:
            return any(
                j is not current
                and j.runnable()
                and not j.cancel_event.is_set()
                and j.sort_key() < current_key
                for j in self._jobs.values()
            )

    def _run_scheduler(self) -> None:
        while True:
            with self._cond:
                job = self._pick()
                while job is None and not self._closing.is_set():
                    self._cond.wait(timeout=0.5)
                    job = self._pick()
                if self._closing.is_set():
                    return
            try:
                if self.packing and job.packable:
                    self._run_packed_slice(job)
                else:
                    self._run_slice(job)
            except Exception as e:  # noqa: BLE001 - a job must not kill the loop
                # Scheduler-infrastructure faults route through the
                # retry policy like slice faults — with the real
                # traceback attached, never a bare repr.
                if job.state not in (
                    JOB_DONE, JOB_FAILED, JOB_CANCELLED, JOB_QUARANTINED,
                    JOB_SUSPENDED, JOB_FAULTED,
                ):
                    self._fault_job(job, e)
            self._evict_finished()

    # -- fault routing (the self-healing core) ------------------------------

    def _fault_job(self, job: CheckJob, exc: BaseException,
                   checker=None, snapshot: Optional[dict] = None) -> None:
        """Routes one slice fault into the retry machinery: classify
        the fault, harvest the best resume payload available (a preempt
        payload the dying checker managed to yield beats the pre-slice
        snapshot beats from-scratch), and let the job's policy decide
        faulted/quarantined/failed. Metrics + journal + durable
        checkpoint ride every outcome."""
        fault_class = classify_fault(exc)
        tb = _format_exc(exc)
        payload = None
        digest = None
        if checker is not None:
            try:
                payload = checker.preempt_payload()
            except Exception:  # noqa: BLE001 - harvest is best-effort
                payload = None
            try:
                digest = checker.state_digest()
            except Exception:  # noqa: BLE001
                digest = None
        if payload is None:
            payload = snapshot
        self._m_faults.inc()
        self._fault_class_counter(fault_class).inc()
        state = job.fault(
            fault_class, repr(exc), tb, payload=payload, digest=digest
        )
        if state == JOB_FAULTED:
            self._m_retries.inc()
            self._checkpoint_job(job)
        else:
            # Terminal (quarantined, or failed for a non-retryable
            # class): the durable checkpoint must not outlive the job.
            if state == JOB_QUARANTINED:
                self._m_quarantined.inc()
            self._drop_checkpoint(job.job_id)
        self._journal_state(job)

    def _spawn(self, job: CheckJob):
        if job.mode == "conformance":
            from ..conformance.checker import ConformanceChecker

            sp = job.spawn or {}
            checker = ConformanceChecker(
                job._conformance_records,
                self.zoo,
                run_id=job.run_id,
                batch_lanes=int(sp.get("batch_lanes", 64)),
                parity=bool(sp.get("parity", False)),
                resume_from=job.payload,
                tenant=job.tenant,
                device=self.device,
            )
            job.payload = None
            return checker
        if job.mode == "swarm":
            # Per-namespace instance, not a fresh factory() call: the
            # swarm's step cache pins the model by identity, so a solo
            # swarm job's second run (and every preempted job's next
            # incarnation) reuses its step, exactly like the pack path.
            model = self._model_for(job.model_factory, job.aot_namespace)
        else:
            # Exhaustive solo jobs keep their own instance: sharing here
            # would let a user-supplied namespace that lies about the
            # configuration silently swap the model.
            model = job.model_factory()
        builder = model.checker()
        opts = job.options
        if opts.get("target_state_count"):
            builder = builder.target_state_count(opts["target_state_count"])
        if opts.get("target_max_depth"):
            builder = builder.target_max_depth(opts["target_max_depth"])
        if opts.get("symmetry"):
            builder = builder.symmetry()
        if job.mode == "swarm":
            # Swarm jobs spawn the device-resident walker regardless of
            # the service's exhaustive spawn_method; their spawn surface
            # is the fleet shape, not the BFS knobs.
            spawn = dict(self.default_swarm_spawn)
            spawn.update(job.spawn)
            spawn["run_id"] = job.run_id
            spawn["device"] = self.device
            if job.aot_namespace is not None:
                spawn.setdefault(
                    "aot_cache", f"swarm:{job.aot_namespace}"
                )
            if job.payload is not None:
                spawn["resume_from"] = job.payload
                job.payload = None
            return builder.spawn_swarm(seed=job.seed, **spawn)
        if opts.get("complete_liveness"):
            builder = builder.complete_liveness(
                budget_states=opts.get("liveness_budget_states"),
                deadline_s=opts.get("liveness_deadline_s"),
            )
        spawn = dict(self.default_spawn)
        spawn.update(job.spawn)
        if (
            spawn.get("liveness") == "device"
            and self.spawn_method not in _DEVICE_LIVENESS_SPAWNS
        ):
            # Honest downgrade (job.liveness_reason says so): the
            # backend cannot honor the knob; passing it through would
            # fail the job on a TypeError instead.
            spawn.pop("liveness", None)
        if (
            job.derived_table_capacity is not None
            and "table_capacity" not in job.spawn
        ):
            # The tenant's budget, not the fixed default, sizes its
            # device table (see _validate_budget).
            spawn["table_capacity"] = job.derived_table_capacity
        spawn["run_id"] = job.run_id
        spawn["device"] = self.device
        # The namespace is a single-device-checker knob (the sharded
        # checker has none); passing it unconditionally would TypeError
        # every job under spawn_method="spawn_sharded_gpu_bfs".
        if (
            job.aot_namespace is not None
            and self.spawn_method == "spawn_gpu_bfs"
        ):
            spawn.setdefault("aot_cache", job.aot_namespace)
        # The disk record rides along where a checker keeps one: the solo
        # checker, under a namespace.
        if (
            self.aot_store is not None
            and self.spawn_method == "spawn_gpu_bfs"
            and spawn.get("aot_cache") is not None
        ):
            spawn.setdefault("aot_store", self.aot_store)
        if job.hbm_budget_mib is not None:
            spawn.setdefault("hbm_budget_mib", job.hbm_budget_mib)
        if job.payload is None:
            # Incremental re-checking: a finished run of this exact
            # model may have left a seed — attach it as a resume payload
            # so the run completes in O(verify), not O(explore).
            self._maybe_attach_seed(job, model, spawn, opts)
        if job.payload is not None:
            spawn["resume_from"] = job.payload
            job.payload = None
        method = getattr(builder, self.spawn_method)
        import inspect

        sig = inspect.signature(method)
        if not any(
            p.kind is p.VAR_KEYWORD for p in sig.parameters.values()
        ):
            # Host-engine spawn methods (spawn_bfs/dfs/...) take no
            # kwargs: drop the device-spawn defaults (run_id and device
            # included — their metrics land in the default registry) so the
            # degrade-gracefully branch below is actually reachable
            # instead of dying on a TypeError at spawn.
            spawn = {k: v for k, v in spawn.items() if k in sig.parameters}
        return method(**spawn)

    # -- warm-start plane (persistent AOT + incremental re-checking) --------

    _SEED_SPAWN_BLOCKERS = ("liveness", "resume_from")

    def _seedable(self, job: CheckJob, opts: dict) -> bool:
        """Whether this job's configuration is in the seed plane at all:
        solo exhaustive, full-space (no targets), safety-only. Liveness
        and swarm verdicts depend on more than the visited set; a
        targeted run's seed would silently shrink a later full run."""
        return (
            self.seed_store is not None
            and self.warm_start
            and not job.warm_pool
            and job.mode == "exhaustive"
            and self.spawn_method == "spawn_gpu_bfs"
            and not opts.get("target_state_count")
            and not opts.get("target_max_depth")
            and not opts.get("complete_liveness")
            and not any(job.spawn.get(k) for k in self._SEED_SPAWN_BLOCKERS)
        )

    def _seed_structure(self, job: CheckJob, model):
        """The (model-structure, params) signature, memoized on the job
        (it digests the model's code and values: cheap, but not free)."""
        cached = getattr(job, "_seed_structure_cache", None)
        if cached is not None:
            return cached
        from ..storage.persist import model_structure_signature

        structure = model_structure_signature(model)
        job._seed_structure_cache = structure
        return structure

    def _maybe_attach_seed(self, job: CheckJob, model, spawn: dict,
                           opts: dict) -> None:
        """Seeds a fresh submission from a persisted finished run of the
        same model signature: the checker restores the seed's visited
        tiers + exact counts and completes in O(verify). Every refusal
        path is the conservative fallback — the job simply runs cold."""
        if not self._seedable(job, opts):
            return
        if spawn.get("liveness"):
            # The merged spawn may carry a service-default liveness mode
            # the job dict doesn't — liveness verdicts depend on more
            # than the visited set, so they stay out of the seed plane.
            return
        try:
            structure = self._seed_structure(job, model)
        except Exception as e:  # noqa: BLE001 - seeding is an optimization
            job.warm_start_reason = f"signature failed: {e!r}"
            return
        artifact, reason = self.seed_store.load(structure["family"])
        if artifact is None:
            if not reason.startswith("no seed"):
                self._m_seed_refused.inc()
                job.warm_start_reason = reason
            return
        from ..storage.persist import (
            adapt_seed_checkpoint,
            seed_compatibility,
        )

        ckpt = artifact.get("checkpoint") or {}
        if bool(ckpt.get("symmetry")) != bool(opts.get("symmetry")):
            self._m_seed_refused.inc()
            job.warm_start_reason = (
                "symmetry mismatch between seed and submission"
            )
            return
        verdict = seed_compatibility(artifact, structure)
        if not verdict.get("compatible"):
            self._m_seed_refused.inc()
            job.warm_start_reason = verdict.get("reason", "incompatible")
            return
        try:
            payload = adapt_seed_checkpoint(artifact, model)
        except Exception as e:  # noqa: BLE001
            self._m_seed_refused.inc()
            job.warm_start_reason = f"seed adaptation failed: {e!r}"
            return
        counts = artifact.get("counts") or {}
        digest = structure["digest"]
        spawn["resume_from"] = payload
        job.warm_start = True
        job.seeded_from = {
            "signature": digest,
            "family": structure["family"],
            "mode": verdict.get("mode", "exact"),
            "runs": int(counts.get("runs", 0)),
            "keys": int(counts.get("keys", 0)),
            "unique": int(counts.get("unique", 0)),
            "invalidated_uniques": int(
                verdict.get("invalidated_uniques", 0)
            ),
        }
        # Honest capability surfacing: the reporter names the seed so a
        # verdict reader knows this run re-verified a persisted space.
        notes = list(spawn.get("config_notes") or ())
        notes.append(
            f"warm-start: seeded from persisted run {digest[:12]} "
            f"(mode={job.seeded_from['mode']}, "
            f"runs={job.seeded_from['runs']}, "
            f"keys={job.seeded_from['keys']})"
        )
        spawn["config_notes"] = notes
        self._m_seed_loaded.inc()

    def _save_seed(self, job: CheckJob, checker) -> None:
        """Persists a finished full exhaustive run as a warm-start seed.
        Strictly an optimization: every failure is swallowed (the
        verdict is already complete), and an already-seeded job's space
        is content-identical to its seed, so re-saving is skipped."""
        if job.warm_start or not self._seedable(job, job.options):
            return
        if getattr(checker, "_live_enabled", False):
            return
        try:
            from ..storage.persist import build_seed_artifact

            structure = self._seed_structure(job, checker._model)
            payload = checker.checkpoint_payload([])
            artifact = build_seed_artifact(
                structure,
                payload,
                coverage=(job.result or {}).get("coverage"),
            )
            if self.seed_store.save(artifact) is not None:
                self._m_seed_saved.inc()
        except Exception:  # noqa: BLE001 - seeds never gate verdicts
            pass

    def _warm_shapes(self, warm_pool):
        """Normalizes the ``warm_pool=`` option into
        ``(namespace, model_name, model_args)`` triples."""
        if warm_pool is True:
            from .zoo import warm_shapes as zoo_warm_shapes

            pairs = zoo_warm_shapes()
        else:
            pairs = [
                (name, dict(args or {})) for name, args in warm_pool
            ]
        out = []
        for name, args in pairs:
            if name not in self.zoo:
                continue
            out.append((zoo_namespace(name, args), name, args))
        return out

    def _warm_pool_worker(self, shapes) -> None:
        """Prepares each registered shape by running it as a
        rock-bottom-priority depth-2 job (``target_max_depth``): the run
        builds the kernels real jobs of that shape launch (before its
        first wave when the namespace's disk record is a hit) and leaves
        the record; then the shape's conformance replay graph."""
        for ns, name, args in shapes:
            if self._closing.is_set():
                break
            entry = self.warm_pool_status[ns]
            try:
                handle = self.submit(
                    model_name=name,
                    model_args=args,
                    options={"target_max_depth": 2},
                    priority=-(2**20),
                    _warm_pool=True,
                )
                entry["job_id"] = handle.job_id
                handle.result(timeout=600.0)
                self._warm_conformance(ns, name, args)
                entry["state"] = "ready"
            except Exception as e:  # noqa: BLE001 - warmth is best-effort
                entry["state"] = "failed"
                entry["error"] = repr(e)
            ready = sum(
                1 for s in self.warm_pool_status.values()
                if s["state"] == "ready"
            )
            pending = sum(
                1 for s in self.warm_pool_status.values()
                if s["state"] == "pending"
            )
            self._g_pool_ready.set(ready)
            self._g_pool_pending.set(pending)

    def _warm_conformance(self, ns: str, name: str, args: dict) -> None:
        """Conformance-plane warm-pool registration: the replay graph for
        this zoo shape, captured (and run once on an inert batch) at the
        default batch geometry, so a first conformance upload of a warm
        shape replays without the capture stall. Best-effort, like the
        rest of the pool. The capture runs on this thread while the
        scheduler may capture a drain: ``conformance/replay.py``'s lock
        and both captures' ``thread_local`` mode keep them apart."""
        try:
            from ..conformance.replay import warm_replay

            factory = self.zoo[name]
            model = self._model_for(lambda: factory(**args), ns)
            warm_replay(
                model, ns, _CONFORMANCE_WARM_T, _CONFORMANCE_WARM_L,
                device=self.device,
            )
        except Exception:  # noqa: BLE001 - warmth is best-effort
            pass

    def _poll_discoveries(self, job: CheckJob, checker) -> None:
        try:
            names = set(checker._discovery_names())
        except Exception:  # noqa: BLE001 - mid-run best effort
            return
        fresh = names - job.seen_discoveries
        if fresh:
            job.seen_discoveries |= names
            if job.first_discovery_t is None:
                job.first_discovery_t = self._clock()

    def _timed_out(self, job: CheckJob) -> bool:
        return (
            job.timeout_s is not None
            and self._clock() - job.submitted_t >= job.timeout_s
        )

    def _fail_timeout(self, job: CheckJob, checker=None,
                      view_digest=None) -> None:
        """Wall-clock timeout: the job fails WITH partial-progress
        evidence (how far it got, and whether a resumable payload
        existed) — an operator must be able to tell a hung model from
        an under-provisioned deadline."""
        digest = view_digest
        if digest is None and checker is not None:
            try:
                digest = checker.state_digest()
            except Exception:  # noqa: BLE001 - evidence is best-effort
                digest = None
        self._m_timeouts.inc()
        job.fail(
            f"timeout: exceeded timeout_s={job.timeout_s} "
            f"(wall {self._clock() - job.submitted_t:.1f}s)",
            flight={
                "reason": "timeout",
                "partial_progress": digest,
                "preempts": job.preempts,
                "slices": job.slices,
                "resumable_payload": job.payload is not None
                or (checker is not None and checker.preempted),
            },
        )
        self._journal_state(job)
        self._drop_checkpoint(job.job_id)

    def _make_watchdog(self, job: CheckJob, checker):
        """The per-slice stall watchdog (telemetry/server.py's engine,
        polled inline — no extra thread): no progress for
        ``stall_deadline_s`` fires the action hook, whose default
        auto-preempts so the wedged job suspends at its next yield
        point and retries from that wave boundary. A deep drain shows
        progress only at its exit, so ``max_drain_waves`` bounds how
        late a stall inside a drain is seen (and a drain that legitimately
        outlasts the deadline reads as one)."""
        if self.stall_deadline_s is None:
            return None
        from ..telemetry.server import StallWatchdog

        def action(idle_s):
            self._m_stall_preempts.inc()
            job.stall_preempts += 1
            if self.on_stall is not None:
                self.on_stall(job, checker, idle_s)
            else:
                try:
                    checker.request_preempt()
                except NotImplementedError:
                    pass

        return StallWatchdog(
            self.stall_deadline_s,
            clock=self._clock,
            on_stall=action,
            done_fn=checker.is_done,
        )

    def _run_slice(self, job: CheckJob) -> None:
        """One scheduling slice: (re)spawn the job's checker, let it run
        for up to a quantum (to completion when nothing else wants the
        device), then preempt/harvest. Strictly serialized — the device
        has exactly one claimant at any time."""
        job.state = JOB_RUNNING
        job.slices += 1
        # Snapshot the resume payload BEFORE _spawn consumes it: a
        # faulted slice hands this back so the retry resumes from the
        # last good wave boundary instead of re-exploring from scratch.
        resume_snapshot = job.payload
        t0 = self._clock()
        if job.started_t is None:
            job.started_t = t0
        try:
            checker = self._spawn(job)
        except Exception as e:  # noqa: BLE001 - bad knobs/model = job failure
            # Spawn-time errors are configuration, not transient faults:
            # no retry, but the real traceback survives.
            job.fail(repr(e), _format_exc(e))
            self._journal_state(job)
            self._drop_checkpoint(job.job_id)
            return
        self._active_checker = checker
        # Honest preemptibility: the admission-time guess (spawn-method
        # map) corrected from the live checker's own declaration.
        job.preemptible = bool(getattr(checker, "supports_preempt", False))
        # On resume, the restored discoveries must not count as "first".
        self._poll_discoveries(job, checker)
        slice_end = t0 + self.quantum_s
        watchdog = self._make_watchdog(job, checker)
        progress_mark = None

        # A backend without preemption support (host engines raise
        # NotImplementedError from the base request_preempt) degrades
        # gracefully: its slice simply runs to completion — failing the
        # job while its worker threads live on would leave TWO checkers
        # claiming the device once the scheduler moved on.
        def try_preempt() -> bool:
            try:
                checker.request_preempt()
                return True
            except NotImplementedError:
                job.preemptible = False
                return False

        preempting = False
        preemptible = True
        timed_out = False
        stalled = False  # stall action fires at most once per slice
        try:
            while not checker.is_done():
                if (job.cancel_event.is_set() or self._closing.is_set()) \
                        and not preempting and preemptible:
                    preemptible = preempting = try_preempt()
                elif (
                    not preempting
                    and preemptible
                    and self._timed_out(job)
                ):
                    # Wall-clock budget blown: stop at the next wave
                    # boundary and fail with the partial progress.
                    timed_out = True
                    preemptible = preempting = try_preempt()
                elif (
                    not preempting
                    and preemptible
                    and self._clock() >= slice_end
                    and self._should_preempt_for_peer(job)
                ):
                    preemptible = preempting = try_preempt()
                self._poll_discoveries(job, checker)
                if watchdog is not None and not preempting and not stalled:
                    # Progress = counters moving, or the slice still in
                    # its compile/restore warmup (no waves CAN land yet
                    # — warmup must not read as a stall). The action
                    # hook fires at most once per slice: after an
                    # auto-preempt the slice is already on its way out,
                    # and refiring every poll would be pure churn.
                    mark = (
                        checker.state_count(),
                        checker.unique_state_count(),
                    )
                    if (
                        mark != progress_mark
                        or getattr(checker, "warmup_seconds", None) is None
                    ):
                        progress_mark = mark
                        watchdog.pet()
                    elif watchdog.poll():
                        stalled = True
                time.sleep(self.poll_interval_s)
            for h in checker.handles():
                h.join()
            self._poll_discoveries(job, checker)
        finally:
            self._active_checker = None
            job.active_s += self._clock() - t0
            job.last_run_t = self._clock()
            job.warmup_s += getattr(checker, "warmup_seconds", None) or 0.0
        err = checker.worker_error()
        if err is not None:
            self._fault_job(job, err, checker=checker,
                            snapshot=resume_snapshot)
            return
        if job.cancel_event.is_set():
            job.finish(JOB_CANCELLED)
            self._journal_state(job)
            self._drop_checkpoint(job.job_id)
            return
        if (timed_out or self._timed_out(job)) and checker.preempted:
            # Timeout is enforced at the next yield point; a run that
            # COMPLETED before it could be stopped keeps its verdict
            # (on a non-preemptible backend the deadline simply cannot
            # cut the slice — discarding a finished result would make
            # the outcome depend on which preempt attempt fired first).
            self._fail_timeout(job, checker=checker)
            return
        if checker.preempted:
            job.suspend(checker.preempt_payload())
            self._checkpoint_job(job)
            self._journal_state(job)
            return
        if job.retries:
            self._m_recovered.inc()
        job.complete(self._finalize(job, checker))
        self._save_seed(job, checker)
        if not job.warm_pool:
            self.slo.observe(job)
        self._journal_state(job)
        self._drop_checkpoint(job.job_id)

    # -- the packer (tenant-packed waves) -----------------------------------

    def _pack_peers(self, key: str, members: Dict[str, CheckJob],
                    mode: str = "exhaustive"):
        """Runnable packable same-configuration same-mode jobs not yet
        in the pack — the admission candidates, best-first. (A swarm
        fleet and an exhaustive wave cannot share a dispatch.)"""
        with self._cond:
            peers = [
                j
                for j in self._jobs.values()
                if j.job_id not in members
                and j.runnable()
                and not j.cancel_event.is_set()
                and j.packable
                and j.aot_namespace == key
                and j.mode == mode
            ]
        return sorted(peers, key=lambda j: j.sort_key())

    def _pack_contender(self, key: str, members: Dict[str, CheckJob],
                        can_join: bool,
                        mode: str = "exhaustive") -> bool:
        """Whether a runnable job OUTSIDE the pack — one that cannot
        simply join it — sorts ahead of where the pack's best member
        would re-enter the queue. Same honesty rule as
        ``_should_preempt_for_peer``: suspending the pack must actually
        hand the device to someone else. A same-shape packable job
        counts as a contender too once the pack has no free lane
        (``can_join=False``) — otherwise a full pack would starve a
        higher-priority same-shape arrival that the time-slicer would
        have preempted for."""
        now = self._clock()
        reentry = min(
            j.sort_key(last_run_override=now) for j in members.values()
        )
        with self._cond:
            return any(
                j.job_id not in members
                and j.runnable()
                and not j.cancel_event.is_set()
                and not (
                    can_join
                    and j.packable
                    and j.aot_namespace == key
                    and j.mode == mode
                )
                and j.sort_key() < reentry
                for j in self._jobs.values()
            )

    def _pack_admit(self, engine, job: CheckJob):
        """Claims a lane slot for one job (restoring its suspended
        payload slice, if any); stamps the membership clocks only AFTER
        the admission succeeds — a failed admit must not leave the job
        reporting packed:true with a counted slice."""
        if job.mode == "swarm":
            view = engine.admit(
                job.job_id,
                job.run_id,
                seed=job.seed,
                depth_cap=job.options.get("target_max_depth"),
                target_state_count=job.options.get("target_state_count"),
                resume_from=job.payload,
            )
        else:
            view = engine.admit(
                job.job_id,
                job.run_id,
                depth_cap=job.options.get("target_max_depth"),
                resume_from=job.payload,
            )
        job.payload = None
        job.state = JOB_RUNNING
        job.slices += 1
        job.packed = True
        now = self._clock()
        if job.started_t is None:
            job.started_t = now
        job.pack_join_t = now
        # Restored discoveries must not count as "first" for ttfv.
        try:
            job.seen_discoveries |= set(view._discovery_names())
        except Exception:  # noqa: BLE001 - best effort
            pass
        return view

    def _try_pack_admit(self, engine, job, members, views,
                        snapshots) -> bool:
        # The pre-admit payload is the job's last checkpointed boundary:
        # a later engine-wide fault retries the member from here (the
        # honest fallback when the pack's own state cannot be trusted).
        snapshot = job.payload
        try:
            view = self._pack_admit(engine, job)
        except Exception as e:  # noqa: BLE001 - admit faults route to retry
            job.payload = snapshot
            self._fault_job(job, e, snapshot=snapshot)
            return False
        members[job.job_id] = job
        views[job.job_id] = view
        snapshots[job.job_id] = snapshot
        return True

    def _pack_leave(self, job: CheckJob, view) -> None:
        """Membership clocks on any exit (complete/suspend/cancel)."""
        now = self._clock()
        job.active_s += now - (job.pack_join_t or now)
        job.pack_join_t = None
        job.last_run_t = now
        job.warmup_s += getattr(view, "warmup_seconds", None) or 0.0

    def _suspend_pack(self, engine, members, views) -> None:
        """Drops every member's lanes (no device drain): each hands back
        its survivors as a checkpoint-v2 payload slice and re-enters the
        admission queue suspended."""
        for jid, job in list(members.items()):
            # A cancelled member's payload would be thrown away —
            # discard up front instead of building the full parent-map
            # export on the scheduler thread.
            cancelled = job.cancel_event.is_set()
            payload = engine.drop(jid, discard=cancelled)
            self._pack_leave(job, views[jid])
            if cancelled:
                job.payload = None
                job.finish(JOB_CANCELLED)
                self._drop_checkpoint(jid)
            else:
                job.suspend(payload)
                self._checkpoint_job(job)
            self._journal_state(job)
        members.clear()
        views.clear()

    def _run_packed_slice(self, lead: CheckJob) -> None:
        """One packed slice: every runnable same-configuration packable
        job co-schedules onto one ``TenantPackedEngine`` — shared waves,
        per-tenant lane accounting. Late same-shape arrivals JOIN the
        live pack (admission = claim a free lane slot); a member's
        cancel drops only its lanes; quantum expiry suspends the pack
        only when an outside contender would actually be picked.
        Strictly serialized with every other slice — the device still
        has exactly one claimant."""
        key = lead.aot_namespace
        mode = lead.mode
        spawn = dict(self.default_spawn)
        model = self._model_for(lead.model_factory, key)
        founders = [lead, *self._pack_peers(key, {}, mode)]
        if mode == "swarm":
            # Swarm packs: lane blocks over one stacked walk dispatch —
            # no shared table, no salting; every tenant's verdict is
            # the solo run's by vmap construction (checker/swarm.py).
            from ..checker.swarm import SwarmPackedEngine

            engine = SwarmPackedEngine(
                model,
                max_tenants=self.max_pack_tenants,
                aot_cache=f"swarmpack:{key}",
                device=self.device,
                **self.default_swarm_spawn,
            )
        else:
            from ..checker.packed_tenancy import TenantPackedEngine

            base_table = spawn.get("table_capacity", 1 << 16)
            # Size the shared table for the founding fleet up front: K
            # tenants' visited sets share one table, and pre-sizing
            # avoids the growth rehashes (and their per-shape compiles)
            # a per-tenant-sized table would churn through mid-pack.
            m = 1
            while m < min(len(founders), self.max_pack_tenants):
                m *= 2
            engine = TenantPackedEngine(
                model,
                frontier_capacity=spawn.get("frontier_capacity", 1 << 10),
                table_capacity=base_table * m,
                max_tenants=self.max_pack_tenants,
                # Packed waves are occupancy-dense by construction (that
                # is the point of packing): the bucket ladder would only
                # add rungs for the few ramp-up waves.
                bucket_ladder=0,
                aot_cache=f"pack:{key}",
                resume_capacity=base_table,
                # The service knob, or a service-wide async default (a
                # pack-safe default_spawn key) — either opts the pack's
                # host half onto the pipeline worker.
                async_pipeline=(
                    self.pack_async
                    or bool(spawn.get("async_pipeline"))
                ),
                # Pack-safe service-wide knob: per-tenant edge
                # partitions keep each member's verdict identical to
                # its solo run's.
                liveness=spawn.get("liveness"),
                device=self.device,
            )
        members: Dict[str, CheckJob] = {}
        views: Dict[str, object] = {}
        snapshots: Dict[str, Optional[dict]] = {}
        self._active_checker = engine
        slice_end = self._clock() + self.quantum_s
        try:
            for job in founders:
                if engine.free_slots() == 0:
                    break
                if job.job_id not in members:
                    self._try_pack_admit(
                        engine, job, members, views, snapshots
                    )
            while members and engine.live_count():
                if self._closing.is_set():
                    self._suspend_pack(engine, members, views)
                    return
                for jid, job in list(members.items()):
                    if job.cancel_event.is_set():
                        engine.drop(jid, discard=True)
                        self._pack_leave(job, views.pop(jid))
                        members.pop(jid)
                        job.payload = None
                        job.finish(JOB_CANCELLED)
                        self._journal_state(job)
                        self._drop_checkpoint(jid)
                    elif self._timed_out(job):
                        # Per-member wall-clock enforcement: only this
                        # tenant's lanes drop; the pack keeps going.
                        digest = None
                        try:
                            digest = views[jid].state_digest()
                        except Exception:  # noqa: BLE001
                            pass
                        engine.drop(jid, discard=True)
                        self._pack_leave(job, views.pop(jid))
                        members.pop(jid)
                        self._fail_timeout(job, view_digest=digest)
                if not members:
                    return
                if engine.free_slots():
                    for job in self._pack_peers(key, members, mode):
                        if engine.free_slots() == 0:
                            break
                        self._try_pack_admit(
                            engine, job, members, views, snapshots
                        )
                if (
                    self._clock() >= slice_end
                    and self._pack_contender(
                        key, members, engine.free_slots() > 0, mode
                    )
                ):
                    self._suspend_pack(engine, members, views)
                    return
                try:
                    done_keys = engine.step()
                except Exception as e:  # noqa: BLE001 - routed below
                    tf = tenant_fault_of(e)
                    if (
                        tf is not None
                        and tf.tenant_key in members
                        # Swarm packs have no async host half — tenant
                        # attribution holds regardless of pack_async.
                        and (mode == "swarm" or not self.pack_async)
                    ):
                        # PACK-LOCAL BLAST RADIUS: the engine rolled
                        # every faulted tenant back to its pre-wave
                        # boundary, so each lane drop hands back an
                        # exact payload slice; the survivors keep
                        # expanding in this very loop. One pass can
                        # fault SEVERAL tenants (e.g. an eviction
                        # sweep), so drop all flagged ones — a flagged
                        # tenant left resident is unschedulable yet
                        # counts live, which would spin this loop
                        # forever.
                        faulted = [tf.tenant_key] + [
                            k
                            for k in engine.faulted_keys()
                            if k != tf.tenant_key
                        ]
                        for jid in faulted:
                            if jid not in members:
                                continue
                            # Each co-faulted tenant routes its OWN
                            # exception (retry_on filtering and the
                            # flight dump must not read another
                            # tenant's error).
                            exc = engine.fault_error(jid) or e
                            job = members.pop(jid)
                            view = views.pop(jid)
                            try:
                                payload = engine.drop(jid)
                            except Exception:  # noqa: BLE001 - fallback
                                payload = snapshots.get(jid)
                            self._pack_leave(job, view)
                            # Conservative: the retried tenant runs
                            # solo (time-sliced) instead of re-joining
                            # the pack it just faulted out of.
                            job.packable = False
                            job.packable_reason = (
                                "faulted in a pack; retrying solo"
                            )
                            self._fault_job(job, exc, snapshot=payload)
                        continue
                    # Non-attributable engine fault (or async mode,
                    # where the poisoned pipeline skipped later
                    # tenants' verdicts so no drop payload can be
                    # trusted): every member retries SOLO from its
                    # last checkpointed boundary — suspended work is
                    # re-explored, never corrupted.
                    for jid, job in list(members.items()):
                        self._pack_leave(job, views[jid])
                        job.packable = False
                        job.packable_reason = (
                            "pack engine fault; retrying solo"
                        )
                        self._fault_job(
                            job, e, snapshot=snapshots.get(jid)
                        )
                    members.clear()
                    views.clear()
                    return
                for done_key in done_keys:
                    job = members.pop(done_key)
                    view = views.pop(done_key)
                    # Final discovery sweep BEFORE completing: a
                    # discovery landing in the job's last wave must
                    # still stamp first_discovery_t (ttfv) — the solo
                    # path polls once more after join for the same
                    # reason.
                    self._poll_discoveries(job, view)
                    self._pack_leave(job, view)
                    engine.release(done_key)
                    if job.retries:
                        self._m_recovered.inc()
                    job.complete(self._finalize(job, view))
                    if not job.warm_pool:
                        self.slo.observe(job)
                    self._journal_state(job)
                    self._drop_checkpoint(done_key)
                for jid, job in members.items():
                    self._poll_discoveries(job, views[jid])
        except Exception as e:  # noqa: BLE001 - engine failure faults members
            if not members:
                raise
            for jid, job in list(members.items()):
                self._pack_leave(job, views.get(jid))
                self._fault_job(job, e, snapshot=snapshots.get(jid))
            members.clear()
        finally:
            self._active_checker = None
            engine.close()

    def _evict_finished(self) -> None:
        """Drops the oldest terminal jobs (and their run registries)
        past the retention cap, and — the tighter bound — the run
        registries of RETAINED terminal jobs past ``max_run_registries``
        (LRU by finish time). A registry-evicted job keeps its record
        and result (snapshotted on the job object); only its live
        instrument registry is forgotten, counted by
        ``service.registry_evicted``. Suspended/queued/running jobs are
        never evicted."""
        from ..telemetry import discard_run_registry
        from ..telemetry.metrics import run_registries

        with self._cond:
            finished = sorted(
                (
                    j
                    for j in self._jobs.values()
                    if j.state in (
                        JOB_DONE, JOB_FAILED, JOB_CANCELLED,
                        JOB_QUARANTINED,
                    )
                ),
                key=lambda j: j.finished_t or 0.0,
            )
            excess = finished[: max(0, len(finished) - self.max_finished_jobs)]
            for j in excess:
                del self._jobs[j.job_id]
        for j in excess:
            discard_run_registry(j.run_id)
        retained = finished[len(excess):]
        live = run_registries()
        with_reg = [j for j in retained if j.run_id in live]
        for j in with_reg[: max(0, len(with_reg) - self.max_run_registries)]:
            discard_run_registry(j.run_id)
            self._m_registry_evicted.inc()

    def _finalize(self, job: CheckJob, checker) -> dict:
        """The completed job's verdict record."""
        if (
            getattr(checker, "_complete_liveness", False)
            and getattr(checker, "_lasso_deadline_s", None) is None
            and self.stall_deadline_s is not None
        ):
            # Stall-watchdog wiring for the host lasso pass: it runs
            # inside discoveries() AFTER the last wave boundary, so the
            # auto-preempt hook has nothing left to preempt — instead
            # the watchdog's deadline bounds the pass itself, which then
            # yields an honest `inconclusive` (liveness.inconclusive
            # metric + reporter line) instead of wedging the scheduler
            # thread for unbounded host minutes.
            checker._lasso_deadline_s = self.stall_deadline_s
        unique = checker.unique_state_count()
        discoveries = {}
        try:
            for name, path in checker.discoveries().items():
                discoveries[name] = {
                    "classification": checker.discovery_classification(name),
                    "length": len(path),
                }
        except Exception as e:  # noqa: BLE001 - verdicts above all
            discoveries = {"error": repr(e)}
        try:
            checker.assert_properties()
            properties_hold = True
        except AssertionError:
            properties_hold = False
        out = io.StringIO()
        try:
            checker.report(WriteReporter(out))
        except Exception:  # noqa: BLE001
            pass
        steady = max(job.active_s - job.warmup_s, 1e-9)
        result = {
            "unique": unique,
            "states": checker.state_count(),
            "max_depth": checker.max_depth(),
            "discoveries": discoveries,
            "properties_hold": properties_hold,
            "report": out.getvalue(),
            "warmup_s": job.warmup_s,
            "rate": unique / steady,
        }
        attribution = checker.attribution_report()
        if attribution is not None:
            result["attribution"] = attribution
            # Compile seconds across incarnations: the final checker's
            # ledger only covers its own life, but the per-run registry's
            # `*.pipeline.compile_seconds` counters persist through
            # preempt/resume cycles. On the card a job's compile phase is
            # its graph captures, which no other job shares.
            try:
                snap = checker.metrics().snapshot()
                result["compile_s_total"] = sum(
                    v
                    for k, v in snap.items()
                    if k.endswith(".pipeline.compile_seconds")
                    and isinstance(v, (int, float))
                )
            except Exception:  # noqa: BLE001 - evidence, not verdict
                pass
        cov = checker.coverage_report()
        if cov is not None:
            result["coverage"] = cov
        try:
            # Warm-start evidence per job: run-registry counters persist
            # across incarnations, so these sum every slice's disk probes
            # and kernel builds.
            snap = checker.metrics().snapshot()
            aot = {
                key: int(v)
                for key, v in snap.items()
                if key.startswith("aot_cache.")
                and isinstance(v, (int, float))
            }
            if aot:
                result["aot"] = aot
        except Exception:  # noqa: BLE001 - evidence, not verdict
            pass
        if job.warm_start:
            result["warm_start"] = True
            result["seeded_from"] = job.seeded_from
        try:
            # Corrected from the live checker (the admission guess may
            # predate a downgrade), plus the per-property evidence.
            job.liveness_mode = checker.liveness_mode
            result["liveness"] = checker.liveness_report()
        except Exception:  # noqa: BLE001 - evidence, never the verdict
            pass
        conf = getattr(checker, "conformance_report", None)
        if conf is not None:
            # The conformance plane's verdict block: one verdict per
            # uploaded record, in upload order, plus batch accounting.
            result["conformance"] = conf()
        return result

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout: Optional[float] = 30.0) -> dict:
        """Stops the scheduler: the running slice (if any) is preempted
        at its next wave boundary and left suspended, queued jobs stay
        queued; in ``service_dir`` mode every suspended job's payload is
        flushed to its durable checkpoint. Idempotent.

        Returns ``{"closed": bool, "stuck": bool}``: a scheduler thread
        still alive after the join timeout is REPORTED (plus a
        ``service.close.stuck`` metric and a trace instant) instead of
        silently pretending the close succeeded — the caller may still
        be holding a wedged device slice."""
        self._closing.set()
        self._wake()
        self._scheduler.join(timeout=timeout)
        stuck = self._scheduler.is_alive()
        if stuck:
            self._m_close_stuck.inc()
            try:
                from ..telemetry import get_tracer

                get_tracer().instant(
                    "service.close.stuck", timeout_s=timeout
                )
            except Exception:  # noqa: BLE001 - diagnostics only
                pass
        # Durable flush: suspended payloads outlive the process only if
        # they are on disk. Safe even when stuck — suspended jobs are
        # not the one the scheduler is wedged on.
        if self.service_dir is not None:
            for job in self.jobs():
                if job.state in (JOB_SUSPENDED, JOB_FAULTED):
                    self._checkpoint_job(job)
                    self._journal_state(job)
            if not stuck:
                with self._journal_lock:
                    if self._journal_fh is not None:
                        try:
                            self._journal_fh.close()
                        except OSError:
                            pass
                        self._journal_fh = None
        return {"closed": not stuck, "stuck": stuck}

    def __enter__(self) -> "CheckService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
