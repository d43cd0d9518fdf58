"""Deterministic seeded fault injection for the self-healing service.

The port's copy of the JAX package's ``utils/faults.py``. The failure modes
a run must survive (a host-tier probe dying mid-wave, a spill hitting
ENOSPC, the async pipeline worker raising, a device wave throwing, a
checkpoint write failing, a wedged wave) are rare and timing-shaped, so the
chaos tests make each happen at an exact, reproducible point. Code
sprinkles zero-cost ``fault_point(site, tenant=...)`` calls at the seams
(``storage/tiered.py``, ``storage/persist.py``, ``checker/pipeline.py``,
``checker/gpu.py``, ``checker/packed_tenancy.py``, ``checker/swarm.py``,
``conformance/checker.py``), and a test arms an injector::

    from stateright_tpu_torch.utils.faults import FaultSpec, inject

    with inject(FaultSpec("storage.host_probe", at=1)):
        ...   # the SECOND host probe anywhere in the process raises
              # HostProbeFault; everything else runs untouched

With no injector armed, ``fault_point`` is one module-global load and
a None check. A spec fires on exact hit indices (``at``/``count``) of a
named site, optionally filtered to one tenant (``tenant=``), counted under
a lock, so multi-threaded runs (the async pipeline worker, the service
scheduler) still hit reproducibly for a fixed workload. ``seeded_specs``
derives the hit indices from an RNG seed for randomized but replayable
chaos sweeps.

Every injected exception derives from ``FaultError`` and carries a
``fault_class`` string; ``classify_fault`` maps any exception (walking the
``__cause__``/``__context__`` chain, so a fault surfaced through
``PipelinePoisonedError`` or ``TenantFaultError`` still classifies as its
root) to the class string the service's ``RetryPolicy`` filters on.
"""

import errno
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterable, List, Optional

__all__ = [
    "CheckpointWriteFault",
    "ConformanceBatchFault",
    "DeviceWaveFault",
    "FAULT_SITES",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
    "HostProbeFault",
    "LivenessEvictFault",
    "PackTenantFault",
    "SeedLoadFault",
    "SpillFault",
    "TenantFaultError",
    "WorkerDeathFault",
    "classify_fault",
    "clear_fault_injector",
    "fault_point",
    "inject",
    "seeded_specs",
    "set_fault_injector",
    "tenant_fault_of",
]


# -- fault taxonomy ----------------------------------------------------------


class FaultError(Exception):
    """Base class for injected faults. ``fault_class`` is the string the
    service's retry filter and the ``fault.*`` metrics key on."""

    fault_class = "unknown"


class HostProbeFault(FaultError):
    """An L1/L2 host-tier probe died mid-wave."""

    fault_class = "host_probe"


class SpillFault(OSError, FaultError):
    """A spill write hit the disk (injected as ENOSPC, the classic)."""

    fault_class = "spill"

    def __init__(self, msg: str = "No space left on device (injected)"):
        OSError.__init__(self, errno.ENOSPC, msg)


class WorkerDeathFault(FaultError):
    """The async host-pipeline worker died mid-job."""

    fault_class = "pipeline_worker"


class DeviceWaveFault(FaultError):
    """A device wave dispatch raised (XLA error, OOM, tunnel drop)."""

    fault_class = "device_wave"


class CheckpointWriteFault(FaultError):
    """A checkpoint pickle/rename failed."""

    fault_class = "checkpoint_write"


class PackTenantFault(FaultError):
    """A per-tenant slice of packed host work (verdict/evict) raised."""

    fault_class = "pack_tenant"


class LivenessEvictFault(FaultError):
    """A liveness edge-store eviction absorb died mid-run (device pull,
    numpy OOM, spill)."""

    fault_class = "liveness_evict"


class SeedLoadFault(OSError, FaultError):
    """A warm-start seed artifact read died (torn file, failing disk) —
    the honest outcome is a refused seed and a full recheck."""

    fault_class = "seed_load"


class ConformanceBatchFault(FaultError):
    """A conformance batch dispatch raised (the replay graph or the audit
    program, a CUDA error). Verdicts are deterministic in the upload, so a retry must
    recover bit-identically through the journal."""

    fault_class = "conformance_batch"


class TenantFaultError(Exception):
    """An engine fault attributable to exactly one packed tenant: the
    pack's blast-radius boundary. The engine's caller drops only this
    tenant (its payload slice resumes it) while the others keep going.
    ``pre_dispatch=True`` means the wave never ran, so every participant's
    input was left as it was."""

    def __init__(self, tenant_key, original: BaseException,
                 pre_dispatch: bool = False):
        super().__init__(
            f"fault attributable to packed tenant {tenant_key!r}: "
            f"{original!r}"
        )
        self.tenant_key = tenant_key
        self.original = original
        self.pre_dispatch = pre_dispatch


def _exception_chain(exc: Optional[BaseException]):
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def classify_fault(exc: Optional[BaseException]) -> str:
    """The fault-class string for an arbitrary exception: the first
    ``FaultError`` (or recognizable real-world analogue) in its cause
    chain, else ``"unknown"``. This is what ``RetryPolicy.retry_on``
    filters against, so injected and organic faults classify alike."""
    from ..checker.pipeline import PipelinePoisonedError

    saw_pipeline = False
    for e in _exception_chain(exc):
        if isinstance(e, TenantFaultError):
            e = e.original
        if isinstance(e, FaultError):
            return e.fault_class
        if isinstance(e, OSError) and e.errno == errno.ENOSPC:
            return "spill"
        if isinstance(e, PipelinePoisonedError):
            saw_pipeline = True
    return "pipeline_worker" if saw_pipeline else "unknown"


def tenant_fault_of(exc: Optional[BaseException]):
    """The ``TenantFaultError`` in an exception's cause chain, or None:
    how the service decides whether a pack fault is attributable to one
    tenant (drop its lanes) or to the whole engine (retry all solo)."""
    for e in _exception_chain(exc):
        if isinstance(e, TenantFaultError):
            return e
    return None


# -- the injector ------------------------------------------------------------

# Default exception factory per site (a spec may override with exc=).
_SITE_EXC = {
    "storage.host_probe": HostProbeFault,
    "storage.spill": SpillFault,
    "checkpoint.write": CheckpointWriteFault,
    # The host pipeline's worker (checker/pipeline.py) and the
    # tenant-packed engine (checker/packed_tenancy.py): its shared wave
    # dispatch and the per-tenant verdict and eviction slices that bound a
    # pack's blast radius.
    "pipeline.worker": WorkerDeathFault,
    "device.wave": DeviceWaveFault,
    "pack.tenant.verdict": PackTenantFault,
    "pack.tenant.evict": PackTenantFault,
    # The swarm engine (checker/swarm.py): the stacked wave dispatch and
    # the per-tenant harvest that bounds a packed swarm's blast radius.
    "swarm.wave": DeviceWaveFault,
    "swarm.tenant.verdict": PackTenantFault,
    # The device liveness edge log's host absorb (storage/edge_log.py).
    "liveness.edge_evict": LivenessEvictFault,
    # The warm-start plane (storage/persist.py): the seed-artifact read; a
    # refusal must degrade to a full recheck, never a wrong verdict.
    "warmstart.seed_load": SeedLoadFault,
    # The conformance plane (conformance/checker.py): the per-batch device
    # dispatch, the retry seam of uploaded-trace auditing.
    "conformance.batch": ConformanceBatchFault,
}

# Sites that exist in the tree — fail fast on typos in test specs.
# ``wave.stall`` (checker/gpu.py's wave and drain loops) only ever sleeps.
FAULT_SITES = frozenset(_SITE_EXC) | {"wave.stall"}


class FaultSpec:
    """One planned fault: fire at hit indices ``[at, at + count)`` of
    ``site`` (0-based, counted per spec over the hits that match its
    ``tenant`` filter). ``stall_s`` sleeps instead of raising (the
    wedged-wave simulation the stall watchdog must catch); ``exc`` is a
    zero-arg exception factory overriding the site default."""

    def __init__(self, site: str, at: int = 0, count: int = 1,
                 tenant=None, exc: Optional[Callable] = None,
                 stall_s: Optional[float] = None):
        if site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: {sorted(FAULT_SITES)})"
            )
        if site == "wave.stall" and stall_s is None:
            raise ValueError("site 'wave.stall' needs stall_s=")
        self.site = site
        self.at = int(at)
        self.count = max(1, int(count))
        self.tenant = tenant
        self.exc = exc if exc is not None else _SITE_EXC.get(site)
        self.stall_s = stall_s
        self.hits = 0       # matching fault_point calls seen
        self.triggered = 0  # times this spec actually fired

    def __repr__(self):
        return (
            f"FaultSpec({self.site!r}, at={self.at}, count={self.count}, "
            f"tenant={self.tenant!r}, hits={self.hits}, "
            f"triggered={self.triggered})"
        )


class FaultInjector:
    """Thread-safe deterministic fault plan: counts every matching
    ``fault_point`` hit per spec and fires on the planned indices."""

    def __init__(self, *specs: FaultSpec):
        self._specs: List[FaultSpec] = list(specs)
        self._lock = threading.Lock()

    @property
    def specs(self) -> List[FaultSpec]:
        return list(self._specs)

    def triggered(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                s.triggered
                for s in self._specs
                if site is None or s.site == site
            )

    def hits(self, site: str) -> int:
        with self._lock:
            return max(
                (s.hits for s in self._specs if s.site == site), default=0
            )

    def fire(self, site: str, tenant=None) -> None:
        stall = None
        trip: Optional[FaultSpec] = None
        with self._lock:
            for spec in self._specs:
                if spec.site != site:
                    continue
                if spec.tenant is not None and spec.tenant != tenant:
                    continue
                idx = spec.hits
                spec.hits += 1
                if spec.at <= idx < spec.at + spec.count:
                    spec.triggered += 1
                    if spec.stall_s is not None:
                        stall = spec.stall_s
                    else:
                        trip = spec
                    break
        if stall is not None:
            self._count_metric(site)
            time.sleep(stall)
            return
        if trip is not None:
            self._count_metric(site)
            raise trip.exc()

    @staticmethod
    def _count_metric(site: str) -> None:
        # Observable injection evidence (never load-bearing): the chaos
        # CI job asserts the fault actually fired via this counter.
        try:
            from ..telemetry import metrics_registry

            reg = metrics_registry()
            reg.counter("fault.injected").inc()
            reg.counter(f"fault.injected.{site}").inc()
        except Exception:  # noqa: BLE001 - diagnostics only
            pass


_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_LOCK = threading.Lock()


def set_fault_injector(inj: Optional[FaultInjector]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = inj


def clear_fault_injector() -> None:
    set_fault_injector(None)


def fault_point(site: str, tenant=None) -> None:
    """An injection seam. One global load + None check when no injector
    is armed — safe on every hot path it decorates."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site, tenant=tenant)


@contextmanager
def inject(*specs: FaultSpec):
    """Arms a process-wide injector for the with-block (tests). Nested
    injection is a test bug — refused rather than silently merged."""
    with _ACTIVE_LOCK:
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a fault injector is already installed")
        inj = FaultInjector(*specs)
        _ACTIVE = inj
    try:
        yield inj
    finally:
        clear_fault_injector()


def seeded_specs(seed: int, sites: Iterable[str], max_at: int = 8,
                 ) -> List[FaultSpec]:
    """A reproducible randomized plan: one fault per site at an RNG-drawn
    hit index. Same seed, same plan, same failure point, run after run:
    the deterministic seeded half of the chaos harness."""
    rng = random.Random(seed)
    return [
        FaultSpec(site, at=rng.randrange(max(1, max_at)))
        for site in sites
    ]
