"""The host pipeline: one FIFO worker thread for host-tier work.

The port's copy of the JAX package's ``checker/pipeline.py``. With
``async_pipeline=True`` the solo checker (``checker/gpu.py``'s wave path)
runs each wave's host probe, parent log and survivor re-entry here, with
its eviction absorbs and checkpoint writes, while the next wave runs on the
device; the tenant-packed engine (``checker/packed_tenancy.py``) runs its
per-tenant partition probes, parent-log appends and survivor re-entry here
while the next packed wave runs. FIFO is the merge fence, and the callers
drain the pipeline before preempts, checkpoints, lane drops, admissions
and the run's end.

Correctness rests on three properties this class enforces:

- **FIFO**: jobs run in submission order on ONE thread, so the tiered
  stores see the exact sequence of probes and evictions the synchronous
  path would issue (a probe submitted before an eviction can never
  observe the evicted keys — the "merge fence").
- **Epoch barriers**: ``drain()`` blocks until every submitted job
  finished, re-raising the first job error. The engine calls it at
  lane drops, evictions, queue-empty and run-end boundaries, so every
  externally observable snapshot (payloads, counters read after a run) is
  identical to the synchronous path's.
- **Bounded depth**: ``throttle()`` caps the verdict backlog (the
  "pending-verdict lane set"), so at most ``max_pending`` waves of
  outputs are held at once.

A job that raises poisons the pipeline: later jobs are skipped (their
inputs may depend on the failed verdict) and the error surfaces as a
typed :class:`PipelinePoisonedError` — carrying the original worker
exception as its ``cause``/``__cause__`` — at the next
``submit``/``throttle``/``drain`` on the caller's thread. Poisoning never
hangs the teardown path: the worker loop keeps draining (skipping) the
queue, so ``close()`` joins.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from ..utils.faults import fault_point

__all__ = ["HostPipeline", "PipelinePoisonedError"]


class PipelinePoisonedError(RuntimeError):
    """The async host pipeline is poisoned: a worker job raised, so no
    further host-tier work can be applied. ``cause`` (also
    ``__cause__``) is the original worker exception — callers routing
    failures look through this wrapper at the root fault."""

    def __init__(self, cause: BaseException):
        super().__init__(
            "async host pipeline failed; no further host-tier work "
            f"can be applied (worker error: {cause!r})"
        )
        self.cause = cause

# Default pending-verdict depth: the producing wave plus one in-flight
# verdict — the "two-deep" in the two-deep pipeline. Deeper queues pin
# more wave-output buffers without adding overlap (the device is already
# never idle at depth 2).
DEFAULT_MAX_PENDING = 2


class HostPipeline:
    """One daemon worker thread executing host-tier jobs in FIFO order."""

    def __init__(self, name: str = "host-pipeline",
                 max_pending: int = DEFAULT_MAX_PENDING):
        self.max_pending = max(1, max_pending)
        self._cv = threading.Condition()
        self._jobs: deque = deque()
        self._pending = 0
        self._submitted = 0
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    # -- caller-thread surface ---------------------------------------------

    def submit(self, fn: Callable[[], None]) -> None:
        """Enqueues one job. Raises the pipeline's poisoning error, if
        any — the caller must not keep producing waves whose verdicts
        can never be applied."""
        with self._cv:
            self._raise_if_poisoned()
            if self._closed:
                raise RuntimeError("host pipeline is closed")
            self._jobs.append(fn)
            self._pending += 1
            self._submitted += 1
            self._cv.notify_all()

    def throttle(self, max_pending: Optional[int] = None) -> None:
        """Blocks until the backlog is within the pipeline depth (the
        bounded pending-verdict lane set)."""
        limit = self.max_pending if max_pending is None else max_pending
        with self._cv:
            self._cv.wait_for(
                lambda: self._pending <= limit or self._error is not None
            )
            self._raise_if_poisoned()

    def drain(self) -> None:
        """Epoch barrier: returns once every submitted job has finished;
        re-raises the first job error on this (the caller's) thread."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._pending == 0 or self._error is not None
            )
            # Poisoned: skipped jobs still drain to zero, but the state
            # they would have produced does not exist — surface it.
            self._raise_if_poisoned()

    def pending(self) -> int:
        with self._cv:
            return self._pending

    @property
    def submitted(self) -> int:
        """Total jobs ever submitted (telemetry/tests)."""
        with self._cv:
            return self._submitted

    def close(self) -> None:
        """Stops the worker after the queue empties. Never raises —
        called from run-end/error paths; surface job errors via
        ``drain()`` first when they matter."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60.0)

    def _raise_if_poisoned(self) -> None:
        if self._error is not None:
            raise PipelinePoisonedError(self._error) from self._error

    # -- worker thread ------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._closed:
                    self._cv.wait()
                if not self._jobs:
                    return  # closed and drained
                fn = self._jobs.popleft()
                poisoned = self._error is not None
            try:
                if not poisoned:
                    # Injection seam: a fault here IS a worker death —
                    # the job never runs and the pipeline poisons,
                    # exactly the shape a segfaulting probe or a dying
                    # numpy allocation would produce.
                    fault_point("pipeline.worker")
                    fn()
            except BaseException as e:  # noqa: BLE001 - surfaced at barriers
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()
