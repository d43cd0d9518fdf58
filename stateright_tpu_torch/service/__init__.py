"""Checking as a service: a persistent, in-process multi-tenant check
scheduler over the port's checkers.

- :class:`CheckService` owns the device: an admission queue of
  :class:`CheckJob` s (model + options + per-tenant ``hbm_budget_mib`` /
  deadline / priority) and a scheduler loop. Qualifying same-shape jobs
  are packed into shared physical waves (``checker/packed_tenancy``,
  ``checker/swarm``); the rest time-slice the device at wave granularity
  through preempt and resume. ``submit()`` returns a :class:`JobHandle`
  (``result()`` / ``status()`` / ``cancel()``); :class:`RetryPolicy`
  retries faulted jobs from their last checkpointed boundary;
  :class:`SLOLedger` folds served verdicts into latency objectives.
- ``zoo.py``: the registered model zoo, which also names the namespaces.

The port's copy of the JAX package's ``service`` package without its HTTP
front end (``ServiceServer``), which is not ported yet.
"""

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
from .service import CheckService, QueueFullError
from .slo import SLOLedger
from .zoo import aot_namespace, default_zoo, warm_shapes

__all__ = [
    "CheckJob",
    "CheckService",
    "JobHandle",
    "JOB_CANCELLED",
    "JOB_DONE",
    "JOB_FAILED",
    "JOB_FAULTED",
    "JOB_QUARANTINED",
    "JOB_QUEUED",
    "JOB_RUNNING",
    "JOB_SUSPENDED",
    "QueueFullError",
    "RetryPolicy",
    "SLOLedger",
    "aot_namespace",
    "default_zoo",
    "warm_shapes",
]
