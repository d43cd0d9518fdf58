"""Process-local metrics registry: counters, gauges, log-scale histograms.

Instruments must stay cheap enough to sit on checker hot paths (one call
per wave/block, never per state): ``inc``/``set``/``observe`` take a
per-instrument lock — ``value += x`` is LOAD/ADD/STORE bytecodes, so the
GIL alone would let concurrent host-checker workers lose updates — and
the microseconds that costs disappear at block/wave granularity. The
registry lock guards only instrument *creation* and ``snapshot``'s dict
copy.

Naming convention: dotted paths, ``<backend>.<quantity>`` — e.g.
``gpu_bfs.coverage.states_evaluated``, ``bfs.states_generated``.

The port's copy of the JAX package's ``telemetry/metrics.py`` (which
imports nothing of JAX; the port imports nothing of that package).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing count (events, states, waves)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0
        self._lock = threading.Lock()

    def inc(self, amount: Number = 1) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self) -> Number:
        return self.value


class Gauge:
    """Last-written value (occupancy, capacity, frontier width). A plain
    STORE_ATTR is already atomic under the GIL, so no lock."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[Number] = None

    def set(self, value: Number) -> None:
        self.value = value

    def snapshot(self) -> Optional[Number]:
        return self.value


class Histogram:
    """Log-scale (base-2) histogram over positive observations.

    Bucket ``i`` counts observations in ``(2**(i-1), 2**i]`` (bucket 0
    holds ``(0, 1]``; zero/negative observations land in bucket 0 too).
    Log buckets fit the heavy-tailed quantities checkers produce — wave
    widths span 1 to millions — with 64 buckets covering the u64 range.
    Tracks count/sum/min/max exactly alongside the buckets.
    """

    __slots__ = ("name", "buckets", "count", "sum", "min", "max", "_lock")

    N_BUCKETS = 64

    def __init__(self, name: str):
        self.name = name
        self.buckets: List[int] = [0] * self.N_BUCKETS
        self.count = 0
        self.sum: Number = 0
        self.min: Optional[Number] = None
        self.max: Optional[Number] = None
        self._lock = threading.Lock()

    def observe(self, value: Number) -> None:
        self.observe_many(value, 1)

    def observe_many(self, value: Number, n: int) -> None:
        """``n`` identical observations in one locked update — the bulk
        path audit consumers need (e.g. a probe-length distribution
        arriving as per-length counts; per-key ``observe`` calls would
        cost millions of lock round trips)."""
        if n <= 0:
            return
        if value > 1:
            i = min(math.ceil(math.log2(value)), self.N_BUCKETS - 1)
        else:
            i = 0
        with self._lock:
            self.buckets[i] += n
            self.count += n
            self.sum += value * n
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value

    def snapshot(self) -> Dict[str, object]:
        # Trailing empty buckets are elided: most histograms use a narrow
        # band of the 64-bucket range and snapshots feed JSON sinks.
        with self._lock:
            buckets = list(self.buckets)
            count, total = self.count, self.sum
            vmin, vmax = self.min, self.max
        hi = 0
        for i, b in enumerate(buckets):
            if b:
                hi = i + 1
        return {
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "mean": (total / count) if count else None,
            "buckets_log2": buckets[:hi],
        }


class MetricsRegistry:
    """Named instruments, created on first use and stable thereafter.

    ``counter``/``gauge``/``histogram`` are get-or-create: callers hold
    the returned instrument and hit it directly on hot paths instead of
    re-resolving the name. Requesting an existing name as a different
    instrument kind raises — silent kind aliasing would corrupt both
    users' data.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time ``{name: value}`` view of every instrument
        (histograms render as their stats dict), sorted by name for
        stable output."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def instruments(self) -> List:
        """Sorted ``(name, instrument)`` pairs — the typed view the
        registry lint needs (``snapshot`` erases the counter/gauge
        distinction)."""
        with self._lock:
            return sorted(self._instruments.items())


_default_registry = MetricsRegistry()

# Per-run registries, keyed by run id: a run given a ``run_id`` (a packed
# tenant, its engine) records into its own registry, so two runs in one
# process never share an instrument; ``run_id=None`` is the process-local
# registry, as before.
_run_lock = threading.Lock()
_run_registries: Dict[str, MetricsRegistry] = {}


def metrics_registry(run_id: Optional[str] = None) -> MetricsRegistry:
    """The process-local registry every checker of the port records into,
    or, given a ``run_id``, that run's own registry (made on first use;
    ``discard_run_registry`` drops it)."""
    if run_id is None:
        return _default_registry
    reg = _run_registries.get(run_id)
    if reg is None:
        with _run_lock:
            reg = _run_registries.setdefault(run_id, MetricsRegistry())
    return reg


def run_registries() -> Dict[str, MetricsRegistry]:
    """A snapshot of the per-run registries, ``{run_id: registry}``."""
    with _run_lock:
        return dict(_run_registries)


def discard_run_registry(run_id: str) -> None:
    """Forgets one run's registry (nothing when there is none)."""
    with _run_lock:
        _run_registries.pop(run_id, None)
