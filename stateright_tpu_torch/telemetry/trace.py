"""Trace events: spans + instants, ring buffer, JSONL sink.

Events are recorded in Chrome trace-event form directly (``name``, ``ph``,
``ts``/``dur`` in microseconds, ``pid``/``tid``, ``args``) so the JSONL
sink is a plain line-per-event stream (the JAX package's
``chrome_trace_from_jsonl`` envelopes it for Perfetto). Timestamps come from
``time.perf_counter_ns`` — monotonic, so span durations are exact even
across wall-clock adjustments.

The in-memory ring buffer is always on (bounded, last-N events) and the
no-sink path is the fast path: one small dict + a deque append per event.
Per-state recording is a design error — backends emit one span per
wave/block/drain.

The port's copy of the JAX package's ``telemetry/trace.py``, without its
Chrome export and its ``jax.profiler`` bridge: device
time on the card comes from ``torch.profiler``
(``scripts/torch_profile.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, IO, List, Optional

RING_CAPACITY = 4096


def _now_us() -> float:
    return time.perf_counter_ns() / 1000.0


def _flush_close(file, owns, lock):
    with lock:
        try:
            file.flush()
        except ValueError:
            pass  # already closed (idempotent close / atexit replay)
        if owns:
            file.close()


class JsonlSink:
    """Appends each event as one JSON line; thread-safe, flushed per
    write so a killed run still leaves a parseable prefix. ``close()``
    always flushes (even for caller-owned files) and every sink carries
    a ``weakref.finalize`` — it fires at interpreter exit so a short run
    that never detaches its sink still lands its tail events on disk,
    but unlike ``atexit.register(self.close)`` it does not pin the sink
    (and its fd) for the whole process lifetime: a long-lived service
    that churns through sinks gets each one flushed and released at GC."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._file: IO[str] = path_or_file
            self._owns = False
            self.path = getattr(path_or_file, "name", None)
        else:
            self._file = open(path_or_file, "w")
            self._owns = True
            self.path = os.fspath(path_or_file)
        self._lock = threading.Lock()
        self._finalizer = weakref.finalize(
            self, _flush_close, self._file, self._owns, self._lock
        )

    def write_event(self, event: Dict) -> None:
        line = json.dumps(event, separators=(",", ":"))
        try:
            with self._lock:
                self._file.write(line + "\n")
                self._file.flush()
        except ValueError:
            # remove_sink() can close this file while another checker's
            # worker thread is mid-_emit with a stale reference; telemetry
            # must never turn that race into a worker_error on an
            # otherwise healthy run. The event survives in the ring.
            pass

    def close(self) -> None:
        self._finalizer()  # at most once; later calls are no-ops


class _Span:
    """Context manager for one complete ("X") event. ``args`` is mutable
    until exit — callers fill in quantities only known at span end (a
    wave's new-unique count, dedup rate, occupancy)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **kwargs) -> "_Span":
        self.args.update(kwargs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = _now_us()
        self._tracer._emit(
            {
                "name": self.name,
                "ph": "X",
                "ts": self._t0,
                "dur": t1 - self._t0,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": self.args,
            }
        )


class _NullSpan:
    """The disabled-tracer span: still yields an object with the span
    surface so call sites stay unconditional."""

    __slots__ = ("args",)

    def __init__(self):
        self.args: Dict = {}

    def set(self, **kwargs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, ring_capacity: int = RING_CAPACITY):
        self._ring: deque = deque(maxlen=ring_capacity)
        self._sinks: List[JsonlSink] = []
        self.enabled = True
        # Emit lock: the async wave engine's host worker closes wave
        # spans concurrently with the checker thread's drain/compile
        # spans (and the monitor's tracer-sink tap consumes both), so
        # the ring append + sink fan-out must be one atomic step —
        # unlocked, a tap could observe event B before event A from the
        # thread that emitted A first, and interleaved sink writes
        # would tear. deque.append alone is GIL-atomic; the
        # append-then-fan-out sequence is not.
        self._emit_lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> "_Span":
        """``with tracer.span("tpu_bfs.wave", frontier=F) as sp: ...`` —
        the span records begin/duration on exit; fill late-bound args via
        ``sp.set(...)`` or ``sp.args[...]``."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """A point event (scope: thread)."""
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "ph": "i",
                "ts": _now_us(),
                "s": "t",
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    def _emit(self, event: Dict) -> None:
        # Never held while a signal handler might re-enter: the flight
        # recorder's events() read deliberately stays lock-free (retry
        # loop below) so a SIGTERM dump cannot deadlock against a
        # checker thread parked mid-emit.
        with self._emit_lock:
            self._ring.append(event)
            for sink in self._sinks:
                sink.write_event(event)

    # -- sinks and inspection ----------------------------------------------

    def add_sink(self, sink) -> "JsonlSink":
        """Attaches a sink (anything with ``write_event``); a str/path
        argument is wrapped in a ``JsonlSink``. Returns the sink."""
        if not hasattr(sink, "write_event"):
            sink = JsonlSink(sink)
        self._sinks.append(sink)
        return sink

    def remove_sink(self, sink, close: bool = True) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)
        if close and hasattr(sink, "close"):
            sink.close()

    def events(self) -> List[Dict]:
        """The ring buffer's current contents, oldest first. A worker
        thread appending mid-copy raises RuntimeError from deque
        iteration (the flight recorder's SIGTERM dump races live wave
        emission); retry — the ring is bounded, so each attempt is
        fast — then fall back to a per-index best-effort copy rather
        than losing the final-wave forensics entirely."""
        for _ in range(8):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        out: List[Dict] = []
        for i in range(len(self._ring)):
            try:
                out.append(self._ring[i])
            except IndexError:
                break
        return out

    def clear(self) -> None:
        self._ring.clear()


class RunScopedTracer:
    """A view of a tracer that stamps ``run_id`` into the args of every
    span and instant, so the interleaved spans of several runs in one
    process stay attributable. Sinks, the ring buffer and everything else
    are the wrapped tracer's: the events land in the one process-local
    stream."""

    def __init__(self, run_id: str, tracer: Optional[Tracer] = None):
        self.run_id = run_id
        self._tracer = tracer if tracer is not None else get_tracer()

    def span(self, name: str, **args):
        args.setdefault("run_id", self.run_id)
        return self._tracer.span(name, **args)

    def instant(self, name: str, **args) -> None:
        args.setdefault("run_id", self.run_id)
        self._tracer.instant(name, **args)

    def __getattr__(self, name):
        return getattr(self._tracer, name)


_default_tracer = Tracer()


def get_tracer(run_id: Optional[str] = None):
    """THE process-local tracer every checker of the port records into;
    with a ``run_id``, a :class:`RunScopedTracer` view of it."""
    if run_id is None:
        return _default_tracer
    return RunScopedTracer(run_id, _default_tracer)


def span(name: str, **args) -> "_Span":
    return _default_tracer.span(name, **args)


def instant(name: str, **args) -> None:
    _default_tracer.instant(name, **args)
