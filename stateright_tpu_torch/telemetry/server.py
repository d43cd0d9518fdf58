"""The live monitor's registry lint and the service's stall watchdog.

The port's copy of two parts of the JAX package's ``telemetry/server.py``:

- the naming lint (``sanitize_metric_name``, ``registry_hygiene_problems``):
  every dotted registry name must map to one Prometheus family of its own;
  the conformance plane's seed-corpus gate and the fault suites read it;
- ``StallWatchdog`` and ``_default_run_id``: the check service
  (``service/service.py``) polls a watchdog inline on its scheduler thread
  and preempts a slice that makes no progress for ``deadline_s``.

The HTTP monitor (``MonitorCore``, ``prometheus_text``, the SSE broker and
the flight recorder) is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional

from .metrics import Counter, MetricsRegistry, metrics_registry
from .trace import Tracer, get_tracer

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str, prefix: str = "stateright") -> str:
    """Dotted registry names to the Prometheus grammar: illegal chars
    become ``_``, a namespace prefix keeps them collision-free, and a
    leading digit (impossible after the prefix, kept for prefix="")
    gets an underscore."""
    out = _NAME_SANITIZE.sub("_", name)
    if prefix:
        out = f"{prefix}_{out}"
    if out and out[0].isdigit():
        out = "_" + out
    return out


def registry_hygiene_problems(registry: MetricsRegistry = None,
                              prefix: str = "stateright") -> List[str]:
    """The metric-registry lint: every registered name must survive the
    Prometheus sanitizer without colliding with a different registered
    name — two dotted names mapping to one exposition family would
    silently merge unrelated series. Counters are checked at their
    exported ``_total`` spelling, so a counter ``x.y`` and a gauge
    ``x.y_total`` collide too. Returns human-readable problem strings
    (empty == clean)."""
    reg = registry if registry is not None else metrics_registry()
    seen: Dict[str, str] = {}
    problems: List[str] = []
    for name, inst in reg.instruments():
        exported = sanitize_metric_name(name, prefix)
        if isinstance(inst, Counter):
            exported += "_total"
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", exported):
            problems.append(
                f"{name!r} sanitizes to non-Prometheus name {exported!r}"
            )
            continue
        other = seen.get(exported)
        if other is not None and other != name:
            problems.append(
                f"{name!r} and {other!r} both export as {exported!r}"
            )
        seen[exported] = name
    return problems


def _default_run_id() -> str:
    """A run id from the wall clock and the process id (what a monitor
    or flight recorder names its files after when no run id is given)."""
    return time.strftime("%Y%m%d-%H%M%S") + ("-%d" % os.getpid())


# -- stall watchdog ----------------------------------------------------------


class StallWatchdog:
    """Fires when no wave completes within ``deadline_s``: a warning
    instant in the trace, a metrics dump to stderr, the ``on_stall`` hook
    and (optional) a ``torch.profiler`` capture of ``capture_s`` seconds
    into ``capture_dir``, so the wedge itself gets profiled. Fires once per
    stall; the next ``pet()`` re-arms it.

    ``clock`` is injectable and ``poll()`` is callable directly, so the
    deadline logic tests with a fake clock and no threads. The check
    service polls it inline; ``start()`` runs it on a thread of its own."""

    def __init__(self, deadline_s: float, registry: MetricsRegistry = None,
                 tracer: Tracer = None, clock=time.monotonic,
                 on_stall=None, capture_dir: Optional[str] = None,
                 capture_s: float = 3.0, done_fn=None):
        self.deadline_s = float(deadline_s)
        self._done_fn = done_fn
        self._registry = registry if registry is not None else metrics_registry()
        self._tracer = tracer if tracer is not None else get_tracer()
        self._clock = clock
        self._on_stall = on_stall
        self._capture_dir = capture_dir
        self._capture_s = capture_s
        self._last_pet = clock()
        # Generations instead of a boolean latch: a pet() racing poll() on
        # a bare flag could latch just after a wave landed and suppress the
        # next genuine stall; "fired once per stall" is "not twice for one
        # pet generation".
        self._pet_gen = 1
        self._fired_gen = 0
        self._stalls = self._registry.counter("monitor.stalls")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pet(self, t: Optional[float] = None) -> None:
        self._last_pet = self._clock() if t is None else t
        self._pet_gen += 1

    def poll(self, now: Optional[float] = None) -> bool:
        """One deadline check; True when this call fired a stall."""
        gen = self._pet_gen
        now = self._clock() if now is None else now
        idle = now - self._last_pet
        if idle <= self.deadline_s or gen == self._fired_gen:
            return False
        if self._done_fn is not None and self._done_fn():
            # The waves stopped because the check finished, not because it
            # wedged.
            return False
        self._fired_gen = gen
        self._stalls.inc()
        self._tracer.instant("monitor.stall", idle_s=idle, deadline_s=self.deadline_s)
        try:
            snap = self._registry.snapshot()
            sys.stderr.write(
                "monitor.stall: no wave for %.1fs (deadline %.1fs); metrics %s\n"
                % (idle, self.deadline_s, json.dumps(snap, sort_keys=True, default=str))
            )
            sys.stderr.flush()
        except Exception:  # noqa: BLE001 - diagnostics must not raise
            pass
        if self._on_stall is not None:
            try:
                self._on_stall(idle)
            except Exception:  # noqa: BLE001
                pass
        if self._capture_dir is not None:
            self._profiler_capture()
        return True

    def _profiler_capture(self) -> None:
        """Best effort: ``torch.profiler`` over the stalled process for
        ``capture_s`` seconds, its Chrome trace written into
        ``capture_dir``, so the trace shows where it is wedged (a device
        wait, a host probe, a capture)."""
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            try:
                time.sleep(self._capture_s)
            finally:
                prof.stop()
            os.makedirs(self._capture_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self._capture_dir, f"stall.{os.getpid()}.{self._fired_gen}.pt.trace.json"))
            self._tracer.instant("monitor.stall_capture", dir=self._capture_dir)
        except Exception:  # noqa: BLE001 - the profiler is optional
            pass

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            interval = max(min(self.deadline_s / 4.0, 1.0), 0.05)

            def loop():
                while not self._stop.wait(interval):
                    self.poll()

            self._thread = threading.Thread(target=loop, name="monitor-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
