"""Wave-timeline attribution: where real-run wall clock goes between waves.

The port's counterpart of the JAX package's ``telemetry/attribution.py``,
with the same public names, ledger keys and rules. The telemetry layer says
*that* a run is slow (spans, counters) and ``checker/breakdown.py`` prices
the wave's stages offline; this module attributes the wall clock of a real
run to the gaps between device work. In attribution mode (opt-in:
``spawn_gpu_bfs(..., attribution=True)``) each host-visible wave and drain
is fenced (``fence``: a wait for the device's queued work, on the CPU
nothing) at phase boundaries, and its wall time is classified into named
phases:

- ``device``      — the staged wave's launches and device time
- ``wave_kernel`` — the same for the fused wave (``csrc/fused_wave.cu``);
  in a drain, the replays of its captured CUDA Graphs
- ``host_probe``  — the host tier's Bloom + run probe at the wave exit
- ``evict``       — evictions of the device table to the host runs
  (with the merges and spills they trigger)
- ``table_grow``  — device-table growth (rehash through the insert kernel)
- ``checkpoint``  — checkpoint export + pickle
- ``compile``     — the port's counterpart of an AOT-cache miss: the
  capture of a drain's CUDA Graph (one window a graph captured, its
  warm-up wave included); a replay of a held graph never enters it
- ``gap``         — the residual: host bookkeeping, transfers the fences
  don't cover, launch idle

The invariant is that phases sum to the measured wave wall: ``gap`` is
defined as the residual, so the only way the ledger can drift is phases
OVERRUNNING the wall (clock skew, double counting), tracked as
``overrun_s`` and held under ``tolerance`` (default 5%). Phases never
nest: an inner ``phase()`` opened while another is open records nothing,
so call sites can wrap helpers without auditing their callees. Phase time
outside any wave window (a restore's table rebuild) goes to
``outside_wave_s``.

**Overlapped execution**: host-tier work that runs on a worker thread
under device compute is a phase class of its own, ``overlapped``, recorded
through the thread-safe ``overlapped(name)`` window and never into a wave
window, so the sum-to-wall invariant stays exact per wave. No caller of
the port uses it yet (the JAX package's async pipeline is not ported).

Results reach the registry and the trace: per-phase
``<prefix>.pipeline.*`` counters and gauges (``telemetry/metrics.py``),
one ``<prefix>.pipeline`` trace span per wave (its args carry ``wall_ms``,
``gap_ms`` and ``<phase>_ms``: ``scripts/trace_summary.py`` renders the
attribution table and ``scripts/gap_report.py`` the ledger with the
overlap headroom) and the ``<prefix>.hashset.probe_length`` histogram.

**Overlap headroom**: the wall clock a perfect overlap of the host phases
(probe, evict, checkpoint) under device compute would save,
``min(host_overlappable_s, device_s)``, and the predicted wall under it.

With ``profile_dir`` set, ``torch.profiler`` (CPU and, where present,
CUDA activities) runs over the first ``profile_waves`` attributed windows
and exports a Chrome trace there; ``parse_profile_device_busy`` splits
device-busy from device-idle from it (``device_split``), which the fence
alone cannot see. Busy time is the union of the device intervals, as
``scripts/torch_profile.py`` computes it (the JAX package sums them).

The clock is injectable (tests drive a fake clock through the classifier
deterministically); ``time.perf_counter`` is the default.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from .metrics import MetricsRegistry, metrics_registry
from .trace import Tracer, get_tracer

__all__ = [
    "DEFAULT_TOLERANCE",
    "DEVICE_PHASES",
    "HOST_OVERLAPPABLE_PHASES",
    "PHASES",
    "WaveAttribution",
    "parse_profile_device_busy",
]

# The canonical phase names (call sites may add others; the ledger carries
# whatever was recorded). Order is the reporting order. Mirrored by
# scripts/trace_summary.py's PHASE_ORDER/HOST_OVERLAPPABLE, which import
# neither package.
PHASES = (
    "device",
    "wave_kernel",
    "host_probe",
    "evict",
    "table_grow",
    "checkpoint",
    "compile",
)
# Host phases an async pipelined engine could overlap under device
# compute: the numerator of the headroom estimate.
# table_grow/compile are device-serial (the next wave needs their
# output), so they are NOT overlappable.
HOST_OVERLAPPABLE_PHASES = ("host_probe", "evict", "checkpoint")
# Phases that ARE device compute: "device" is the staged wave, "wave_kernel"
# the fused wave's kernel chain (wave_kernel="fused", ops/fused_wave.py).
# Utilization and the overlap-headroom denominator sum the class, so the
# two wave engines report comparable ledgers.
DEVICE_PHASES = ("device", "wave_kernel")
DEFAULT_TOLERANCE = 0.05


class _Phase:
    """One timed phase window inside (or between) waves. Non-reentrant by
    design: if another phase is already open this one records nothing
    (phases partition the wave wall; nesting would double-count)."""

    __slots__ = ("_attr", "name", "_t0", "_active")

    def __init__(self, attr: "WaveAttribution", name: str):
        self._attr = attr
        self.name = name
        self._t0 = 0.0
        self._active = False

    def __enter__(self) -> "_Phase":
        attr = self._attr
        if attr._open_phase is None:
            attr._open_phase = self
            self._active = True
            self._t0 = attr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._active:
            attr = self._attr
            attr._open_phase = None
            attr._add_phase(self.name, attr._clock() - self._t0)


class _OverlappedPhase:
    """One host-tier window running on a worker thread, shadowed under
    device compute. Thread-safe (its ledger is
    lock-guarded and it never touches the wave window's ``_open_phase``
    state) and reentrant across threads by construction: every window
    records, because overlapped windows measure real concurrent work
    rather than partitioning one thread's wall. Emits a
    ``<prefix>.pipeline.overlapped`` span so trace readers see the
    achieved overlap without the registry."""

    __slots__ = ("_attr", "name", "_t0", "_span")

    def __init__(self, attr: "WaveAttribution", name: str):
        self._attr = attr
        self.name = name

    def __enter__(self) -> "_OverlappedPhase":
        attr = self._attr
        self._span = attr._tracer.span(
            f"{attr.prefix}.pipeline.overlapped", phase=self.name
        )
        self._span.__enter__()
        self._t0 = attr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        attr = self._attr
        dt = max(0.0, attr._clock() - self._t0)
        attr._add_overlapped(self.name, dt)
        self._span.set(**{f"{self.name}_ms": dt * 1e3})
        self._span.__exit__(exc_type, exc, tb)


class _Wave:
    """One wave (or drain) window: measures wall, collects the phases
    recorded inside it, computes the residual gap on exit, and emits the
    ``<prefix>.pipeline`` trace span. Exit is idempotent so the worker's
    error path can ``abort()`` a window a crashed loop left open, and a
    caller can close a window early, without double counting."""

    __slots__ = ("_attr", "kind", "phases", "_t0", "_span", "_done")

    def __init__(self, attr: "WaveAttribution", kind: str):
        self._attr = attr
        self.kind = kind
        self.phases: Dict[str, float] = {}
        self._done = False

    def __enter__(self) -> "_Wave":
        attr = self._attr
        attr._current = self
        attr._maybe_profile_start()
        self._span = attr._tracer.span(
            f"{attr.prefix}.pipeline", kind=self.kind
        )
        self._span.__enter__()
        self._t0 = attr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._done:
            return
        self._done = True
        attr = self._attr
        wall = attr._clock() - self._t0
        attr._current = None
        residual = wall - sum(self.phases.values())
        gap = max(0.0, residual)
        overrun = max(0.0, -residual)
        attr._wall_s += wall
        attr._gap_s += gap
        attr._overrun_s += overrun
        if self.kind == "drain":
            attr._drains += 1
        else:
            attr._waves += 1
        attr._c_waves.inc()
        attr._c_wall.inc(wall)
        attr._c_gap.inc(gap)
        if attr._wall_s > 0:
            device = sum(
                attr._totals.get(p, 0.0) for p in DEVICE_PHASES
            )
            attr._g_util.set(device / attr._wall_s)
            attr._g_gap.set(attr._gap_s / attr._wall_s)
        self._span.set(
            wall_ms=wall * 1e3,
            gap_ms=gap * 1e3,
            **{f"{k}_ms": v * 1e3 for k, v in self.phases.items()},
        )
        self._span.__exit__(exc_type, exc, tb)
        attr._maybe_profile_stop()


class WaveAttribution:
    """The per-run attribution engine one checker owns in attribution
    mode. ``wave()`` wraps each host-visible wave/drain window; ``phase()``
    wraps the classified sections inside it; ``fence()`` pins async device
    work into the surrounding phase. ``report()`` returns the ledger."""

    def __init__(
        self,
        prefix: str,
        clock=None,
        tracer: Tracer = None,
        registry: MetricsRegistry = None,
        tolerance: float = DEFAULT_TOLERANCE,
        profile_dir: Optional[str] = None,
        profile_waves: int = 8,
    ):
        self.prefix = prefix
        self._clock = clock if clock is not None else time.perf_counter
        self._tracer = tracer if tracer is not None else get_tracer()
        reg = registry if registry is not None else metrics_registry()
        self._registry = reg
        self.tolerance = tolerance
        self._totals: Dict[str, float] = {}
        # Window counts per phase: how many device windows, graph
        # captures or probes a run paid, not just their seconds.
        self._windows: Dict[str, int] = {}
        # Phase time accrued OUTSIDE any wave window (the restore path's
        # table grows and evictions): reported separately so the in-wave
        # phases + gap still sum to the wave wall; folding it into _totals
        # would break the ledger invariant on every resumed run.
        self._outside: Dict[str, float] = {}
        self._phase_counters: Dict[str, object] = {}
        # Overlapped ledger: host-tier time a worker thread spent shadowed
        # under device compute, per phase. Lock-guarded: the worker and
        # checker threads both reach it.
        self._overlapped: Dict[str, float] = {}
        self._ov_lock = threading.Lock()
        self._ov_counters: Dict[str, object] = {}
        self._overlap_mode = False
        self._wall_s = 0.0
        self._gap_s = 0.0
        self._overrun_s = 0.0
        self._waves = 0
        self._drains = 0
        self._current: Optional[_Wave] = None
        self._open_phase: Optional[_Phase] = None
        p = f"{prefix}.pipeline"
        self._c_waves = reg.counter(f"{p}.waves")
        self._c_wall = reg.counter(f"{p}.wall_seconds")
        self._c_gap = reg.counter(f"{p}.gap_seconds")
        self._g_util = reg.gauge(f"{p}.utilization")
        self._g_gap = reg.gauge(f"{p}.gap_share")
        # Audit surface for the probabilistic machinery: the device
        # hash set's probe-chain displacement distribution (observed at
        # run end from the final table).
        self._probe_hist = reg.histogram(f"{prefix}.hashset.probe_length")
        self._probe_counts: Optional[List[int]] = None
        # torch.profiler window (best effort, never fatal).
        self._profile_dir = profile_dir
        self._profile_waves = max(1, profile_waves)
        self._profile_state = "pending" if profile_dir else "off"
        self._profile_t0_waves = 0
        self._profiler = None
        self.device_split: Optional[Dict[str, float]] = None

    # -- recording ---------------------------------------------------------

    def wave(self, kind: str = "wave") -> _Wave:
        return _Wave(self, kind)

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def overlapped(self, name: str) -> _OverlappedPhase:
        """A host-tier window running on a worker thread, recorded into the
        separate ``overlapped`` ledger, never into any wave window (see the
        module docstring)."""
        return _OverlappedPhase(self, name)

    def set_overlap_mode(self, on: bool = True) -> None:
        """Marks the ledger as describing a pipelined run (reported as
        ``overlap_mode``): readers must not expect the host phases
        inside the wave windows — they ride ``overlapped_s``."""
        self._overlap_mode = bool(on)

    def fence(self, tree) -> None:
        """Waits until the device work queued on every CUDA device that a
        tensor of ``tree`` (a tensor, or dicts, lists and tuples of them)
        lives on has finished, so the surrounding phase window measures
        real work instead of launch latency. CPU tensors and other leaves
        need no wait."""
        devices = set()
        _cuda_devices(tree, devices)
        for dev in devices:
            torch.cuda.synchronize(dev)

    def _add_phase(self, name: str, dt: float) -> None:
        if dt < 0:
            dt = 0.0
        cur = self._current
        if cur is not None:
            cur.phases[name] = cur.phases.get(name, 0.0) + dt
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._windows[name] = self._windows.get(name, 0) + 1
        else:
            self._outside[name] = self._outside.get(name, 0.0) + dt
        c = self._phase_counters.get(name)
        if c is None:
            c = self._registry.counter(
                f"{self.prefix}.pipeline.{name}_seconds"
            )
            self._phase_counters[name] = c
        c.inc(dt)

    def _add_overlapped(self, name: str, dt: float) -> None:
        with self._ov_lock:
            self._overlapped[name] = self._overlapped.get(name, 0.0) + dt
            c = self._ov_counters.get(name)
            if c is None:
                c = self._registry.counter(
                    f"{self.prefix}.pipeline.overlapped.{name}_seconds"
                )
                self._ov_counters[name] = c
            total = self._ov_counters.get("__total__")
            if total is None:
                total = self._registry.counter(
                    f"{self.prefix}.pipeline.overlapped_seconds"
                )
                self._ov_counters["__total__"] = total
        # Counters carry their own locks; inc outside ours.
        c.inc(dt)
        total.inc(dt)

    def abort(self) -> None:
        """Finalizes any window a crashing loop left open (the checker
        worker calls it as its run ends): the open phase is flushed and
        the wave closes normally, so the dying wave's ``.pipeline`` span
        still reaches the trace sinks and no dangling
        ``_current``/``_open_phase`` state survives into a later ledger
        read. Also stops a still-running profiler window on the thread
        that started it. No-op when nothing is open."""
        phase = self._open_phase
        if phase is not None:
            phase.__exit__(None, None, None)
        cur = self._current
        if cur is not None:
            cur.__exit__(None, None, None)
        self._profile_finalize()

    def observe_probe_lengths(self, counts) -> None:
        """Feeds the device hash set's displacement counts (index =
        probe-chain length, value = resident keys at that length) into
        the ``<prefix>.hashset.probe_length`` log2 histogram and keeps
        the exact counts for the ledger."""
        counts = [int(c) for c in counts]
        while counts and counts[-1] == 0:
            counts.pop()
        self._probe_counts = counts
        for d, c in enumerate(counts):
            if c:
                self._probe_hist.observe_many(d, c)

    # -- torch.profiler window (device-busy split) -------------------------

    def _maybe_profile_start(self) -> None:
        if self._profile_state != "pending":
            return
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self._profile_state = "running"
            self._profile_t0_waves = self._waves + self._drains
        except Exception:  # noqa: BLE001 - profiler optional by design
            self._profile_state = "failed"

    def _maybe_profile_stop(self) -> None:
        if self._profile_state != "running":
            return
        done = (self._waves + self._drains) - self._profile_t0_waves
        if done < self._profile_waves:
            return
        self._profile_finalize()

    def _profile_finalize(self) -> None:
        """Stops a still-running profiler window, exports its Chrome trace
        into ``profile_dir`` and parses it. Called from the window-count
        stop, from ``abort()`` (a run that finishes in fewer than
        ``profile_waves`` windows must not leave the profiler running) and
        from ``report()``."""
        if self._profile_state != "running":
            return
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profiler.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            path = os.path.join(
                self._profile_dir, f"{self.prefix}.{os.getpid()}.{id(self):x}.pt.trace.json"
            )
            self._profiler.export_chrome_trace(path)
            self._profile_state = "done"
            self.device_split = parse_profile_device_busy(self._profile_dir)
        except Exception:  # noqa: BLE001
            self._profile_state = "failed"
        finally:
            self._profiler = None

    # -- the ledger ---------------------------------------------------------

    def report(self) -> Dict[str, object]:
        """The phase ledger: totals, shares, the sum-to-wall invariant,
        and the overlap-headroom estimate."""
        self._profile_finalize()
        wall = self._wall_s
        phases = {k: v for k, v in sorted(self._totals.items())}
        device = sum(phases.get(p, 0.0) for p in DEVICE_PHASES)
        host = sum(phases.get(p, 0.0) for p in HOST_OVERLAPPABLE_PHASES)
        headroom = min(host, device)
        with self._ov_lock:
            overlapped = dict(sorted(self._overlapped.items()))
        out: Dict[str, object] = {
            "prefix": self.prefix,
            "waves": self._waves,
            "drains": self._drains,
            "wall_s": wall,
            "phases_s": phases,
            "gap_s": self._gap_s,
            "overrun_s": self._overrun_s,
            "tolerance": self.tolerance,
            "within_tolerance": (
                self._overrun_s <= self.tolerance * wall if wall else True
            ),
            "phase_share": (
                {k: v / wall for k, v in phases.items()} if wall else {}
            ),
            "phase_windows": {
                k: v for k, v in sorted(self._windows.items())
            },
            "gap_share": (self._gap_s / wall) if wall else None,
            "utilization": (device / wall) if wall else None,
            "overlap_headroom": {
                "host_overlappable_s": host,
                "device_s": device,
                "headroom_s": headroom,
                "headroom_pct": (headroom / wall) if wall else 0.0,
                "predicted_wall_s": wall - headroom,
            },
            "device_split": self.device_split,
            # Overlapped execution: host time shadowed under device
            # compute, NOT in phases_s, so the sum-to-wall invariant above
            # stays exact in both modes.
            "overlap_mode": self._overlap_mode,
        }
        if overlapped or self._overlap_mode:
            out["overlapped_s"] = overlapped
            out["overlapped_total_s"] = sum(overlapped.values())
        if self._outside:
            # Phase time outside any wave window (the restore): real, but
            # not part of any wave's wall; reported separately so the
            # invariant above stays exact on resumed runs.
            out["outside_wave_s"] = {
                k: v for k, v in sorted(self._outside.items())
            }
        if self._probe_counts is not None:
            out["probe_length_counts"] = list(self._probe_counts)
        return out


def _cuda_devices(tree, out: set) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)


# Chrome-trace categories of the device's own activity in a torch.profiler
# export: the kernels, and the copies and fills the device runs.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def parse_profile_device_busy(logdir) -> Optional[Dict[str, float]]:
    """Best-effort device-busy/idle split from a ``torch.profiler`` capture:
    finds the newest Chrome-trace export (``*.json``) under ``logdir`` and
    takes the union of its device intervals (kernels, device copies and
    fills) against the span from the first to the last. Returns
    ``{"busy_s", "idle_s", "span_s", "source"}`` or None when the trace
    holds no device interval (a CPU run) or is unreadable. Overlapping
    intervals count once, as ``scripts/torch_profile.py`` counts them."""
    try:
        paths = sorted(
            glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True),
            key=os.path.getmtime,
        )
        if not paths:
            return None
        with open(paths[-1]) as f:
            trace = json.load(f)
        intervals = sorted(
            (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
            for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATEGORIES
        )
        if not intervals:
            return None
        busy_us, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][1]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
        span_us = max(e for _s, e in intervals) - intervals[0][0]
        return {
            "busy_s": busy_us / 1e6,
            "idle_s": max(0.0, span_us - busy_us) / 1e6,
            "span_s": span_us / 1e6,
            "source": "torch.profiler",
        }
    except Exception:  # noqa: BLE001 - profiling is advisory, never fatal
        return None
