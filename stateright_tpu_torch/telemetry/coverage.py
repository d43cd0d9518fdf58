"""State-space cartography: coverage, vacuity, and shape profiling.

The port's copy of the JAX package's ``telemetry/coverage.py``. A green
check answers "did any property fail?" and says nothing about *what was
explored*; with ``spawn_gpu_bfs(coverage=True)``, and always on the host
engines, a run answers the TLC-style coverage questions too:

- **Action coverage** — how often each action fired (produced a valid
  candidate) and how often it discovered a fresh state. An action that
  never fires is *dead* in the reachable space.
- **Property exercise** — for ``always`` properties with a declared
  antecedent (``BatchableModel.packed_antecedents``), the number of
  evaluated states where it held: zero means the invariant passed
  *vacuously*. For ``sometimes``, the witness count plus the **near-miss
  depth** (deepest frontier explored while still unwitnessed); for
  ``eventually``, the evaluated states whose condition had already held on
  their path.
- **Shape statistics** — new-unique-per-depth histogram, successors-per-
  state log2 histogram, terminal-state count, revisit rate, and — under
  symmetry — the orbit compression ratio (in-wave distinct plain
  fingerprints over distinct orbit keys).

Each wave reduces these into one integer vector on the device
(``DeviceCoverage``'s layout): the staged wave in torch
(``DeviceCoverage.wave_reduce``), the fused wave inside its CUDA kernels
``fw_frontier`` and ``fw_compact`` (``csrc/fused_wave.cu``), of which
``wave_reduce`` is the plain twin. The deep drain adds the consumed waves' vectors on the device
and the host reads the sum in the drain's one read. ``CoverageLedger``
consumes the vectors at the host exits, records ``<prefix>.coverage.*``
registry metrics, one cumulative ``<prefix>.coverage`` trace span per
host-visible wave and a ``<prefix>.coverage.summary`` instant carrying the
full report at run end. With ``coverage=False`` (the default) a wave runs
nothing of this. The host engines (``bfs``, ``dfs``, ``on_demand``) feed
the ledger per-block aggregates through ``BlockCoverage`` instead.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, metrics_registry
from .trace import Tracer, get_tracer

__all__ = [
    "DEPTH_BINS",
    "CoverageLedger",
    "DeviceCoverage",
    "coverage_action_labels",
    "sanitize_component",
]

# New-unique-per-depth histogram width (linear bins; deeper states
# saturate into the last bin and the report says so).
DEPTH_BINS = 64

_COMPONENT_RE = re.compile(r"[^A-Za-z0-9_]")


def sanitize_component(name: str) -> str:
    """A metric-name-safe component for user-provided labels (property
    names, action labels): every non-``[A-Za-z0-9_]`` rune becomes ``_``
    so the Prometheus exposition's own sanitizer is a no-op on coverage
    families."""
    out = _COMPONENT_RE.sub("_", name.strip()) or "_"
    return out


def _log2_bin(value: int) -> int:
    """The ``metrics.Histogram`` bucket index of ``value``: 0 for
    ``value <= 1``, else ``ceil(log2(value))``."""
    if value <= 1:
        return 0
    return (value - 1).bit_length()


def coverage_action_labels(model, action_count: int) -> List[str]:
    """The per-action label axis for a packed model: the model's
    ``packed_action_labels()`` (``BatchableModel``'s default is
    ``action_<id>``), truncated or padded with ``action_<id>`` to
    ``action_count``."""
    labels = [str(x) for x in list(model.packed_action_labels())[:action_count]]
    labels += [f"action_{i}" for i in range(len(labels), action_count)]
    return labels


class DeviceCoverage:
    """Static layout + the per-wave reduction of the device checker.

    The reduction's output is ONE integer vector per wave (int64 on the
    device; the JAX package's is int32, with the same values). Layout::

        [0] evaluated   [1] terminal   [2] uniq_fp   [3] uniq_key
        [4 : 4+A]                action fired counts
        [4+A : 4+2A]             action fresh counts
        [4+2A : 4+2A+P]          property exercise counts
        [... : +succ_bins]       successors-per-state log2 bins
        [... : +DEPTH_BINS]      fresh-unique-per-depth linear bins

    Everything except the action-fresh and depth slices is *eval-based*
    (recorded once per logical wave: a table-growth retry re-expands the
    same frontier); action-fresh/depth are *fresh-based* and accumulate
    across retries (only previously-pending lanes come back fresh).
    ``uniq_fp`` and ``uniq_key`` count a wave's distinct fingerprints and
    distinct orbit keys under symmetry (0 without it).
    """

    def __init__(self, action_count: int, property_count: int):
        self.A = int(action_count)
        self.P = int(property_count)
        self.succ_bins = _log2_bin(self.A) + 1
        self.depth_bins = DEPTH_BINS
        self.size = 4 + 2 * self.A + self.P + self.succ_bins + self.depth_bins

    # -- slices (shared by the reduction and the host-side consume) --------

    @property
    def s_fired(self):
        return slice(4, 4 + self.A)

    @property
    def s_fresh(self):
        return slice(4 + self.A, 4 + 2 * self.A)

    @property
    def s_props(self):
        return slice(4 + 2 * self.A, 4 + 2 * self.A + self.P)

    @property
    def s_succ(self):
        base = 4 + 2 * self.A + self.P
        return slice(base, base + self.succ_bins)

    @property
    def s_depth(self):
        base = 4 + 2 * self.A + self.P + self.succ_bins
        return slice(base, base + self.depth_bins)

    # -- the reductions (torch, capturable: no host reads) ------------------

    @staticmethod
    def count_distinct(hi, lo, valid):
        """In-wave distinct (hi, lo) u32 pairs (int64 tensors) among
        ``valid`` lanes, as a 0-dim int64 tensor (one sort). The all-ones
        sentinel pair never collides with real keys — fingerprints nudge
        away from it."""
        import torch

        sent = (1 << 63) - 1  # the sentinel pair, as its signed sort key
        key = torch.where(valid, ((hi << 32) | lo) ^ (-(1 << 63)),
                          torch.full_like(hi, sent))
        skey, _ = torch.sort(key)
        first = torch.ones_like(valid)
        first[1:] = skey[1:] != skey[:-1]
        return (first & (skey != sent)).sum()

    def wave_reduce(self, *, eval_mask, cvalid, fresh, lane_action,
                    new_depth, exercised, uniq_fp=None, uniq_key=None):
        """The per-wave coverage vector (int64, ``self.size`` wide).

        ``eval_mask`` (F,) — frontier lanes evaluated this wave;
        ``cvalid`` (F, A) — valid candidates (already AND'd with
        ``eval_mask``); ``fresh`` (B,) — visited-set claim winners, in
        the same lane order as ``lane_action``/``new_depth`` (B,) —
        per-lane action id and child depth; ``exercised`` — list of
        (F,) bool vectors aligned with properties (may be empty);
        ``uniq_fp``/``uniq_key`` — optional 0-dim in-wave distinct
        counts (symmetry's orbit-compression numerator/denominator).
        Scatter-adds into zeroed vectors, so it runs inside a
        captured CUDA Graph.
        """
        import torch

        i64 = torch.int64
        dev = eval_mask.device
        zero = torch.zeros((), dtype=i64, device=dev)
        ev = eval_mask.to(i64)
        evaluated = ev.sum()
        terminal = (eval_mask & ~cvalid.any(dim=1)).sum()
        act_fired = cvalid.sum(dim=0, dtype=i64)
        act_fresh = torch.zeros(self.A, dtype=i64, device=dev).index_add_(
            0, lane_action, fresh.to(i64))
        if self.P:
            prop_ex = torch.stack([e.sum() for e in exercised]).to(i64)
        else:
            prop_ex = torch.zeros(0, dtype=i64, device=dev)
        succ = cvalid.sum(dim=1, dtype=i64)
        # Per-lane bin vector: with a single successor bin
        # (action_count == 1) the loop below never runs.
        sbin = torch.zeros_like(succ)
        for j in range(self.succ_bins - 1):
            sbin = sbin + (succ > (1 << j)).to(i64)
        succ_hist = torch.zeros(self.succ_bins, dtype=i64, device=dev).index_add_(
            0, sbin, ev)
        dbin = new_depth.clamp(0, self.depth_bins - 1)
        depth_hist = torch.zeros(self.depth_bins, dtype=i64, device=dev).index_add_(
            0, dbin, fresh.to(i64))
        head = torch.stack([
            evaluated,
            terminal,
            (uniq_fp if uniq_fp is not None else zero).to(i64),
            (uniq_key if uniq_key is not None else zero).to(i64),
        ])
        return torch.cat([head, act_fired, act_fresh, prop_ex, succ_hist, depth_hist])


class BlockCoverage:
    """Per-block accumulator for the host engines' ``_check_block``
    loops: plain dict bumps in the hot loop, one ``record_block`` flush
    per ≤BLOCK_SIZE block (the same once-per-block shape as their
    telemetry spans). Actions are keyed by the action object itself
    (``repr`` fallback for unhashables) and converted to labels only at
    flush — distinct actions per block are few."""

    __slots__ = (
        "ledger", "model", "evaluated", "terminals",
        "fired", "fresh", "exercised", "succ", "depth",
    )

    def __init__(self, ledger: "CoverageLedger", model):
        self.ledger = ledger
        self.model = model
        self.evaluated = 0
        self.terminals = 0
        self.fired: Dict[object, int] = {}
        self.fresh: Dict[object, int] = {}
        self.exercised: Dict[int, int] = {}
        self.succ: Dict[int, int] = {}
        self.depth: Dict[int, int] = {}

    def action(self, action, fresh: bool) -> None:
        """One valid transition via ``action`` (``fresh``: it claimed a
        brand-new state)."""
        try:
            self.fired[action] = self.fired.get(action, 0) + 1
        except TypeError:
            action = repr(action)
            self.fired[action] = self.fired.get(action, 0) + 1
        if fresh:
            self.fresh[action] = self.fresh.get(action, 0) + 1

    def exercise(self, index: int) -> None:
        self.exercised[index] = self.exercised.get(index, 0) + 1

    def _label(self, action) -> str:
        if isinstance(action, str):
            return action
        if isinstance(action, tuple) and all(
            isinstance(x, (str, int, bool)) for x in action
        ):
            # The common host-action shape ("RmPrepare", 2) reads as
            # RmPrepare_2 — matching the packed_action_labels idiom —
            # instead of repr's quote-and-paren noise.
            return "_".join(str(x) for x in action)
        try:
            return self.model.format_action(action)
        except Exception:  # noqa: BLE001 - labels are advisory
            return repr(action)

    def flush(self, max_depth: Optional[int] = None) -> None:
        if not self.evaluated and not self.fired:
            return
        self.ledger.record_block(
            evaluated=self.evaluated,
            terminals=self.terminals,
            fired={self._label(k): v for k, v in self.fired.items()},
            fresh={self._label(k): v for k, v in self.fresh.items()},
            exercised=self.exercised,
            succ_counts=self.succ,
            depth_counts=self.depth,
            max_depth=max_depth,
        )
        # One cumulative `.coverage` span per block (same cadence as the
        # engines' block spans).
        self.ledger.emit_wave_span()


class CoverageLedger:
    """The per-run coverage accumulator one checker owns.

    The device checker feeds it ``consume_device`` vectors (see
    ``DeviceCoverage``) at its host exits; the host engines feed
    ``record_block`` aggregates once per ≤1500-state block. Both update
    the ``<prefix>.coverage.*`` registry instruments; ``emit_wave_span``
    and ``finalize`` surface the cumulative state into the trace stream.
    """

    def __init__(
        self,
        prefix: str,
        properties,
        action_labels: Optional[List[str]] = None,
        registry: MetricsRegistry = None,
        tracer: Tracer = None,
        symmetry: bool = False,
    ):
        self.prefix = prefix
        self._p = f"{prefix}.coverage"
        reg = registry if registry is not None else metrics_registry()
        self._registry = reg
        self._tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.Lock()
        # Property metadata (expectation as its string value so the
        # report is JSON-clean without importing Expectation here).
        self._props = [
            {
                "name": p.name,
                "expectation": getattr(
                    p.expectation, "value", str(p.expectation)
                ),
                "has_antecedent": getattr(p, "antecedent", None) is not None,
            }
            for p in properties
        ]
        self.action_labels = (
            list(action_labels) if action_labels is not None else None
        )
        # -- accumulated state -------------------------------------------
        self._fired: Dict[str, int] = {}
        self._fresh: Dict[str, int] = {}
        if self.action_labels is not None:
            for label in self.action_labels:
                self._fired[label] = 0
                self._fresh[label] = 0
        self._exercised = [0] * len(self._props)
        self._near_miss = [None] * len(self._props)
        self._evaluated = 0
        self._terminals = 0
        self._generated = 0
        self._unique = 0
        self._seed_unique = 0
        # Symmetry-only: in-wave distinct plain fps / orbit keys.
        self._uniq_fp = 0
        self._uniq_key = 0
        self._symmetry = bool(symmetry)
        self._depth_hist = [0] * DEPTH_BINS
        self._succ_bins: Dict[int, int] = {}
        self._revisits_reported = 0
        self._discovered: Optional[set] = None
        self._finalized = False
        # -- registry instruments ----------------------------------------
        self._c_eval = reg.counter(f"{self._p}.states_evaluated")
        self._c_term = reg.counter(f"{self._p}.terminal_states")
        self._c_revisit = reg.counter(f"{self._p}.revisits")
        self._g_revisit = reg.gauge(f"{self._p}.revisit_rate")
        self._g_action_cov = reg.gauge(f"{self._p}.action_coverage")
        self._g_orbit = (
            reg.gauge(f"{self._p}.orbit_compression") if symmetry else None
        )
        self._h_depth = reg.histogram(f"{self._p}.depth")
        self._h_succ = reg.histogram(f"{self._p}.successors")
        self._c_action_fired: Dict[str, object] = {}
        self._c_action_fresh: Dict[str, object] = {}
        if self.action_labels is not None:
            # Eager creation: dead actions must show as explicit zeros in
            # /metrics, not as absent families.
            for label in self.action_labels:
                self._action_counter(label, fired=True)
                self._action_counter(label, fired=False)
        self._c_prop_ex = [
            reg.counter(
                f"{self._p}.property_exercised.{sanitize_component(m['name'])}"
            )
            for m in self._props
        ]

    def _action_counter(self, label: str, fired: bool):
        cache = self._c_action_fired if fired else self._c_action_fresh
        c = cache.get(label)
        if c is None:
            kind = "action_fired" if fired else "action_fresh"
            c = self._registry.counter(
                f"{self._p}.{kind}.{sanitize_component(label)}"
            )
            cache[label] = c
        return c

    # -- recording ----------------------------------------------------------

    def record_seed(self, n_unique: int, depth: int = 1) -> None:
        """Initial states (they never flow through a wave/block): depth
        histogram + unique total."""
        n = int(n_unique)
        if n <= 0:
            return
        with self._lock:
            self._seed_unique += n
            self._unique += n
            self._depth_hist[min(max(depth, 0), DEPTH_BINS - 1)] += n
        self._h_depth.observe_many(depth, n)

    def consume_device(self, vec, layout: DeviceCoverage, *,
                       first_attempt: bool = True,
                       max_depth: Optional[int] = None) -> None:
        """One wave's (or drain-aggregate's) device coverage vector.
        ``first_attempt=False`` marks a table-growth retry of the same
        logical wave: only the fresh-based slices (action fresh, depth
        bins) accumulate — the eval-based ones were already recorded."""
        import numpy as np

        v = np.asarray(vec, dtype=np.int64)
        labels = self.action_labels or []
        fresh_by_action = v[layout.s_fresh]
        depth_bins = v[layout.s_depth]
        fired_by_action = v[layout.s_fired] if first_attempt else None
        succ_bins = v[layout.s_succ] if first_attempt else None
        with self._lock:
            for i, label in enumerate(labels):
                self._fresh[label] = self._fresh.get(label, 0) + int(
                    fresh_by_action[i]
                )
            for d in np.flatnonzero(depth_bins):
                self._depth_hist[int(d)] += int(depth_bins[d])
            self._unique += int(fresh_by_action.sum())
            if first_attempt:
                self._evaluated += int(v[0])
                self._terminals += int(v[1])
                self._uniq_fp += int(v[2])
                self._uniq_key += int(v[3])
                self._generated += int(fired_by_action.sum())
                for i, label in enumerate(labels):
                    self._fired[label] = self._fired.get(label, 0) + int(
                        fired_by_action[i]
                    )
                prop_ex = v[layout.s_props]
                for i in range(len(self._props)):
                    self._exercised[i] += int(prop_ex[i])
                for b in np.flatnonzero(succ_bins):
                    self._succ_bins[int(b)] = self._succ_bins.get(
                        int(b), 0
                    ) + int(succ_bins[b])
            if max_depth is not None:
                self._update_near_miss(max_depth)
            revisits, rev_delta = self._revisits_locked()
        # Registry updates outside the ledger lock (instruments lock
        # themselves; ordering races only skew gauges transiently).
        for i, label in enumerate(labels):
            if int(fresh_by_action[i]):
                self._action_counter(label, fired=False).inc(
                    int(fresh_by_action[i])
                )
        for d in np.flatnonzero(depth_bins):
            self._h_depth.observe_many(int(d), int(depth_bins[d]))
        if first_attempt:
            self._c_eval.inc(int(v[0]))
            self._c_term.inc(int(v[1]))
            for i, label in enumerate(labels):
                if int(fired_by_action[i]):
                    self._action_counter(label, fired=True).inc(
                        int(fired_by_action[i])
                    )
            for i, c in enumerate(self._c_prop_ex):
                n = int(v[layout.s_props][i])
                if n:
                    c.inc(n)
            for b in np.flatnonzero(succ_bins):
                self._h_succ.observe_many(
                    1 if int(b) == 0 else (1 << int(b)), int(succ_bins[b])
                )
        self._refresh_gauges(revisits, rev_delta)

    def record_block(self, *, evaluated: int, terminals: int,
                     fired: Dict[str, int], fresh: Dict[str, int],
                     exercised: Dict[int, int],
                     succ_counts: Dict[int, int],
                     depth_counts: Dict[int, int],
                     max_depth: Optional[int] = None) -> None:
        """One host-engine block's aggregates (labels are already
        strings; ``exercised`` maps property index -> count;
        ``depth_counts`` maps fresh-state depth -> count)."""
        generated = sum(fired.values())
        block_fresh = sum(fresh.values())
        with self._lock:
            self._evaluated += int(evaluated)
            self._terminals += int(terminals)
            self._generated += int(generated)
            self._unique += int(block_fresh)
            for label, n in fired.items():
                self._fired[label] = self._fired.get(label, 0) + int(n)
            for label, n in fresh.items():
                self._fresh[label] = self._fresh.get(label, 0) + int(n)
            for i, n in exercised.items():
                if 0 <= i < len(self._exercised):
                    self._exercised[i] += int(n)
            for s, n in succ_counts.items():
                b = _log2_bin(int(s))
                self._succ_bins[b] = self._succ_bins.get(b, 0) + int(n)
            for d, n in depth_counts.items():
                self._depth_hist[min(max(int(d), 0), DEPTH_BINS - 1)] += int(n)
            if max_depth is not None:
                self._update_near_miss(max_depth)
            revisits, rev_delta = self._revisits_locked()
        self._c_eval.inc(int(evaluated))
        self._c_term.inc(int(terminals))
        for label, n in fired.items():
            if n:
                self._action_counter(label, fired=True).inc(int(n))
        for label, n in fresh.items():
            if n:
                self._action_counter(label, fired=False).inc(int(n))
        for i, n in exercised.items():
            if n and 0 <= i < len(self._c_prop_ex):
                self._c_prop_ex[i].inc(int(n))
        for s, n in succ_counts.items():
            if n:
                self._h_succ.observe_many(int(s), int(n))
        for d, n in depth_counts.items():
            if n:
                self._h_depth.observe_many(int(d), int(n))
        self._refresh_gauges(revisits, rev_delta)

    def _update_near_miss(self, max_depth: int) -> None:
        """Deepest frontier evaluated while a ``sometimes`` property was
        still unwitnessed (caller holds the lock)."""
        for i, meta in enumerate(self._props):
            if meta["expectation"] != "sometimes":
                continue
            if self._exercised[i] == 0:
                prev = self._near_miss[i]
                self._near_miss[i] = (
                    max_depth if prev is None else max(prev, max_depth)
                )

    def _revisits_locked(self):
        """Cumulative revisit count + the not-yet-reported delta for the
        ``.revisits`` counter (caller holds the ledger lock, so the
        delta handoff is race-free across worker threads)."""
        revisits = max(
            0, int(self._generated - (self._unique - self._seed_unique))
        )
        delta = max(0, revisits - self._revisits_reported)
        self._revisits_reported = max(self._revisits_reported, revisits)
        return revisits, delta

    def _refresh_gauges(self, revisits: int, rev_delta: int = 0) -> None:
        if rev_delta:
            self._c_revisit.inc(rev_delta)
        if self._generated:
            self._g_revisit.set(revisits / self._generated)
        if self.action_labels:
            fired = sum(1 for x in self._fired.values() if x > 0)
            self._g_action_cov.set(fired / len(self.action_labels))
        if self._g_orbit is not None and self._uniq_key:
            self._g_orbit.set(self._uniq_fp / self._uniq_key)

    # -- surfacing -----------------------------------------------------------

    def emit_wave_span(self) -> None:
        """One cumulative ``<prefix>.coverage`` span per host-visible
        wave, in the JAX package's event shape (its monitor and
        ``trace_summary`` read these spans)."""
        with self._lock:
            args = self._span_args()
        with self._tracer.span(f"{self._p}", **args):
            pass

    def _span_args(self) -> Dict[str, object]:
        total = len(self.action_labels) if self.action_labels else None
        fired = sum(1 for x in self._fired.values() if x > 0)
        sometimes = [
            (i, m) for i, m in enumerate(self._props)
            if m["expectation"] == "sometimes"
        ]
        args = {
            "evaluated": self._evaluated,
            "terminals": self._terminals,
            "actions_fired": fired,
            "revisit_rate": (
                max(
                    0.0,
                    1.0 - (self._unique - self._seed_unique)
                    / self._generated,
                )
                if self._generated
                else 0.0
            ),
            "sometimes_witnessed": sum(
                1 for i, _ in sometimes if self._exercised[i] > 0
            ),
            "sometimes_total": len(sometimes),
            "props_total": len(self._props),
        }
        if total is not None:
            args["actions_total"] = total
            args["dead_actions"] = total - fired
        if self._symmetry and self._uniq_key:
            args["orbit_compression"] = self._uniq_fp / self._uniq_key
        return args

    def finalize(self, discovered=None) -> None:
        """Run-end: records the discovery outcome and emits a
        ``<prefix>.coverage.summary`` instant carrying the full report.
        Safe to call more than once (the host engines call it from every
        worker's shutdown path; readers take the LAST summary per
        prefix, so the final call's complete totals win)."""
        with self._lock:
            if discovered is not None:
                self._discovered = set(discovered)
            self._finalized = True
        report = self.report()
        self._tracer.instant(f"{self._p}.summary", report=report)

    def vacuity(self) -> Dict[str, List[str]]:
        """The CI-failing findings: dead actions (never enabled anywhere
        reachable), ``always`` properties whose declared antecedent never
        fired, and undiscovered ``sometimes`` properties. Informational
        cousins (fired-but-never-fresh actions, never-met ``eventually``
        conditions) ride the report, not this dict."""
        with self._lock:
            dead = (
                [a for a in self.action_labels if self._fired.get(a, 0) == 0]
                if self.action_labels is not None
                else []
            )
            unexercised = [
                m["name"]
                for i, m in enumerate(self._props)
                if m["expectation"] == "always"
                and m["has_antecedent"]
                and self._exercised[i] == 0
            ]
            undiscovered = [
                m["name"]
                for i, m in enumerate(self._props)
                if m["expectation"] == "sometimes"
                and (
                    m["name"] not in self._discovered
                    if self._discovered is not None
                    else self._exercised[i] == 0
                )
            ]
        return {
            "dead_actions": dead,
            "unexercised_always": unexercised,
            "undiscovered_sometimes": undiscovered,
        }

    def report(self) -> Dict[str, object]:
        """The full cartography (JSON-clean)."""
        vac = self.vacuity()
        with self._lock:
            wave_unique = self._unique - self._seed_unique
            revisits = max(0, self._generated - wave_unique)
            hi = 0
            for i, n in enumerate(self._depth_hist):
                if n:
                    hi = i + 1
            succ_hist = [
                self._succ_bins.get(b, 0)
                for b in range(max(self._succ_bins, default=-1) + 1)
            ]
            actions = {
                "total": (
                    len(self.action_labels)
                    if self.action_labels is not None
                    else None
                ),
                "fired": sum(1 for x in self._fired.values() if x > 0),
                "never_new": sorted(
                    a
                    for a, n in self._fired.items()
                    if n > 0 and self._fresh.get(a, 0) == 0
                ),
                "table": {
                    a: {
                        "fired": self._fired.get(a, 0),
                        "fresh": self._fresh.get(a, 0),
                    }
                    for a in (
                        self.action_labels
                        if self.action_labels is not None
                        else sorted(self._fired)
                    )
                },
            }
            props = {}
            for i, m in enumerate(self._props):
                entry = {
                    "expectation": m["expectation"],
                    "exercised": self._exercised[i],
                    "has_antecedent": m["has_antecedent"],
                }
                if self._discovered is not None:
                    entry["discovered"] = m["name"] in self._discovered
                if m["expectation"] == "sometimes":
                    entry["near_miss_depth"] = self._near_miss[i]
                props[m["name"]] = entry
            out = {
                "prefix": self.prefix,
                "evaluated": self._evaluated,
                "generated": self._generated,
                "unique": self._unique,
                "terminal_states": self._terminals,
                "revisits": revisits,
                "revisit_rate": (
                    revisits / self._generated if self._generated else 0.0
                ),
                "mean_in_degree": (
                    self._generated / wave_unique if wave_unique else None
                ),
                "actions": actions,
                "properties": props,
                "shape": {
                    "depth_hist": self._depth_hist[:hi],
                    "depth_saturated": bool(
                        self._depth_hist[DEPTH_BINS - 1]
                    ),
                    "succ_hist_log2": succ_hist,
                },
                "vacuity": vac,
                "vacuous": bool(any(vac.values())),
            }
            if self._symmetry:
                out["symmetry"] = {
                    "wave_distinct_fps": self._uniq_fp,
                    "wave_distinct_orbits": self._uniq_key,
                    "orbit_compression": (
                        self._uniq_fp / self._uniq_key
                        if self._uniq_key
                        else None
                    ),
                }
        return out
