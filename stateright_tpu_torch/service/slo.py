"""Service SLO ledger: end-to-end latency attribution per verification
job. The port's copy of the JAX package's ``service/slo.py``.

Every terminal job already carries its lifecycle stamps (``CheckJob``:
``submitted_t`` → ``started_t`` → summed compile ``warmup_s`` → first
discovery → ``finished_t``) — the ledger folds them into rolling
per-mode latency objectives:

- **ttfv decomposition**: ``queue_s`` (submit → first schedule, the
  admission/scheduler wait), ``compile_s`` (the job's summed compile
  warmup: on the card, its CUDA Graph captures), ``explore_s`` (the
  residual: device waves + host folds until the first discovery). The
  three are clamped to partition ``ttfv_s`` exactly, so "what do I buy
  by fixing cold-compile" is one subtraction per mode.
- **rolling percentiles**: p50/p99 ttfv and verdict (submit → terminal)
  latency over a bounded window per mode (``exhaustive`` / ``swarm`` /
  ``packed`` — a packed slice's mode wins over its base mode), plus
  registry histograms for the full distributions.
- **SLO targets + burn rate**: configurable targets
  (``CheckService(slo_targets={"ttfv_s": 30, "verdict_s": 120,
  "objective": 0.99})``); the burn-rate gauge is the windowed violation
  rate over the error budget ``1 - objective`` (1.0 = burning exactly
  the budget, >1 = on track to miss the SLO).

Surfaces: ``snapshot()`` (``CheckService.slo``) and the ``slo.*`` metric
family in the default registry (linted by ``registry_hygiene_problems``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from ..telemetry.metrics import metrics_registry

MODES = ("exhaustive", "swarm", "packed", "conformance")

# Error-budget objective and latency targets; targets=None keeps the
# ledger observational (percentiles/decomposition, no burn gauges).
DEFAULT_OBJECTIVE = 0.99


def _pct(values, p):
    """Nearest-rank percentile (the bench's convention) — None on empty."""
    if not values:
        return None
    vs = sorted(values)
    k = max(0, min(len(vs) - 1, int(round((p / 100.0) * (len(vs) - 1)))))
    return vs[k]


def decompose_ttfv(ttfv_s: Optional[float], queued_s: float,
                   compile_s: float) -> Optional[Dict[str, float]]:
    """Splits one job's ttfv into queue/compile/explore, clamped so the
    three sum to ``ttfv_s`` exactly (a discovery can land mid-compile on
    a resumed slice; clamping keeps the partition honest rather than
    reporting phases that overlap)."""
    if ttfv_s is None:
        return None
    t = max(0.0, float(ttfv_s))
    q = min(max(0.0, float(queued_s)), t)
    c = min(max(0.0, float(compile_s)), t - q)
    return {
        "ttfv_s": t,
        "queue_s": q,
        "compile_s": c,
        "explore_s": t - q - c,
    }


class SLOLedger:
    """Rolling per-mode SLO accounting over terminal jobs.

    ``observe(job)`` is called once per job at its completion site (the
    solo-slice and packed-slice verdict paths); jobs that fail or are
    cancelled never observe — the SLO measures served verdicts. All
    state is windowed (``window`` jobs per mode) so a long-lived service
    reports current behaviour, not its launch day."""

    def __init__(self, targets: Optional[dict] = None,
                 registry=None, window: int = 512):
        self.targets = dict(targets or {})
        self.objective = float(
            self.targets.pop("objective", DEFAULT_OBJECTIVE)
        )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"slo objective must be in (0, 1), got {self.objective}"
            )
        for k in self.targets:
            if k not in ("ttfv_s", "verdict_s"):
                raise ValueError(
                    f"unknown slo target {k!r} (expected 'ttfv_s', "
                    f"'verdict_s', 'objective')"
                )
        self.window = max(8, int(window))
        self._lock = threading.Lock()
        self._obs: Dict[str, deque] = {m: deque(maxlen=self.window) for m in MODES}
        self._jobs: Dict[str, int] = {m: 0 for m in MODES}
        reg = registry if registry is not None else metrics_registry()
        self._reg = reg
        self._g: Dict[tuple, object] = {}
        self._h_ttfv = {m: reg.histogram(f"slo.{m}.ttfv_seconds") for m in MODES}
        self._h_verdict = {
            m: reg.histogram(f"slo.{m}.verdict_seconds") for m in MODES
        }

    def _gauge(self, mode: str, name: str):
        g = self._g.get((mode, name))
        if g is None:
            g = self._reg.gauge(f"slo.{mode}.{name}")
            self._g[(mode, name)] = g
        return g

    @staticmethod
    def job_mode(job) -> str:
        return "packed" if getattr(job, "packed", False) else job.mode

    def observe(self, job) -> None:
        """Folds one completed job; cheap (a few floats under one lock +
        gauge stores), called on the slice thread at verdict time."""
        mode = self.job_mode(job)
        if mode not in self._obs:
            return
        lat = job.latency()
        # Compile-share evidence (warm-start plane): ``compile_s`` is
        # the job's summed warmup; ``compile_free`` is derived from the
        # per-job disk-AOT counters — a disk miss is exactly one fresh
        # compile, so zero misses means every executable came from a
        # cache (memory or disk). None when the job had no AOT binding.
        aot = None
        result = getattr(job, "result", None)
        if isinstance(result, dict):
            aot = result.get("aot")
        compile_free = None
        if aot is not None:
            compile_free = aot.get("aot_cache.disk_miss", 0) == 0
        row = {
            "job_id": job.job_id,
            "verdict_s": lat["wall_s"],
            "queued_s": lat["queued_s"],
            "compile_s": float(job.warmup_s),
            "compile_free": compile_free,
            "warm_start": bool(getattr(job, "warm_start", False)),
            "decomposition": decompose_ttfv(
                lat["ttfv_s"], lat["queued_s"], job.warmup_s
            ),
        }
        with self._lock:
            self._obs[mode].append(row)
            self._jobs[mode] += 1
        self._h_verdict[mode].observe(row["verdict_s"])
        if row["decomposition"] is not None:
            self._h_ttfv[mode].observe(row["decomposition"]["ttfv_s"])
        self._publish(mode)

    def _mode_view(self, mode: str) -> dict:
        with self._lock:
            rows = list(self._obs[mode])
            jobs = self._jobs[mode]
        verdicts = [r["verdict_s"] for r in rows]
        decomps = [r["decomposition"] for r in rows if r["decomposition"]]
        ttfvs = [d["ttfv_s"] for d in decomps]
        compiles = [
            r["compile_s"] for r in rows if r.get("compile_s") is not None
        ]
        known_free = [
            r for r in rows if r.get("compile_free") is not None
        ]
        view = {
            "jobs": jobs,
            "window": len(rows),
            "ttfv": {
                "count": len(ttfvs),
                "p50_s": _pct(ttfvs, 50),
                "p99_s": _pct(ttfvs, 99),
            },
            "verdict": {
                "count": len(verdicts),
                "p50_s": _pct(verdicts, 50),
                "p99_s": _pct(verdicts, 99),
            },
            "compile": {
                "count": len(compiles),
                "p50_s": _pct(compiles, 50),
                "p99_s": _pct(compiles, 99),
                "free_fraction": (
                    sum(1 for r in known_free if r["compile_free"])
                    / len(known_free)
                    if known_free
                    else None
                ),
                "warm_start_jobs": sum(
                    1 for r in rows if r.get("warm_start")
                ),
            },
            "decomposition": {
                phase: {
                    "p50_s": _pct([d[phase] for d in decomps], 50),
                    "mean_s": (
                        sum(d[phase] for d in decomps) / len(decomps)
                        if decomps
                        else None
                    ),
                }
                for phase in ("queue_s", "compile_s", "explore_s")
            },
            "last": rows[-1] if rows else None,
        }
        burn = {}
        budget = 1.0 - self.objective
        if "ttfv_s" in self.targets and ttfvs:
            bad = sum(t > self.targets["ttfv_s"] for t in ttfvs)
            burn["ttfv"] = (bad / len(ttfvs)) / budget
        if "verdict_s" in self.targets and verdicts:
            bad = sum(v > self.targets["verdict_s"] for v in verdicts)
            burn["verdict"] = (bad / len(verdicts)) / budget
        if burn:
            view["burn_rate"] = burn
        return view

    def _publish(self, mode: str) -> None:
        view = self._mode_view(mode)
        self._gauge(mode, "jobs").set(view["jobs"])
        for key, block in (("ttfv", view["ttfv"]),
                           ("verdict", view["verdict"])):
            for stat in ("p50_s", "p99_s"):
                if block[stat] is not None:
                    self._gauge(mode, f"{key}_{stat}").set(block[stat])
        for phase, block in view["decomposition"].items():
            if block["p50_s"] is not None:
                self._gauge(mode, f"{phase}_p50").set(block["p50_s"])
        comp = view["compile"]
        for stat in ("p50_s", "p99_s"):
            if comp[stat] is not None:
                self._gauge(mode, f"compile_{stat}").set(comp[stat])
        if comp["free_fraction"] is not None:
            self._gauge(mode, "compile_free_fraction").set(
                comp["free_fraction"]
            )
        for key, rate in view.get("burn_rate", {}).items():
            self._gauge(mode, f"{key}_burn_rate").set(rate)

    def snapshot(self) -> dict:
        """The whole ledger: targets, objective, window and each mode's
        view."""
        return {
            "targets": dict(self.targets),
            "objective": self.objective,
            "window": self.window,
            "modes": {m: self._mode_view(m) for m in MODES},
        }
