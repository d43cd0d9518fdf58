"""The post-spawn checker handle: counts, discoveries, joins, assertions.

Reference: ``Checker`` trait at ``src/checker.rs:273-557``. This is the
compatibility surface that tests hit; every backend of the port (host
BFS/DFS, on-demand, simulation, GPU BFS) returns an object with this
interface. It is the JAX package's ``checker/base.py`` with its metrics
registry, coverage ledger, wave-timeline attribution hooks, the
``complete_liveness()`` lasso pass, device liveness (``liveness="device"``)
and the preemption surface, and without the hooks into the async pipeline
and the live monitor, which the port has not taken on yet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Generic, List, Optional, TypeVar

from ..core.model import Expectation
from ..core.path import Path
from ..report import ReportData, ReportDiscovery, Reporter

State = TypeVar("State")
Action = TypeVar("Action")

# The attribution hooks' context when attribution is off: one shared object,
# so the off path costs an enter and an exit and nothing else.
_NULL_CTX = contextlib.nullcontext()

EXAMPLE = "example"
COUNTEREXAMPLE = "counterexample"


class Checker(Generic[State, Action]):
    """Base class for checker handles. Subclasses implement the abstract
    accessors; joins/reports/assertions are shared."""

    # -- abstract surface --------------------------------------------------

    def model(self):
        raise NotImplementedError

    def state_count(self) -> int:
        """Total states generated including repeats (>= unique_state_count)."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        raise NotImplementedError

    def max_depth(self) -> int:
        raise NotImplementedError

    def discoveries(self) -> Dict[str, Path]:
        """Map from property name to discovery path."""
        raise NotImplementedError

    def handles(self) -> List[threading.Thread]:
        """Extract (and clear) the worker thread handles."""
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def worker_error(self) -> Optional[BaseException]:
        """The first exception raised by a worker thread, if any."""
        return None

    def check_fingerprint(self, fp: int) -> None:
        """Ask the checker to check the given fingerprint (on-demand only)."""

    def run_to_completion(self) -> None:
        """Ask the checker to run to completion (on-demand only)."""

    # -- preemption (the GPU checker implements it; see checker/gpu.py) -------

    _preempt_payload = None

    # True on the backends whose request_preempt() yields a resumable
    # payload; the packing pair says whether the backend's runs can share a
    # packed engine (the swarm's can) and why not.
    supports_preempt = False
    supports_packing = False
    packing_reason: Optional[str] = None

    # The walkers' truncation count: walks aborted because their trace
    # buffer overflowed (not a semantic depth cap). Nonzero means absence
    # of discoveries on those walks is not evidence; the report warns once
    # at run end.
    _trace_overflows = 0

    def request_preempt(self) -> None:
        """Asks the worker to stop at the next wave boundary and put its
        state into an in-memory checkpoint payload. The GPU checker
        implements it; the host engines' per-state loops have no payload
        format to yield."""
        raise NotImplementedError(f"{type(self).__name__} does not support preemption")

    @property
    def preempted(self) -> bool:
        """True when the worker stopped at a preempt request (the run is
        incomplete and resumable)."""
        return self._preempt_payload is not None

    def preempt_payload(self):
        """The stopped run's in-memory checkpoint payload, or None (not
        preempted, or finished first). Pass it as ``resume_from=``."""
        return self._preempt_payload

    # -- telemetry and coverage ----------------------------------------------

    _attr = None
    _cov = None
    _cov_layout = None
    _cov_antecedents = None

    @property
    def _tracer(self):
        from ..telemetry import get_tracer

        return get_tracer()

    # A run given a run id (a packed tenant) records into its own registry.
    run_id = None
    _registry = None

    def metrics(self):
        """The telemetry metrics registry this checker records into: the
        process-local one, or the run's own (``_registry``, a packed
        tenant's run-scoped registry); ``metrics().snapshot()`` is the
        cheap point-in-time view."""
        if self._registry is not None:
            return self._registry
        from ..telemetry import metrics_registry

        return metrics_registry()

    # -- wave-timeline attribution (the GPU checker's) ------------------------

    def _init_attribution(self, prefix: str, attribution) -> None:
        """Installs the attribution engine when requested: ``True`` builds
        a ``WaveAttribution`` recording into ``self._tracer`` and
        ``self.metrics()``, or pass an engine already built (an injected
        clock, a ``profile_dir``). Falsy leaves attribution off (the class
        default)."""
        if not attribution:
            return
        from ..telemetry.attribution import WaveAttribution

        self._attr = (
            attribution
            if isinstance(attribution, WaveAttribution)
            else WaveAttribution(prefix, tracer=self._tracer, registry=self.metrics())
        )

    def _phase(self, name: str):
        """An attribution phase window, or the shared no-op context when
        attribution is off (the off path reads no clock and fences
        nothing)."""
        if self._attr is None:
            return _NULL_CTX
        return self._attr.phase(name)

    def _wave_window(self, kind: str = "wave"):
        """One attributed wave or drain window (no-op when attribution is
        off)."""
        if self._attr is None:
            return _NULL_CTX
        return self._attr.wave(kind)

    def _phase_overlapped(self, name: str):
        """An attribution window for host-tier work running on a worker
        thread under device compute: it records into the thread-safe
        ``overlapped`` ledger, not into the wave window
        (``telemetry/attribution.py``). No-op when attribution is off."""
        if self._attr is None:
            return _NULL_CTX
        return self._attr.overlapped(name)

    def _abort_attribution(self) -> None:
        """Run-end cleanup on the worker thread: closes any window a crash
        left open, so the dying wave's ``.pipeline`` span still reaches the
        sinks and no dangling state survives into a ledger read, and stops
        a profiler window still running. Never raises: it must not mask
        the run's own error."""
        if self._attr is None:
            return
        try:
            self._attr.abort()
        except Exception:  # noqa: BLE001 - never mask the worker error
            pass

    @property
    def attribution(self):
        """The ``WaveAttribution`` engine, or None outside attribution
        mode."""
        return self._attr

    def attribution_report(self):
        """The wave-timeline phase ledger
        (``stateright_tpu_torch.telemetry.attribution``): where real-run
        wall clock went between device work. None unless the run was
        spawned with ``attribution=True`` (the GPU checker takes it; the
        host engines have no device/host boundary to attribute)."""
        return self._attr.report() if self._attr is not None else None

    def _init_coverage(self, prefix: str, coverage, action_count: int,
                       symmetry: bool = False) -> None:
        """Installs the coverage ledger, the device vector's layout and the
        model's antecedents when requested (``symmetry``: the ledger keeps
        the orbit-compression counts). Falsy leaves coverage off (the
        class default) and the waves run exactly as before."""
        if not coverage:
            return
        from ..telemetry.coverage import (
            CoverageLedger,
            DeviceCoverage,
            coverage_action_labels,
        )

        model = self._model
        props = self._properties
        self._cov = CoverageLedger(
            prefix,
            props,
            action_labels=coverage_action_labels(model, action_count),
            tracer=self._tracer,
            registry=self.metrics(),
            symmetry=symmetry,
        )
        self._cov_layout = DeviceCoverage(action_count, len(props))
        ants = list(model.packed_antecedents())
        if len(ants) != len(props):
            raise ValueError(
                "packed_antecedents() must align 1:1 with properties(): "
                f"{len(ants)} != {len(props)}"
            )
        self._cov_antecedents = ants

    def _finalize_coverage(self, discovered) -> None:
        """Run-end ledger finalize (summary instant + vacuity verdict)."""
        if self._cov is not None:
            self._cov.finalize(discovered=discovered)

    @property
    def coverage(self):
        """The ``CoverageLedger``, or None when coverage is off."""
        return self._cov

    def coverage_report(self) -> Optional[dict]:
        """The state-space cartography (``telemetry/coverage.py``):
        per-action fire/fresh counts with dead-action detection,
        per-property exercise counts (vacuity), and shape statistics.
        None unless the run records coverage
        (``spawn_gpu_bfs(coverage=True)``)."""
        return self._cov.report() if self._cov is not None else None

    # -- liveness surfaces (device mode + the host post-pass) ----------------

    # True on backends whose ``liveness="device"`` spawn knob yields sound
    # ``eventually`` verdicts through the device edge log.
    supports_device_liveness = False
    _live = None
    _live_enabled = False
    _live_store = None
    _live_ins = None

    @property
    def liveness_mode(self) -> str:
        """How this run's ``eventually`` verdicts were produced:
        ``"device"`` (edge-log trim/reach, sound by construction),
        ``"host_pass"`` (the opt-in O(region) post-pass of
        ``complete_liveness()``) or ``"default"`` (reference parity: the
        documented DAG-join/cycle false negatives)."""
        if getattr(self, "_live", None) == "device":
            return "device"
        if getattr(self, "_complete_liveness", False):
            return "host_pass"
        return "default"

    def liveness_report(self) -> dict:
        """The per-property liveness evidence: mode, device verdicts
        (``outcomes``), edge-store stats, host-pass inconclusive names, and
        whether a crashed run skipped the pass."""
        out: dict = {"mode": self.liveness_mode}
        outcomes = getattr(self, "_live_outcomes", None)
        if outcomes:
            out["outcomes"] = dict(outcomes)
        store = getattr(self, "_live_store", None)
        if store is not None:
            out["edge_store"] = store.stats()
        inconclusive = getattr(self, "_lasso_inconclusive", None)
        if inconclusive:
            out["inconclusive"] = sorted(inconclusive)
        if getattr(self, "_liveness_skipped_crashed", False):
            out["skipped_crashed_run"] = True
        return out

    def _with_device_liveness(self, out: Dict[str, Path]):
        """Merges device-liveness counterexamples into ``out`` without
        overriding default-semantics discoveries, and signals (once)
        when a crashed run makes the missing verdicts untrustworthy —
        a missing counterexample must never read as absence."""
        if not getattr(self, "_live_enabled", False):
            return out
        for name, path in getattr(self, "_live_paths", {}).items():
            out.setdefault(name, path)
        if self.is_done() and self.worker_error() is not None:
            self._signal_liveness_skip()
        return out

    def _flush_live_edges(self) -> None:
        """Pre-analysis hook: backends with a device-resident edge log
        drain it here."""

    def _run_liveness_analysis(self, prefix: str) -> None:
        """End-of-exploration device-liveness pass on the checker's
        ``_device``, run on the worker thread (so ``is_done()`` implies the
        verdicts exist and a crash surfaces through ``worker_error``).
        Preempted runs skip it: the edge store rides the checkpoint payload
        and the resumed incarnation finishes the job."""
        if not self._live_enabled or self._preempt_payload is not None:
            return
        # The JAX package first drains its async pipeline's deferred
        # absorbs here; the port's edge-log absorbs run on this thread, with
        # the async pipeline too, so nothing is left to drain.
        self._flush_live_edges()
        from .device_liveness import analyze_liveness

        t0 = time.perf_counter()
        with self._tracer.span(f"{prefix}.liveness.analysis"):
            self._live_paths, self._live_outcomes = analyze_liveness(
                self._model,
                self._properties,
                self._ebit,
                self._live_store,
                self._host_fp,
                set(self._discoveries_fp),
                instruments=self._live_ins,
                tracer=self._tracer,
                device=self._device,
            )
        self._live_ins.analysis_seconds.set(time.perf_counter() - t0)
        self._tracer.instant(
            f"{prefix}.liveness.summary",
            store=self._live_store.stats(),
            outcomes=self._live_outcomes,
            analysis_s=time.perf_counter() - t0,
        )

    def _signal_liveness_skip(self) -> None:
        """Crashed-run skip evidence: the ``liveness.skipped_crashed_run``
        counter plus a flag the reporter turns into a warning line."""
        if getattr(self, "_liveness_skipped_crashed", False):
            return
        self._liveness_skipped_crashed = True
        try:
            self.metrics().counter("liveness.skipped_crashed_run").inc()
        except Exception:  # noqa: BLE001 - signal, never a new failure
            pass

    # -- complete-liveness plumbing (shared by every spawning checker) ------

    def _setup_lasso(self, options) -> None:
        """Initializes the opt-in lasso-pass state (see checker/liveness.py)
        from the builder options. Refuses capped runs up front: the lasso
        search explores the whole condition-false region regardless of
        ``target_state_count``/``target_max_depth``, so on a model whose
        space is finite only because of the caps it would never terminate,
        and even when it did, its certificates could exceed the caps."""
        self._complete_liveness: bool = options._complete_liveness
        if self._complete_liveness and (
            options._target_state_count is not None
            or options._target_max_depth is not None
        ):
            raise ValueError(
                "complete_liveness() requires an uncapped run: the lasso "
                "search ignores target_state_count/target_max_depth and "
                "would search the full condition-false region"
            )
        self._lassos: Optional[Dict[str, Path]] = None
        self._lasso_lock = threading.Lock()
        # Bounded-pass knobs (builder) + the honest third outcome the
        # bounded pass fills (see checker/liveness.py).
        self._lasso_budget_states = options._liveness_budget_states
        self._lasso_deadline_s = options._liveness_deadline_s
        self._lasso_inconclusive: List[str] = []

    def _with_lassos(self, out: Dict[str, Path], done: bool, have):
        """Merges lasso counterexamples into ``out`` WITHOUT overriding
        existing entries — a terminal-state discovery recorded after the
        pass was cached must keep precedence."""
        from .liveness import checker_lasso_pass

        for name, path in checker_lasso_pass(self, done, have).items():
            out.setdefault(name, path)
        return out

    # -- shared behavior ---------------------------------------------------

    def join(self) -> "Checker":
        for h in self.handles():
            h.join()
        err = self.worker_error()
        if err is not None:
            raise RuntimeError("checker worker thread failed") from err
        return self

    def join_and_report(self, reporter: Reporter) -> "Checker":
        return self._report_loop(reporter, join=True)

    def report(self, reporter: Reporter) -> "Checker":
        return self._report_loop(reporter, join=False)

    def _report_loop(self, reporter: Reporter, join: bool) -> "Checker":
        start = time.monotonic()
        handles = self.handles() if join else []
        stop = threading.Event()

        def poll():
            while not self.is_done() and not stop.is_set():
                reporter.report_checking(
                    ReportData(
                        total_states=self.state_count(),
                        unique_states=self.unique_state_count(),
                        max_depth=self.max_depth(),
                        duration_secs=time.monotonic() - start,
                        done=False,
                    )
                )
                stop.wait(reporter.delay())

        if join:
            poller = threading.Thread(target=poll, daemon=True)
            poller.start()
            for h in handles:
                h.join()
            stop.set()
            poller.join()
        else:
            poll()
        err = self.worker_error()
        if err is not None:
            # Crashed run with the liveness pass armed: the pass was
            # skipped, so absence of a counterexample proves nothing —
            # say so before surfacing the crash.
            if getattr(self, "_complete_liveness", False):
                self._signal_liveness_skip()
                reporter.report_liveness(skipped_crashed=True)
            raise RuntimeError("checker worker thread failed") from err

        reporter.report_checking(
            ReportData(
                total_states=self.state_count(),
                unique_states=self.unique_state_count(),
                max_depth=self.max_depth(),
                duration_secs=time.monotonic() - start,
                done=True,
            )
        )
        discoveries = {
            name: ReportDiscovery(path, self.discovery_classification(name))
            for name, path in self.discoveries().items()
        }
        reporter.report_discoveries(discoveries)
        # Configuration the checker rounded or rewrote on the user's behalf
        # (e.g. a tile-aligned table capacity) is reported on every run.
        notes = getattr(self, "config_notes", None)
        if notes:
            reporter.report_config_notes(notes)
        # A sometimes/eventually property with no discovery is a silent
        # pass unless the reporter says so; only once checking completed.
        if self.is_done():
            undiscovered = [
                p
                for p in self.model().properties()
                if p.name not in discoveries
                and p.expectation in (
                    Expectation.SOMETIMES, Expectation.EVENTUALLY
                )
            ]
            if undiscovered:
                reporter.report_undiscovered(undiscovered)
            # Truncated walks must never read as absence of discoveries.
            overflows = getattr(self, "_trace_overflows", 0)
            if overflows:
                reporter.report_truncation(overflows)
            # Bounded host-pass honesty: the discoveries() call above
            # already ran (and cached) the lasso pass, so the
            # inconclusive set is final here.
            inconclusive = getattr(self, "_lasso_inconclusive", None)
            if inconclusive:
                reporter.report_liveness(inconclusive=inconclusive)
        return self

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        prop = self.model().property(name)
        if prop.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY):
            return COUNTEREXAMPLE
        return EXAMPLE

    def assert_properties(self) -> None:
        """Verifies examples exist for all `sometimes` properties and no
        counterexamples exist for any `always`/`eventually` properties."""
        for p in self.model().properties():
            if p.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(p.name)
            else:
                self.assert_no_discovery(p.name)

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str) -> None:
        found = self.discovery(name)
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found}Last state: {found.last_state()!r}\n"
            )
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )

    def assert_discovery(self, name: str, actions: List[Action]) -> None:
        """Verifies the specified actions constitute a valid discovery for the
        named property (by replaying them through the model), and that some
        discovery was in fact found."""
        additional_info: List[str] = []
        found = self.assert_any_discovery(name)
        model = self.model()
        for init_state in model.init_states():
            path = Path.from_actions(model, init_state, actions)
            if path is None:
                continue
            prop = model.property(name)
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, path.last_state()):
                    return
            elif prop.expectation == Expectation.EVENTUALLY:
                states = path.into_states()
                is_liveness_satisfied = any(
                    prop.condition(model, s) for s in states
                )
                last_actions: List[Action] = []
                model.actions(states[-1], last_actions)
                is_path_terminal = not last_actions
                if not is_liveness_satisfied and is_path_terminal:
                    return
                if is_liveness_satisfied:
                    additional_info.append(
                        "incorrect counterexample satisfies eventually property"
                    )
                if not is_path_terminal:
                    additional_info.append("incorrect counterexample is nonterminal")
            else:  # SOMETIMES
                if prop.condition(model, path.last_state()):
                    return
        extra = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{extra}, but a valid one was found. '
            f"found={found.into_actions()!r}"
        )
