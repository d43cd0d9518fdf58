"""Random-walk (simulation) host checker.

Repeatedly rolls a trace from a random init state via a pluggable ``Chooser``
until loop/boundary/terminal, evaluating properties along the trace. For state
spaces too large to exhaust. Note: like the reference, simulation only
terminates when every property has a discovery or ``target_state_count`` is
reached — otherwise it keeps sampling traces.

Reference design: ``SimulationChecker`` at
``src/checker/simulation.rs``. The port's copy of the JAX package's
``checker/simulation.py``: with the same seed and chooser it walks the same
states.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ..telemetry import metrics_registry
from .base import Checker


class Chooser:
    """Chooses transitions during a simulation run. Created per thread."""

    def new_state(self, seed: int):
        raise NotImplementedError

    def choose_initial_state(self, chooser_state, initial_states: List) -> int:
        raise NotImplementedError

    def choose_action(self, chooser_state, current_state, actions: List) -> int:
        raise NotImplementedError


class UniformChooser(Chooser):
    """Makes uniform random choices."""

    def new_state(self, seed: int):
        return random.Random(seed)

    def choose_initial_state(self, rng, initial_states):
        return rng.randrange(len(initial_states))

    def choose_action(self, rng, current_state, actions):
        return rng.randrange(len(actions))


class SimulationChecker(Checker):
    def __init__(self, options, seed: int, chooser: Chooser):
        model = options.model
        self._model = model
        symmetry = options._symmetry
        target_state_count = options._target_state_count
        target_max_depth = options._target_max_depth
        visitor = options._visitor
        properties = model.properties()
        property_count = len(properties)

        self._state_count = 0
        self._count_lock = threading.Lock()
        self._max_depth = 0
        self._discoveries: Dict[str, List[Fingerprint]] = {}
        # One span per rolled trace (not per step): simulation traces are
        # the unit the reference reasons about, and tiny traces stay off
        # the per-state hot loop.
        reg = metrics_registry()
        self._m_traces = reg.counter("simulation.traces")
        self._m_steps = reg.counter("simulation.states_visited")
        self._m_trace_len = reg.histogram("simulation.trace_len")
        self._worker_error: Optional[BaseException] = None
        self._handles: List[threading.Thread] = []
        self._stop = threading.Event()

        def worker(thread_seed: int):
            try:
                rng = random.Random(thread_seed)
                trace_seed = thread_seed
                while not self._stop.is_set():
                    with self._tracer.span(
                        "simulation.trace", seed=trace_seed
                    ) as sp:
                        trace_len = self._check_trace_from_initial(
                            trace_seed,
                            chooser,
                            properties,
                            visitor,
                            target_max_depth,
                            symmetry,
                        )
                        sp.set(trace_len=trace_len)
                    self._m_traces.inc()
                    self._m_steps.inc(trace_len)
                    self._m_trace_len.observe(trace_len)
                    if len(self._discoveries) == property_count:
                        return
                    if (
                        target_state_count is not None
                        and target_state_count <= self._state_count
                    ):
                        return
                    trace_seed = rng.getrandbits(64)
            except BaseException as e:  # noqa: BLE001
                if self._worker_error is None:
                    self._worker_error = e
                self._stop.set()

        for t in range(max(1, options._thread_count)):
            h = threading.Thread(
                target=worker, args=(seed + t,), name=f"checker-{t}", daemon=True
            )
            h.start()
            self._handles.append(h)

    def _check_trace_from_initial(
        self, seed, chooser, properties, visitor, target_max_depth, symmetry
    ):
        model = self._model
        discoveries = self._discoveries
        chooser_state = chooser.new_state(seed)

        initial_states = model.init_states()
        index = chooser.choose_initial_state(chooser_state, initial_states)
        state = initial_states[index]

        fingerprint_path: List[Fingerprint] = []
        generated = set()  # fingerprints seen in this run, for cycle detection
        ebits = frozenset(
            i
            for i, p in enumerate(properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        while True:
            if len(fingerprint_path) > self._max_depth:
                with self._count_lock:
                    if len(fingerprint_path) > self._max_depth:
                        self._max_depth = len(fingerprint_path)
            if (
                target_max_depth is not None
                and len(fingerprint_path) >= target_max_depth
            ):
                # Return (not break): we don't know whether this is terminal,
                # so unmet eventually bits must not become discoveries.
                return len(fingerprint_path)
            if not model.within_boundary(state):
                break

            fingerprint_path.append(fingerprint(state))
            key = (
                fingerprint(symmetry(state)) if symmetry else fingerprint_path[-1]
            )
            if key in generated:
                break  # found a loop
            generated.add(key)

            with self._count_lock:
                self._state_count += 1

            if visitor is not None:
                visitor.visit(
                    model, Path.from_fingerprints(model, fingerprint_path)
                )

            is_awaiting_discoveries = False
            for i, prop in enumerate(properties):
                if prop.name in discoveries:
                    continue
                if prop.expectation == Expectation.ALWAYS:
                    if not prop.condition(model, state):
                        discoveries[prop.name] = list(fingerprint_path)
                    else:
                        is_awaiting_discoveries = True
                elif prop.expectation == Expectation.SOMETIMES:
                    if prop.condition(model, state):
                        discoveries[prop.name] = list(fingerprint_path)
                    else:
                        is_awaiting_discoveries = True
                else:  # EVENTUALLY
                    is_awaiting_discoveries = True
                    if prop.condition(model, state):
                        ebits = ebits - {i}
            if not is_awaiting_discoveries:
                break

            actions: List = []
            model.actions(state, actions)
            # Choose actions until one yields a next state or none remain.
            advanced = False
            while actions:
                index = chooser.choose_action(chooser_state, state, actions)
                action = actions[index]
                actions[index] = actions[-1]
                actions.pop()
                next_state = model.next_state(state, action)
                if next_state is not None:
                    state = next_state
                    advanced = True
                    break
            if not advanced:
                break  # terminal: still check eventually properties below

        for i, prop in enumerate(properties):
            # Insert-if-vacant — see the matching note in bfs.py. A trace that
            # ended before visiting any state (out-of-boundary init) has no
            # path to report and is skipped.
            if i in ebits and fingerprint_path and prop.name not in discoveries:
                discoveries[prop.name] = list(fingerprint_path)
        return len(fingerprint_path)

    # -- Checker surface ---------------------------------------------------

    def model(self):
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        # Unique states are not tracked across runs; approximated by total.
        return self._state_count

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        return {
            name: Path.from_fingerprints(self._model, fps)
            for name, fps in list(self._discoveries.items())
        }

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return all(not h.is_alive() for h in self._handles) or bool(
            self._stop.is_set()
        )

    def worker_error(self) -> Optional[BaseException]:
        return self._worker_error
