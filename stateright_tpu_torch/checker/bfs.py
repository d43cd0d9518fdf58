"""Breadth-first host checker: the exact oracle for the GPU checker.

Visited set maps fingerprint -> parent fingerprint (TLC-style, per Yu/Manolios/
Lamport "Model Checking TLA+ Specifications") for later path reconstruction.

Reference design: ``BfsChecker`` at ``src/checker/bfs.rs``. This is the
JAX package's ``checker/bfs.py`` with one worker thread, and without its
job market, telemetry and coverage: the same per-state semantics (property
evaluation, ``eventually`` bits, boundary, depth cap, first-writer-wins
parents) in the same FIFO order.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from .base import Checker

# Job: (state, fingerprint, eventually-bits, depth)
Job = Tuple[object, Fingerprint, frozenset, int]


class BfsChecker(Checker):
    def __init__(self, options):
        model = options.model
        self._model = model
        self._target_state_count: Optional[int] = options._target_state_count
        self._target_max_depth: Optional[int] = options._target_max_depth
        self._visitor = options._visitor
        properties = model.properties()

        init_states = [s for s in model.init_states() if model.within_boundary(s)]
        self._state_count = len(init_states)
        self._max_depth = 0
        # fingerprint -> parent fingerprint (None for init states)
        self._generated: Dict[Fingerprint, Optional[Fingerprint]] = {}
        for s in init_states:
            self._generated.setdefault(fingerprint(s), None)
        ebits = frozenset(
            i
            for i, p in enumerate(properties)
            if p.expectation == Expectation.EVENTUALLY
        )
        self._pending: Deque[Job] = deque(
            (s, fingerprint(s), ebits, 1) for s in init_states
        )
        self._discoveries: Dict[str, Fingerprint] = {}
        self._worker_error: Optional[BaseException] = None
        self._done = threading.Event()
        self._handles: List[threading.Thread] = [
            threading.Thread(
                target=self._run, args=(properties,), name="checker-0",
                daemon=True,
            )
        ]
        self._handles[0].start()

    def _run(self, properties) -> None:
        try:
            while self._pending:
                if not self._check_one(self._pending.pop(), properties):
                    return
                if len(self._discoveries) == len(properties):
                    return
                if (
                    self._target_state_count is not None
                    and self._target_state_count <= self._state_count
                ):
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            self._worker_error = e
        finally:
            self._done.set()

    def _check_one(self, job: Job, properties) -> bool:
        """Evaluates and expands one state; False when every remaining
        property already has a discovery (the run may stop)."""
        model = self._model
        generated = self._generated
        discoveries = self._discoveries
        state, state_fp, ebits, depth = job
        self._max_depth = max(self._max_depth, depth)
        if self._target_max_depth is not None and depth >= self._target_max_depth:
            return True
        if self._visitor is not None:
            self._visitor.visit(model, reconstruct_path(model, generated, state_fp))

        is_awaiting_discoveries = False
        for i, prop in enumerate(properties):
            if prop.name in discoveries:
                continue
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, state):
                    discoveries[prop.name] = state_fp
                else:
                    is_awaiting_discoveries = True
            elif prop.expectation == Expectation.SOMETIMES:
                if prop.condition(model, state):
                    discoveries[prop.name] = state_fp
                else:
                    is_awaiting_discoveries = True
            else:
                # EVENTUALLY: discoveries only identified at terminal
                # states; still awaiting regardless of current truth.
                is_awaiting_discoveries = True
                if prop.condition(model, state):
                    ebits = ebits - {i}
        if not is_awaiting_discoveries:
            return False

        is_terminal = True
        actions: List = []
        model.actions(state, actions)
        for action in actions:
            next_state = model.next_state(state, action)
            if next_state is None or not model.within_boundary(next_state):
                continue
            self._state_count += 1
            is_terminal = False
            next_fp = fingerprint(next_state)
            # ebits are deliberately NOT part of the fingerprint,
            # reproducing the reference's eventually false-negative on
            # DAG joins and cycles.
            if next_fp in generated:
                continue
            generated[next_fp] = state_fp
            self._pending.appendleft((next_state, next_fp, ebits, depth + 1))
        if is_terminal:
            for i, prop in enumerate(properties):
                if i in ebits and prop.name not in discoveries:
                    discoveries[prop.name] = state_fp
        return True

    # -- Checker surface ---------------------------------------------------

    def model(self):
        return self._model

    def state_count(self) -> int:
        return max(self._state_count, len(self._generated))

    def unique_state_count(self) -> int:
        return len(self._generated)

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        return {
            name: reconstruct_path(self._model, self._generated, fp)
            for name, fp in list(self._discoveries.items())
        }

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._done.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._worker_error


def reconstruct_path(
    model,
    generated: Dict[Fingerprint, Optional[Fingerprint]],
    fp: Fingerprint,
) -> Path:
    """Walk parent pointers back to an init state, then replay forward."""
    fingerprints: Deque[Fingerprint] = deque()
    next_fp: Optional[Fingerprint] = fp
    while next_fp is not None and next_fp in generated:
        fingerprints.appendleft(next_fp)
        next_fp = generated[next_fp]
    return Path.from_fingerprints(model, fingerprints)
