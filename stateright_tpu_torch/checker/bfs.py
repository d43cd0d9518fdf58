"""Parallel breadth-first host checker.

Visited set maps fingerprint -> parent fingerprint (TLC-style, per Yu/Manolios/
Lamport "Model Checking TLA+ Specifications") for later path reconstruction.

Reference design: ``BfsChecker`` at ``src/checker/bfs.rs``.
The port's copy of the JAX package's ``checker/bfs.py``: with one thread
(the default) it visits states in FIFO order with first-writer-wins
parents, the exact oracle the GPU checker (``checker/gpu.py``) is held
against.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ..telemetry import BlockInstruments
from ..telemetry.coverage import BlockCoverage, CoverageLedger
from .base import Checker
from .job_market import JobBroker

# Max states evaluated per block before checking for early exit / work sharing.
BLOCK_SIZE = 1500

# Job: (state, fingerprint, eventually-bits, depth)
Job = Tuple[object, Fingerprint, frozenset, int]


class BfsChecker(Checker):
    def __init__(self, options):
        model = options.model
        self._model = model
        self._target_state_count: Optional[int] = options._target_state_count
        self._target_max_depth: Optional[int] = options._target_max_depth
        self._setup_lasso(options)
        thread_count = max(1, options._thread_count)
        visitor = options._visitor
        properties = model.properties()
        property_count = len(properties)

        init_states = [s for s in model.init_states() if model.within_boundary(s)]
        self._state_count = len(init_states)
        self._count_lock = threading.Lock()
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
        pending: Deque[Job] = deque(
            (s, fingerprint(s), ebits, 1) for s in init_states
        )
        self._discoveries: Dict[str, Fingerprint] = {}
        # Telemetry instruments resolved once (not per block): each block
        # of ≤BLOCK_SIZE states costs one span + a few counter bumps, so
        # the always-on layer stays off the per-state hot loop.
        self._bi = BlockInstruments("bfs")
        # Coverage ledger (telemetry/coverage.py): always-on for the
        # host engines — per-block dict merges are noise next to the
        # per-state Python expansion loop.
        self._cov = CoverageLedger("bfs", properties, tracer=self._tracer)
        self._cov.record_seed(len(self._generated))
        self._job_broker: JobBroker[Job] = JobBroker(thread_count)
        self._job_broker.push(pending)
        self._worker_error: Optional[BaseException] = None
        self._handles: List[threading.Thread] = []

        def worker(t: int):
            try:
                pending: Deque[Job] = deque()
                while True:
                    if not pending:
                        pending = self._job_broker.pop()
                        if not pending:
                            return
                    self._check_block(pending, properties, visitor)
                    if len(self._discoveries) == property_count:
                        return
                    if (
                        self._target_state_count is not None
                        and self._target_state_count <= self._state_count
                    ):
                        return
                    if len(pending) > 1 and thread_count > 1:
                        self._job_broker.split_and_push(pending)
            except BaseException as e:  # noqa: BLE001 - worker dies, market closes
                if self._worker_error is None:
                    self._worker_error = e
            finally:
                self._job_broker.close()
                self._finalize_coverage(set(self._discoveries))

        for t in range(thread_count):
            h = threading.Thread(
                target=worker, args=(t,), name=f"checker-{t}", daemon=True
            )
            h.start()
            self._handles.append(h)

    def _check_block(self, pending: Deque[Job], properties, visitor) -> None:
        model = self._model
        generated = self._generated
        discoveries = self._discoveries
        max_count = BLOCK_SIZE
        actions: List = []
        # Accumulated locally and flushed under the lock once per block to keep
        # the hot loop off the lock (the reference uses relaxed atomics here).
        generated_count = 0
        block_max_depth = self._max_depth
        block_span = self._tracer.span("bfs.block")
        block_span.__enter__()
        bc = BlockCoverage(self._cov, model)
        try:
            while max_count > 0 and pending:
                max_count -= 1
                state, state_fp, ebits, depth = pending.pop()

                if depth > block_max_depth:
                    block_max_depth = depth
                if (
                    self._target_max_depth is not None
                    and depth >= self._target_max_depth
                ):
                    continue
                bc.evaluated += 1
                if visitor is not None:
                    visitor.visit(
                        model, reconstruct_path(model, generated, state_fp)
                    )

                # Property evaluation; early-exit when every property has a
                # discovery.
                is_awaiting_discoveries = False
                for i, prop in enumerate(properties):
                    if prop.name in discoveries:
                        continue
                    if prop.expectation == Expectation.ALWAYS:
                        if not prop.condition(model, state):
                            discoveries[prop.name] = state_fp
                        else:
                            is_awaiting_discoveries = True
                        # Exercise: antecedent-true states (vacuity), or
                        # every evaluated state without one.
                        ant = prop.antecedent
                        if ant is None or ant(model, state):
                            bc.exercise(i)
                    elif prop.expectation == Expectation.SOMETIMES:
                        if prop.condition(model, state):
                            discoveries[prop.name] = state_fp
                            bc.exercise(i)
                        else:
                            is_awaiting_discoveries = True
                    else:
                        # EVENTUALLY: discoveries only identified at terminal
                        # states; still awaiting regardless of current truth.
                        is_awaiting_discoveries = True
                        if prop.condition(model, state):
                            ebits = ebits - {i}
                        if i not in ebits:
                            bc.exercise(i)
                if not is_awaiting_discoveries:
                    return

                # Expand.
                is_terminal = True
                succ = 0
                actions.clear()
                model.actions(state, actions)
                for action in actions:
                    next_state = model.next_state(state, action)
                    if next_state is None:
                        continue
                    if not model.within_boundary(next_state):
                        continue
                    generated_count += 1
                    succ += 1
                    next_fp = fingerprint(next_state)
                    # NOTE (parity): ebits are deliberately NOT part of the
                    # fingerprint, reproducing the reference's documented
                    # eventually-property false-negative on DAG joins/cycles.
                    if next_fp in generated:
                        is_terminal = False
                        bc.action(action, False)
                        continue
                    generated[next_fp] = state_fp
                    is_terminal = False
                    bc.action(action, True)
                    bc.depth[depth + 1] = bc.depth.get(depth + 1, 0) + 1
                    pending.appendleft((next_state, next_fp, ebits, depth + 1))
                bc.succ[succ] = bc.succ.get(succ, 0) + 1
                if is_terminal:
                    bc.terminals += 1
                    for i, prop in enumerate(properties):
                        # Insert-if-vacant: once a property has a discovery its
                        # ebit is no longer cleared during evaluation, so a
                        # stale set bit here must not overwrite the valid
                        # counterexample with a path that never tracked it
                        # (deviation: the reference overwrites, which can
                        # report an "eventually" trace ending in a state that
                        # satisfies the property; counts are unaffected).
                        if i in ebits and prop.name not in discoveries:
                            discoveries[prop.name] = state_fp
        finally:
            with self._count_lock:
                self._state_count += generated_count
                if block_max_depth > self._max_depth:
                    self._max_depth = block_max_depth
            self._bi.record(
                block_span,
                evaluated=BLOCK_SIZE - max_count,
                generated=generated_count,
                max_depth=block_max_depth,
                unique_total=len(generated),
                pending=len(pending),
            )
            bc.flush(max_depth=block_max_depth)

    # -- Checker surface ---------------------------------------------------

    def model(self):
        return self._model

    def state_count(self) -> int:
        # Block-local counters flush once per check_block; clamp so the
        # documented invariant state_count >= unique_state_count holds for
        # mid-run polls too.
        return max(self._state_count, len(self._generated))

    def unique_state_count(self) -> int:
        return len(self._generated)

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        out = {
            name: reconstruct_path(self._model, self._generated, fp)
            for name, fp in list(self._discoveries.items())
        }
        return self._with_lassos(
            out, self._job_broker.is_closed(), self._discoveries
        )

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._job_broker.is_closed() or len(self._discoveries) == len(
            self._model.properties()
        )

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
