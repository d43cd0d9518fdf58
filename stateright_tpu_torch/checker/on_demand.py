"""On-demand (lazy) host checker powering the Explorer.

Workers block on a control channel: ``CheckFingerprint(fp)`` targets one
pending state for expansion; ``RunToCompletion`` unblocks fully (turning the
checker into a plain BFS). A forwarder thread fans control messages to all
workers. Visited set stores parent pointers like BFS.

Reference design: ``OnDemandChecker`` at
``src/checker/on_demand.rs``. The port's copy of the JAX package's
``checker/on_demand.py``.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..core.fingerprint import Fingerprint, fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ..telemetry import BlockInstruments
from ..telemetry.coverage import BlockCoverage, CoverageLedger
from .base import Checker
from .bfs import reconstruct_path
from .job_market import JobBroker

BLOCK_SIZE = 1500

Job = Tuple[object, Fingerprint, frozenset, int]

_CHECK = "check"
_RUN_TO_COMPLETION = "run"


class OnDemandChecker(Checker):
    def __init__(self, options):
        model = options.model
        self._model = model
        target_state_count = options._target_state_count
        thread_count = max(1, options._thread_count)
        visitor = options._visitor
        properties = model.properties()
        property_count = len(properties)

        init_states = [s for s in model.init_states() if model.within_boundary(s)]
        self._state_count = len(init_states)
        self._count_lock = threading.Lock()
        self._max_depth = 0
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
        # Per-block telemetry (see the matching note in bfs.py).
        self._bi = BlockInstruments("on_demand")
        # Always-on coverage ledger (see the matching note in bfs.py) —
        # this is what feeds the Explorer's coverage panel.
        self._cov = CoverageLedger(
            "on_demand", properties, tracer=self._tracer
        )
        self._cov.record_seed(len(self._generated))
        self._job_broker: JobBroker[Job] = JobBroker(thread_count)
        self._job_broker.push(pending)
        self._worker_error: Optional[BaseException] = None
        self._handles: List[threading.Thread] = []
        self._control: "queue.Queue" = queue.Queue()
        worker_controls: List["queue.Queue"] = []

        def worker(t: int, control: "queue.Queue"):
            try:
                pending: Deque[Job] = deque()
                targetted: Deque[Job] = deque()
                wait_for_fingerprints = True
                while True:
                    if not pending:
                        pending = self._job_broker.pop()
                        if not pending:
                            return
                    if wait_for_fingerprints:
                        # Step 0: wait for someone to ask us to do work.
                        while True:
                            msg = control.get()
                            if msg is None:
                                return  # control channel closed
                            kind, fp = msg
                            if kind == _RUN_TO_COMPLETION:
                                wait_for_fingerprints = False
                                break
                            # _CHECK: look for the fp in our pending queue.
                            if not pending:
                                break
                            index = next(
                                (
                                    i
                                    for i, (_s, f, _e, _d) in enumerate(pending)
                                    if f == fp
                                ),
                                None,
                            )
                            if index is not None:
                                job = pending[index]
                                del pending[index]
                                targetted.append(job)
                                break
                    if not wait_for_fingerprints:
                        targetted.extend(pending)
                        pending.clear()

                    # Step 1: do work on the targetted slice.
                    self._check_block(targetted, pending, properties, visitor)
                    pending.extend(targetted)
                    targetted.clear()
                    if len(self._discoveries) == property_count:
                        return
                    if (
                        target_state_count is not None
                        and target_state_count <= self._state_count
                    ):
                        return
                    # Step 2: share work.
                    if len(pending) > 1 and thread_count > 1:
                        self._job_broker.split_and_push(pending)
            except BaseException as e:  # noqa: BLE001
                if self._worker_error is None:
                    self._worker_error = e
            finally:
                self._job_broker.close()
                self._finalize_coverage(set(self._discoveries))

        for t in range(thread_count):
            control: "queue.Queue" = queue.Queue()
            worker_controls.append(control)
            h = threading.Thread(
                target=worker, args=(t, control), name=f"checker-{t}", daemon=True
            )
            h.start()
            self._handles.append(h)

        def forwarder():
            while True:
                msg = self._control.get()
                for c in worker_controls:
                    c.put(msg)
                if msg is None:
                    return

        # The forwarder is deliberately NOT in handles: it lives as long as the
        # control channel and is a daemon thread, so join() after
        # run_to_completion() doesn't block on it.
        fh = threading.Thread(target=forwarder, name="control-forwarder", daemon=True)
        fh.start()
        self._forwarder = fh

    def _check_block(
        self,
        targetted: Deque[Job],
        pending: Deque[Job],
        properties,
        visitor,
    ) -> None:
        """Expand up to BLOCK_SIZE states from ``targetted``; newly generated
        states go back onto ``pending`` (to await the next control message)."""
        model = self._model
        generated = self._generated
        discoveries = self._discoveries
        local: List[Job] = []
        for _ in range(min(BLOCK_SIZE, len(targetted))):
            local.append(targetted.popleft())
        generated_count = 0
        block_size = len(local)
        block_max_depth = self._max_depth
        block_span = self._tracer.span("on_demand.block")
        block_span.__enter__()
        bc = BlockCoverage(self._cov, model)
        try:
            while local:
                state, state_fp, ebits, depth = local.pop()
                if depth > block_max_depth:
                    block_max_depth = depth
                bc.evaluated += 1
                if visitor is not None:
                    visitor.visit(
                        model, reconstruct_path(model, generated, state_fp)
                    )

                is_awaiting_discoveries = False
                for i, prop in enumerate(properties):
                    if prop.name in discoveries:
                        continue
                    if prop.expectation == Expectation.ALWAYS:
                        if not prop.condition(model, state):
                            discoveries[prop.name] = state_fp
                        else:
                            is_awaiting_discoveries = True
                        ant = prop.antecedent
                        if ant is None or ant(model, state):
                            bc.exercise(i)
                    elif prop.expectation == Expectation.SOMETIMES:
                        if prop.condition(model, state):
                            discoveries[prop.name] = state_fp
                            bc.exercise(i)
                        else:
                            is_awaiting_discoveries = True
                    else:  # EVENTUALLY
                        is_awaiting_discoveries = True
                        if prop.condition(model, state):
                            ebits = ebits - {i}
                        if i not in ebits:
                            bc.exercise(i)
                if not is_awaiting_discoveries:
                    return

                is_terminal = True
                succ = 0
                actions: List = []
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
                evaluated=block_size - len(local),
                generated=generated_count,
                max_depth=block_max_depth,
                unique_total=len(generated),
                pending=len(targetted) + len(pending),
            )
            bc.flush(max_depth=block_max_depth)

    # -- Checker surface ---------------------------------------------------

    def model(self):
        return self._model

    def check_fingerprint(self, fp: Fingerprint) -> None:
        self._control.put((_CHECK, fp))

    def run_to_completion(self) -> None:
        self._control.put((_RUN_TO_COMPLETION, None))

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
        return {
            name: reconstruct_path(self._model, self._generated, fp)
            for name, fp in list(self._discoveries.items())
        }

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._job_broker.is_closed() or len(self._discoveries) == len(
            self._model.properties()
        )

    def worker_error(self) -> Optional[BaseException]:
        return self._worker_error
