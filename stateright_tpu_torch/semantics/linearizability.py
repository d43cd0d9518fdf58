"""Linearizability tester (Wing & Gong-style exhaustive serialization search).

Each invocation records the index of every other thread's last completed
operation; serialization rejects interleavings that violate those real-time
constraints. The ``always "linearizable"`` property evaluates
``serialized_history() is not None`` per state — exponential worst case; this
is the hot spot in register-style benchmarks. The device checker runs its
packed twin instead (``semantics/packed_linearizability.py``).

Reference: ``LinearizabilityTester`` at
``src/semantics/linearizability.rs:57-312``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .base import ConsistencyTester, SequentialSpec


class LinearizabilityTester(ConsistencyTester):
    def __init__(self, init_ref_obj: SequentialSpec):
        self.init_ref_obj = init_ref_obj
        # thread -> list of (completed_map, op, ret); completed_map records,
        # at invocation time, each *other* thread's last completed op index.
        self.history_by_thread: Dict = {}
        # thread -> (completed_map, op)
        self.in_flight_by_thread: Dict = {}
        self.is_valid_history = True

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(h) for h in self.history_by_thread.values()
        )

    def clone(self) -> "LinearizabilityTester":
        c = LinearizabilityTester(self.init_ref_obj.clone())
        c.history_by_thread = {
            t: list(h) for t, h in self.history_by_thread.items()
        }
        c.in_flight_by_thread = dict(self.in_flight_by_thread)
        c.is_valid_history = self.is_valid_history
        return c

    # -- recording -----------------------------------------------------------

    def on_invoke(self, thread_id, op) -> "LinearizabilityTester":
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id in self.in_flight_by_thread:
            self.is_valid_history = False
            in_flight_op = self.in_flight_by_thread[thread_id][1]
            raise ValueError(
                f"Thread already has an operation in flight. "
                f"thread_id={thread_id!r}, op={in_flight_op!r}, "
                f"history_by_thread={self.history_by_thread!r}"
            )
        last_completed = tuple(
            sorted(
                (t, len(h) - 1)
                for t, h in self.history_by_thread.items()
                if t != thread_id and h
            )
        )
        self.in_flight_by_thread[thread_id] = (last_completed, op)
        self.history_by_thread.setdefault(thread_id, [])
        return self

    def on_return(self, thread_id, ret) -> "LinearizabilityTester":
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id not in self.in_flight_by_thread:
            self.is_valid_history = False
            raise ValueError(
                f"There is no in-flight invocation for this thread ID. "
                f"thread_id={thread_id!r}, unexpected_return={ret!r}, "
                f"history={self.history_by_thread.get(thread_id, [])!r}"
            )
        completed, op = self.in_flight_by_thread.pop(thread_id)
        self.history_by_thread.setdefault(thread_id, []).append(
            (completed, op, ret)
        )
        return self

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None

    # -- serialization search ------------------------------------------------

    def serialized_history(self) -> Optional[List[Tuple[object, object]]]:
        """A total order of (op, ret) consistent with the reference object's
        semantics and the recorded real-time constraints, or None."""
        if not self.is_valid_history:
            return None
        # thread -> list of (orig_index, (completed_map, op, ret))
        remaining = {
            t: [(i, entry) for i, entry in enumerate(h)]
            for t, h in sorted(self.history_by_thread.items())
        }
        in_flight = dict(sorted(self.in_flight_by_thread.items()))
        return _serialize([], self.init_ref_obj, remaining, in_flight)

    # -- value semantics -----------------------------------------------------

    def __stable_fields__(self):
        return (
            "LinearizabilityTester",
            self.init_ref_obj,
            tuple(
                (t, tuple(h)) for t, h in sorted(self.history_by_thread.items())
            ),
            tuple(sorted(self.in_flight_by_thread.items())),
            self.is_valid_history,
        )

    def __eq__(self, other):
        return (
            isinstance(other, LinearizabilityTester)
            and self.init_ref_obj == other.init_ref_obj
            and self.history_by_thread == other.history_by_thread
            and self.in_flight_by_thread == other.in_flight_by_thread
            and self.is_valid_history == other.is_valid_history
        )

    def __hash__(self):
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self):
        return (
            f"LinearizabilityTester(init={self.init_ref_obj!r}, "
            f"history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r}, "
            f"valid={self.is_valid_history})"
        )


def _violates_real_time(completed_map, remaining) -> bool:
    """True if some peer still has an unconsumed op at or before the index
    recorded as already-completed when this op was invoked."""
    for peer_id, min_peer_time in completed_map:
        ops = remaining.get(peer_id)
        if ops:
            next_peer_time = ops[0][0]
            if next_peer_time <= min_peer_time:
                return True
    return False


def _serialize(valid_history, ref_obj, remaining, in_flight):
    if all(not h for h in remaining.values()):
        return valid_history
    for thread_id in list(remaining.keys()):
        remaining_history = remaining[thread_id]
        if not remaining_history:
            # Case 1: no completed ops left; maybe linearize an in-flight op.
            if thread_id not in in_flight:
                continue
            completed_map, op = in_flight[thread_id]
            if _violates_real_time(completed_map, remaining):
                continue
            next_ref_obj = ref_obj.clone()
            ret = next_ref_obj.invoke(op)
            next_in_flight = dict(in_flight)
            del next_in_flight[thread_id]
            result = _serialize(
                valid_history + [(op, ret)],
                next_ref_obj,
                remaining,
                next_in_flight,
            )
            if result is not None:
                return result
        else:
            # Case 2: consume the thread's next completed op.
            _orig_index, (completed_map, op, ret) = remaining_history[0]
            if _violates_real_time(completed_map, remaining):
                continue
            next_ref_obj = ref_obj.clone()
            if not next_ref_obj.is_valid_step(op, ret):
                continue
            next_remaining = dict(remaining)
            next_remaining[thread_id] = remaining_history[1:]
            result = _serialize(
                valid_history + [(op, ret)],
                next_ref_obj,
                next_remaining,
                in_flight,
            )
            if result is not None:
                return result
    return None
