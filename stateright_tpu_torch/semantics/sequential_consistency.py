"""Sequential-consistency tester: like linearizability minus the real-time
constraints (only per-thread program order is preserved).

Reference: ``SequentialConsistencyTester`` at
``src/semantics/sequential_consistency.rs:55-284``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .base import ConsistencyTester, SequentialSpec


class SequentialConsistencyTester(ConsistencyTester):
    def __init__(self, init_ref_obj: SequentialSpec):
        self.init_ref_obj = init_ref_obj
        self.history_by_thread: Dict = {}  # thread -> list of (op, ret)
        self.in_flight_by_thread: Dict = {}  # thread -> op
        self.is_valid_history = True

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(h) for h in self.history_by_thread.values()
        )

    def clone(self) -> "SequentialConsistencyTester":
        c = SequentialConsistencyTester(self.init_ref_obj.clone())
        c.history_by_thread = {
            t: list(h) for t, h in self.history_by_thread.items()
        }
        c.in_flight_by_thread = dict(self.in_flight_by_thread)
        c.is_valid_history = self.is_valid_history
        return c

    def on_invoke(self, thread_id, op) -> "SequentialConsistencyTester":
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id in self.in_flight_by_thread:
            self.is_valid_history = False
            raise ValueError(
                f"Thread already has an operation in flight. "
                f"thread_id={thread_id!r}, "
                f"op={self.in_flight_by_thread[thread_id]!r}, "
                f"history_by_thread={self.history_by_thread!r}"
            )
        self.in_flight_by_thread[thread_id] = op
        self.history_by_thread.setdefault(thread_id, [])
        return self

    def on_return(self, thread_id, ret) -> "SequentialConsistencyTester":
        if not self.is_valid_history:
            raise ValueError("Earlier history was invalid.")
        if thread_id not in self.in_flight_by_thread:
            self.is_valid_history = False
            raise ValueError(
                f"There is no in-flight invocation for this thread ID. "
                f"thread_id={thread_id!r}, unexpected_return={ret!r}, "
                f"history={self.history_by_thread.get(thread_id, [])!r}"
            )
        op = self.in_flight_by_thread.pop(thread_id)
        self.history_by_thread.setdefault(thread_id, []).append((op, ret))
        return self

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None

    def serialized_history(self) -> Optional[List[Tuple[object, object]]]:
        if not self.is_valid_history:
            return None
        remaining = {
            t: list(h) for t, h in sorted(self.history_by_thread.items())
        }
        in_flight = dict(sorted(self.in_flight_by_thread.items()))
        return _serialize([], self.init_ref_obj, remaining, in_flight)

    def __stable_fields__(self):
        return (
            "SequentialConsistencyTester",
            self.init_ref_obj,
            tuple(
                (t, tuple(h)) for t, h in sorted(self.history_by_thread.items())
            ),
            tuple(sorted(self.in_flight_by_thread.items())),
            self.is_valid_history,
        )

    def __eq__(self, other):
        return (
            isinstance(other, SequentialConsistencyTester)
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
            f"SequentialConsistencyTester(init={self.init_ref_obj!r}, "
            f"history={self.history_by_thread!r}, "
            f"in_flight={self.in_flight_by_thread!r}, "
            f"valid={self.is_valid_history})"
        )


def _serialize(valid_history, ref_obj, remaining, in_flight):
    if all(not h for h in remaining.values()):
        return valid_history
    for thread_id in list(remaining.keys()):
        remaining_history = remaining[thread_id]
        if not remaining_history:
            # Case 1: maybe linearize an in-flight op at the end.
            if thread_id not in in_flight:
                continue
            op = in_flight[thread_id]
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
            op, ret = remaining_history[0]
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
