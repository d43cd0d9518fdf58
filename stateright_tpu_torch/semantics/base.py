"""Sequential specifications and consistency testers.

Reference: ``SequentialSpec`` at ``src/semantics.rs:73-98``,
``ConsistencyTester`` at
``src/semantics/consistency_tester.rs:15-43``.
"""

from __future__ import annotations

from typing import Iterable, Tuple


class SequentialSpec:
    """A sequential "reference object" against which to validate the
    operational semantics of a concurrent system. Ops and returns are tagged
    tuples (e.g. ``("Write", v)`` -> ``("WriteOk",)``)."""

    def invoke(self, op) -> object:
        """Invokes an operation, mutating this reference object, and returns
        the resulting value."""
        raise NotImplementedError

    def is_valid_step(self, op, ret) -> bool:
        """Whether invoking ``op`` might result in ``ret`` (mutates)."""
        return self.invoke(op) == ret

    def is_valid_history(self, ops: Iterable[Tuple[object, object]]) -> bool:
        """Whether a sequential (op, ret) history is valid for this object."""
        return all(self.is_valid_step(op, ret) for op, ret in ops)

    def clone(self) -> "SequentialSpec":
        raise NotImplementedError


class ConsistencyTester:
    """Tests the consistency of a concurrent system against a
    ``SequentialSpec`` by recording operation invocations and returns.
    ``on_invoke``/``on_return`` raise ``ValueError`` on invalid histories
    (e.g. two in-flight operations for one thread)."""

    def on_invoke(self, thread_id, op) -> "ConsistencyTester":
        raise NotImplementedError

    def on_return(self, thread_id, ret) -> "ConsistencyTester":
        raise NotImplementedError

    def is_consistent(self) -> bool:
        raise NotImplementedError

    def on_invret(self, thread_id, op, ret) -> "ConsistencyTester":
        self.on_invoke(thread_id, op)
        return self.on_return(thread_id, ret)
