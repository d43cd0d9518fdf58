"""Per-evaluated-state visitor callbacks.

Reference: ``src/checker/visitor.rs``.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Set, TypeVar

from .path import Path

State = TypeVar("State")
Action = TypeVar("Action")


class CheckerVisitor:
    """Receives the full ``Path`` for every state the checker evaluates."""

    def visit(self, model, path: Path) -> None:
        raise NotImplementedError


class FnVisitor(CheckerVisitor):
    """Wraps any ``fn(path)`` or ``fn(model, path)`` callable as a visitor."""

    def __init__(self, fn: Callable):
        self._fn = fn
        try:
            import inspect

            self._arity = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            self._arity = 1

    def visit(self, model, path: Path) -> None:
        if self._arity >= 2:
            self._fn(model, path)
        else:
            self._fn(path)


class PathRecorder(CheckerVisitor, Generic[State, Action]):
    """Records the set of all visited paths."""

    def __init__(self):
        self._lock = threading.Lock()
        self.paths: Set[Path] = set()

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self.paths.add(path)


class StateRecorder(CheckerVisitor, Generic[State]):
    """Records the sequence of last-states of visited paths (i.e. the states
    in visitation order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.states: List[State] = []

    def visit(self, model, path: Path) -> None:
        with self._lock:
            self.states.append(path.last_state())
