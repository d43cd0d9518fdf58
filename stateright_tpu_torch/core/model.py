"""The core model abstraction: nondeterministic transition systems + properties.

Reference: ``Model`` trait at ``src/lib.rs:156-255``,
``Property``/``Expectation`` at ``:262-326``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Generic, List, Optional, Tuple, TypeVar

State = TypeVar("State")
Action = TypeVar("Action")


class Expectation(Enum):
    """Whether a property is always, eventually, or sometimes true."""

    ALWAYS = "always"
    EVENTUALLY = "eventually"
    SOMETIMES = "sometimes"


@dataclass(frozen=True)
class Property(Generic[State]):
    """A named predicate over (model, state).

    - ``always``: safety invariant; the checker seeks a counterexample.
    - ``sometimes``: reachability; the checker seeks an example.
    - ``eventually``: liveness (acyclic paths only — matching the reference's
      documented false-negative on cycles/DAG joins,
      ``src/lib.rs:278-287`` and ``src/checker/bfs.rs:285-305``);
      the checker seeks a counterexample path ending in a terminal state.

    ``antecedent`` (optional, ``always`` only) declares the guard of an
    implication-shaped invariant (``antecedent => consequent``): the
    coverage ledger counts the states where it held, so a run whose
    antecedent never fired is reported as a *vacuous* pass instead of a
    silent green (TLC's coverage statistics make the same distinction).
    It never changes checking semantics — only observability.
    """

    expectation: Expectation
    name: str
    condition: Callable[[Any, Any], bool]
    antecedent: Optional[Callable[[Any, Any], bool]] = None

    @staticmethod
    def always(
        name: str,
        condition: Callable[[Any, Any], bool],
        antecedent: Optional[Callable[[Any, Any], bool]] = None,
    ) -> "Property":
        return Property(Expectation.ALWAYS, name, condition, antecedent)

    @staticmethod
    def eventually(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.EVENTUALLY, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[[Any, Any], bool]) -> "Property":
        return Property(Expectation.SOMETIMES, name, condition)


class Model(Generic[State, Action]):
    """The primary abstraction: implementations model a nondeterministic
    system's evolution.

    Subclasses implement ``init_states``, ``actions``, ``next_state`` and
    optionally ``properties``/``within_boundary``/display hooks.

    Reference: ``src/lib.rs:156-255``.
    """

    def init_states(self) -> List[State]:
        """Returns the initial possible states."""
        raise NotImplementedError

    def actions(self, state: State, actions: List[Action]) -> None:
        """Collects the subsequent possible actions based on a previous state."""
        raise NotImplementedError

    def next_state(self, last_state: State, action: Action) -> Optional[State]:
        """Converts a previous state and action to a resulting state.

        ``None`` indicates that the action does not change the state (the
        transition is pruned).
        """
        raise NotImplementedError

    def format_action(self, action: Action) -> str:
        return repr(action)

    def format_step(self, last_state: State, action: Action) -> Optional[str]:
        next_state = self.next_state(last_state, action)
        return None if next_state is None else repr(next_state)

    def as_svg(self, path) -> Optional[str]:
        """An SVG representation of a ``Path`` for this model (Explorer)."""
        return None

    def next_steps(self, last_state: State) -> List[Tuple[Action, State]]:
        """The (action, state) pairs that follow a particular state."""
        actions: List[Action] = []
        self.actions(last_state, actions)
        steps = []
        for action in actions:
            state = self.next_state(last_state, action)
            if state is not None:
                steps.append((action, state))
        return steps

    def next_states(self, last_state: State) -> List[State]:
        """The states that follow a particular state."""
        actions: List[Action] = []
        self.actions(last_state, actions)
        states = []
        for action in actions:
            state = self.next_state(last_state, action)
            if state is not None:
                states.append(state)
        return states

    def properties(self) -> List[Property]:
        return []

    def property(self, name: str) -> Property:
        """Looks up a property by name. Raises if the property does not exist."""
        for p in self.properties():
            if p.name == name:
                return p
        available = [p.name for p in self.properties()]
        raise KeyError(f"Unknown property. requested={name}, available={available}")

    def within_boundary(self, state: State) -> bool:
        """Whether a state is within the state space that should be checked."""
        return True

    def checker(self) -> "CheckerBuilder":
        from ..checker.builder import CheckerBuilder

        return CheckerBuilder(self)


class FnModel(Model):
    """Wraps ``fn(prev_state | None, next_states: list)`` as a Model, for
    one-liner models in tests (reference: blanket impl at
    ``src/test_util.rs:119-137``).

    When ``prev_state`` is None the function should append init states;
    otherwise it should append successor states. Every distinct successor
    state is its own action (the action *is* the state).
    """

    def __init__(self, fn: Callable[[Optional[Any], List[Any]], None]):
        self.fn = fn

    def init_states(self):
        states: List[Any] = []
        self.fn(None, states)
        return states

    def actions(self, state, actions):
        states: List[Any] = []
        self.fn(state, states)
        actions.extend(states)

    def next_state(self, last_state, action):
        return action
