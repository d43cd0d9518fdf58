"""Counterexample/example paths, reconstructed from fingerprint sequences.

Reference: ``src/checker/path.rs``. Reconstruction re-executes
the model along the fingerprint trail (the TLC technique from "Model Checking
TLA+ Specifications", Yu/Manolios/Lamport). The detailed nondeterminism
diagnostics are kept — they encode real user pain.
"""

from __future__ import annotations

from typing import Generic, List, Optional, Sequence, Tuple, TypeVar

from .fingerprint import Fingerprint, fingerprint

State = TypeVar("State")
Action = TypeVar("Action")

_NONDETERMINISM_HINT = """
The most obvious cause would be a model that operates directly upon untracked external state such
as the file system, a global mutable, or a source of randomness. Note that this is often
inadvertent. For example, iterating over an unordered container does not always happen in the same
order, which can lead to unexpected nondeterminism."""


class Path(Generic[State, Action]):
    """A path of states including actions:
    ``state --action--> state ... --action--> state``."""

    def __init__(self, steps: List[Tuple[State, Optional[Action]]]):
        self._steps = steps

    @staticmethod
    def from_fingerprints(
        model, fingerprints: Sequence[Fingerprint], fp_of=None
    ) -> "Path":
        """Reconstructs a path by replaying the model along a fingerprint trail.

        ``fp_of`` overrides the fingerprint function (default: the stable host
        ``fingerprint``). The GPU checker passes their device fingerprint of the
        packed state so host replay matches device-recorded trails.
        """
        if fp_of is None:
            fp_of = fingerprint
        fps = list(fingerprints)
        if not fps:
            raise ValueError("empty path is invalid")
        init_print = fps[0]
        last_state = None
        for s in model.init_states():
            if fp_of(s) == init_print:
                last_state = s
                break
        if last_state is None:
            available = [fp_of(s) for s in model.init_states()]
            raise RuntimeError(
                f"""
Unable to reconstruct a `Path` based on digests ("fingerprints") from states visited earlier. No
init state has the expected fingerprint ({init_print}). This usually happens when the return value
of `Model.init_states` varies.
{_NONDETERMINISM_HINT}

Available init fingerprints (none of which match): {available}"""
            )
        output: List[Tuple[State, Optional[Action]]] = []
        for next_fp in fps[1:]:
            found = None
            for a, s in model.next_steps(last_state):
                if fp_of(s) == next_fp:
                    found = (a, s)
                    break
            if found is None:
                available = [fp_of(s) for s in model.next_states(last_state)]
                raise RuntimeError(
                    f"""
Unable to reconstruct a `Path` based on digests ("fingerprints") from states visited earlier.
{1 + len(output)} previous state(s) of the path were able to be reconstructed, but no subsequent
state has the next fingerprint ({next_fp}). This usually happens when `Model.actions` or
`Model.next_state` vary even when given the same input arguments.
{_NONDETERMINISM_HINT}

Available next fingerprints (none of which match): {available}"""
                )
            action, next_state = found
            output.append((last_state, action))
            last_state = next_state
        output.append((last_state, None))
        return Path(output)

    @staticmethod
    def from_actions(model, init_state: State, actions) -> Optional["Path"]:
        """Constructs a path from an initial state and a sequence of actions.
        Returns None for inputs unreachable via the model."""
        if init_state not in model.init_states():
            return None
        output: List[Tuple[State, Optional[Action]]] = []
        prev_state = init_state
        for action in actions:
            found = None
            for a, s in model.next_steps(prev_state):
                if a == action:
                    found = (a, s)
                    break
            if found is None:
                return None
            output.append((prev_state, found[0]))
            prev_state = found[1]
        output.append((prev_state, None))
        return Path(output)

    @staticmethod
    def final_state(model, fingerprints: Sequence[Fingerprint]) -> Optional[State]:
        """The final state associated with a particular fingerprint path."""
        fps = list(fingerprints)
        if not fps:
            return None
        matching_state = None
        for s in model.init_states():
            if fingerprint(s) == fps[0]:
                matching_state = s
                break
        if matching_state is None:
            return None
        for next_print in fps[1:]:
            found = None
            for s in model.next_states(matching_state):
                if fingerprint(s) == next_print:
                    found = s
                    break
            if found is None:
                return None
            matching_state = found
        return matching_state

    def last_state(self) -> State:
        return self._steps[-1][0]

    def into_states(self) -> List[State]:
        return [s for s, _a in self._steps]

    def into_actions(self) -> List[Action]:
        return [a for _s, a in self._steps if a is not None]

    def into_vec(self) -> List[Tuple[State, Optional[Action]]]:
        return list(self._steps)

    def encode(self) -> str:
        """Encodes the path as '/'-delimited fingerprints."""
        return "/".join(str(fingerprint(s)) for s, _a in self._steps)

    def __len__(self) -> int:
        return len(self._steps)

    def __iter__(self):
        return iter(self._steps)

    def __eq__(self, other) -> bool:
        return isinstance(other, Path) and self._steps == other._steps

    def __hash__(self) -> int:
        def _key(x):
            try:
                return hash(x)
            except TypeError:
                return fingerprint(x)

        return hash(tuple((_key(s), _key(a)) for s, a in self._steps))

    def __str__(self) -> str:
        lines = [f"Path[{len(self._steps) - 1}]:"]
        for _state, action in self._steps:
            if action is not None:
                lines.append(f"- {action!r}")
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        return f"Path({self._steps!r})"
