"""Per-actor set of named pending timers.

Durations are irrelevant under model checking (``model_timeout()`` is a
zero-length range); a timeout action is enumerated for every set timer.

Reference: ``Timers`` at ``src/actor/timers.rs``. The packed
representation is a bitmask per actor.
"""

from __future__ import annotations

from typing import Dict, Iterator


class Timers:
    """A collection of timers that have been set for a given actor."""

    def __init__(self, timers=()):
        # dict-as-set: deterministic insertion-order iteration.
        self._set: Dict = {t: True for t in timers}

    def set(self, timer) -> bool:
        if timer in self._set:
            return False
        self._set[timer] = True
        return True

    def cancel(self, timer) -> bool:
        return self._set.pop(timer, None) is not None

    def cancel_all(self) -> None:
        self._set.clear()

    def __iter__(self) -> Iterator:
        return iter(self._set)

    def __contains__(self, timer) -> bool:
        return timer in self._set

    def __len__(self) -> int:
        return len(self._set)

    def copy(self) -> "Timers":
        return Timers(self._set)

    def __stable_fields__(self):
        # Order-insensitive, like the reference's HashableHashSet.
        return (frozenset_safe(self._set),)

    def __eq__(self, other) -> bool:
        return isinstance(other, Timers) and set(self._set) == set(other._set)

    def __hash__(self) -> int:
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self) -> str:
        return f"Timers({list(self._set)!r})"


def frozenset_safe(items):
    """A frozenset when elements are Python-hashable, else a stable-sorted
    tuple keyed by stable hash."""
    try:
        return frozenset(items)
    except TypeError:
        from ..core.fingerprint import stable_hash

        return tuple(sorted(items, key=stable_hash))
