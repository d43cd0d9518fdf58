"""Vector clocks: a partial causal order on distributed events.

Semantics mirror the reference (the Rust ``src/util/vector_clock.rs``):
implicit-zero padding for equality and ordering, zero-truncating stable hash
(so ``[1]`` and ``[1, 0]`` are equal and hash identically), and elementwise
max merge. Instances are immutable — operations return new clocks — which
matches this framework's value-style state discipline.

The port's copy of the JAX package's ``utils/vector_clock.py`` (which
imports no JAX): the same semantics and the same stable hash.
"""

from __future__ import annotations

from typing import Iterable, Tuple


class VectorClock:
    __slots__ = ("_elems",)

    def __init__(self, elems: Iterable[int] = ()):
        self._elems: Tuple[int, ...] = tuple(int(e) for e in elems)

    def elems(self) -> Tuple[int, ...]:
        return self._elems

    def incremented(self, index: int) -> "VectorClock":
        """A copy with component ``index`` incremented (growing as needed)."""
        elems = list(self._elems)
        if index >= len(elems):
            elems.extend([0] * (1 + index - len(elems)))
        elems[index] += 1
        return VectorClock(elems)

    @staticmethod
    def merge_max(c1: "VectorClock", c2: "VectorClock") -> "VectorClock":
        """Elementwise max of two clocks."""
        n = max(len(c1._elems), len(c2._elems))
        return VectorClock(
            max(c1._get(i), c2._get(i)) for i in range(n)
        )

    def _get(self, i: int) -> int:
        return self._elems[i] if i < len(self._elems) else 0

    def _truncated(self) -> Tuple[int, ...]:
        cutoff = len(self._elems)
        while cutoff and self._elems[cutoff - 1] == 0:
            cutoff -= 1
        return self._elems[:cutoff]

    # Trailing zeros are semantically absent: equality/hash/order all pad
    # with implicit zeros.

    def __eq__(self, other) -> bool:
        if not isinstance(other, VectorClock):
            return NotImplemented
        return self._truncated() == other._truncated()

    def __hash__(self) -> int:
        return hash(self._truncated())

    def __stable_fields__(self):
        return (self._truncated(),)

    def _cmp(self, other) -> object:
        """-1/0/1 for ordered clocks, None for concurrent (incomparable)."""
        expected = 0
        for i in range(max(len(self._elems), len(other._elems))):
            a, b = self._get(i), other._get(i)
            order = (a > b) - (a < b)
            if expected == 0:
                expected = order
            elif order not in (0, expected):
                return None
        return expected

    def __lt__(self, other) -> bool:
        return self._cmp(other) == -1

    def __le__(self, other) -> bool:
        return self._cmp(other) in (-1, 0)

    def __gt__(self, other) -> bool:
        return self._cmp(other) == 1

    def __ge__(self, other) -> bool:
        return self._cmp(other) in (0, 1)

    def concurrent_with(self, other) -> bool:
        """True when neither clock happened-before the other."""
        return self._cmp(other) is None

    def __repr__(self) -> str:
        return f"VectorClock({list(self._elems)!r})"

    def __str__(self) -> str:
        return "<" + "".join(f"{c}, " for c in self._elems) + "...>"
