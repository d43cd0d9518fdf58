"""A map from dense natural-number keys (e.g. actor ``Id``s) to values.

Semantics mirror the reference (the Rust ``src/util/densenatmap.rs``):
keys must stay dense — ``insert`` either overwrites an existing key or
appends at exactly ``len`` (anything else raises), which catches actor-index
bookkeeping bugs early. Symmetry reduction reindexes the map through the
rewrite plan (reference ``Rewrite`` impl at ``:223-236``).

The port's copy of the JAX package's ``utils/dense_nat_map.py`` (which
imports no JAX): the same semantics and the same stable hash.
"""

from __future__ import annotations

from typing import Generic, Iterable, Iterator, List, Tuple, TypeVar

V = TypeVar("V")


class DenseNatMap(Generic[V]):
    __slots__ = ("_values",)

    def __init__(self, values: Iterable[V] = ()):
        self._values: List[V] = list(values)

    @staticmethod
    def from_pairs(pairs: Iterable[Tuple[int, V]]) -> "DenseNatMap":
        """Builds from (key, value) pairs in any order; the keys must form
        exactly ``0..n``."""
        pairs = list(pairs)
        result: List = [None] * len(pairs)
        seen = [False] * len(pairs)
        for k, v in pairs:
            k = int(k)
            if not 0 <= k < len(pairs) or seen[k]:
                raise ValueError(
                    f"keys must form a dense range 0..{len(pairs)}: "
                    f"bad or duplicate key {k}"
                )
            seen[k] = True
            result[k] = v
        return DenseNatMap(result)

    def get(self, key) -> V:
        index = int(key)
        if not 0 <= index < len(self._values):
            return None
        return self._values[index]

    def insert(self, key, value: V) -> V:
        """Overwrites ``key`` (returning the previous value) or appends at
        exactly ``len`` (returning None). Out-of-order inserts raise."""
        index = int(key)
        if index > len(self._values):
            raise IndexError(
                f"out-of-order insert: index={index}, len={len(self._values)}"
            )
        if index == len(self._values):
            self._values.append(value)
            return None
        previous, self._values[index] = self._values[index], value
        return previous

    def __getitem__(self, key) -> V:
        return self._values[int(key)]

    def __setitem__(self, key, value: V) -> None:
        self.insert(key, value)

    def __contains__(self, key) -> bool:
        return 0 <= int(key) < len(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterator[V]:
        return iter(self._values)

    def values(self) -> List[V]:
        return list(self._values)

    def items(self):
        from ..actor.actor import Id

        return [(Id(i), v) for i, v in enumerate(self._values)]

    def __eq__(self, other) -> bool:
        if not isinstance(other, DenseNatMap):
            return NotImplemented
        return self._values == other._values

    def __hash__(self) -> int:
        from ..core.fingerprint import stable_hash

        return stable_hash(tuple(self._values))

    def __stable_fields__(self):
        return (tuple(self._values),)

    def __rewrite__(self, plan) -> "DenseNatMap":
        return DenseNatMap(plan.reindex(self._values))

    def __repr__(self) -> str:
        return f"DenseNatMap({self._values!r})"
