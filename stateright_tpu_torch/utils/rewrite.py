"""Symmetry-reduction machinery on the host: rewrite plans and recursive
Id rewriting.

The port's copy of the JAX package's ``utils/rewrite.py``. A
``RewritePlan`` is a permutation of the actors; applying it recursively
yields a behaviorally equivalent state. ``orbit_min`` takes the least
permuted state over all ``n!`` plans: one representative per orbit, the
host twin of the GPU checker's orbit-proper symmetry keys.

Reference: ``RewritePlan`` at ``src/checker/rewrite_plan.rs``
(permutation-by-sorting at ``:81-106``, ``reindex`` at ``:110-123``) and the
recursive ``Rewrite`` impls at ``src/checker/rewrite.rs``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

from ..core.fingerprint import stable_encode


def canonical_sort_key(value) -> bytes:
    """A deterministic total-order key for arbitrary stable-hashable values:
    the canonical byte encoding (the reference requires ``V: Ord``; mixing
    natural ordering with a hash fallback would be intransitive for
    heterogeneous values, so the encoding alone is the order).

    Any deterministic total order yields a valid canonicalization: the set
    of equivalence classes (and hence symmetry-reduced state counts) does
    not depend on which member is chosen as representative."""
    return stable_encode(value)


def orbit_min(n: int, permuted_fn: Callable):
    """True orbit canonical form: the minimum over all ``n!`` rewrite plans
    of ``permuted_fn(plan)``, keyed by canonical byte encoding. Proper (one
    representative per orbit), so symmetry-reduced counts are traversal-
    and engine-independent. Shares the device path's actor-count bound."""
    from itertools import permutations

    from ..core.batch import MAX_SYMMETRY_ACTORS

    if n > MAX_SYMMETRY_ACTORS:
        raise ValueError(
            f"orbit canonicalization over {n} actors enumerates {n}! "
            f"permutations; the supported bound is {MAX_SYMMETRY_ACTORS}"
        )
    return min(
        (permuted_fn(RewritePlan(list(p))) for p in permutations(range(n))),
        key=canonical_sort_key,
    )


class RewritePlan:
    """Maps old actor indices (Ids) to new ones."""

    def __init__(self, mapping: List[int]):
        # mapping[old_index] = new_index
        self.mapping = mapping

    @staticmethod
    def from_values_to_sort(values: Sequence) -> "RewritePlan":
        """Builds the permutation that stable-sorts ``values``."""
        order = sorted(range(len(values)), key=lambda i: canonical_sort_key(values[i]))
        mapping = [0] * len(values)
        for new_index, old_index in enumerate(order):
            mapping[old_index] = new_index
        return RewritePlan(mapping)

    def rewrite_id(self, id_value):
        from ..actor.actor import Id

        return Id(self.mapping[int(id_value)])

    def reindex(self, indexed: Sequence) -> List:
        """Permutes a per-actor vector (result[new] = rewrite(indexed[old]))
        and recursively rewrites each element."""
        result = [None] * len(self.mapping)
        for old_index, new_index in enumerate(self.mapping):
            result[new_index] = rewrite_value(indexed[old_index], self)
        return result


def rewrite_value(value, plan: RewritePlan):
    """Recursively rewrites every ``Id`` inside ``value`` per ``plan``.

    Only instances of ``stateright_tpu_torch.actor.Id`` are rewritten; plain
    ints pass through (as in the reference, where only the ``Id`` type
    implements ``Rewrite<Id>`` non-trivially)."""
    from ..actor.actor import Id

    if isinstance(value, Id):
        return plan.rewrite_id(value)
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, tuple):
        return tuple(rewrite_value(v, plan) for v in value)
    if isinstance(value, list):
        return [rewrite_value(v, plan) for v in value]
    if isinstance(value, (set, frozenset)):
        return frozenset(rewrite_value(v, plan) for v in value)
    if isinstance(value, dict):
        return {
            rewrite_value(k, plan): rewrite_value(v, plan)
            for k, v in value.items()
        }
    if hasattr(value, "__rewrite__"):
        return value.__rewrite__(plan)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value)(
            **{
                f.name: rewrite_value(getattr(value, f.name), plan)
                for f in dataclasses.fields(value)
            }
        )
    # Opaque values (e.g. Timers) are returned unchanged.
    return value
