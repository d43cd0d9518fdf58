"""The packed-state protocol: models whose transitions run on the device.

The port's counterpart of the JAX package's ``core/batch.py``. The
reference's ``Model`` trait enumerates actions into a growable ``Vec``
(``src/lib.rs:172-184``); a ``BatchableModel`` additionally exposes its
transition relation in fixed-width, batched form:

- packed states are dicts (or a bare tensor) of torch tensors with a
  leading lane axis: ``(N, ...)``. Leaves carry u32 values in ``int64``
  (see ``ops/fingerprint.py``);
- the action set is a static dense range ``0..packed_action_count``; each
  action id either applies (guard true) or reports invalid;
- ``packed_expand`` maps a batch of F states to all F x A candidates at
  once, written batched rather than through ``vmap`` because that is the
  form the wave consumes;
- ``packed_conditions`` are batched predicates aligned 1:1 with
  ``properties()``.

Packed and host representations must agree: ``pack_state``/``unpack_state``
convert one state between them, and two host states are equal iff their
packed forms are identical (this is what makes device fingerprints usable
for dedup and path replay).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from ..ops.fingerprint import fingerprint_state

PackedState = Any  # dict of tensors (or one tensor) with a leading lane axis


def map_leaves(fn: Callable[[torch.Tensor], torch.Tensor], state: PackedState):
    """Applies ``fn`` to every tensor leaf of a packed state."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: map_leaves(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(map_leaves(fn, v) for v in state)
    raise TypeError(f"packed state leaf of type {type(state).__name__}")


def leaves(state: PackedState) -> List[torch.Tensor]:
    """The tensor leaves of a packed state."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [x for v in state.values() for x in leaves(v)]
    return [x for v in state for x in leaves(v)]


class BatchableModel:
    """Mixin protocol implemented by models that support the GPU checker.

    A class typically subclasses both ``Model`` (host path: exact oracle,
    paths) and ``BatchableModel`` (device path)."""

    def packed_action_count(self) -> int:
        """Static upper bound on actions per state (dense action ids)."""
        raise NotImplementedError

    def packed_init_states(self, device="cpu") -> PackedState:
        """All initial states, stacked along a leading lane axis."""
        raise NotImplementedError

    def packed_expand(self, states: PackedState) -> Tuple[PackedState, torch.Tensor]:
        """All ``A = packed_action_count()`` candidates of each of F states:
        ``states[F] -> (candidates[F, A], valid[F, A])``. Candidate leaves
        gain an action axis after the lane axis; ``valid`` is False where
        the action's guard does not hold (the host model would not have
        enumerated it) or the transition is a pruned no-op."""
        raise NotImplementedError

    def packed_conditions(self) -> List[Callable[[PackedState], torch.Tensor]]:
        """Batched predicates aligned with ``properties()`` (same order):
        each maps ``states[N]`` to an ``(N,)`` bool tensor."""
        raise NotImplementedError

    def packed_within_boundary(self, states: PackedState) -> torch.Tensor:
        """Batched analog of ``within_boundary``: ``(N,)`` bool."""
        leaf = leaves(states)[0]
        return torch.ones(leaf.shape[0], dtype=torch.bool, device=leaf.device)

    def packed_fingerprint(self, states: PackedState):
        """(hi, lo) device fingerprints of a batch, each ``(N,)`` int64
        carrying u32 — THE fingerprint definition the checker uses (dedup,
        parent log, replay). The default hashes every leaf."""
        return fingerprint_state(states)

    def pack_state(self, host_state: Any) -> PackedState:
        """Packs one host state into tensors WITHOUT the lane axis."""
        raise NotImplementedError

    def unpack_state(self, packed: PackedState) -> Any:
        """Unpacks one packed state (no lane axis) into a host state."""
        raise NotImplementedError

