"""System snapshot for an actor model.

NOTE (reference parity): hashing and equality cover actor_states / history /
timers_set / network but deliberately NOT ``crashed`` — matching the
reference's manual ``Hash``/``PartialEq`` impls
(``src/actor/model_state.rs:86-112``). A Crash transition with
no set timers therefore fingerprints identically to its parent state.

The symmetry group action of the JAX package's copy (``_permuted``,
``representative``, ``orbit_representative``) is not ported: the port has
no symmetry reduction yet.
"""

from __future__ import annotations

from typing import List

from .network import Network
from .timers import Timers


class ActorModelState:
    """Snapshot in time for the entire actor system."""

    __slots__ = ("actor_states", "network", "timers_set", "crashed", "history")

    def __init__(
        self,
        actor_states: List,
        network: Network,
        timers_set: List[Timers],
        crashed: List[bool],
        history,
    ):
        self.actor_states = actor_states
        self.network = network
        self.timers_set = timers_set
        self.crashed = crashed
        self.history = history

    def copy(self) -> "ActorModelState":
        return ActorModelState(
            actor_states=list(self.actor_states),
            network=self.network.copy(),
            timers_set=[t.copy() for t in self.timers_set],
            crashed=list(self.crashed),
            history=self.history,
        )

    def __stable_fields__(self):
        # `crashed` intentionally excluded (see module docstring).
        return (
            tuple(self.actor_states),
            self.history,
            tuple(self.timers_set),
            self.network,
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ActorModelState)
            and self.actor_states == other.actor_states
            and self.history == other.history
            and self.timers_set == other.timers_set
            and self.network == other.network
        )

    def __hash__(self) -> int:
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self) -> str:
        return (
            "ActorModelState { "
            f"actor_states: {self.actor_states!r}, "
            f"history: {self.history!r}, "
            f"is_timer_set: {self.timers_set!r}, "
            f"network: {self.network!r} }}"
        )
