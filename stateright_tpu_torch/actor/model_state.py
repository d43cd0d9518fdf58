"""System snapshot for an actor model.

NOTE (reference parity): hashing and equality cover actor_states / history /
timers_set / network but deliberately NOT ``crashed`` — matching the
reference's manual ``Hash``/``PartialEq`` impls
(``src/actor/model_state.rs:86-112``). A Crash transition with
no set timers therefore fingerprints identically to its parent state.

The symmetry group action (``_permuted``, ``representative``,
``orbit_representative``, ``rewrite_network``) is the JAX package's: the
host twin of ``PackedActorModel.packed_apply_permutation``.
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

    def _permuted(self, plan) -> "ActorModelState":
        """The symmetry group action: permute actor-indexed vectors and
        rewrite every embedded Id per ``plan``."""
        from ..utils.rewrite import rewrite_value

        return ActorModelState(
            actor_states=plan.reindex(self.actor_states),
            network=rewrite_network(self.network, plan),
            timers_set=plan.reindex(self.timers_set),
            crashed=plan.reindex(self.crashed),
            history=rewrite_value(self.history, plan),
        )

    def representative(self) -> "ActorModelState":
        """Sort-heuristic member of this state's symmetry equivalence class
        (the reference's, ``src/actor/model_state.rs:115-132``).

        NOT a canonical form: id rewriting changes the sorted rows, so
        symmetry-reduced counts under this heuristic depend on traversal
        order. ``orbit_representative`` is the proper alternative."""
        from ..utils.rewrite import RewritePlan

        return self._permuted(RewritePlan.from_values_to_sort(self.actor_states))

    def orbit_representative(self) -> "ActorModelState":
        """True orbit canonical form (``utils.rewrite.orbit_min``): the
        semantics of the GPU checker's symmetry keys, so host and device
        symmetry-reduced counts agree exactly."""
        from ..utils.rewrite import orbit_min

        return orbit_min(len(self.actor_states), self._permuted)

    def __repr__(self) -> str:
        return (
            "ActorModelState { "
            f"actor_states: {self.actor_states!r}, "
            f"history: {self.history!r}, "
            f"is_timer_set: {self.timers_set!r}, "
            f"network: {self.network!r} }}"
        )


def rewrite_network(network: Network, plan) -> Network:
    """Rewrites all actor Ids in a network per a RewritePlan."""
    from ..utils.rewrite import rewrite_value
    from .network import Envelope

    rewritten = Network(network.kind)
    for env in network.iter_all():
        rewritten.send(
            Envelope(
                src=plan.rewrite_id(env.src),
                dst=plan.rewrite_id(env.dst),
                msg=rewrite_value(env.msg, plan),
            )
        )
    return rewritten
