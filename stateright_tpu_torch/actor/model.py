"""ActorModel: the bridge from actors to the ``Model`` interface.

A system of actors communicating over a modeled ``Network`` becomes a
nondeterministic transition system whose actions are message deliveries/drops,
timeouts, and crash faults. ``H`` is an auxiliary history variable (TLA-style)
threaded through message hooks — e.g. a linearizability tester.

Reference: ``ActorModel`` at ``src/actor/model.rs:23-649``.
Its fixed-width staged twin, the transitions batched in torch, is
``actor/packed.py::PackedActorModel`` (bounded actors, bounded message slots,
a dense action table).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..core.model import Model, Property
from .actor import (
    CANCEL_TIMER,
    SEND,
    SET_TIMER,
    Actor,
    Id,
    Out,
    is_no_op,
    is_no_op_with_timer,
)
from .model_state import ActorModelState
from .network import Envelope, Network, ORDERED
from .timers import Timers

LOSSY = True
LOSSLESS = False


def model_timeout():
    """An arbitrary timeout range for model checking (the specific value is
    irrelevant: timeouts fire nondeterministically)."""
    return (0, 0)


def model_peers(self_ix: int, count: int) -> List[Id]:
    """The peer Ids for actor ``self_ix`` among ``count`` actors."""
    return [Id(j) for j in range(count) if j != self_ix]


# -- actions -----------------------------------------------------------------


@dataclass(frozen=True)
class DeliverAction:
    src: Id
    dst: Id
    msg: object

    def __repr__(self):
        return f"Deliver {{ src: {self.src!r}, dst: {self.dst!r}, msg: {self.msg!r} }}"


@dataclass(frozen=True)
class DropAction:
    envelope: Envelope

    def __repr__(self):
        return f"Drop({self.envelope!r})"


@dataclass(frozen=True)
class TimeoutAction:
    id: Id
    timer: object

    def __repr__(self):
        return f"Timeout({self.id!r}, {self.timer!r})"


@dataclass(frozen=True)
class CrashAction:
    id: Id

    def __repr__(self):
        return f"Crash({self.id!r})"


class ActorModel(Model):
    """Represents a system of actors that communicate over a network.

    Builder usage::

        model = (ActorModel(cfg, init_history)
                 .actor(Server())
                 .actors(Client() for _ in range(2))
                 .init_network(Network.new_ordered())
                 .lossy_network(True)
                 .max_crashes(1)
                 .property(Expectation.ALWAYS, "safe", lambda m, s: ...)
                 .record_msg_in(lambda cfg, history, env: ... or None)
                 .within_boundary(lambda cfg, state: ...))
    """

    def __init__(self, cfg=None, init_history=None):
        self.actors_list: List[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self._init_network: Network = Network.new_unordered_duplicating()
        self._lossy_network: bool = LOSSLESS
        self._max_crashes: int = 0
        self._properties: List[Property] = []
        # Original append positions, kept parallel to ``_properties`` so a
        # codec's positionally-aligned ``packed_conditions`` list can be
        # filtered consistently after ``retain_properties``.
        self._property_codec_pos: List[int] = []
        self._properties_added: int = 0
        self._record_msg_in: Callable = lambda cfg, history, env: None
        self._record_msg_out: Callable = lambda cfg, history, env: None
        self._within_boundary: Callable = lambda cfg, state: True

    # -- builder -------------------------------------------------------------

    def actor(self, actor: Actor) -> "ActorModel":
        self.actors_list.append(actor)
        return self

    def actors(self, actors) -> "ActorModel":
        for actor in actors:
            self.actors_list.append(actor)
        return self

    def init_network(self, network: Network) -> "ActorModel":
        self._init_network = network
        return self

    def lossy_network(self, lossy: bool) -> "ActorModel":
        self._lossy_network = lossy
        return self

    def max_crashes(self, max_crashes: int) -> "ActorModel":
        self._max_crashes = max_crashes
        return self

    def property(self, expectation, name: str = None, condition=None):
        """Builder-style with 3 args (expectation, name, condition); with a
        single string argument, behaves as ``Model.property`` name lookup."""
        if name is None and condition is None:
            return Model.property(self, expectation)
        self._properties.append(Property(expectation, name, condition))
        self._property_codec_pos.append(self._properties_added)
        self._properties_added += 1
        return self

    def retain_properties(self, *names: str) -> "ActorModel":
        """Keeps only the named properties (e.g. to benchmark
        time-to-counterexample on a single falsifiable liveness property —
        checkers finish early once every remaining property has a
        discovery). Packed codecs stay aligned: their positional
        ``packed_conditions`` list is filtered by the same positions."""
        if not names:
            raise ValueError(
                "retain_properties needs at least one property name "
                "(a checker with no properties explores nothing)"
            )
        have = {p.name for p in self._properties}
        missing = [n for n in names if n not in have]
        if missing:
            raise ValueError(f"unknown properties: {missing} (have {sorted(have)})")
        keep = [i for i, p in enumerate(self._properties) if p.name in names]
        self._properties = [self._properties[i] for i in keep]
        self._property_codec_pos = [self._property_codec_pos[i] for i in keep]
        return self

    def record_msg_in(self, fn) -> "ActorModel":
        """fn(cfg, history, envelope) -> new history or None (no change)."""
        self._record_msg_in = fn
        return self

    def record_msg_out(self, fn) -> "ActorModel":
        self._record_msg_out = fn
        return self

    def within_boundary_fn(self, fn) -> "ActorModel":
        self._within_boundary = fn
        return self

    # -- internals -----------------------------------------------------------

    def _process_commands(self, id: Id, out: Out, state: ActorModelState) -> None:
        """Applies an actor's output commands to the (freshly copied) system
        state: sends to the network (with history hook), timer bookkeeping."""
        index = int(id)
        for c in out.commands:
            if c.kind == SEND:
                dst, msg = c.args
                history = self._record_msg_out(
                    self.cfg, state.history, Envelope(src=id, dst=dst, msg=msg)
                )
                if history is not None:
                    state.history = history
                state.network.send(Envelope(src=id, dst=Id(dst), msg=msg))
            elif c.kind == SET_TIMER:
                timer, _duration = c.args
                while len(state.timers_set) <= index:
                    state.timers_set.append(Timers())
                state.timers_set[index].set(timer)
            elif c.kind == CANCEL_TIMER:
                (timer,) = c.args
                state.timers_set[index].cancel(timer)

    # -- Model interface -----------------------------------------------------

    def init_states(self) -> List[ActorModelState]:
        init_sys_state = ActorModelState(
            actor_states=[],
            history=self.init_history,
            timers_set=[Timers() for _ in self.actors_list],
            network=self._init_network.copy(),
            crashed=[False] * len(self.actors_list),
        )
        for index, actor in enumerate(self.actors_list):
            id = Id(index)
            out = Out()
            state = actor.on_start(id, out)
            init_sys_state.actor_states.append(state)
            self._process_commands(id, out, init_sys_state)
        return [init_sys_state]

    def actions(self, state: ActorModelState, actions: List) -> None:
        for env in state.network.iter_deliverable():
            # option 1: message is lost
            if self._lossy_network:
                actions.append(DropAction(env))
            # option 2: message is delivered (skip if recipient DNE; for
            # ordered networks iter_deliverable already yields flow heads only)
            if int(env.dst) < len(self.actors_list):
                actions.append(
                    DeliverAction(src=env.src, dst=env.dst, msg=env.msg)
                )
        # option 3: actor timeout
        for index, timers in enumerate(state.timers_set):
            for timer in timers:
                actions.append(TimeoutAction(Id(index), timer))
        # option 4: actor crash
        n_crashed = sum(1 for c in state.crashed if c)
        if n_crashed < self._max_crashes:
            for index, crashed in enumerate(state.crashed):
                if not crashed:
                    actions.append(CrashAction(Id(index)))

    def next_state(
        self, last_sys_state: ActorModelState, action
    ) -> Optional[ActorModelState]:
        if isinstance(action, DropAction):
            next_state = last_sys_state.copy()
            next_state.network.on_drop(action.envelope)
            return next_state

        if isinstance(action, DeliverAction):
            src, id, msg = action.src, action.dst, action.msg
            index = int(id)
            # Not all messages can be delivered, so ignore those.
            if index >= len(last_sys_state.actor_states):
                return None
            if last_sys_state.crashed[index]:
                return None
            last_actor_state = last_sys_state.actor_states[index]

            out = Out()
            returned = self.actors_list[index].on_msg(
                id, last_actor_state, src, msg, out
            )
            is_ordered = self._init_network.kind == ORDERED
            # Some operations are no-ops, so ignore those as well (but ordered
            # networks must still consume the message to preserve FIFO state).
            if is_no_op(returned, out) and not is_ordered:
                return None
            history = self._record_msg_in(
                self.cfg,
                last_sys_state.history,
                Envelope(src=src, dst=id, msg=msg),
            )

            next_sys_state = last_sys_state.copy()
            next_sys_state.network.on_deliver(Envelope(src=src, dst=id, msg=msg))
            if returned is not None:
                next_sys_state.actor_states[index] = returned
            if history is not None:
                next_sys_state.history = history
            self._process_commands(id, out, next_sys_state)
            return next_sys_state

        if isinstance(action, TimeoutAction):
            id, timer = action.id, action.timer
            index = int(id)
            out = Out()
            returned = self.actors_list[index].on_timeout(
                id, last_sys_state.actor_states[index], timer, out
            )
            if is_no_op_with_timer(returned, out, timer):
                return None
            next_sys_state = last_sys_state.copy()
            # The timer is no longer valid.
            next_sys_state.timers_set[index].cancel(timer)
            if returned is not None:
                next_sys_state.actor_states[index] = returned
            self._process_commands(id, out, next_sys_state)
            return next_sys_state

        if isinstance(action, CrashAction):
            index = int(action.id)
            next_sys_state = last_sys_state.copy()
            next_sys_state.timers_set[index].cancel_all()
            next_sys_state.crashed[index] = True
            return next_sys_state

        raise TypeError(f"unknown action: {action!r}")

    def properties(self) -> List[Property]:
        return list(self._properties)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self._within_boundary(self.cfg, state)

    def format_action(self, action) -> str:
        if isinstance(action, DeliverAction):
            return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
        return repr(action)

    def format_step(self, last_state, action) -> Optional[str]:
        next_state = self.next_state(last_state, action)
        return None if next_state is None else repr(next_state)

    def as_svg(self, path) -> Optional[str]:
        """Renders a sequence diagram of a path (for the Explorer UI).

        Reference: ``src/actor/model.rs:475-640``."""
        plot = lambda x, y: (x * 100, y * 30)
        actor_count = len(self.actors_list)
        path_vec = path.into_vec()
        height = 30 * (len(path_vec) + 1)
        width = 100 * (actor_count + 1)
        svg = [
            f'<svg version="1.1" baseProfile="full" width="{width}" '
            f'height="{height}" viewBox="-20 -20 {width + 20} {height + 20}" '
            'xmlns="http://www.w3.org/2000/svg">'
        ]
        # Vertical timeline per actor.
        for actor_index in range(actor_count):
            x1, y1 = plot(actor_index, 0)
            x2, y2 = plot(actor_index, len(path_vec))
            svg.append(f'<line x1="{x1}" y1="{y1}" x2="{x2}" y2="{y2}" class="svg-actor-timeline" />')
            svg.append(f'<text x="{x1}" y="{y1}" class="svg-actor-label">{actor_index}</text>')
        # Event markers per step.
        time = 0
        send_time_by_env = {}
        for state, action in path_vec:
            time += 1
            if isinstance(action, DeliverAction):
                x_to, y_to = plot(int(action.dst), time)
                env = Envelope(action.src, action.dst, action.msg)
                if env in send_time_by_env:
                    x_from, y_from = plot(int(action.src), send_time_by_env[env])
                    svg.append(
                        f'<line x1="{x_from}" x2="{x_to}" y1="{y_from}" y2="{y_to}" '
                        'marker-end="url(#arrow)" class="svg-event-line" />'
                    )
                svg.append(f'<circle cx="{x_to}" cy="{y_to}" r="10" class="svg-event-shape" />')
                svg.append(f'<text x="{x_to}" y="{y_to}" class="svg-event-label">{action.msg!r}</text>')
            elif isinstance(action, TimeoutAction):
                x, y = plot(int(action.id), time)
                svg.append(f'<rect x="{x - 10}" y="{y - 10}" width="20" height="20" class="svg-event-shape" />')
                svg.append(f'<text x="{x}" y="{y}" class="svg-event-label">Timeout</text>')
            # Track sends at this step by diffing network contents.
            if action is not None:
                next_state_obj = self.next_state(state, action)
                if next_state_obj is not None:
                    before = {}
                    for env in state.network.iter_all():
                        before[env] = before.get(env, 0) + 1
                    for env in next_state_obj.network.iter_all():
                        before[env] = before.get(env, 0) - 1
                    for env, count in before.items():
                        if count < 0:
                            send_time_by_env[env] = time
        svg.append("</svg>")
        return "".join(svg)
