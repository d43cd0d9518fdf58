"""Ordered reliable link (ORL): exactly-once in-order delivery over lossy nets.

Wraps any actor with sequence numbers, acknowledgements, and a periodic
resend timer — the "perfect link" construction (Cachin/Guerraoui/Rodrigues)
plus per-source/destination-pair ordering. Pair with
``Network.new_ordered`` to shrink the checked state space.

Semantics per the reference (``src/actor/ordered_reliable_link.rs``):
send side tracks unacked messages (resent on the network timer); the receive
side acks every Deliver and drops already-delivered sequence numbers; actor
restarts are not supported (sequencers are not persisted). Deviation: the
reference ``todo!()``s SetTimer/CancelTimer from the wrapped actor
(``:191-196``); here user timers are forwarded through a timer wrapper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .actor import (
    CANCEL_TIMER,
    SEND,
    SET_TIMER,
    Actor,
    Id,
    Out,
    is_no_op,
)

# Messages: ("Deliver", seq, inner_msg) | ("Ack", seq)
# Timers:   ("Network",) | ("User", inner_timer)
NETWORK_TIMER = ("Network",)


def deliver_msg(seq: int, msg) -> Tuple:
    return ("Deliver", seq, msg)


def ack_msg(seq: int) -> Tuple:
    return ("Ack", seq)


def user_timer(timer) -> Tuple:
    return ("User", timer)


@dataclass(frozen=True)
class OrlState:
    # send side
    next_send_seq: int
    msgs_pending_ack: Tuple  # sorted tuple of (seq, dst, msg)
    # receive side
    last_delivered_seqs: Tuple  # sorted tuple of (src, seq)
    wrapped_state: object


class ActorWrapper(Actor):
    """Wraps an actor with logic to (1) maintain message order, (2) resend
    lost messages, and (3) avoid redelivery."""

    def __init__(self, wrapped_actor: Actor, resend_interval=(1.0, 2.0)):
        self.wrapped_actor = wrapped_actor
        self.resend_interval = resend_interval

    def name(self) -> str:
        return self.wrapped_actor.name()

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _last_delivered(state: OrlState, src: Id) -> int:
        for s, seq in state.last_delivered_seqs:
            if s == src:
                return seq
        return 0

    def _process_output(self, seq, pending, wrapped_out: Out, o: Out):
        """Translates the wrapped actor's commands; returns updated
        (next_send_seq, msgs_pending_ack)."""
        pending = list(pending)
        for command in wrapped_out:
            if command.kind == SEND:
                dst, inner = command.args
                o.send(dst, deliver_msg(seq, inner))
                pending.append((seq, dst, inner))
                seq += 1
            elif command.kind == SET_TIMER:
                timer, duration = command.args
                o.set_timer(user_timer(timer), duration)
            elif command.kind == CANCEL_TIMER:
                o.cancel_timer(user_timer(command.args[0]))
        return seq, tuple(sorted(pending, key=lambda p: p[0]))

    # -- Actor surface -----------------------------------------------------

    def on_start(self, id: Id, o: Out) -> OrlState:
        o.set_timer(NETWORK_TIMER, self.resend_interval)
        wrapped_out = Out()
        wrapped_state = self.wrapped_actor.on_start(id, wrapped_out)
        seq, pending = self._process_output(1, (), wrapped_out, o)
        return OrlState(
            next_send_seq=seq,
            msgs_pending_ack=pending,
            last_delivered_seqs=(),
            wrapped_state=wrapped_state,
        )

    def on_msg(self, id: Id, state: OrlState, src: Id, msg, o: Out):
        kind = msg[0]
        if kind == "Deliver":
            _, seq, inner = msg
            # Always ack to stop resends; drop if already delivered.
            o.send(src, ack_msg(seq))
            if seq <= self._last_delivered(state, src):
                return None
            wrapped_out = Out()
            next_wrapped = self.wrapped_actor.on_msg(
                id, state.wrapped_state, src, inner, wrapped_out
            )
            if is_no_op(next_wrapped, wrapped_out):
                return None
            next_seq, pending = self._process_output(
                state.next_send_seq, state.msgs_pending_ack, wrapped_out, o
            )
            delivered = tuple(
                sorted(
                    [(s, q) for s, q in state.last_delivered_seqs if s != src]
                    + [(src, seq)]
                )
            )
            return OrlState(
                next_send_seq=next_seq,
                msgs_pending_ack=pending,
                last_delivered_seqs=delivered,
                wrapped_state=(
                    next_wrapped
                    if next_wrapped is not None
                    else state.wrapped_state
                ),
            )
        if kind == "Ack":
            _, seq = msg
            pending = tuple(
                p for p in state.msgs_pending_ack if p[0] != seq
            )
            if pending == state.msgs_pending_ack:
                return None
            return OrlState(
                next_send_seq=state.next_send_seq,
                msgs_pending_ack=pending,
                last_delivered_seqs=state.last_delivered_seqs,
                wrapped_state=state.wrapped_state,
            )
        return None

    def on_timeout(self, id: Id, state: OrlState, timer, o: Out):
        if timer == NETWORK_TIMER:
            o.set_timer(NETWORK_TIMER, self.resend_interval)
            for seq, dst, inner in state.msgs_pending_ack:
                o.send(dst, deliver_msg(seq, inner))
            return None
        if timer[0] == "User":
            wrapped_out = Out()
            next_wrapped = self.wrapped_actor.on_timeout(
                id, state.wrapped_state, timer[1], wrapped_out
            )
            if is_no_op(next_wrapped, wrapped_out):
                return None
            next_seq, pending = self._process_output(
                state.next_send_seq, state.msgs_pending_ack, wrapped_out, o
            )
            return OrlState(
                next_send_seq=next_seq,
                msgs_pending_ack=pending,
                last_delivered_seqs=state.last_delivered_seqs,
                wrapped_state=(
                    next_wrapped
                    if next_wrapped is not None
                    else state.wrapped_state
                ),
            )
        return None
