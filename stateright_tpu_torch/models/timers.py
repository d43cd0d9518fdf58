"""Pinger actors driven purely by named timers — exercises the Timer plumbing
(set/cancel/renew, no-op-with-timer pruning).

Reference: ``examples/timers.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..actor import Actor, ActorModel, Id, Network, Out, model_peers, model_timeout
from ..core.model import Expectation

PING, PONG = "Ping", "Pong"
EVEN, ODD, NO_OP = "Even", "Odd", "NoOp"


@dataclass(frozen=True)
class PingerState:
    sent: int
    received: int


class PingerActor(Actor):
    def __init__(self, peer_ids: List[Id]):
        self.peer_ids = peer_ids

    def on_start(self, id: Id, o: Out) -> PingerState:
        o.set_timer(EVEN, model_timeout())
        o.set_timer(ODD, model_timeout())
        o.set_timer(NO_OP, model_timeout())
        return PingerState(sent=0, received=0)

    def on_msg(self, id: Id, state: PingerState, src: Id, msg, o: Out):
        if msg == PING:
            o.send(src, PONG)
            return None
        if msg == PONG:
            return PingerState(sent=state.sent, received=state.received + 1)
        return None

    def on_timeout(self, id: Id, state: PingerState, timer, o: Out):
        if timer == EVEN:
            o.set_timer(EVEN, model_timeout())
            sent = state.sent
            for dst in self.peer_ids:
                if int(dst) % 2 == 0:
                    sent += 1
                    o.send(dst, PING)
            return PingerState(sent=sent, received=state.received) if sent != state.sent else None
        if timer == ODD:
            o.set_timer(ODD, model_timeout())
            sent = state.sent
            for dst in self.peer_ids:
                if int(dst) % 2 != 0:
                    sent += 1
                    o.send(dst, PING)
            return PingerState(sent=sent, received=state.received) if sent != state.sent else None
        if timer == NO_OP:
            o.set_timer(NO_OP, model_timeout())
            return None
        return None


@dataclass
class PingerModelCfg:
    server_count: int
    network: Network = field(
        default_factory=Network.new_unordered_nonduplicating
    )

    def into_model(self) -> ActorModel:
        model = ActorModel(cfg=self, init_history=None)
        for i in range(self.server_count):
            model.actor(PingerActor(model_peers(i, self.server_count)))
        return model.init_network(self.network).property(
            Expectation.ALWAYS, "true", lambda _m, _s: True
        )
