"""Register-protocol adapter: a message interface for register-like actors and
a client actor for model checking them against a ``ConsistencyTester``.

Clients do ``put_count`` Puts followed by a Get, round-robining servers via
``(index + op_count) % server_count``; ``record_invocations``/
``record_returns`` plug the message flow into any consistency tester used as
``ActorModel`` history.

Reference: ``src/actor/register.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..semantics.register import READ, ReadOk, Write, WRITE_OK
from .actor import Actor, Id, Out
from .network import Envelope


# -- the register message interface ------------------------------------------


@dataclass(frozen=True)
class Internal:
    """A message specific to the register system's internal protocol."""

    msg: object

    def __repr__(self):
        return f"Internal({self.msg!r})"


@dataclass(frozen=True)
class Put:
    request_id: int
    value: object

    def __repr__(self):
        return f"Put({self.request_id!r}, {self.value!r})"


@dataclass(frozen=True)
class Get:
    request_id: int

    def __repr__(self):
        return f"Get({self.request_id!r})"


@dataclass(frozen=True)
class PutOk:
    request_id: int

    def __repr__(self):
        return f"PutOk({self.request_id!r})"


@dataclass(frozen=True)
class GetOk:
    request_id: int
    value: object

    def __repr__(self):
        return f"GetOk({self.request_id!r}, {self.value!r})"


# -- history hooks -----------------------------------------------------------


def record_invocations(_cfg, history, env: Envelope):
    """Pass to ``ActorModel.record_msg_out``: records Read on Get, Write on
    Put (into a cloned tester; invalid histories are swallowed, matching the
    reference)."""
    if isinstance(env.msg, Get):
        h = history.clone()
        try:
            h.on_invoke(env.src, READ)
        except ValueError:
            pass
        return h
    if isinstance(env.msg, Put):
        h = history.clone()
        try:
            h.on_invoke(env.src, Write(env.msg.value))
        except ValueError:
            pass
        return h
    return None


def record_returns(_cfg, history, env: Envelope):
    """Pass to ``ActorModel.record_msg_in``: records ReadOk on GetOk, WriteOk
    on PutOk."""
    if isinstance(env.msg, GetOk):
        h = history.clone()
        try:
            h.on_return(env.dst, ReadOk(env.msg.value))
        except ValueError:
            pass
        return h
    if isinstance(env.msg, PutOk):
        h = history.clone()
        try:
            h.on_return(env.dst, WRITE_OK)
        except ValueError:
            pass
        return h
    return None


# -- the model-checking client actor -----------------------------------------


@dataclass(frozen=True)
class ClientState:
    awaiting: Optional[int]
    op_count: int

    def __repr__(self):
        return f"Client {{ awaiting: {self.awaiting!r}, op_count: {self.op_count!r} }}"


class RegisterClient(Actor):
    """A client that Puts ``put_count`` values then Gets, round-robining
    servers. Servers must precede clients in the actor list so destinations
    derive from ``(client_index + k) % server_count``."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def name(self) -> str:
        return "Client"

    def on_start(self, id: Id, o: Out) -> ClientState:
        index = int(id)
        server_count = self.server_count
        if index < server_count:
            raise ValueError(
                "RegisterClient actors must be added to the model after servers."
            )
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = index  # next will be 2 * index
        value = chr(ord("A") + (index - server_count))
        o.send(Id(index % server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def _completes_put(self, msg) -> bool:
        """Whether ``msg`` completes an outstanding Put (the write-once
        variant also accepts PutFail)."""
        return isinstance(msg, PutOk)

    def on_msg(self, id: Id, state: ClientState, src: Id, msg, o: Out):
        if not isinstance(state, ClientState) or state.awaiting is None:
            return None
        index = int(id)
        server_count = self.server_count
        if self._completes_put(msg) and msg.request_id == state.awaiting:
            unique_request_id = (state.op_count + 1) * index
            if state.op_count < self.put_count:
                value = chr(ord("Z") - (index - server_count))
                o.send(
                    Id((index + state.op_count) % server_count),
                    Put(unique_request_id, value),
                )
            else:
                o.send(
                    Id((index + state.op_count) % server_count),
                    Get(unique_request_id),
                )
            return ClientState(
                awaiting=unique_request_id, op_count=state.op_count + 1
            )
        if isinstance(msg, GetOk) and msg.request_id == state.awaiting:
            return ClientState(awaiting=None, op_count=state.op_count + 1)
        return None
