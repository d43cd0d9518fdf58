"""Single-copy (non-replicated) register servers — linearizable with one
server (93 states for 2 clients), NOT linearizable with two.

The port of the JAX package's ``models/single_copy_register.py``, on
unordered and ordered networks alike.

Reference: ``examples/single-copy-register.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..actor import Actor, ActorModel, Id, Network, Out
from ..actor.packed import PackedActorModel
from ..actor import packed_register as pr
from ..actor.register import (
    Get,
    GetOk,
    Put,
    PutOk,
    RegisterClient,
    record_invocations,
    record_returns,
)
from ..core.model import Expectation
from ..semantics import LinearizabilityTester, Register

DEFAULT_VALUE = "\x00"


class SingleCopyActor(Actor):
    def on_start(self, id: Id, o: Out) -> str:
        return DEFAULT_VALUE

    def on_msg(self, id: Id, state: str, src: Id, msg, o: Out):
        if isinstance(msg, Put):
            o.send(src, PutOk(msg.request_id))
            return msg.value
        if isinstance(msg, Get):
            o.send(src, GetOk(msg.request_id, state))
            # Writing the same state back still counts as a write in the
            # reference (send side effect makes this a non-no-op anyway).
            return None
        return None


class SingleCopyPackedCodec(pr.RegisterProtocolCodec):
    """Packed kernels for the single-copy server + register clients.
    Server row ``[val, 0, 0]``; messages are the shared register kinds
    (``W = 3``: ``[kind, req, val]``)."""

    msg_width = 3
    state_width = pr.CLIENT_ROW_WORDS

    def __init__(self, client_count: int, server_count: int):
        self.send_capacity = 1
        self._init_register_protocol(client_count, server_count, DEFAULT_VALUE)

    def pack_actor_state(self, i, s) -> np.ndarray:
        if i >= self.server_count:
            return pr.pack_client_state(s, self.state_width)
        row = np.zeros((self.state_width,), np.uint32)
        row[0] = ord(s)
        return row

    def unpack_actor_state(self, i, row):
        if i >= self.server_count:
            return pr.unpack_client_state(row)
        return chr(np.asarray(row)[0])

    def pack_msg(self, msg) -> np.ndarray:
        vec = np.zeros((self.msg_width,), np.uint32)
        if isinstance(msg, Put):
            vec[:] = [pr.K_PUT, msg.request_id, ord(msg.value)]
        elif isinstance(msg, Get):
            vec[:2] = [pr.K_GET, msg.request_id]
        elif isinstance(msg, PutOk):
            vec[:2] = [pr.K_PUT_OK, msg.request_id]
        elif isinstance(msg, GetOk):
            vec[:] = [pr.K_GET_OK, msg.request_id, ord(msg.value)]
        else:
            raise TypeError(f"cannot pack message: {msg!r}")
        return vec

    def unpack_msg(self, vec):
        vec = np.asarray(vec)
        k = int(vec[0])
        if k == pr.K_PUT:
            return Put(int(vec[1]), chr(vec[2]))
        if k == pr.K_GET:
            return Get(int(vec[1]))
        if k == pr.K_PUT_OK:
            return PutOk(int(vec[1]))
        if k == pr.K_GET_OK:
            return GetOk(int(vec[1]), chr(vec[2]))
        raise ValueError(f"unknown packed message kind: {k}")

    def on_msg_branches(self, model):
        no_sends, send_row, _broadcast = pr.trace_helpers(self, self.server_count)

        def server_on_msg(me, row, src, msg):
            L, dev = row.shape[0], row.device
            kind, req = msg[:, 0], msg[:, 1]
            ns = no_sends(L, dev)
            is_put = kind == pr.K_PUT
            is_get = kind == pr.K_GET
            put_sends, get_sends = ns.clone(), ns.clone()
            put_sends[:, 0].copy_(send_row(L, dev, src, pr.K_PUT_OK, req))
            get_sends[:, 0].copy_(send_row(L, dev, src, pr.K_GET_OK, req, row[:, 0]))
            sends = torch.where(
                is_put[:, None, None], put_sends,
                torch.where(is_get[:, None, None], get_sends, ns),
            )
            row_out = pr.with_cols(row, {0: torch.where(is_put, msg[:, 2], row[:, 0])})
            zero = torch.zeros_like(kind)
            return row_out, sends, zero, zero, is_put

        client = pr.client_on_msg_branch(self, self.put_count, self.server_count)
        return [server_on_msg, client]


@dataclass
class SingleCopyModelCfg:
    client_count: int
    server_count: int
    network: Network = field(
        default_factory=Network.new_unordered_nonduplicating
    )
    envelope_capacity: int = 8

    def into_model(self) -> ActorModel:
        model = PackedActorModel(
            codec=SingleCopyPackedCodec(self.client_count, self.server_count),
            cfg=self,
            init_history=LinearizabilityTester(Register(DEFAULT_VALUE)),
        ).with_envelope_capacity(self.envelope_capacity)
        if self.network.kind == "ordered":
            # Register clients never message clients and nobody messages
            # itself. A flow depth of 2 is a bound the protocol cannot
            # exceed: a client sends each server at most a Put and then,
            # only after the PutOk, a Get, and the server sends the two
            # replies.
            model = model.with_flow_pairs(
                pr.register_flow_pairs(self.client_count, self.server_count)
            ).with_flow_capacity(2)
        for _ in range(self.server_count):
            model.actor(SingleCopyActor())
        for _ in range(self.client_count):
            model.actor(
                RegisterClient(put_count=1, server_count=self.server_count)
            )

        def value_chosen(_model, state):
            for env in state.network.iter_deliverable():
                if isinstance(env.msg, GetOk) and env.msg.value != DEFAULT_VALUE:
                    return True
            return False

        return (
            model.init_network(self.network)
            .property(
                Expectation.ALWAYS,
                "linearizable",
                lambda _, state: state.history.serialized_history() is not None,
            )
            .property(Expectation.SOMETIMES, "value chosen", value_chosen)
            .record_msg_in(record_returns)
            .record_msg_out(record_invocations)
        )
