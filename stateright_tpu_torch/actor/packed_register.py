"""Packed helpers for register-protocol actor systems (paxos, single-copy, ABD).

The port of the JAX package's ``actor/packed_register.py``. The reference's
register harness (``src/actor/register.rs``) pairs protocol servers with
``RegisterActor`` clients and plugs the message flow into a consistency
tester through history hooks. This module is the batched twin shared by
every such codec:

- canonical message kind codes for the client-facing protocol (codecs place
  their internal protocol kinds at ``KIND_INTERNAL_BASE`` and up);
- pack/unpack and the batched ``on_msg`` kernel for ``RegisterClient`` rows;
- the history hooks mapping Put/Get sends to tester invocations and
  PutOk/GetOk deliveries to returns (host analogs: ``record_invocations`` /
  ``record_returns`` in ``actor/register.py``).

Every kernel takes a leading lane axis ``L`` and u32 values in int64.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..ops.fingerprint import U32
from .packed import ActorPackedCodec
from .register import ClientState

# Client-facing message kinds, shared across register-protocol codecs.
# 0 is reserved (empty envelope slots hash as zeros).
K_PUT, K_GET, K_PUT_OK, K_GET_OK = 1, 2, 3, 4
KIND_INTERNAL_BASE = 5

# Client rows are [has_awaiting, awaiting, op_count]; codecs pad to their
# server row width.
CLIENT_ROW_WORDS = 3

Word = Union[int, torch.Tensor]


def pack_client_state(state: ClientState, width: int) -> np.ndarray:
    row = np.zeros((width,), np.uint32)
    if state.awaiting is not None:
        row[0] = 1
        row[1] = state.awaiting
    row[2] = state.op_count
    return row


def unpack_client_state(row) -> ClientState:
    return ClientState(
        awaiting=int(row[1]) if int(row[0]) else None,
        op_count=int(row[2]),
    )


def with_cols(row: torch.Tensor, cols: Dict[int, Word]) -> torch.Tensor:
    """A copy of ``(L, R)`` rows with the given columns replaced (the
    batched ``row.at[i].set(v)`` chain); a value is an int or an ``(L,)``
    tensor. Writes in place into the copy, never from host memory."""
    out = row.clone()
    for i, v in cols.items():
        if isinstance(v, torch.Tensor):
            out[:, i].copy_(v)
        else:
            out[:, i].fill_(v)
    return out


def words_row(L: int, width: int, words, device) -> torch.Tensor:
    """An ``(L, width)`` block whose first columns are ``words`` (ints or
    ``(L,)`` tensors) and the rest zero."""
    cols = [
        w if isinstance(w, torch.Tensor)
        else torch.full((L,), w, dtype=torch.int64, device=device)
        for w in words
    ]
    cols += [torch.zeros(L, dtype=torch.int64, device=device)] * (width - len(cols))
    return torch.stack(cols, dim=1)


def trace_helpers(codec, server_count: int):
    """(no_sends, send_row, broadcast) builders shared by server kernels: a
    blank ``(L, S, 1+W)`` send table, one ``(L, 1+W)`` send row ``[dst,
    words..., pad]``, and a broadcast giving every server its own row with
    ``me``'s left blank."""
    W, S = codec.msg_width, codec.send_capacity

    def no_sends(L, device):
        return torch.full((L, S, 1 + W), codec.SEND_NONE, dtype=torch.int64,
                          device=device)

    def send_row(L, device, dst, *words):
        return words_row(L, 1 + W, (dst,) + words, device)

    def broadcast(me, *words):
        L, dev = me.shape[0], me.device
        rows = no_sends(L, dev)
        for s in range(server_count):
            row = send_row(L, dev, s, *words)
            rows[:, s].copy_(torch.where((me == s)[:, None], rows[:, s], row))
        return rows

    return no_sends, send_row, broadcast


def client_on_msg_branch(codec, put_count: int, server_count: int):
    """The batched twin of ``RegisterClient.on_msg``: PutOk advances to the
    next Put or the final Get; GetOk completes the run. Round-robin
    destination ``(index + op_count) % server_count``, request id
    ``(op_count + 1) * index``, values ``'Z' - (index - server_count)``."""
    W = codec.msg_width
    no_sends, _send_row, _broadcast = trace_helpers(codec, server_count)

    def on_msg(me, row, src, msg):
        L, dev = row.shape[0], row.device
        kind, req = msg[:, 0], msg[:, 1]
        has_aw, aw, opc = row[:, 0], row[:, 1], row[:, 2]
        awaited = (has_aw == 1) & (req == aw)
        put_done = (kind == K_PUT_OK) & awaited
        get_done = (kind == K_GET_OK) & awaited

        nreq = ((opc + 1) * me) & U32
        dst = ((me + opc) & U32) % server_count
        zval = (ord("Z") - (me - server_count)) & U32
        next_msg = torch.where(
            (opc < put_count)[:, None],
            words_row(L, W, (K_PUT, nreq, zval), dev),
            words_row(L, W, (K_GET, nreq, 0), dev),
        )
        p_sends = no_sends(L, dev)
        p_sends[:, 0].copy_(torch.cat([dst[:, None], next_msg], dim=1))
        opc1 = (opc + 1) & U32
        p_row = with_cols(row, {0: 1, 1: nreq, 2: opc1})
        g_row = with_cols(row, {0: 0, 1: 0, 2: opc1})
        row_out = torch.where(put_done[:, None], p_row,
                              torch.where(get_done[:, None], g_row, row))
        sends = torch.where(put_done[:, None, None], p_sends, no_sends(L, dev))
        zero = torch.zeros_like(kind)
        return row_out, sends, zero, zero, put_done | get_done

    return on_msg


def make_history_hooks(lin, server_count: int):
    """(history_on_deliver, history_on_send) for a codec whose client threads
    are actors ``server_count..N`` and whose messages use the kind codes
    above. ``lin`` is a ``PackedRegisterLinearizability``."""
    C = lin.C

    def on_send(model, hist, src, dst, msg):
        # record_invocations: a Put/Get entering the network invokes
        # Write/Read for thread = the sender.
        kind = msg[:, 0]
        is_put = kind == K_PUT
        is_get = kind == K_GET
        c = (src - server_count).clamp(0, C - 1)
        active = (src >= server_count) & (is_put | is_get)
        op_kind = torch.where(is_put, 1, 2)
        return lin.on_invoke(hist, c, op_kind, msg[:, 2], active)

    def on_deliver(model, hist, src, dst, msg):
        # record_returns: a PutOk/GetOk delivered to a client returns
        # WriteOk/ReadOk(value) for thread = the recipient.
        kind = msg[:, 0]
        is_ret = (kind == K_PUT_OK) | (kind == K_GET_OK)
        c = (dst - server_count).clamp(0, C - 1)
        active = (dst >= server_count) & is_ret
        return lin.on_return(hist, c, msg[:, 2], active)

    return on_deliver, on_send


class RegisterProtocolCodec(ActorPackedCodec):
    """Shared base for register-protocol codecs (paxos, single-copy, ABD):
    servers are actor type 0, clients type 1, and the auxiliary history is a
    packed ``LinearizabilityTester`` with the standard hooks and conditions
    (``always linearizable``, ``sometimes value chosen``)."""

    put_count = 1

    def _init_register_protocol(self, client_count, server_count, default_value):
        from ..semantics.packed_linearizability import PackedRegisterLinearizability

        self.client_count = client_count
        self.server_count = server_count
        self._lin = PackedRegisterLinearizability(
            thread_ids=range(server_count, server_count + client_count),
            ops_per_thread=self.put_count + 1,
            default_value=default_value,
        )
        self.history_width = self._lin.width
        self._hooks = make_history_hooks(self._lin, server_count)

    def actor_type_id(self, i, actor) -> int:
        return 0 if i < self.server_count else 1

    def pack_history(self, history) -> np.ndarray:
        return self._lin.pack(history)

    def unpack_history(self, vec):
        return self._lin.unpack(vec)

    def history_on_deliver(self, model, hist, src, dst, msg):
        return self._hooks[0](model, hist, src, dst, msg)

    def history_on_send(self, model, hist, src, dst, msg):
        return self._hooks[1](model, hist, src, dst, msg)

    def packed_conditions(self, model):
        lin_ok = self._lin.predicate()
        return [
            lambda states: lin_ok(states["hist"]),
            value_chosen_condition(model),
        ]


def value_chosen_condition(model):
    """Batched twin of the examples' ``sometimes "value chosen"``: some
    deliverable GetOk carries a non-default value. On an ordered network
    "deliverable" means the flow heads only (host ``iter_deliverable``)."""

    def cond(states):
        if model._ordered:
            msg = states["flow_msg"][:, :, 0]
            live = states["flow_len"] > 0
        else:
            msg = states["net_msg"]
            live = states["net_cnt"] > 0
        return (live & (msg[:, :, 0] == K_GET_OK) & (msg[:, :, 2] != 0)).any(dim=1)

    return cond


def register_flow_pairs(client_count: int, server_count: int):
    """Directed flow pairs a register-protocol system can ever use on an
    ordered network: every ``(src, dst)`` pair except self-pairs and
    client-to-client ones (clients message only servers; servers message
    clients and, in ABD's replication, other servers). For 3 clients and 2
    servers this keeps 14 of 25 pairs (``PackedActorModel.with_flow_pairs``).
    An excluded pair that the protocol did use would prune transitions, and
    the pinned counts would show it."""
    n = server_count + client_count
    return [
        (a, b)
        for a in range(n)
        for b in range(n)
        if a != b and not (a >= server_count and b >= server_count)
    ]
