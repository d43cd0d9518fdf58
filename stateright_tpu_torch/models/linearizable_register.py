"""ABD quorum register (Attiya, Bar-Noy, Dolev): a replicated register that
IS linearizable without consensus. 2 clients / 2 servers reach 544 unique
states on an unordered network and 620 over ordered flows; 3 clients / 2
servers over ordered flows reach 46,516 (``linearizable-register check 3
ordered``, a row of the reference's bench suite).

The port of the JAX package's ``models/linearizable_register.py``.

Internal protocol (tagged tuples inside ``Internal``):
  ("Query", req_id)
  ("AckQuery", req_id, seq, val)
  ("Record", req_id, seq, val)
  ("AckRecord", req_id)
where seq = (logical_clock, actor_id).

Reference: ``examples/linearizable-register.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..actor import Actor, ActorModel, Id, Network, Out, model_peers
from ..actor import packed_register as pr
from ..actor.packed import PackedActorModel, popcount32
from ..actor.register import (
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
    record_invocations,
    record_returns,
)
from ..core.model import Expectation
from ..ops.fingerprint import U32
from ..semantics import LinearizabilityTester, Register
from .paxos import majority

DEFAULT_VALUE = "\x00"


@dataclass(frozen=True)
class Phase1:
    request_id: int
    requester_id: Id
    write: Optional[str]  # Some(value) for Put, None for Get
    responses: Tuple  # sorted tuple of (actor_id, (seq, val))


@dataclass(frozen=True)
class Phase2:
    request_id: int
    requester_id: Id
    read: Optional[str]  # Some(value) for Get, None for Put
    acks: Tuple  # sorted tuple of actor ids


@dataclass(frozen=True)
class AbdState:
    seq: Tuple[int, int]
    val: str
    phase: object  # None | Phase1 | Phase2


class AbdActor(Actor):
    def __init__(self, peers: List[Id]):
        self.peers = peers

    def on_start(self, id: Id, o: Out) -> AbdState:
        return AbdState(seq=(0, id), val=DEFAULT_VALUE, phase=None)

    def on_msg(self, id: Id, state: AbdState, src: Id, msg, o: Out):
        if isinstance(msg, (Put, Get)) and state.phase is None:
            o.broadcast(self.peers, Internal(("Query", msg.request_id)))
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase1(
                    request_id=msg.request_id,
                    requester_id=src,
                    write=msg.value if isinstance(msg, Put) else None,
                    responses=((id, (state.seq, state.val)),),
                ),
            )
        if not isinstance(msg, Internal):
            return None
        inner = msg.msg
        kind = inner[0]

        if kind == "Query":
            o.send(src, Internal(("AckQuery", inner[1], state.seq, state.val)))
            return None

        if (
            kind == "AckQuery"
            and isinstance(state.phase, Phase1)
            and state.phase.request_id == inner[1]
        ):
            seq_in, val_in = inner[2], inner[3]
            phase = state.phase
            responses = dict(phase.responses)
            responses[src] = (seq_in, val_in)
            if len(responses) == majority(len(self.peers) + 1):
                # Quorum reached; move to phase 2. Sequencers are distinct, so
                # max-by-seq is deterministic.
                seq, val = max(responses.values(), key=lambda sv: sv[0])
                read = None
                if phase.write is not None:
                    seq = (seq[0] + 1, id)
                    val = phase.write
                else:
                    read = val
                o.broadcast(self.peers, Internal(("Record", phase.request_id, seq, val)))
                # Self-send Record.
                new_seq, new_val = state.seq, state.val
                if seq > state.seq:
                    new_seq, new_val = seq, val
                # Self-send AckRecord.
                return AbdState(
                    seq=new_seq,
                    val=new_val,
                    phase=Phase2(
                        request_id=phase.request_id,
                        requester_id=phase.requester_id,
                        read=read,
                        acks=(id,),
                    ),
                )
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase1(
                    request_id=phase.request_id,
                    requester_id=phase.requester_id,
                    write=phase.write,
                    responses=tuple(sorted(responses.items())),
                ),
            )

        if kind == "Record":
            seq_in, val_in = inner[2], inner[3]
            o.send(src, Internal(("AckRecord", inner[1])))
            if seq_in > state.seq:
                return AbdState(seq=seq_in, val=val_in, phase=state.phase)
            return None

        if (
            kind == "AckRecord"
            and isinstance(state.phase, Phase2)
            and state.phase.request_id == inner[1]
            and src not in state.phase.acks
        ):
            phase = state.phase
            acks = tuple(sorted(set(phase.acks) | {src}))
            if len(acks) == majority(len(self.peers) + 1):
                if phase.read is not None:
                    o.send(phase.requester_id, GetOk(phase.request_id, phase.read))
                else:
                    o.send(phase.requester_id, PutOk(phase.request_id))
                return AbdState(seq=state.seq, val=state.val, phase=None)
            return AbdState(
                seq=state.seq,
                val=state.val,
                phase=Phase2(
                    request_id=phase.request_id,
                    requester_id=phase.requester_id,
                    read=phase.read,
                    acks=acks,
                ),
            )
        return None


class AbdPackedCodec(pr.RegisterProtocolCodec):
    """Batched kernels for ``AbdActor`` + ``RegisterClient`` + history.

    Server row (``R = 9 + 4*Ns``):
    ``[seq_clock, seq_id, val, phase_kind, ph_req, ph_rqr, ph_has_val,
    ph_val, acks_mask, then per server s: [present, clock, sid, val]]``
    where ``ph_has_val``/``ph_val`` hold Phase1's pending write or Phase2's
    pending read (told apart by ``phase_kind``), and the per-server slots
    hold Phase1's query responses. Client rows use the shared register
    layout.

    Messages (``W = 5``): register kinds 1-4, then Query=5 ``[k, req]``,
    AckQuery=6 / Record=7 ``[k, req, clock, sid, val]``, AckRecord=8
    ``[k, req]``.
    """

    K_QUERY = pr.KIND_INTERNAL_BASE
    K_ACK_QUERY = pr.KIND_INTERNAL_BASE + 1
    K_RECORD = pr.KIND_INTERNAL_BASE + 2
    K_ACK_RECORD = pr.KIND_INTERNAL_BASE + 3

    msg_width = 5

    def __init__(self, client_count: int, server_count: int):
        self.state_width = 9 + 4 * server_count
        self.send_capacity = server_count
        self._init_register_protocol(client_count, server_count, DEFAULT_VALUE)

    # -- host <-> packed ---------------------------------------------------

    def pack_actor_state(self, i, s) -> np.ndarray:
        if i >= self.server_count:
            return pr.pack_client_state(s, self.state_width)
        row = np.zeros((self.state_width,), np.uint32)
        row[0], row[1], row[2] = s.seq[0], int(s.seq[1]), ord(s.val)
        if isinstance(s.phase, Phase1):
            row[3] = 1
            row[4], row[5] = s.phase.request_id, int(s.phase.requester_id)
            if s.phase.write is not None:
                row[6], row[7] = 1, ord(s.phase.write)
            for sid, (seq, val) in s.phase.responses:
                b = 9 + 4 * int(sid)
                row[b : b + 4] = [1, seq[0], int(seq[1]), ord(val)]
        elif isinstance(s.phase, Phase2):
            row[3] = 2
            row[4], row[5] = s.phase.request_id, int(s.phase.requester_id)
            if s.phase.read is not None:
                row[6], row[7] = 1, ord(s.phase.read)
            for a in s.phase.acks:
                row[8] |= np.uint32(1 << int(a))
        return row

    def unpack_actor_state(self, i, row):
        if i >= self.server_count:
            return pr.unpack_client_state(row)
        row = np.asarray(row)
        phase = None
        if int(row[3]) == 1:
            responses = []
            for s in range(self.server_count):
                b = 9 + 4 * s
                if row[b]:
                    responses.append(
                        (Id(s), ((int(row[b + 1]), Id(int(row[b + 2]))), chr(row[b + 3])))
                    )
            phase = Phase1(
                request_id=int(row[4]),
                requester_id=Id(int(row[5])),
                write=chr(row[7]) if row[6] else None,
                responses=tuple(responses),
            )
        elif int(row[3]) == 2:
            phase = Phase2(
                request_id=int(row[4]),
                requester_id=Id(int(row[5])),
                read=chr(row[7]) if row[6] else None,
                acks=tuple(Id(b) for b in range(self.server_count) if int(row[8]) & (1 << b)),
            )
        return AbdState(seq=(int(row[0]), Id(int(row[1]))), val=chr(row[2]), phase=phase)

    def pack_msg(self, msg) -> np.ndarray:
        vec = np.zeros((self.msg_width,), np.uint32)
        if isinstance(msg, Put):
            vec[:3] = [pr.K_PUT, msg.request_id, ord(msg.value)]
        elif isinstance(msg, Get):
            vec[:2] = [pr.K_GET, msg.request_id]
        elif isinstance(msg, PutOk):
            vec[:2] = [pr.K_PUT_OK, msg.request_id]
        elif isinstance(msg, GetOk):
            vec[:3] = [pr.K_GET_OK, msg.request_id, ord(msg.value)]
        elif isinstance(msg, Internal):
            inner = msg.msg
            kind = inner[0]
            if kind == "Query":
                vec[:2] = [self.K_QUERY, inner[1]]
            elif kind in ("AckQuery", "Record"):
                k = self.K_ACK_QUERY if kind == "AckQuery" else self.K_RECORD
                vec[:5] = [k, inner[1], inner[2][0], int(inner[2][1]), ord(inner[3])]
            elif kind == "AckRecord":
                vec[:2] = [self.K_ACK_RECORD, inner[1]]
            else:
                raise ValueError(f"unknown internal message: {inner!r}")
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
        if k == self.K_QUERY:
            return Internal(("Query", int(vec[1])))
        seq = (int(vec[2]), Id(int(vec[3])))
        if k == self.K_ACK_QUERY:
            return Internal(("AckQuery", int(vec[1]), seq, chr(vec[4])))
        if k == self.K_RECORD:
            return Internal(("Record", int(vec[1]), seq, chr(vec[4])))
        if k == self.K_ACK_RECORD:
            return Internal(("AckRecord", int(vec[1])))
        raise ValueError(f"unknown packed message kind: {k}")

    # -- batched kernels ---------------------------------------------------

    def on_msg_branches(self, model):
        Ns = self.server_count
        maj = majority(Ns)
        no_sends, send_row, broadcast = pr.trace_helpers(self, Ns)

        def seq_gt(c1, s1, c2, s2):
            return (c1 > c2) | ((c1 == c2) & (s1 > s2))

        def server_on_msg(me, row, src, msg):
            L, dev = row.shape[0], row.device
            kind, req = msg[:, 0], msg[:, 1]
            ns = no_sends(L, dev)
            sq_c, sq_s, val = row[:, 0], row[:, 1], row[:, 2]
            phase, ph_req, ph_rqr = row[:, 3], row[:, 4], row[:, 5]
            ph_has, ph_val, acks = row[:, 6], row[:, 7], row[:, 8]
            zero = torch.zeros_like(kind)

            def with_send0(row_s):
                out = ns.clone()
                out[:, 0].copy_(row_s)
                return out

            # ---- Put/Get (idle): start phase 1 ----------------------------
            is_put = kind == pr.K_PUT
            start_fire = (is_put | (kind == pr.K_GET)) & (phase == 0)
            start_row = pr.with_cols(row, {3: 1, 4: req, 5: src,
                                           6: torch.where(is_put, 1, zero),
                                           7: torch.where(is_put, msg[:, 2], zero)})
            own_resp = torch.stack([torch.ones_like(sq_c), sq_c, sq_s, val], dim=1)
            for s in range(Ns):
                b = 9 + 4 * s
                start_row[:, b : b + 4].copy_(torch.where((me == s)[:, None], own_resp, 0))
            start_sends = broadcast(me, self.K_QUERY, req)

            # ---- Query: answer with current (seq, val) --------------------
            query_fire = kind == self.K_QUERY
            query_sends = with_send0(send_row(L, dev, src, self.K_ACK_QUERY, req, sq_c,
                                              sq_s, val))

            # ---- AckQuery (phase 1, matching request) ---------------------
            ackq_fire = (kind == self.K_ACK_QUERY) & (phase == 1) & (ph_req == req)
            resp_ent = torch.cat([torch.ones_like(msg[:, :1]), msg[:, 2:5]], dim=1)
            aq_row = row.clone()
            for s in range(Ns):
                b = 9 + 4 * s
                aq_row[:, b : b + 4].copy_(
                    torch.where((src == s)[:, None], resp_ent, aq_row[:, b : b + 4]))
            count = sum(aq_row[:, 9 + 4 * s] for s in range(Ns)) & U32
            quorum = count == maj
            # max response by seq (sequencers are distinct).
            best = aq_row[:, 9:13]
            for s in range(1, Ns):
                ent = aq_row[:, 9 + 4 * s : 13 + 4 * s]
                better = (ent[:, 0] > best[:, 0]) | (
                    (ent[:, 0] == best[:, 0])
                    & seq_gt(ent[:, 1], ent[:, 2], best[:, 1], best[:, 2])
                )
                best = torch.where(better[:, None], ent, best)
            m_c, m_s, m_v = best[:, 1], best[:, 2], best[:, 3]
            write = ph_has == 1
            n_c = torch.where(write, (m_c + 1) & U32, m_c)  # a write bumps the clock
            n_s = torch.where(write, me, m_s)
            n_v = torch.where(write, ph_val, m_v)
            adopt = seq_gt(n_c, n_s, sq_c, sq_s)
            q_row = pr.with_cols(aq_row, {
                0: torch.where(adopt, n_c, sq_c),
                1: torch.where(adopt, n_s, sq_s),
                2: torch.where(adopt, n_v, val),
                3: 2,
                6: torch.where(write, zero, 1),
                7: torch.where(write, zero, m_v),
                8: (torch.ones_like(me) << me) & U32,
            })
            q_row[:, 9 : 9 + 4 * Ns].zero_()
            q_sends = broadcast(me, self.K_RECORD, ph_req, n_c, n_s, n_v)
            aq_row = torch.where(quorum[:, None], q_row, aq_row)
            aq_sends = torch.where(quorum[:, None, None], q_sends, ns)

            # ---- Record: ack; adopt if newer ------------------------------
            rec_fire = kind == self.K_RECORD
            rec_adopt = seq_gt(msg[:, 2], msg[:, 3], sq_c, sq_s)
            rec_row = pr.with_cols(row, {
                0: torch.where(rec_adopt, msg[:, 2], sq_c),
                1: torch.where(rec_adopt, msg[:, 3], sq_s),
                2: torch.where(rec_adopt, msg[:, 4], val),
            })
            rec_sends = with_send0(send_row(L, dev, src, self.K_ACK_RECORD, req))

            # ---- AckRecord (phase 2, matching, new acker) -----------------
            ackr_fire = (
                (kind == self.K_ACK_RECORD)
                & (phase == 2)
                & (ph_req == req)
                & (((acks >> src) & 1) == 0)
            )
            acks2 = acks | ((torch.ones_like(src) << src) & U32)
            r_quorum = popcount32(acks2) == maj
            done_row = pr.with_cols(row, {3: 0, 4: 0, 5: 0, 6: 0, 7: 0, 8: 0})
            cont_row = pr.with_cols(row, {8: acks2})
            ar_row = torch.where(r_quorum[:, None], done_row, cont_row)
            reply = torch.where(
                (ph_has == 1)[:, None],
                send_row(L, dev, ph_rqr, pr.K_GET_OK, ph_req, ph_val),
                send_row(L, dev, ph_rqr, pr.K_PUT_OK, ph_req),
            )
            ar_sends = torch.where(r_quorum[:, None, None], with_send0(reply), ns)

            # ---- select ----------------------------------------------------
            row_out, sends = row, ns
            changed = torch.zeros_like(kind, dtype=torch.bool)
            for fire, r, sd, ch in (
                (start_fire, start_row, start_sends, True),
                (query_fire, row, query_sends, False),
                (ackq_fire, aq_row, aq_sends, True),
                (rec_fire, rec_row, rec_sends, rec_adopt),
                (ackr_fire, ar_row, ar_sends, True),
            ):
                row_out = torch.where(fire[:, None], r, row_out)
                sends = torch.where(fire[:, None, None], sd, sends)
                changed = torch.where(fire, ch, changed)
            return row_out, sends, zero, zero, changed

        client = pr.client_on_msg_branch(self, self.put_count, Ns)
        return [server_on_msg, client]


@dataclass
class AbdModelCfg:
    client_count: int
    server_count: int
    network: Network = field(default_factory=Network.new_unordered_nonduplicating)
    envelope_capacity: int = 8
    # Ordered networks only: the per-flow FIFO depth. None picks 2 for 2
    # servers (the quorum is every server, so every reply drains before the
    # client's next phase; the pinned 2c/2s and 3c/2s counts hold it) and 8
    # otherwise (with 3+ servers a laggard replica's server-to-server FIFO
    # grows with each coordinated op, so no small bound is safe). Either way
    # it is a modelling boundary: an overflowing send prunes the transition.
    flow_capacity: Optional[int] = None

    def into_model(self) -> ActorModel:
        model = PackedActorModel(
            codec=AbdPackedCodec(self.client_count, self.server_count),
            cfg=self,
            init_history=LinearizabilityTester(Register(DEFAULT_VALUE)),
        ).with_envelope_capacity(self.envelope_capacity)
        if self.network.kind == "ordered":
            # Clients never message clients and nobody messages itself: the
            # flows are the pairs the protocol can use.
            if self.flow_capacity is not None:
                depth = self.flow_capacity
            else:
                depth = 2 if self.server_count == 2 else 8
            model = model.with_flow_pairs(
                pr.register_flow_pairs(self.client_count, self.server_count)
            ).with_flow_capacity(depth)
        for i in range(self.server_count):
            model.actor(AbdActor(model_peers(i, self.server_count)))
        for _ in range(self.client_count):
            model.actor(RegisterClient(put_count=1, server_count=self.server_count))

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
