"""Single Decree Paxos, checked for linearizability against a register spec.

The port of the JAX package's ``models/paxos.py``. Two clients / three
servers under an unordered non-duplicating network reach exactly 16,668
unique states; three clients / three servers with 24 envelope slots reach
1,194,428 ("paxos check 3"). The model is a ``PackedActorModel``: the same
actors check on the host oracle AND on the GPU checker, auxiliary
linearizability history included (bounded-width encoding + the batched
predicate of ``semantics/packed_linearizability.py``).

Reference: ``examples/paxos.rs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from ..actor import Actor, ActorModel, Id, Network, Out, model_peers
from ..actor.packed import PackedActorModel
from ..actor import packed_register as pr
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

DEFAULT_VALUE = "\x00"  # the register's initial value (reference: char::default)


def majority(cluster_size: int) -> int:
    """The minimum size of a majority within a cluster."""
    return cluster_size // 2 + 1


# Internal protocol messages are tagged tuples:
#   ("Prepare", ballot)
#   ("Prepared", ballot, last_accepted)
#   ("Accept", ballot, proposal)
#   ("Accepted", ballot)
#   ("Decided", ballot, proposal)
# ballot = (round, leader_id); proposal = (request_id, requester_id, value);
# last_accepted/accepted = None | (ballot, proposal).


def _accepted_sort_key(accepted):
    # None sorts below any accepted (ballot, proposal), like Rust's Option.
    return (0,) if accepted is None else (1, accepted)


@dataclass(frozen=True)
class PaxosState:
    # shared state
    ballot: Tuple[int, int]
    # leader state
    proposal: Optional[Tuple]
    prepares: Tuple  # sorted tuple of (acceptor_id, last_accepted)
    accepts: FrozenSet[Id]
    # acceptor state
    accepted: Optional[Tuple]
    is_decided: bool


class PaxosActor(Actor):
    def __init__(self, peer_ids: List[Id]):
        self.peer_ids = peer_ids

    def name(self) -> str:
        return "Paxos Server"

    def on_start(self, id: Id, o: Out) -> PaxosState:
        return PaxosState(
            ballot=(0, Id(0)),
            proposal=None,
            prepares=(),
            accepts=frozenset(),
            accepted=None,
            is_decided=False,
        )

    def on_msg(self, id: Id, state: PaxosState, src: Id, msg, o: Out):
        if state.is_decided:
            if isinstance(msg, Get):
                # Reply with the decided value (never reply "undecided": a
                # value may have been decided elsewhere with delivery pending).
                _b, (_req_id, _src, value) = state.accepted
                o.send(src, GetOk(msg.request_id, value))
            return None

        if isinstance(msg, Put) and state.proposal is None:
            ballot = (state.ballot[0] + 1, id)
            proposal = (msg.request_id, src, msg.value)
            # Simulate Prepare + Prepared self-sends.
            prepares = ((id, state.accepted),)
            o.broadcast(self.peer_ids, Internal(("Prepare", ballot)))
            return PaxosState(
                ballot=ballot,
                proposal=proposal,
                prepares=prepares,
                accepts=frozenset(),
                accepted=state.accepted,
                is_decided=False,
            )

        if isinstance(msg, Internal):
            inner = msg.msg
            kind = inner[0]
            if kind == "Prepare" and state.ballot < inner[1]:
                ballot = inner[1]
                o.send(
                    src, Internal(("Prepared", ballot, state.accepted))
                )
                return PaxosState(
                    ballot=ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=state.accepts,
                    accepted=state.accepted,
                    is_decided=False,
                )
            if kind == "Prepared" and inner[1] == state.ballot:
                ballot, last_accepted = inner[1], inner[2]
                prepares_map = dict(state.prepares)
                prepares_map[src] = last_accepted
                prepares = tuple(sorted(prepares_map.items()))
                proposal = state.proposal
                accepted = state.accepted
                accepts = state.accepts
                if len(prepares) == majority(len(self.peer_ids) + 1):
                    # Leadership handoff: favor the most recently accepted
                    # proposal from the prepare quorum; else the client's.
                    best = max(
                        prepares_map.values(), key=_accepted_sort_key
                    )
                    proposal = best[1] if best is not None else state.proposal
                    # Simulate Accept + Accepted self-sends.
                    accepted = (ballot, proposal)
                    accepts = frozenset([id])
                    o.broadcast(
                        self.peer_ids, Internal(("Accept", ballot, proposal))
                    )
                return PaxosState(
                    ballot=state.ballot,
                    proposal=proposal,
                    prepares=prepares,
                    accepts=accepts,
                    accepted=accepted,
                    is_decided=False,
                )
            if kind == "Accept" and state.ballot <= inner[1]:
                ballot, proposal = inner[1], inner[2]
                o.send(src, Internal(("Accepted", ballot)))
                return PaxosState(
                    ballot=ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=state.accepts,
                    accepted=(ballot, proposal),
                    is_decided=False,
                )
            if kind == "Accepted" and inner[1] == state.ballot:
                ballot = inner[1]
                accepts = state.accepts | {src}
                is_decided = state.is_decided
                if len(accepts) == majority(len(self.peer_ids) + 1):
                    is_decided = True
                    proposal = state.proposal
                    o.broadcast(
                        self.peer_ids, Internal(("Decided", ballot, proposal))
                    )
                    request_id, requester_id, _ = proposal
                    o.send(requester_id, PutOk(request_id))
                return PaxosState(
                    ballot=state.ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=accepts,
                    accepted=state.accepted,
                    is_decided=is_decided,
                )
            if kind == "Decided":
                ballot, proposal = inner[1], inner[2]
                return PaxosState(
                    ballot=ballot,
                    proposal=state.proposal,
                    prepares=state.prepares,
                    accepts=state.accepts,
                    accepted=(ballot, proposal),
                    is_decided=True,
                )
        return None


class PaxosPackedCodec(pr.RegisterProtocolCodec):
    """Packed kernels for ``PaxosActor`` + ``RegisterClient`` + the
    linearizability history — the batched twin of the host callbacks above.

    Server row (``R = 14 + 7*Ns`` u32 words):
    ``[b_rnd, b_ldr, has_prop, p_req, p_rqr, p_val, is_decided,
    has_acc, a_rnd, a_ldr, a_req, a_rqr, a_val, accepts_mask,
    then per server s: [present, has_la, la_rnd, la_ldr, la_req, la_rqr,
    la_val]]``. Client rows use the shared register layout (padded).

    Messages (``W = 9``): register kinds 1-4 (``packed_register``), then
    Prepare=5 ``[k, rnd, ldr]``, Prepared=6 ``[k, rnd, ldr, has_la, la_rnd,
    la_ldr, la_req, la_rqr, la_val]``, Accept=7 ``[k, rnd, ldr, req, rqr,
    val]``, Accepted=8 ``[k, rnd, ldr]``, Decided=9 (Accept layout).
    """

    K_PREPARE = pr.KIND_INTERNAL_BASE
    K_PREPARED = pr.KIND_INTERNAL_BASE + 1
    K_ACCEPT = pr.KIND_INTERNAL_BASE + 2
    K_ACCEPTED = pr.KIND_INTERNAL_BASE + 3
    K_DECIDED = pr.KIND_INTERNAL_BASE + 4

    msg_width = 9

    def __init__(self, client_count: int, server_count: int):
        self.state_width = 14 + 7 * server_count
        self.send_capacity = server_count
        self._init_register_protocol(client_count, server_count, DEFAULT_VALUE)

    # -- host <-> packed ---------------------------------------------------

    def pack_actor_state(self, i, s) -> np.ndarray:
        row = np.zeros((self.state_width,), np.uint32)
        if i >= self.server_count:
            return pr.pack_client_state(s, self.state_width)
        row[0], row[1] = s.ballot[0], int(s.ballot[1])
        if s.proposal is not None:
            row[2] = 1
            row[3], row[4], row[5] = (
                s.proposal[0],
                int(s.proposal[1]),
                ord(s.proposal[2]),
            )
        row[6] = 1 if s.is_decided else 0
        if s.accepted is not None:
            (rnd, ldr), (req, rqr, val) = s.accepted
            row[7:13] = [1, rnd, int(ldr), req, int(rqr), ord(val)]
        for v in s.accepts:
            row[13] |= np.uint32(1) << np.uint32(int(v))
        for acceptor, la in s.prepares:
            b = 14 + 7 * int(acceptor)
            row[b] = 1
            if la is not None:
                (rnd, ldr), (req, rqr, val) = la
                row[b + 1 : b + 7] = [1, rnd, int(ldr), req, int(rqr), ord(val)]
        return row

    def unpack_actor_state(self, i, row):
        if i >= self.server_count:
            return pr.unpack_client_state(row)
        row = np.asarray(row)

        def opt_bp(base):  # Option<(ballot, proposal)> at 6 words
            if not row[base]:
                return None
            return (
                (int(row[base + 1]), Id(int(row[base + 2]))),
                (int(row[base + 3]), Id(int(row[base + 4])), chr(row[base + 5])),
            )

        prepares = []
        for s in range(self.server_count):
            b = 14 + 7 * s
            if row[b]:
                prepares.append((Id(s), opt_bp(b + 1)))
        return PaxosState(
            ballot=(int(row[0]), Id(int(row[1]))),
            proposal=(
                (int(row[3]), Id(int(row[4])), chr(row[5]))
                if row[2]
                else None
            ),
            prepares=tuple(prepares),
            accepts=frozenset(
                Id(b)
                for b in range(self.server_count)
                if int(row[13]) & (1 << b)
            ),
            accepted=opt_bp(7),
            is_decided=bool(row[6]),
        )

    def pack_msg(self, msg) -> np.ndarray:
        vec = np.zeros((self.msg_width,), np.uint32)

        def put_bp(base, bp):  # (ballot, proposal) pair, no presence flag
            (rnd, ldr), (req, rqr, val) = bp
            vec[base : base + 5] = [rnd, int(ldr), req, int(rqr), ord(val)]

        if isinstance(msg, Put):
            vec[0], vec[1], vec[2] = pr.K_PUT, msg.request_id, ord(msg.value)
        elif isinstance(msg, Get):
            vec[0], vec[1] = pr.K_GET, msg.request_id
        elif isinstance(msg, PutOk):
            vec[0], vec[1] = pr.K_PUT_OK, msg.request_id
        elif isinstance(msg, GetOk):
            vec[0], vec[1], vec[2] = (
                pr.K_GET_OK,
                msg.request_id,
                ord(msg.value),
            )
        elif isinstance(msg, Internal):
            inner = msg.msg
            kind = inner[0]
            if kind == "Prepare":
                vec[0], vec[1], vec[2] = self.K_PREPARE, inner[1][0], int(inner[1][1])
            elif kind == "Prepared":
                vec[0], vec[1], vec[2] = self.K_PREPARED, inner[1][0], int(inner[1][1])
                if inner[2] is not None:
                    vec[3] = 1
                    (rnd, ldr), (req, rqr, val) = inner[2]
                    vec[4:9] = [rnd, int(ldr), req, int(rqr), ord(val)]
            elif kind == "Accept":
                vec[0], vec[1], vec[2] = self.K_ACCEPT, inner[1][0], int(inner[1][1])
                req, rqr, val = inner[2]
                vec[3:6] = [req, int(rqr), ord(val)]
            elif kind == "Accepted":
                vec[0], vec[1], vec[2] = self.K_ACCEPTED, inner[1][0], int(inner[1][1])
            elif kind == "Decided":
                vec[0], vec[1], vec[2] = self.K_DECIDED, inner[1][0], int(inner[1][1])
                req, rqr, val = inner[2]
                vec[3:6] = [req, int(rqr), ord(val)]
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
        ballot = (int(vec[1]), Id(int(vec[2])))
        if k == self.K_PREPARE:
            return Internal(("Prepare", ballot))
        if k == self.K_PREPARED:
            la = None
            if vec[3]:
                la = (
                    (int(vec[4]), Id(int(vec[5]))),
                    (int(vec[6]), Id(int(vec[7])), chr(vec[8])),
                )
            return Internal(("Prepared", ballot, la))
        prop = (int(vec[3]), Id(int(vec[4])), chr(vec[5]))
        if k == self.K_ACCEPT:
            return Internal(("Accept", ballot, prop))
        if k == self.K_ACCEPTED:
            return Internal(("Accepted", ballot))
        if k == self.K_DECIDED:
            return Internal(("Decided", ballot, prop))
        raise ValueError(f"unknown packed message kind: {k}")

    # -- batched kernels ---------------------------------------------------

    def on_msg_branches(self, model):
        Ns = self.server_count
        maj = majority(Ns)
        no_sends, send_row, broadcast = pr.trace_helpers(self, Ns)

        def lex_gt(a, b):
            """a > b over equal-length ``(L, K)`` u32 key vectors."""
            gt = torch.zeros_like(a[:, 0], dtype=torch.bool)
            eq = torch.ones_like(gt)
            for k in range(a.shape[1]):
                gt = gt | (eq & (a[:, k] > b[:, k]))
                eq = eq & (a[:, k] == b[:, k])
            return gt

        def server_on_msg(me, row, src, msg):
            L, dev = row.shape[0], row.device
            kind = msg[:, 0]
            ns = no_sends(L, dev)
            b_rnd, b_ldr = row[:, 0], row[:, 1]
            has_prop = row[:, 2]
            decided = row[:, 6]
            accepts = row[:, 13]
            mb_rnd, mb_ldr = msg[:, 1], msg[:, 2]

            def with_send(rows, s, row_s):
                out = rows.clone()
                out[:, s].copy_(row_s)
                return out

            # ---- decided: Get gets the decided value, all else ignored ----
            dec_get = kind == pr.K_GET
            dec_sends = torch.where(
                dec_get[:, None, None],
                with_send(ns, 0, send_row(L, dev, src, pr.K_GET_OK, msg[:, 1], row[:, 12])),
                ns,
            )

            # ---- Put (no proposal yet): start a new ballot ----------------
            put_fire = (kind == pr.K_PUT) & (has_prop == 0)
            nb_rnd = (b_rnd + 1) & U32
            put_row = pr.with_cols(row, {0: nb_rnd, 1: me, 2: 1, 3: msg[:, 1], 4: src,
                                         5: msg[:, 2], 13: 0})
            own_prep = torch.cat([torch.ones_like(row[:, :1]), row[:, 7:13]], dim=1)
            for s in range(Ns):
                b = 14 + 7 * s
                put_row[:, b : b + 7].copy_(torch.where((me == s)[:, None], own_prep, 0))
            put_sends = broadcast(me, self.K_PREPARE, nb_rnd, me)

            # ---- Prepare (msg ballot beats ours): adopt + answer ----------
            b_lt = (b_rnd < mb_rnd) | ((b_rnd == mb_rnd) & (b_ldr < mb_ldr))
            b_eq = (b_rnd == mb_rnd) & (b_ldr == mb_ldr)
            prep_fire = (kind == self.K_PREPARE) & b_lt
            prep_row = pr.with_cols(row, {0: mb_rnd, 1: mb_ldr})
            prep_sends = with_send(ns, 0, send_row(
                L, dev, src, self.K_PREPARED, mb_rnd, mb_ldr,
                *(row[:, k] for k in range(7, 13)),
            ))

            # ---- Prepared (for our current ballot) ------------------------
            pred_fire = (kind == self.K_PREPARED) & b_eq
            la_ent = torch.cat([torch.ones_like(msg[:, :1]), msg[:, 3:9]], dim=1)
            pred_row = row.clone()
            for s in range(Ns):
                b = 14 + 7 * s
                pred_row[:, b : b + 7].copy_(
                    torch.where((src == s)[:, None], la_ent, pred_row[:, b : b + 7])
                )
            count = sum(pred_row[:, 14 + 7 * s] for s in range(Ns)) & U32
            quorum = count == maj
            # Leadership handoff: max last_accepted over present prepares
            # (the leading present bit keeps absent entries from winning).
            best = pred_row[:, 14 : 14 + 7]
            for s in range(1, Ns):
                ent = pred_row[:, 14 + 7 * s : 14 + 7 * s + 7]
                best = torch.where(lex_gt(ent, best)[:, None], ent, best)
            best_has_la = best[:, 1] == 1
            q_req = torch.where(best_has_la, best[:, 4], row[:, 3])
            q_rqr = torch.where(best_has_la, best[:, 5], row[:, 4])
            q_val = torch.where(best_has_la, best[:, 6], row[:, 5])
            q_has = torch.where(best_has_la, 1, has_prop)
            q_row = pr.with_cols(pred_row, {
                2: q_has, 3: q_req, 4: q_rqr, 5: q_val, 7: 1, 8: mb_rnd, 9: mb_ldr,
                10: q_req, 11: q_rqr, 12: q_val, 13: (torch.ones_like(me) << me) & U32,
            })
            q_sends = broadcast(me, self.K_ACCEPT, mb_rnd, mb_ldr, q_req, q_rqr, q_val)
            pred_row = torch.where(quorum[:, None], q_row, pred_row)
            pred_sends = torch.where(quorum[:, None, None], q_sends, ns)

            # ---- Accept (ballot at or beyond ours): adopt + ack -----------
            acc_fire = (kind == self.K_ACCEPT) & (b_lt | b_eq)
            acc_row = pr.with_cols(row, {
                0: mb_rnd, 1: mb_ldr, 7: 1, 8: mb_rnd, 9: mb_ldr,
                10: msg[:, 3], 11: msg[:, 4], 12: msg[:, 5],
            })
            acc_sends = with_send(ns, 0, send_row(L, dev, src, self.K_ACCEPTED, mb_rnd,
                                                  mb_ldr))

            # ---- Accepted (for our ballot): count the quorum --------------
            actd_fire = (kind == self.K_ACCEPTED) & b_eq
            accepts2 = accepts | ((torch.ones_like(src) << src) & U32)
            popcount = ((accepts2[:, None] >> torch.arange(32, device=dev)) & 1).sum(dim=1)
            dec_quorum = popcount == maj
            actd_row = pr.with_cols(row, {13: accepts2,
                                          6: torch.where(dec_quorum, 1, decided)})
            dec_bcast = broadcast(me, self.K_DECIDED, b_rnd, b_ldr, row[:, 3], row[:, 4],
                                  row[:, 5])
            put_ok = send_row(L, dev, row[:, 4], pr.K_PUT_OK, row[:, 3])
            own = torch.arange(self.send_capacity, device=dev) == me[:, None]
            dec_bcast = torch.where(own[:, :, None], put_ok[:, None, :], dec_bcast)
            actd_sends = torch.where(dec_quorum[:, None, None], dec_bcast, ns)

            # ---- Decided: adopt unconditionally ---------------------------
            decd_fire = kind == self.K_DECIDED
            decd_row = pr.with_cols(row, {
                0: mb_rnd, 1: mb_ldr, 7: 1, 8: mb_rnd, 9: mb_ldr,
                10: msg[:, 3], 11: msg[:, 4], 12: msg[:, 5], 6: 1,
            })

            # ---- select (kinds are mutually exclusive) --------------------
            row_out, sends = row, ns
            for fire, r, sd in (
                (put_fire, put_row, put_sends),
                (prep_fire, prep_row, prep_sends),
                (pred_fire, pred_row, pred_sends),
                (acc_fire, acc_row, acc_sends),
                (actd_fire, actd_row, actd_sends),
                (decd_fire, decd_row, ns),
            ):
                row_out = torch.where(fire[:, None], r, row_out)
                sends = torch.where(fire[:, None, None], sd, sends)
            changed = put_fire | prep_fire | pred_fire | acc_fire | actd_fire | decd_fire
            is_dec = decided == 1
            row_out = torch.where(is_dec[:, None], row, row_out)
            sends = torch.where(is_dec[:, None, None], dec_sends, sends)
            changed = changed & ~is_dec
            zero = torch.zeros_like(kind)
            return row_out, sends, zero, zero, changed

        client = pr.client_on_msg_branch(self, self.put_count, Ns)
        return [server_on_msg, client]


@dataclass
class PaxosModelCfg:
    client_count: int
    server_count: int
    network: Network = field(
        default_factory=Network.new_unordered_nonduplicating
    )
    envelope_capacity: int = 16

    def into_model(self) -> ActorModel:
        model = PackedActorModel(
            codec=PaxosPackedCodec(self.client_count, self.server_count),
            cfg=self,
            init_history=LinearizabilityTester(Register(DEFAULT_VALUE)),
        ).with_envelope_capacity(self.envelope_capacity)
        for i in range(self.server_count):
            model.actor(PaxosActor(model_peers(i, self.server_count)))
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
