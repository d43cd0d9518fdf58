"""Raft leader election, checked over lossy networks with timers and crashes.

The port of the JAX package's ``models/raft.py``. The scope is the election
subprotocol: election timers fire nondeterministically (every timing
interleaving is explored), candidates solicit votes, a majority quorum
elects a leader which announces itself by heartbeat.

Checked properties:

- ``always "election safety"``: at most one leader per term (Raft paper
  §5.2); holds under message loss, duplication and reordering.
- ``sometimes "leader elected"``: a leader exists.
- ``eventually "stable leader"``: falsifiable on purpose. Repeated split
  votes (or total message loss on a lossy network) can exhaust the term
  boundary with no leader elected, and the checker reports that
  counterexample: the time to it is the second end-to-end metric.

The term bound (``max_term``) is the state-space boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional

import numpy as np
import torch

from ..actor import Actor, ActorModel, Id, Network, Out, model_peers, model_timeout
from ..actor import packed_register as pr
from ..actor.packed import ActorPackedCodec, PackedActorModel, popcount32
from ..core.model import Expectation
from ..ops.fingerprint import U32

FOLLOWER, CANDIDATE, LEADER = "Follower", "Candidate", "Leader"
ELECTION = "Election"


def majority(cluster_size: int) -> int:
    return cluster_size // 2 + 1


# Messages (no embedded Ids: the envelope's src carries the sender):
#   ("RequestVote", term)
#   ("Vote", term)            -- a granted vote (denials are silent)
#   ("Heartbeat", term)


@dataclass(frozen=True)
class RaftState:
    role: str
    term: int
    voted_for: Optional[Id]
    votes: FrozenSet[Id]


class RaftActor(Actor):
    def __init__(self, peer_ids: List[Id]):
        self.peer_ids = peer_ids

    def name(self) -> str:
        return "Raft Server"

    def _cluster_size(self) -> int:
        return len(self.peer_ids) + 1

    def on_start(self, id: Id, o: Out) -> RaftState:
        o.set_timer(ELECTION, model_timeout())
        return RaftState(role=FOLLOWER, term=0, voted_for=None, votes=frozenset())

    def on_timeout(self, id: Id, state: RaftState, timer, o: Out):
        if timer != ELECTION:
            return None
        # Start (or restart, on split votes) an election.
        o.set_timer(ELECTION, model_timeout())
        term = state.term + 1
        votes = frozenset([id])
        if len(votes) >= majority(self._cluster_size()):
            # Single-node cluster: the self-vote is already a majority.
            o.cancel_timer(ELECTION)
            return RaftState(role=LEADER, term=term, voted_for=id, votes=votes)
        o.broadcast(self.peer_ids, ("RequestVote", term))
        return RaftState(role=CANDIDATE, term=term, voted_for=id, votes=votes)

    def on_msg(self, id: Id, state: RaftState, src: Id, msg, o: Out):
        kind, term = msg[0], msg[1]
        if kind == "RequestVote":
            if term > state.term:
                # Newer term: adopt it as a follower and grant the vote.
                o.send(src, ("Vote", term))
                return RaftState(role=FOLLOWER, term=term, voted_for=src, votes=frozenset())
            if (
                term == state.term
                and state.role == FOLLOWER
                and state.voted_for in (None, src)
            ):
                o.send(src, ("Vote", term))
                if state.voted_for == src:
                    return None  # duplicate request, vote resent
                return RaftState(role=FOLLOWER, term=term, voted_for=src, votes=state.votes)
            return None  # stale term or vote already cast: deny silently

        if kind == "Vote":
            if state.role != CANDIDATE or term != state.term:
                return None  # stale vote (e.g. from a previous election)
            votes = state.votes | {src}
            if len(votes) >= majority(self._cluster_size()):
                o.cancel_timer(ELECTION)
                o.broadcast(self.peer_ids, ("Heartbeat", state.term))
                return RaftState(role=LEADER, term=state.term, voted_for=state.voted_for,
                                 votes=votes)
            if votes == state.votes:
                return None  # duplicate vote
            return RaftState(role=CANDIDATE, term=state.term, voted_for=state.voted_for,
                             votes=votes)

        if kind == "Heartbeat":
            if term < state.term:
                return None  # stale leader
            if state.role == FOLLOWER and term == state.term:
                # Already following this term's leader; renewing the election
                # timer alone would be a no-op-with-timer (pruned).
                o.set_timer(ELECTION, model_timeout())
                return None
            o.set_timer(ELECTION, model_timeout())
            return RaftState(
                role=FOLLOWER,
                term=term,
                voted_for=state.voted_for if term == state.term else None,
                votes=frozenset(),
            )

        return None


class RaftPackedCodec(ActorPackedCodec):
    """Batched kernels for ``RaftActor``: the twin of the host callbacks
    above (state row ``[role, term, voted_for+1, votes_bitmask]``, message
    ``[kind, term]`` with kinds RequestVote=1 Vote=2 Heartbeat=3)."""

    msg_width = 2
    state_width = 4
    timer_values = [ELECTION]

    K_REQUEST_VOTE, K_VOTE, K_HEARTBEAT = 1, 2, 3
    _KIND_NAME = {1: "RequestVote", 2: "Vote", 3: "Heartbeat"}
    _KIND_CODE = {"RequestVote": 1, "Vote": 2, "Heartbeat": 3}
    _ROLE_CODE = {FOLLOWER: 0, CANDIDATE: 1, LEADER: 2}
    _ROLE_NAME = {0: FOLLOWER, 1: CANDIDATE, 2: LEADER}

    def __init__(self, server_count: int):
        self.n = server_count
        self.send_capacity = server_count

    # -- host <-> packed ---------------------------------------------------

    def pack_actor_state(self, i, s: RaftState) -> np.ndarray:
        votes = 0
        for v in s.votes:
            votes |= 1 << int(v)
        return np.array(
            [self._ROLE_CODE[s.role], s.term,
             0 if s.voted_for is None else int(s.voted_for) + 1, votes],
            np.uint32,
        )

    def unpack_actor_state(self, i, row) -> RaftState:
        votes = int(row[3])
        return RaftState(
            role=self._ROLE_NAME[int(row[0])],
            term=int(row[1]),
            voted_for=None if int(row[2]) == 0 else Id(int(row[2]) - 1),
            votes=frozenset(Id(b) for b in range(self.n) if votes & (1 << b)),
        )

    def pack_msg(self, msg) -> np.ndarray:
        return np.array([self._KIND_CODE[msg[0]], msg[1]], np.uint32)

    def unpack_msg(self, vec):
        return (self._KIND_NAME[int(vec[0])], int(vec[1]))

    # -- batched kernels ---------------------------------------------------

    def on_msg_branches(self, model):
        maj = majority(self.n)
        no_sends, send_row, broadcast = pr.trace_helpers(self, self.n)

        def on_msg(me, row, src, msg):
            L, dev = row.shape[0], row.device
            role, term, voted, votes = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
            kind, mterm = msg[:, 0], msg[:, 1]
            ns = no_sends(L, dev)
            zero = torch.zeros_like(kind)

            # --- RequestVote ---
            newer = mterm > term
            grant_same = (mterm == term) & (role == 0) & ((voted == 0) | (voted == src + 1))
            rv_grant = newer | grant_same
            rv_changed = newer | (grant_same & (voted != src + 1))
            rv_row = torch.stack([zero, torch.where(newer, mterm, term), src + 1,
                                  torch.where(newer, zero, votes)], dim=1)
            rv_row = torch.where(rv_changed[:, None], rv_row, row)
            # reply Vote(mterm) to src when granting
            rv_sends = ns.clone()
            rv_sends[:, 0].copy_(torch.where(
                rv_grant[:, None], send_row(L, dev, src, self.K_VOTE, mterm), ns[:, 0]))

            # --- Vote ---
            votes_new = votes | ((torch.ones_like(src) << src) & U32)
            is_cand = (role == 1) & (mterm == term)
            wins = popcount32(votes_new) >= maj
            v_changed = is_cand & (votes != votes_new)
            v_wins = is_cand & wins
            v_row = torch.stack([torch.where(v_wins, 2, 1), term, voted, votes_new], dim=1)
            v_row = torch.where((v_changed | v_wins)[:, None], v_row, row)
            v_sends = torch.where(v_wins[:, None, None],
                                  broadcast(me, self.K_HEARTBEAT, term), ns)
            v_cancel = torch.where(v_wins, 1, zero)

            # --- Heartbeat ---
            hb_live = mterm >= term
            hb_same_follower = (role == 0) & (mterm == term)
            hb_adopt = hb_live & ~hb_same_follower
            hb_row = torch.stack([zero, mterm, torch.where(mterm == term, voted, zero), zero],
                                 dim=1)
            hb_row = torch.where(hb_adopt[:, None], hb_row, row)
            hb_set = torch.where(hb_live, 1, zero)

            is_rv = kind == self.K_REQUEST_VOTE
            is_v = kind == self.K_VOTE
            row_out = torch.where(is_rv[:, None], rv_row,
                                  torch.where(is_v[:, None], v_row, hb_row))
            sends = torch.where(is_rv[:, None, None], rv_sends,
                                torch.where(is_v[:, None, None], v_sends, ns))
            set_bits = torch.where(is_rv | is_v, zero, hb_set)
            cancel_bits = torch.where(is_v, v_cancel, zero)
            changed = torch.where(is_rv, rv_changed,
                                  torch.where(is_v, v_changed | v_wins, hb_adopt))
            return row_out, sends, set_bits, cancel_bits, changed

        return [on_msg]

    def on_timeout_branches(self, model):
        maj = majority(self.n)
        no_sends, _send_row, broadcast = pr.trace_helpers(self, self.n)

        def on_timeout(me, row, bit):
            L, dev = row.shape[0], row.device
            term1 = (row[:, 1] + 1) & U32
            votes1 = (torch.ones_like(me) << me) & U32
            wins = popcount32(votes1) >= maj  # a single-node cluster only
            row_out = torch.stack([torch.where(wins, 2, 1), term1, me + 1, votes1], dim=1)
            sends = torch.where(wins[:, None, None], no_sends(L, dev),
                                broadcast(me, self.K_REQUEST_VOTE, term1))
            # Host: set_timer first, cancel on self-election — cancel wins.
            set_bits = torch.ones_like(me)
            cancel_bits = torch.where(wins, 1, 0)
            return row_out, sends, set_bits, cancel_bits, torch.ones_like(wins)

        return [on_timeout]

    # -- batched symmetry hooks -------------------------------------------------

    def rewrite_actor_row(self, model, rows, old_to_new):
        """``voted_for`` (stored +1, 0 = None) maps through the relabeling;
        the ``votes`` bitmask moves bit ``b`` to bit ``old_to_new[b]``.
        Messages carry no ids (the envelope src is the vote's identity).
        The shift is masked to stay defined when ``old_to_new`` carries
        refinement colors (arbitrary u32 names) instead of a permutation: a
        no-op for real permutations (ids < n <= 32), and under colors the
        bitmask becomes a commutative digest of the voters' (masked)
        colors, which is all refinement needs."""
        voted = rows[:, :, 2]
        safe = torch.where(voted == 0, 0, voted - 1)
        new_voted = torch.where(voted == 0, voted,
                                (torch.gather(old_to_new, 1, safe) + 1) & U32)
        bit = torch.arange(self.n, device=rows.device)
        bits = (rows[:, :, 3, None] >> bit) & 1  # (L, N, n)
        new_votes = (bits << (old_to_new[:, None, :] & 31)).sum(dim=2) & U32
        return torch.cat([rows[:, :, :2], new_voted[:, :, None], new_votes[:, :, None],
                          rows[:, :, 4:]], dim=2)

    # -- batched model hooks ---------------------------------------------------

    def packed_conditions(self, model):
        n = self.n
        crashes = bool(model._max_crashes)

        def leaders(states):
            lead = states["rows"][:, :, 0] == 2
            if crashes:
                lead = lead & (states["crashed"] == 0)
            return lead

        def election_safety(states):
            lead = leaders(states)
            term = states["rows"][:, :, 1]
            order = torch.arange(n, device=term.device)
            pair = (
                lead[:, :, None]
                & lead[:, None, :]
                & (term[:, :, None] == term[:, None, :])
                & (order[:, None] < order[None, :])
            )
            return ~pair.flatten(1).any(dim=1)

        def leader_elected(states):
            return leaders(states).any(dim=1)

        return [election_safety, leader_elected, leader_elected]

    def packed_within_boundary(self, model, states):
        return (states["rows"][:, :, 1] <= model.cfg.max_term).all(dim=1)

    def packed_row_within_boundary(self, model, rows):
        # The term cap above, one row at a time.
        return rows[:, 1] <= model.cfg.max_term


@dataclass
class RaftModelCfg:
    server_count: int = 5
    max_term: int = 2
    lossy: bool = True
    max_crashes: int = 0
    network: Network = field(default_factory=Network.new_unordered_nonduplicating)

    def into_model(self) -> ActorModel:
        n = self.server_count
        model = PackedActorModel(codec=RaftPackedCodec(n), cfg=self, init_history=None)
        # Distinct-envelope upper bound: 3 message kinds × directed pairs ×
        # live terms (boundary-pruned states keep message terms ≤ max_term).
        model.with_envelope_capacity(max(8, 3 * n * (n - 1) * self.max_term))
        for i in range(n):
            model.actor(RaftActor(model_peers(i, n)))

        def election_safety(_model, state):
            leaders = [
                s.term
                for s, crashed in zip(state.actor_states, state.crashed)
                if not crashed and s.role == LEADER
            ]
            return len(leaders) == len(set(leaders))

        def leader_elected(_model, state):
            # Crashed leaders don't count (as in election_safety): a dead
            # leader's cluster is leaderless.
            return any(
                s.role == LEADER
                for s, crashed in zip(state.actor_states, state.crashed)
                if not crashed
            )

        max_term = self.max_term
        return (
            model.init_network(self.network)
            .lossy_network(self.lossy)
            .max_crashes(self.max_crashes)
            .within_boundary_fn(
                lambda _cfg, state: all(s.term <= max_term for s in state.actor_states)
            )
            .property(Expectation.ALWAYS, "election safety", election_safety)
            .property(Expectation.SOMETIMES, "leader elected", leader_elected)
            .property(Expectation.EVENTUALLY, "stable leader", leader_elected)
        )
