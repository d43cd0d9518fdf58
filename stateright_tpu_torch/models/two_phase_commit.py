"""Two-phase commit (subset of the Gray/Lamport "Consensus on Transaction
Commit" TLA+ spec).

State: per-RM states + transaction-manager state + prepared flags + a message
set. Exact oracle counts: 3 RMs = 288 states, 5 RMs = 8,832, 8 RMs =
1,745,408; under symmetry (orbits of the RM permutations) 5 RMs = 314,
9 RMs = 2,232.

Reference: ``examples/2pc.rs``. The host side is the JAX package's
``models/two_phase_commit.py`` as it is (same state class, so host
fingerprints and the reporter's golden strings agree, with its host group
action); the packed side, the symmetry hooks included, is written batched
in torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, List, Tuple

import torch

from ..core.batch import BatchableModel, gather_actors, lane_permutation
from ..core.model import Model, Property
from ..ops.fingerprint import U32, avalanche32
from ..utils.rewrite import RewritePlan

# RM states
WORKING, PREPARED, COMMITTED, ABORTED = "Working", "Prepared", "Committed", "Aborted"
# TM states
TM_INIT, TM_COMMITTED, TM_ABORTED = "Init", "Committed", "Aborted"
# Messages: ("Prepared", rm) | ("Commit",) | ("Abort",)
COMMIT_MSG = ("Commit",)
ABORT_MSG = ("Abort",)


def prepared_msg(rm: int) -> Tuple:
    return ("Prepared", rm)


@dataclass(frozen=True)
class TwoPhaseState:
    rm_state: Tuple[str, ...]
    tm_state: str
    tm_prepared: Tuple[bool, ...]
    msgs: FrozenSet[Tuple]

    def _permuted(self, plan: RewritePlan) -> "TwoPhaseState":
        return TwoPhaseState(
            rm_state=tuple(plan.reindex(self.rm_state)),
            tm_state=self.tm_state,
            tm_prepared=tuple(plan.reindex(self.tm_prepared)),
            msgs=frozenset(
                ("Prepared", plan.mapping[m[1]]) if m[0] == "Prepared" else m
                for m in self.msgs
            ),
        )

    def representative(self) -> "TwoPhaseState":
        # The reference's sort heuristic (``examples/2pc.rs:203-228``): NOT a
        # canonical form, see orbit_representative.
        return self._permuted(RewritePlan.from_values_to_sort(self.rm_state))

    def orbit_representative(self) -> "TwoPhaseState":
        """True orbit canonical form (``utils.rewrite.orbit_min``):
        traversal-order-independent, the semantics of the GPU checker's
        symmetry keys."""
        from ..utils.rewrite import orbit_min

        return orbit_min(len(self.rm_state), self._permuted)


# Packed codes. Order matters only for the packed representation.
_RM_CODE = {WORKING: 0, PREPARED: 1, COMMITTED: 2, ABORTED: 3}
_RM_NAME = {v: k for k, v in _RM_CODE.items()}
_TM_CODE = {TM_INIT: 0, TM_COMMITTED: 1, TM_ABORTED: 2}
_TM_NAME = {v: k for k, v in _TM_CODE.items()}


class TwoPhaseSys(Model, BatchableModel):
    def __init__(self, rm_count: int):
        self.rm_count = rm_count

    def init_states(self) -> List[TwoPhaseState]:
        return [
            TwoPhaseState(
                rm_state=(WORKING,) * self.rm_count,
                tm_state=TM_INIT,
                tm_prepared=(False,) * self.rm_count,
                msgs=frozenset(),
            )
        ]

    def actions(self, state: TwoPhaseState, actions: List) -> None:
        if state.tm_state == TM_INIT and all(state.tm_prepared):
            actions.append(("TmCommit",))
        if state.tm_state == TM_INIT:
            actions.append(("TmAbort",))
        for rm in range(self.rm_count):
            if state.tm_state == TM_INIT and prepared_msg(rm) in state.msgs:
                actions.append(("TmRcvPrepared", rm))
            if state.rm_state[rm] == WORKING:
                actions.append(("RmPrepare", rm))
                actions.append(("RmChooseToAbort", rm))
            if COMMIT_MSG in state.msgs:
                actions.append(("RmRcvCommitMsg", rm))
            if ABORT_MSG in state.msgs:
                actions.append(("RmRcvAbortMsg", rm))

    def next_state(self, state: TwoPhaseState, action) -> TwoPhaseState:
        kind = action[0]
        rm_state = list(state.rm_state)
        tm_prepared = list(state.tm_prepared)
        tm_state = state.tm_state
        msgs = state.msgs
        if kind == "TmRcvPrepared":
            tm_prepared[action[1]] = True
        elif kind == "TmCommit":
            tm_state = TM_COMMITTED
            msgs = msgs | {COMMIT_MSG}
        elif kind == "TmAbort":
            tm_state = TM_ABORTED
            msgs = msgs | {ABORT_MSG}
        elif kind == "RmPrepare":
            rm_state[action[1]] = PREPARED
            msgs = msgs | {prepared_msg(action[1])}
        elif kind == "RmChooseToAbort":
            rm_state[action[1]] = ABORTED
        elif kind == "RmRcvCommitMsg":
            rm_state[action[1]] = COMMITTED
        elif kind == "RmRcvAbortMsg":
            rm_state[action[1]] = ABORTED
        else:
            raise ValueError(f"unknown action {action!r}")
        return TwoPhaseState(
            rm_state=tuple(rm_state),
            tm_state=tm_state,
            tm_prepared=tuple(tm_prepared),
            msgs=msgs,
        )

    def properties(self) -> List[Property]:
        return [
            Property.sometimes(
                "abort agreement",
                lambda _, state: all(s == ABORTED for s in state.rm_state),
            ),
            Property.sometimes(
                "commit agreement",
                lambda _, state: all(s == COMMITTED for s in state.rm_state),
            ),
            Property.always(
                "consistent",
                lambda _, state: not (
                    ABORTED in state.rm_state and COMMITTED in state.rm_state
                ),
            ),
        ]

    # -- BatchableModel (packed protocol) ----------------------------------
    #
    # Packed state layout (int64 tensors carrying u32 values, lane axis
    # first; the same values as the JAX package's uint32 layout):
    #   rm:       (F, N) per-RM code (0=Working 1=Prepared 2=Committed 3=Aborted)
    #   tm:       (F,)   TM code     (0=Init 1=Committed 2=Aborted)
    #   prepared: (F,)   bitmask of tm_prepared flags
    #   msgs:     (F,)   bitmask: bit rm = Prepared{rm}, bit N = Commit,
    #                    bit N+1 = Abort
    #
    # Dense action ids (A = 2 + 5N):
    #   0 = TmCommit, 1 = TmAbort,
    #   2 + rm*5 + k with k: 0=TmRcvPrepared 1=RmPrepare 2=RmChooseToAbort
    #                        3=RmRcvCommitMsg 4=RmRcvAbortMsg

    def packed_action_count(self) -> int:
        return 2 + 5 * self.rm_count

    def packed_action_labels(self):
        # The dense ids' labels (the coverage ledger's per-action axis),
        # named as the host actions are.
        labels = ["TmCommit", "TmAbort"]
        for rm in range(self.rm_count):
            labels += [
                f"TmRcvPrepared_{rm}",
                f"RmPrepare_{rm}",
                f"RmChooseToAbort_{rm}",
                f"RmRcvCommitMsg_{rm}",
                f"RmRcvAbortMsg_{rm}",
            ]
        return labels

    def packed_init_states(self, device="cpu"):
        n = self.rm_count
        z = torch.zeros((1,), dtype=torch.int64, device=device)
        return {
            "rm": torch.zeros((1, n), dtype=torch.int64, device=device),
            "tm": z,
            "prepared": z.clone(),
            "msgs": z.clone(),
        }

    def packed_expand(self, states):
        n = self.rm_count
        rms, tm = states["rm"], states["tm"]
        prepared, msgs = states["prepared"], states["msgs"]
        dev = tm.device
        aid = torch.arange(self.packed_action_count(), device=dev)
        rm = ((aid - 2) // 5).clamp(0, n - 1)  # (A,)
        k = (aid - 2) % 5
        is_rm = aid >= 2
        bit = 1 << rm

        tm_init = (tm == 0)[:, None]  # (F, 1)
        all_prepared = (prepared == (1 << n) - 1)[:, None]
        commit_in = (((msgs >> n) & 1) == 1)[:, None]
        abort_in = (((msgs >> (n + 1)) & 1) == 1)[:, None]
        prep_msg_in = ((msgs[:, None] >> rm) & 1) == 1  # (F, A)
        rm_working = rms[:, rm] == 0  # (F, A)

        valid = torch.where(
            aid == 0, tm_init & all_prepared,
            torch.where(
                aid == 1, tm_init,
                torch.where(
                    k == 0, tm_init & prep_msg_in,
                    torch.where(
                        (k == 1) | (k == 2), rm_working,
                        torch.where(k == 3, commit_in, abort_in),
                    ),
                ),
            ),
        )

        zero = torch.zeros_like(aid)
        new_tm = torch.where(
            aid == 0, 1, torch.where(aid == 1, 2, tm[:, None])
        )
        new_msgs = msgs[:, None] | (
            torch.where(aid == 0, 1 << n, zero)
            | torch.where(aid == 1, 1 << (n + 1), zero)
            | torch.where(is_rm & (k == 1), bit, zero)
        )
        new_prepared = prepared[:, None] | torch.where(is_rm & (k == 0), bit, zero)
        # k: 1=Prepare->1, 2=ChooseToAbort->3, 3=RcvCommit->2, 4=RcvAbort->3
        rm_val = torch.where(
            k == 1, 1, torch.where(k == 2, 3, torch.where(k == 3, 2, 3))
        )
        writes = (torch.arange(n, device=dev)[None, :] == rm[:, None]) & (
            is_rm & (k != 0)
        )[:, None]  # (A, N)
        new_rms = torch.where(writes, rm_val[:, None], rms[:, None, :])
        F = tm.shape[0]
        A = aid.shape[0]
        cand = {
            "rm": new_rms,
            "tm": new_tm.expand(F, A),
            "prepared": new_prepared.expand(F, A),
            "msgs": new_msgs.expand(F, A),
        }
        return cand, valid.expand(F, A)

    def packed_conditions(self):
        return [
            lambda st: (st["rm"] == 3).all(dim=1),  # abort agreement
            lambda st: (st["rm"] == 2).all(dim=1),  # commit agreement
            lambda st: ~(
                (st["rm"] == 3).any(dim=1) & (st["rm"] == 2).any(dim=1)
            ),
        ]

    # -- symmetry (orbit-proper; see core/batch.py) ------------------------

    def packed_symmetry(self):
        from ..core.batch import permutation_tables

        return permutation_tables(self.rm_count)

    def packed_apply_permutation(self, states, new_to_old, old_to_new):
        """The RM-permutation group action on a batch: permute the per-RM
        codes and the RM-indexed bits of the prepared and message bitmasks
        (the device analog of the host ``TwoPhaseState._permuted``)."""
        n = self.rm_count
        L = states["tm"].shape[0]
        n2o = lane_permutation(new_to_old, L)
        shift = torch.arange(n, device=n2o.device)

        def permute_bits(mask):
            bits = (mask[:, None] >> n2o) & 1
            return (bits << shift).sum(dim=1)

        low_mask = (1 << n) - 1
        return {
            "rm": gather_actors(states["rm"], n2o),
            "tm": states["tm"],
            "prepared": permute_bits(states["prepared"]),
            "msgs": permute_bits(states["msgs"] & low_mask)
            | (states["msgs"] & (U32 ^ low_mask)),
        }

    def packed_refine_colors(self, states, colors):
        """Equivariant WL round (see ``core/batch.py``): each RM's view is
        fully local (its code, its ``prepared`` bit and its ``Prepared{rm}``
        message bit), so one round separates every non-automorphic pair and
        color ties are always automorphisms. The TM's fields are
        permutation-invariant and add nothing."""
        idx = torch.arange(self.rm_count, device=colors.device)
        prep = (states["prepared"][:, None] >> idx) & 1
        msg = (states["msgs"][:, None] >> idx) & 1
        return avalanche32(
            ((colors * 0x9E3779B1) & U32)
            ^ ((states["rm"] * 0x01000193) & U32)
            ^ (prep * 0xCC9E2D51)
            ^ (msg * 0x1B873593)
        )

    def pack_state(self, host_state: TwoPhaseState):
        n = self.rm_count
        msgs = 0
        for m in host_state.msgs:
            if m[0] == "Prepared":
                msgs |= 1 << m[1]
            elif m == COMMIT_MSG:
                msgs |= 1 << n
            elif m == ABORT_MSG:
                msgs |= 1 << (n + 1)
        prepared = 0
        for i, flag in enumerate(host_state.tm_prepared):
            if flag:
                prepared |= 1 << i
        return {
            "rm": torch.tensor(
                [_RM_CODE[s] for s in host_state.rm_state], dtype=torch.int64
            ),
            "tm": torch.tensor(_TM_CODE[host_state.tm_state], dtype=torch.int64),
            "prepared": torch.tensor(prepared, dtype=torch.int64),
            "msgs": torch.tensor(msgs, dtype=torch.int64),
        }

    def unpack_state(self, packed) -> TwoPhaseState:
        n = self.rm_count
        msgs_mask = int(packed["msgs"])
        msgs = set()
        for rm in range(n):
            if msgs_mask & (1 << rm):
                msgs.add(prepared_msg(rm))
        if msgs_mask & (1 << n):
            msgs.add(COMMIT_MSG)
        if msgs_mask & (1 << (n + 1)):
            msgs.add(ABORT_MSG)
        prepared = int(packed["prepared"])
        return TwoPhaseState(
            rm_state=tuple(_RM_NAME[int(c)] for c in packed["rm"].tolist()),
            tm_state=_TM_NAME[int(packed["tm"])],
            tm_prepared=tuple(bool(prepared & (1 << i)) for i in range(n)),
            msgs=frozenset(msgs),
        )
