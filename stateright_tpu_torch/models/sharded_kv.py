"""Sharded key-value store with live key migration.

``K`` keys spread over ``S`` shards, clients writing (bounded version
counters), and a migration protocol that hands a key from its owner to a
destination shard in two steps (``MigrateStart`` marks the key in flight,
``MigrateComplete`` transfers ownership). The modeled bug is a write landing
while the key's handoff is in flight: with ``guarded=False`` (the default)
writes are accepted during migration and mark the key *torn*, violating
``always "no torn writes"``. ``guarded=True`` refuses writes on in-flight
keys, the fix.

The keys are independent, so a guarded model's space is the product of
one key's reachable states: 64 at S = 4, V = 3
(``ShardedKv(4, 1, 3, guarded=True)``), so ``64 ** K`` in all (16,777,216
at K = 4).

Properties:
- ``always "no torn writes"`` (antecedent: some migration in flight — the
  coverage ledger flags a run that never exercised migration as a vacuous
  pass). Violated when ``guarded=False`` at depth 2.
- ``always "no total tear"`` — every key torn at once (>= 2K actions from
  init), with the same antecedent.
- ``sometimes "fully migrated"`` — every key left its home shard.
- ``sometimes "saturated writes"`` — every key's version hit the cap.

The host side is the JAX package's ``models/sharded_kv.py`` as it is (same
state class, so host fingerprints and the reporter's golden strings agree);
the packed side is written batched in torch, candidates lane for lane equal
to ``jax.vmap`` of the JAX model's ``packed_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..core.batch import BatchableModel
from ..core.model import Model, Property

# ``inflight`` sentinel: no migration for this key.
_NONE = None


@dataclass(frozen=True)
class ShardedKvState:
    owner: Tuple[int, ...]       # key -> owning shard
    ver: Tuple[int, ...]         # key -> version counter
    inflight: Tuple[Optional[int], ...]  # key -> destination shard | None
    torn: Tuple[bool, ...]       # key -> a write raced its migration


class ShardedKv(Model, BatchableModel):
    """``S`` shards, ``K`` keys (home shard ``k % S``), versions bounded
    by ``V``. ``guarded=True`` is the fixed protocol (no writes while a
    key is in flight). ``retain`` keeps only the named properties (with
    their conditions and antecedents)."""

    def __init__(self, shards: int = 2, keys: int = 2, max_version: int = 1,
                 guarded: bool = False, retain=None):
        if shards < 2:
            raise ValueError("migration needs at least 2 shards")
        self.S = int(shards)
        self.K = int(keys)
        self.V = int(max_version)
        self.guarded = bool(guarded)
        self._retain = (
            tuple(retain)
            if retain is not None and not isinstance(retain, str)
            else ((retain,) if retain else None)
        )

    def _keep(self, items, props):
        if self._retain is None:
            return items
        kept = [x for p, x in zip(props, items) if p.name in self._retain]
        if len(kept) != len(self._retain):
            have = [p.name for p in props]
            raise ValueError(
                f"retain={self._retain!r} does not match properties {have!r}"
            )
        return kept

    def _home(self, k: int) -> int:
        return k % self.S

    # -- host model ---------------------------------------------------------

    def init_states(self) -> List[ShardedKvState]:
        return [
            ShardedKvState(
                owner=tuple(self._home(k) for k in range(self.K)),
                ver=(0,) * self.K,
                inflight=(_NONE,) * self.K,
                torn=(False,) * self.K,
            )
        ]

    def actions(self, state: ShardedKvState, actions: List) -> None:
        for k in range(self.K):
            if state.ver[k] < self.V and (
                not self.guarded or state.inflight[k] is _NONE
            ):
                actions.append(("Write", k))
            if state.inflight[k] is _NONE:
                for d in range(self.S):
                    if d != state.owner[k]:
                        actions.append(("MigrateStart", k, d))
            else:
                actions.append(("MigrateComplete", k))

    def next_state(self, state: ShardedKvState, action) -> ShardedKvState:
        kind, k = action[0], action[1]
        owner = list(state.owner)
        ver = list(state.ver)
        inflight = list(state.inflight)
        torn = list(state.torn)
        if kind == "Write":
            ver[k] += 1
            if inflight[k] is not _NONE:
                # The race: an accepted write while the key is mid-
                # handoff can land on the retiring owner and vanish.
                torn[k] = True
        elif kind == "MigrateStart":
            inflight[k] = action[2]
        elif kind == "MigrateComplete":
            owner[k] = inflight[k]
            inflight[k] = _NONE
        else:
            raise ValueError(f"unknown action {action!r}")
        return ShardedKvState(
            owner=tuple(owner), ver=tuple(ver),
            inflight=tuple(inflight), torn=tuple(torn),
        )

    def _all_properties(self) -> List[Property]:
        return [
            Property.always(
                "no torn writes",
                lambda _, s: not any(s.torn),
                antecedent=lambda _, s: any(f is not _NONE for f in s.inflight),
            ),
            Property.always(
                "no total tear",
                lambda _, s: not all(s.torn),
                antecedent=lambda _, s: any(f is not _NONE for f in s.inflight),
            ),
            Property.sometimes(
                "fully migrated",
                lambda m, s: all(s.owner[k] != m._home(k) for k in range(m.K)),
            ),
            Property.sometimes(
                "saturated writes",
                lambda m, s: all(v == m.V for v in s.ver),
            ),
        ]

    def properties(self) -> List[Property]:
        props = self._all_properties()
        return self._keep(props, props)

    # -- BatchableModel (packed protocol) -----------------------------------
    #
    # Packed layout (int64 tensors carrying the JAX package's u32 values,
    # lane axis first, (F, K) each):
    #   owner:    key -> owning shard
    #   ver:      key -> version
    #   inflight: key -> destination shard, S = none
    #   torn:     key -> 0/1
    #
    # Dense action ids (A = K + K*S + K):
    #   [0, K)           Write(k = aid)
    #   [K, K + K*S)     MigrateStart(k = (aid-K) // S, d = (aid-K) % S)
    #   [K + K*S, A)     MigrateComplete(k = aid - K - K*S)

    def packed_action_count(self) -> int:
        return self.K * (self.S + 2)

    def packed_action_labels(self):
        labels = [f"Write_{k}" for k in range(self.K)]
        for k in range(self.K):
            labels += [f"MigrateStart_{k}_to_{d}" for d in range(self.S)]
        labels += [f"MigrateComplete_{k}" for k in range(self.K)]
        return labels

    def packed_init_states(self, device="cpu"):
        K = self.K
        return {
            "owner": torch.tensor([[self._home(k) for k in range(K)]], dtype=torch.int64,
                                  device=device),
            "ver": torch.zeros((1, K), dtype=torch.int64, device=device),
            "inflight": torch.full((1, K), self.S, dtype=torch.int64, device=device),
            "torn": torch.zeros((1, K), dtype=torch.int64, device=device),
        }

    def packed_expand(self, states):
        """Every action of every state, ``(F, A, K)`` leaves: the JAX
        package's ``packed_step`` over the action axis, written with the
        action id as a broadcast axis."""
        K, S = self.K, self.S
        owner, ver = states["owner"], states["ver"]
        inflight, torn = states["inflight"], states["torn"]
        F = owner.shape[0]
        dev = owner.device
        aid = torch.arange(self.packed_action_count(), device=dev)  # (A,)
        is_write = aid < K
        is_start = (aid >= K) & (aid < K + K * S)
        is_complete = ~is_write & ~is_start
        k = torch.where(is_write, aid,
                        torch.where(is_start, (aid - K) // S, aid - K - K * S))
        k = k.clamp(0, K - 1)
        d = ((aid - K) % S).clamp(0, S - 1)

        # Each action's key column of every state: (F, A).
        own_k = owner[:, k]
        ver_k = ver[:, k]
        inf_k = inflight[:, k]
        key_free = inf_k == S
        write_ok = ver_k < self.V
        if self.guarded:
            write_ok = write_ok & key_free
        valid = torch.where(
            is_write, write_ok,
            torch.where(is_start, key_free & (d != own_k), ~key_free),
        )

        onehot = (torch.arange(K, device=dev)[None, :] == k[:, None])[None]  # (1, A, K)
        wr = onehot & is_write[None, :, None]
        st = onehot & is_start[None, :, None]
        cm = onehot & is_complete[None, :, None]
        free3 = key_free[:, :, None]  # (F, A, 1)
        new_ver = torch.where(wr, ver[:, None, :] + 1, ver[:, None, :])
        new_torn = torch.where(wr & ~free3, 1, torn[:, None, :])
        new_inflight = torch.where(
            st, d[None, :, None],
            torch.where(cm, S, inflight[:, None, :]),
        )
        new_owner = torch.where(cm, inf_k[:, :, None], owner[:, None, :])
        A = aid.shape[0]
        cand = {
            "owner": new_owner.expand(F, A, K),
            "ver": new_ver.expand(F, A, K),
            "inflight": new_inflight.expand(F, A, K),
            "torn": new_torn.expand(F, A, K),
        }
        return cand, valid

    def packed_conditions(self):
        def fully_migrated(st):
            # The home shards made on the device (no host copy: the
            # conditions run inside captured drain graphs).
            home = torch.arange(self.K, device=st["owner"].device) % self.S
            return (st["owner"] != home).all(dim=1)

        conds = [
            lambda st: ~(st["torn"] == 1).any(dim=1),
            lambda st: ~(st["torn"] == 1).all(dim=1),
            fully_migrated,
            lambda st: (st["ver"] == self.V).all(dim=1),
        ]
        return self._keep(conds, self._all_properties())

    def packed_antecedents(self):
        def inflight_any(st):
            return (st["inflight"] != self.S).any(dim=1)

        return self._keep(
            [inflight_any, inflight_any, None, None], self._all_properties()
        )

    def pack_state(self, host_state: ShardedKvState):
        return {
            "owner": torch.tensor(host_state.owner, dtype=torch.int64),
            "ver": torch.tensor(host_state.ver, dtype=torch.int64),
            "inflight": torch.tensor(
                [self.S if f is _NONE else f for f in host_state.inflight],
                dtype=torch.int64,
            ),
            "torn": torch.tensor([1 if t else 0 for t in host_state.torn],
                                 dtype=torch.int64),
        }

    def unpack_state(self, packed) -> ShardedKvState:
        return ShardedKvState(
            owner=tuple(int(o) for o in packed["owner"].tolist()),
            ver=tuple(int(v) for v in packed["ver"].tolist()),
            inflight=tuple(
                _NONE if int(f) == self.S else int(f)
                for f in packed["inflight"].tolist()
            ),
            torn=tuple(bool(t) for t in packed["torn"].tolist()),
        )
