"""Racy shared-counter models.

``Increment``: N threads each read the shared counter into a local, then write
local+1 back — the classic lost-update race; ``always "fin"`` is intentionally
falsifiable. ``IncrementLock``: the same machine guarded by a lock; ``"fin"``
and ``"mutex"`` hold.

Reference: ``examples/increment.rs`` and ``increment_lock.rs``. The host
side is the JAX package's ``models/increment.py`` as it is; the packed side,
the symmetry hooks included, is written batched in torch. The threads are
interchangeable, so both models support symmetry reduction (symmetric
``Increment(2)`` = 8 orbits).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core.batch import BatchableModel, gather_actors
from ..core.model import Model, Property
from ..ops.fingerprint import U32, avalanche32

# ProcState is (t, pc): thread-local value and program counter.


@dataclass(frozen=True)
class IncrementState:
    i: int
    s: Tuple[Tuple[int, int], ...]  # per-thread (t, pc)

    def representative(self) -> "IncrementState":
        return IncrementState(i=self.i, s=tuple(sorted(self.s)))


def _set_thread(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``(F, A, n)`` candidates of the ``(F, n)`` per-thread vector ``x``:
    action ``a`` (thread ``a``) writes ``value[:, a]`` at thread ``a``."""
    n = x.shape[1]
    own = torch.eye(n, dtype=torch.bool, device=x.device)  # (A, n), A == n
    return torch.where(own, value[:, :, None], x[:, None, :])


def _refine_threads(states, colors):
    """Per-thread data is fully local (no cross-thread references), so one
    equivariant round separates all non-automorphic threads."""
    return avalanche32(
        ((colors * 0x9E3779B1) & U32)
        ^ ((states["t"] * 0x01000193) & U32)
        ^ ((states["pc"] * 0xCC9E2D51) & U32)
    )


class Increment(Model, BatchableModel):
    """pc 1: may Read (t <- i, pc 2); pc 2: may Write (i <- t+1, pc 3).

    Packed layout (device path): ``i`` ``(F,)``, ``t``/``pc`` per-thread
    ``(F, N)``, u32 in int64. One dense action per thread (the pc uniquely
    selects the enabled op, so the successor set matches the host model's
    separate Read/Write actions exactly).
    """

    def __init__(self, thread_count: int):
        self.thread_count = thread_count

    def init_states(self):
        return [IncrementState(i=0, s=((0, 1),) * self.thread_count)]

    def actions(self, state, actions):
        for thread_id, (_t, pc) in enumerate(state.s):
            if pc == 1:
                actions.append(("Read", thread_id))
            elif pc == 2:
                actions.append(("Write", thread_id))

    def next_state(self, state, action):
        kind, n = action
        s = list(state.s)
        if kind == "Read":
            s[n] = (state.i, 2)
            return IncrementState(i=state.i, s=tuple(s))
        t, _pc = s[n]
        s[n] = (t, 3)
        return IncrementState(i=(t + 1) % 256, s=tuple(s))

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda _, state: sum(1 for _t, pc in state.s if pc == 3)
                == state.i,
            )
        ]

    # -- BatchableModel (packed protocol) ----------------------------------

    def packed_action_count(self) -> int:
        return self.thread_count

    def packed_init_states(self, device="cpu"):
        n = self.thread_count
        return {
            "i": torch.zeros((1,), dtype=torch.int64, device=device),
            "t": torch.zeros((1, n), dtype=torch.int64, device=device),
            "pc": torch.ones((1, n), dtype=torch.int64, device=device),
        }

    def packed_expand(self, states):
        i, t, pc = states["i"], states["t"], states["pc"]
        F, A = pc.shape
        # Action a runs thread a: the thread's pc picks its op.
        is_read = pc == 1
        valid = is_read | (pc == 2)
        cand = {
            "i": torch.where(is_read, i[:, None], (t + 1) & 0xFF),
            "t": _set_thread(t, torch.where(is_read, i[:, None], t)),
            "pc": _set_thread(pc, (pc + 1) & U32),
        }
        return cand, valid

    def packed_conditions(self):
        return [
            lambda st: (st["pc"] == 3).sum(dim=1) == st["i"],
        ]

    def packed_symmetry(self):
        from ..core.batch import permutation_tables

        return permutation_tables(self.thread_count)

    def packed_apply_permutation(self, states, new_to_old, old_to_new):
        return {
            "i": states["i"],
            "t": gather_actors(states["t"], new_to_old),
            "pc": gather_actors(states["pc"], new_to_old),
        }

    def packed_refine_colors(self, states, colors):
        return _refine_threads(states, colors)

    def pack_state(self, host_state: IncrementState):
        return {
            "i": torch.tensor(host_state.i, dtype=torch.int64),
            "t": torch.tensor([t for t, _pc in host_state.s], dtype=torch.int64),
            "pc": torch.tensor([pc for _t, pc in host_state.s], dtype=torch.int64),
        }

    def unpack_state(self, packed) -> IncrementState:
        return IncrementState(
            i=int(packed["i"]),
            s=tuple(
                (int(t), int(pc))
                for t, pc in zip(packed["t"].tolist(), packed["pc"].tolist())
            ),
        )


@dataclass(frozen=True)
class IncrementLockState:
    i: int
    lock: bool
    s: Tuple[Tuple[int, int], ...]

    def representative(self) -> "IncrementLockState":
        return IncrementLockState(i=self.i, lock=self.lock, s=tuple(sorted(self.s)))


class IncrementLock(Model, BatchableModel):
    """Same counter machine with a lock; both properties hold.

    Packed layout: ``i``/``lock`` ``(F,)``, ``t``/``pc`` ``(F, N)``; one
    dense action per thread (pc + lock uniquely select the enabled op).
    """

    def __init__(self, thread_count: int):
        self.thread_count = thread_count

    def init_states(self):
        return [
            IncrementLockState(i=0, lock=False, s=((0, 0),) * self.thread_count)
        ]

    def actions(self, state, actions):
        for thread_id, (_t, pc) in enumerate(state.s):
            if pc == 0 and not state.lock:
                actions.append(("Lock", thread_id))
            elif pc == 1:
                actions.append(("Read", thread_id))
            elif pc == 2:
                actions.append(("Write", thread_id))
            elif pc == 3 and state.lock:
                actions.append(("Release", thread_id))

    def next_state(self, state, action):
        kind, n = action
        s = list(state.s)
        t, pc = s[n]
        if kind == "Lock":
            s[n] = (t, 1)
            return IncrementLockState(i=state.i, lock=True, s=tuple(s))
        if kind == "Read":
            s[n] = (state.i, 2)
            return IncrementLockState(i=state.i, lock=state.lock, s=tuple(s))
        if kind == "Write":
            s[n] = (t, 3)
            return IncrementLockState(
                i=(t + 1) % 256, lock=state.lock, s=tuple(s)
            )
        s[n] = (t, 4)
        return IncrementLockState(i=state.i, lock=False, s=tuple(s))

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda _, state: sum(1 for _t, pc in state.s if pc >= 3)
                == state.i,
            ),
            Property.always(
                "mutex",
                lambda _, state: sum(1 for _t, pc in state.s if 1 <= pc < 4)
                <= 1,
            ),
        ]

    # -- BatchableModel (packed protocol) ----------------------------------

    def packed_action_count(self) -> int:
        return self.thread_count

    def packed_init_states(self, device="cpu"):
        n = self.thread_count
        z = torch.zeros((1,), dtype=torch.int64, device=device)
        return {
            "i": z,
            "lock": z.clone(),
            "t": torch.zeros((1, n), dtype=torch.int64, device=device),
            "pc": torch.zeros((1, n), dtype=torch.int64, device=device),
        }

    def packed_expand(self, states):
        i, lock = states["i"][:, None], states["lock"][:, None]
        t, pc = states["t"], states["pc"]
        unlocked = lock == 0
        is_lock = (pc == 0) & unlocked
        is_read = pc == 1
        is_write = pc == 2
        is_release = (pc == 3) & ~unlocked
        valid = is_lock | is_read | is_write | is_release
        cand = {
            "i": torch.where(is_write, (t + 1) & 0xFF, i),
            "lock": torch.where(is_lock, 1, torch.where(is_release, 0, lock)),
            "t": _set_thread(t, torch.where(is_read, i, t)),
            "pc": _set_thread(pc, (pc + 1) & U32),
        }
        return cand, valid

    def packed_conditions(self):
        return [
            lambda st: (st["pc"] >= 3).sum(dim=1) == st["i"],
            lambda st: ((st["pc"] >= 1) & (st["pc"] < 4)).sum(dim=1) <= 1,
        ]

    def packed_symmetry(self):
        from ..core.batch import permutation_tables

        return permutation_tables(self.thread_count)

    def packed_apply_permutation(self, states, new_to_old, old_to_new):
        return {
            "i": states["i"],
            "lock": states["lock"],
            "t": gather_actors(states["t"], new_to_old),
            "pc": gather_actors(states["pc"], new_to_old),
        }

    def packed_refine_colors(self, states, colors):
        # The lock holder is implied by ``pc``, not an id: one round
        # suffices, as for Increment.
        return _refine_threads(states, colors)

    def pack_state(self, host_state: IncrementLockState):
        return {
            "i": torch.tensor(host_state.i, dtype=torch.int64),
            "lock": torch.tensor(1 if host_state.lock else 0, dtype=torch.int64),
            "t": torch.tensor([t for t, _pc in host_state.s], dtype=torch.int64),
            "pc": torch.tensor([pc for _t, pc in host_state.s], dtype=torch.int64),
        }

    def unpack_state(self, packed) -> IncrementLockState:
        return IncrementLockState(
            i=int(packed["i"]),
            lock=bool(int(packed["lock"])),
            s=tuple(
                (int(t), int(pc))
                for t, pc in zip(packed["t"].tolist(), packed["pc"].tolist())
            ),
        )
