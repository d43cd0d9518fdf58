"""Device-side linearizability: bounded-width packed histories + a batched
serialization-search predicate, in torch.

The port of the JAX package's ``semantics/packed_linearizability.py``; the
packed encoding is the same word for word, and every function here is
batched over a leading lane axis (u32 values in int64).

The host ``LinearizabilityTester`` (``semantics/linearizability.py``, ported
from ``src/semantics/linearizability.rs:57-312``) is
recursive and pointer-heavy — infeasible to trace. SURVEY §7's "hard parts"
names the alternative implemented here: *bound op counts and precompute
serializability tables*. For register-protocol workloads every client thread
performs a statically bounded number of operations (``put_count`` Puts then
one Get), so

- the tester state packs into a fixed-width u32 vector: per thread, a
  completed-op count plus ``O`` op slots ``[kind, value, constraint[C]]``
  where ``constraint[p]`` records peer ``p``'s completed-op count at
  invocation time (the host's ``completed_map`` real-time constraint in
  dense form), with slot ``j == count`` holding the in-flight op if any;
- the Wing&Gong search becomes a *data-parallel scan over a precomputed
  interleaving table*: every program-order-respecting interleaving of the
  per-thread op streams (a multinomial — e.g. 6 for 2 threads × 2 ops),
  crossed with the 2^C choices of which in-flight ops to linearize. Each
  (interleaving, inclusion) lane replays the register semantics and the
  real-time constraints with masks; the history is linearizable iff any
  lane validates. All shapes are static, so the whole predicate runs in the
  wave's model stage (and in a captured drain graph) with no host round
  trip.

Encoding invariants (bijective with the host tester for reachable register
histories — exact-count parity depends on it):
- ``hist[0]``: ``is_valid_history`` (1/0). Invalid histories freeze.
- thread ``c`` occupies ``1 + c*TW .. 1 + (c+1)*TW`` with
  ``TW = 1 + O*(2+C)``: count word, then op slots in program order.
- op kinds: 0 = absent, 1 = write (value = written char), 2 = read
  (value = returned char for completed reads, 0 while in flight).
- an empty ``history_by_thread`` entry on the host co-occurs with an
  in-flight op, so "thread ever invoked" is recoverable from the slots.
"""

from __future__ import annotations

from itertools import product
from typing import List, Sequence

import numpy as np
import torch

from ..actor.actor import Id
from .linearizability import LinearizabilityTester
from .register import READ, ReadOk, Register, Write, WRITE_OK


def _interleavings(C: int, O: int):
    """All orderings of C streams × O slots that respect stream order:
    (S, M) arrays of thread ids and occurrence indexes, M = C*O."""
    M = C * O
    seqs: List[List[int]] = []

    def rec(prefix, used):
        if len(prefix) == M:
            seqs.append(list(prefix))
            return
        for t in range(C):
            if used[t] < O:
                used[t] += 1
                prefix.append(t)
                rec(prefix, used)
                prefix.pop()
                used[t] -= 1

    rec([], [0] * C)
    seq_t = np.array(seqs, np.int32)
    seq_j = np.zeros_like(seq_t)
    for s in range(seq_t.shape[0]):
        occ = [0] * C
        for pos in range(M):
            t = int(seq_t[s, pos])
            seq_j[s, pos] = occ[t]
            occ[t] += 1
    return seq_t, seq_j


class PackedRegisterLinearizability:
    """Packs ``LinearizabilityTester(Register(default))`` histories for
    ``thread_ids`` client threads with at most ``ops_per_thread`` operations
    each, and builds the batched hooks + predicate."""

    def __init__(
        self,
        thread_ids: Sequence,
        ops_per_thread: int,
        default_value: str,
    ):
        self.thread_ids = [int(t) for t in thread_ids]
        self.C = len(self.thread_ids)
        self.O = ops_per_thread
        self.default_value = default_value
        self.TW = 1 + self.O * (2 + self.C)
        self.width = 1 + self.C * self.TW
        self._dense = {t: c for c, t in enumerate(self.thread_ids)}

    # -- host <-> packed ----------------------------------------------------

    def pack(self, tester: LinearizabilityTester) -> np.ndarray:
        C, O = self.C, self.O
        out = np.zeros((self.width,), np.uint32)
        out[0] = 1 if tester.is_valid_history else 0

        def constraint_vec(completed_map):
            vec = np.zeros((C,), np.uint32)
            for peer, last_idx in completed_map:
                vec[self._dense[int(peer)]] = last_idx + 1
            return vec

        def slot_base(c, j):
            return 1 + c * self.TW + 1 + j * (2 + C)

        for t, entries in tester.history_by_thread.items():
            c = self._dense[int(t)]
            if len(entries) > O:
                raise ValueError(
                    f"thread {t} has {len(entries)} completed ops; "
                    f"ops_per_thread={O} is too small"
                )
            out[1 + c * self.TW] = len(entries)
            for j, (completed_map, op, ret) in enumerate(entries):
                b = slot_base(c, j)
                if op[0] == "Write":
                    out[b] = 1
                    out[b + 1] = ord(op[1])
                else:  # READ; ret = ReadOk(value)
                    out[b] = 2
                    out[b + 1] = ord(ret[1])
                out[b + 2 : b + 2 + C] = constraint_vec(completed_map)
        for t, (completed_map, op) in tester.in_flight_by_thread.items():
            c = self._dense[int(t)]
            j = int(out[1 + c * self.TW])
            if j >= O:
                raise ValueError(
                    f"thread {t} in-flight op overflows ops_per_thread={O}"
                )
            b = slot_base(c, j)
            if op[0] == "Write":
                out[b] = 1
                out[b + 1] = ord(op[1])
            else:
                out[b] = 2
            out[b + 2 : b + 2 + C] = constraint_vec(completed_map)
        return out

    def unpack(self, vec) -> LinearizabilityTester:
        C, O = self.C, self.O
        vec = np.asarray(vec)
        tester = LinearizabilityTester(Register(self.default_value))
        tester.is_valid_history = bool(vec[0])

        def read_slot(c, j):
            b = 1 + c * self.TW + 1 + j * (2 + C)
            kind = int(vec[b])
            value = int(vec[b + 1])
            constr = vec[b + 2 : b + 2 + C]
            completed_map = tuple(
                sorted(
                    (self.thread_ids[p], int(constr[p]) - 1)
                    for p in range(C)
                    if constr[p] > 0
                )
            )
            return kind, value, completed_map

        for c, t in enumerate(self.thread_ids):
            tid = Id(t)
            count = int(vec[1 + c * self.TW])
            entries = []
            for j in range(count):
                kind, value, completed_map = read_slot(c, j)
                if kind == 1:
                    entries.append((completed_map, Write(chr(value)), WRITE_OK))
                else:
                    entries.append((completed_map, READ, ReadOk(chr(value))))
            in_flight = None
            if count < O:
                kind, value, completed_map = read_slot(c, count)
                if kind == 1:
                    in_flight = (completed_map, Write(chr(value)))
                elif kind == 2:
                    in_flight = (completed_map, READ)
            if entries or in_flight is not None:
                tester.history_by_thread[tid] = entries
            if in_flight is not None:
                tester.in_flight_by_thread[tid] = in_flight
        return tester

    # -- batched structure helpers -------------------------------------------

    def _split(self, hist):
        """(valid (L,), counts (L, C), slots (L, C, O, 2+C)) of ``(L, width)``
        histories."""
        C, O = self.C, self.O
        L = hist.shape[0]
        body = hist[:, 1:].reshape(L, C, self.TW)
        return hist[:, 0], body[:, :, 0], body[:, :, 1:].reshape(L, C, O, 2 + C)

    def _join(self, valid, counts, slots):
        L = valid.shape[0]
        body = torch.cat([counts[:, :, None], slots.reshape(L, self.C, -1)], dim=2)
        return torch.cat([valid[:, None], body.reshape(L, -1)], dim=1)

    def _select(self, counts, c):
        """The one-hot masks of thread ``c`` (``(L, C)``) and of its slot
        ``j = clip(count, 0, O - 1)`` (``(L, C, O)``), and its count."""
        C, O = self.C, self.O
        dev = counts.device
        selc = torch.arange(C, device=dev) == c[:, None]
        cnt = (counts * selc).sum(dim=1)
        j = cnt.clamp(0, O - 1)
        sel = selc[:, :, None] & (torch.arange(O, device=dev) == j[:, None])[:, None, :]
        return selc, sel, cnt

    # -- batched recording hooks --------------------------------------------

    def on_invoke(self, hist, c, kind, value, active):
        """Records an invocation by dense thread ``c`` (``(L,)``) per lane.
        Mirrors host ``on_invoke``: double-in-flight invalidates the
        history; the constraint vector snapshots peer completed counts."""
        valid, counts, slots = self._split(hist)
        selc, sel, cnt = self._select(counts, c)
        cur = (slots * sel[..., None]).sum(dim=(1, 2))  # (L, 2 + C)
        bad = (cur[:, 0] != 0) | (cnt >= self.O)
        new_slot = torch.cat(
            [kind[:, None], value[:, None], torch.where(selc, 0, counts)], dim=1
        )
        live = active & (valid == 1)
        apply = sel & (live & ~bad)[:, None, None]
        slots = torch.where(apply[..., None], new_slot[:, None, None, :], slots)
        valid = torch.where(live & bad, 0, valid)
        return self._join(valid, counts, slots)

    def on_return(self, hist, c, ret_value, active):
        """Records a return for dense thread ``c``: completes the in-flight
        op (reads store the returned value); a return with no in-flight op
        invalidates the history (host ``on_return``)."""
        valid, counts, slots = self._split(hist)
        selc, sel, cnt = self._select(counts, c)
        cur = (slots * sel[..., None]).sum(dim=(1, 2))
        kind = cur[:, 0]
        has_inflight = (kind != 0) & (cnt < self.O)
        live = active & (valid == 1)
        apply = live & has_inflight
        new_value = torch.where(kind == 2, ret_value, cur[:, 1])
        col = torch.arange(2 + self.C, device=hist.device) == 1
        write = (sel & apply[:, None, None])[..., None] & col
        slots = torch.where(write, new_value[:, None, None, None], slots)
        counts = counts + (selc & apply[:, None]).to(counts.dtype)
        valid = torch.where(live & ~has_inflight, 0, valid)
        return self._join(valid, counts, slots)

    # -- the batched predicate ------------------------------------------------

    def predicate(self, real_time: bool = True):
        """Builds ``fn(hist) -> (L,) bool``: True iff a serialization exists.

        The JAX package's dynamic programming over *consumption vectors*: a
        node is the vector of per-thread consumed-op counts; per node a
        bitmask over the value universe (default + each slot's value) holds
        the register values some program-order-respecting prefix reaches
        there. A transition consumes thread ``t``'s next op (its slot index
        is the node's own count, so every index is static); real-time
        constraints depend only on the node, and acceptance allows stopping
        at any node that consumed every completed op, so in-flight ops need
        no 2^C factor. ``real_time=False`` decides sequential consistency.
        Every shape is static and no host table reaches the device, so the
        predicate runs inside a captured drain."""
        C, O = self.C, self.O
        nodes = sorted(product(range(O + 1), repeat=C), key=lambda c: (sum(c), c))
        node_idx = {c: i for i, c in enumerate(nodes)}
        default = ord(self.default_value)
        V = 1 + C * O  # value universe: default + one per op slot
        if V > 32:
            raise ValueError(
                f"packed linearizability supports at most 31 ops total "
                f"({C} clients x {O} ops = {C * O})"
            )

        def fn(hist):
            valid, counts, slots = self._split(hist)
            L = hist.shape[0]
            dev = hist.device
            bits = torch.ones(V, dtype=torch.int64, device=dev) << torch.arange(
                V, device=dev
            )
            U = torch.cat([
                torch.full((L, 1), default, dtype=torch.int64, device=dev),
                slots[:, :, :, 1].reshape(L, C * O),
            ], dim=1)

            def eq_bits(v):
                return torch.where(U == v[:, None], bits, 0).sum(dim=1)

            EB = [[eq_bits(slots[:, t, j, 1]) for j in range(O)] for t in range(C)]
            zero = torch.zeros(L, dtype=torch.int64, device=dev)
            masks = [zero] * len(nodes)
            masks[0] = eq_bits(torch.full((L,), default, dtype=torch.int64, device=dev))
            accept = torch.zeros(L, dtype=torch.bool, device=dev)
            for i, c in enumerate(nodes):
                m = masks[i]
                done = m != 0
                for t in range(C):
                    done = done & (counts[:, t] <= c[t])
                accept = accept | done
                for t in range(C):
                    j = c[t]
                    if j >= O:
                        continue
                    succ = node_idx[c[:t] + (j + 1,) + c[t + 1 :]]
                    kind = slots[:, t, j, 0]
                    completed = counts[:, t] > j
                    present = completed | ((counts[:, t] == j) & (kind != 0))
                    if real_time:
                        for p in range(C):
                            present = present & (slots[:, t, j, 2 + p] <= c[p])
                    eb = EB[t][j]
                    write_m = torch.where(m != 0, eb, 0)
                    read_m = torch.where(completed, m & eb, m)
                    m_next = torch.where(kind == 1, write_m,
                                         torch.where(kind == 2, read_m, m))
                    masks[succ] = masks[succ] | torch.where(present, m_next, 0)
            return (valid == 1) & accept

        return fn

    def predicate_lanes(self, real_time: bool = True):
        """The lane-grid predicate: every interleaving × every in-flight
        inclusion as an independent lane (``_interleavings``), the JAX
        package's independent oracle for the DP above."""
        C, O = self.C, self.O
        M = C * O
        seq_t, seq_j = _interleavings(C, O)
        incl = np.array(list(product([0, 1], repeat=C)), np.int64)
        S, K = seq_t.shape[0], incl.shape[0]
        seq_t = np.repeat(seq_t, K, axis=0).astype(np.int64)  # (S*K, M)
        seq_j = np.repeat(seq_j, K, axis=0).astype(np.int64)
        incl = np.tile(incl, (S, 1))  # (S*K, C)
        default = ord(self.default_value)

        def fn(hist):
            valid, counts, slots = self._split(hist)
            L, dev = hist.shape[0], hist.device
            G = seq_t.shape[0]
            val = torch.full((L, G), default, dtype=torch.int64, device=dev)
            ok = torch.ones((L, G), dtype=torch.bool, device=dev)
            consumed = torch.zeros((L, G, C), dtype=torch.int64, device=dev)
            inc = torch.from_numpy(incl).to(dev)
            for pos in range(M):
                t = torch.from_numpy(seq_t[:, pos]).to(dev)
                j = torch.from_numpy(seq_j[:, pos]).to(dev)
                slot = slots[:, t, j]  # (L, G, 2 + C)
                kind, v, constr = slot[..., 0], slot[..., 1], slot[..., 2:]
                cnt = counts[:, t]
                completed = j < cnt
                inflight = (j == cnt) & (kind != 0) & (inc.gather(1, t[:, None])[:, 0] == 1)
                present = completed | inflight
                rt_ok = (consumed >= constr).all(dim=2) if real_time else True
                ok = ok & (~present | rt_ok)
                ok = ok & (~(present & completed & (kind == 2)) | (val == v))
                val = torch.where(present & (kind == 1), v, val)
                consumed = consumed + (
                    (torch.arange(C, device=dev) == t[:, None]) & present[..., None]
                ).to(torch.int64)
            return (valid == 1) & ok.any(dim=1)

        return fn
