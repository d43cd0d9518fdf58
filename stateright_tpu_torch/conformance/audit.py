"""Batched consistency auditing of uploaded operation histories, on the
card.

The port of the JAX package's ``conformance/audit.py``. A bounded history
packs into a fixed-width u32 vector (``semantics/packed_linearizability.py``)
and the Wing&Gong search becomes a static-shaped batched predicate; one
shape bucket of uploaded histories (spec, semantics, C, O, default) is one
batched device dispatch (``default`` is the register's initial value — the
predicate bakes it in, so it is part of the bucket identity; None for vec):

- **register** histories ride ``PackedRegisterLinearizability``
  unchanged: ingestion drives the host ``LinearizabilityTester`` (which
  captures the dense real-time constraint words) and ``pack``s it; the
  device predicate is the consumption-vector DP, with
  ``real_time=False`` for the sequential-consistency buckets.
- **vec** (stack) histories get their own packed codec here
  (``PackedVecHistory``): per-thread slots ``[kind, value, ret_kind,
  ret_value, constraint[C]]`` (kinds 1=Push/2=Pop/3=Len) and a lane-grid
  predicate — every program-order interleaving × every in-flight
  inclusion replays the stack semantics with masks, as one torch program
  over ``(histories, lanes)``. The DP's value-bitmask trick is
  register-specific (a register IS its last write); a stack needs the
  actual LIFO replay, and the lane grid is ``predicate_lanes`` with a
  stack register file.

Packed vectors stay ``np.uint32`` on the host and ride as ``int64`` on the
device. Every verdict is gated on the host testers: ``host_is_consistent``
is the oracle the parity tests (and the checker's gate) diff against, bit
for bit. Histories the bounded codecs cannot represent (register value
universe > 31 ops, vec lane grids past ``MAX_VEC_LANES``) — or whose
register DP would be pathological (past ``MAX_REGISTER_DP_TRANSITIONS``,
the JAX package's compile-sanity bound, kept so the two packages refuse
the same uploads) — are **refused honestly**: ``pack_history`` returns a
reason instead of a wrong verdict.

Predicates are cached process-globally per bucket key and device.
"""

from __future__ import annotations

import math
import threading
from itertools import product
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checker.gpu import resolve_device
from ..semantics.linearizability import LinearizabilityTester
from ..semantics.packed_linearizability import (
    PackedRegisterLinearizability,
    _interleavings,
)
from ..semantics.register import READ, ReadOk, Register, Write, WRITE_OK
from ..semantics.sequential_consistency import SequentialConsistencyTester
from ..semantics.vec import LEN, LenOk, POP, PopOk, Push, PUSH_OK, VecSpec
from .wire import history_shape

# Static bound on the vec lane grid (interleavings x 2^C inclusion
# masks). C=2,O=2 -> 24 lanes; C=3,O=2 -> 720; C=2,O=4 -> 280. Past
# this the grid stops being sane work for one history — refuse, honestly.
MAX_VEC_LANES = 4096

# Static bound on the register DP's transition graph, ``(O+1)^C * C``:
# the JAX package's bound (its unrolled DP's compile time is sharply
# superlinear in that graph; C=3,O=3 (192) wedges its compiler for
# minutes). The port's DP is as many batched torch steps, and keeps the
# bound and its reason word for word, so both packages refuse the same
# uploads.
MAX_REGISTER_DP_TRANSITIONS = 96

# Elements of one (histories, lanes, M) intermediate of the vec grid: a
# batch past it runs in row chunks (2^23 int64 elements = 64 MiB).
_VEC_CHUNK_ELEMENTS = 1 << 23


def _thread_ids(rec: dict) -> List[int]:
    ids = set()
    for _etype, tid, _tag, _value in rec["events"]:
        ids.add(tid)
    return sorted(ids) or [0]


def _wire_op(tag: str, value):
    if tag == "Write":
        return Write(value)
    if tag == "Read":
        return READ
    if tag == "Push":
        return Push(value)
    if tag == "Pop":
        return POP
    return LEN


def _wire_ret(tag: str, value):
    if tag == "Write":
        return WRITE_OK
    if tag == "Read":
        return ReadOk(value)
    if tag == "Push":
        return PUSH_OK
    if tag == "Pop":
        return PopOk(None if value == ("none",) else ("Some", value[1]))
    return LenOk(value)


def drive_tester(tester, events) -> None:
    """Replays decoded wire events into a host-style tester, stopping at
    the first invalidating event exactly as a host client would (the
    testers raise AND latch ``is_valid_history=False``; feeding further
    events would raise "Earlier history was invalid")."""
    for etype, tid, tag, value in events:
        try:
            if etype == "invoke":
                tester.on_invoke(tid, _wire_op(tag, value))
            elif tag is None:  # orphan return: payload untypeable
                tester.on_return(tid, ("OrphanReturn",))
            else:
                tester.on_return(tid, _wire_ret(tag, value))
        except ValueError:
            return


def host_is_consistent(rec: dict) -> bool:
    """THE parity oracle: the host tester's verdict for one decoded
    history record. Every device verdict is gated on agreeing with this
    bit-for-bit."""
    spec = (
        Register(rec["default"]) if rec["spec"] == "register" else VecSpec()
    )
    tester = (
        LinearizabilityTester(spec)
        if rec["semantics"] == "linearizability"
        else SequentialConsistencyTester(spec)
    )
    drive_tester(tester, rec["events"])
    return tester.is_consistent()


# -- vec (stack) packed codec ----------------------------------------------


class PackedVecHistory:
    """Fixed-width packing + batched predicate for bounded stack
    histories (``VecSpec``): C threads x at most O ops each.

    Layout (all u32): ``vec[0]`` = is_valid_history; thread ``c`` block
    = count word + O slots ``[kind, value, ret_kind, ret_value,
    constraint[C]]``. Kinds: 0 absent, 1 Push (value = pushed char),
    2 Pop (completed: ret_kind 1=PopOk(None), 2=PopOk(Some ret_value)),
    3 Len (completed: ret_value = returned length). ``constraint[p]``
    is peer ``p``'s completed count at invoke time (dense
    ``completed_map``) — ignored under ``real_time=False``.
    """

    SW = 4  # kind, value, ret_kind, ret_value (+ C constraint words)

    def __init__(self, C: int, O: int):
        self.C = C
        self.O = O
        self.TW = 1 + O * (self.SW + C)
        self.width = 1 + C * self.TW
        # Bound check FIRST, arithmetically: the interleaving count is
        # the multinomial (C*O)!/(O!)^C, so a hostile shape (say 5x5 ->
        # ~6e14 sequences) must be refused before _interleavings — a
        # full recursive enumeration — ever runs, or the refusal itself
        # parks the worker in unbounded CPU/memory.
        n_seqs = math.factorial(C * O) // (math.factorial(O) ** C)
        self.lanes = n_seqs * (1 << C)
        if self.lanes > MAX_VEC_LANES:
            raise ValueError(
                f"vec history lane grid {self.lanes} exceeds "
                f"{MAX_VEC_LANES} ({C} threads x {O} ops); split the "
                "history or audit it on the host"
            )
        self._seqs = _interleavings(C, O)

    def _slot(self, c: int, j: int) -> int:
        return 1 + c * self.TW + 1 + j * (self.SW + self.C)

    def pack(self, events, thread_ids: Sequence[int]) -> np.ndarray:
        """Decoded wire events -> packed vector, mirroring the host
        testers' recording semantics exactly (double-invoke / orphan
        return latch invalid and freeze)."""
        C, O = self.C, self.O
        dense = {t: c for c, t in enumerate(thread_ids)}
        out = np.zeros((self.width,), np.uint32)
        out[0] = 1
        counts = [0] * C
        inflight: Dict[int, int] = {}  # dense thread -> slot index
        for etype, tid, tag, value in events:
            c = dense[tid]
            if etype == "invoke":
                if c in inflight or counts[c] >= O:
                    out[0] = 0
                    return out
                j = counts[c]
                b = self._slot(c, j)
                out[b] = {"Push": 1, "Pop": 2, "Len": 3}[tag]
                out[b + 1] = ord(value) if tag == "Push" else 0
                for p in range(C):
                    out[b + self.SW + p] = counts[p] if p != c else 0
                inflight[c] = j
            else:
                if c not in inflight:
                    out[0] = 0
                    return out
                j = inflight.pop(c)
                b = self._slot(c, j)
                if tag == "Pop":
                    if value == ("none",):
                        out[b + 2] = 1
                    else:
                        out[b + 2] = 2
                        out[b + 3] = ord(value[1])
                elif tag == "Len":
                    # The wire admits any non-negative LenOk, but the
                    # stack can never hold more than C*O entries, so any
                    # larger payload is equally unsatisfiable — clamp to
                    # C*O+1 rather than overflow the u32 slot (the host
                    # oracle reports such a history inconsistent, not a
                    # worker error).
                    out[b + 3] = min(int(value), C * O + 1)
                counts[c] += 1
                out[1 + c * self.TW] = counts[c]
        return out

    def predicate(self, real_time: bool = True):
        """``fn(hists) -> (B,) bool`` over ``(B, width)`` int64 histories:
        True iff a serialization exists. Lane grid = interleavings x
        in-flight inclusion, ``G = self.lanes`` lanes a history; each lane
        replays the stack with a register file of size M = C*O (the push
        upper bound) and masks, like
        ``PackedRegisterLinearizability.predicate_lanes`` with LIFO state
        instead of a scalar value. Batches past ``_VEC_CHUNK_ELEMENTS``
        run in row chunks."""
        C, O, SW = self.C, self.O, self.SW
        M = C * O
        seq_t, seq_j = self._seqs
        S = seq_t.shape[0]
        incs = np.array(list(product([0, 1], repeat=C)), np.int64)
        K = incs.shape[0]
        seq_t = np.repeat(seq_t, K, axis=0).astype(np.int64)  # (G, M)
        seq_j = np.repeat(seq_j, K, axis=0).astype(np.int64)
        incs = np.tile(incs, (S, 1))  # (G, C)
        G = seq_t.shape[0]
        inc_t = np.take_along_axis(incs, seq_t, axis=1)  # (G, M)
        rows = max(1, _VEC_CHUNK_ELEMENTS // (G * M))
        tables: Dict[str, tuple] = {}

        def grid(hist, T, J, INC):
            B = hist.shape[0]
            dev = hist.device
            body = hist[:, 1:].reshape(B, C, self.TW)
            counts = body[:, :, 0]
            slots = body[:, :, 1:].reshape(B, C, O, SW + C)
            stack = torch.zeros((B, G, M), dtype=torch.int64, device=dev)
            sp = torch.zeros((B, G), dtype=torch.int64, device=dev)
            ok = torch.ones((B, G), dtype=torch.bool, device=dev)
            consumed = torch.zeros((B, G, C), dtype=torch.int64, device=dev)
            cidx = torch.arange(C, device=dev)
            for pos in range(M):
                t, j = T[:, pos], J[:, pos]
                slot = slots[:, t, j]  # (B, G, SW + C)
                kind, value = slot[..., 0], slot[..., 1]
                ret_kind, ret_value = slot[..., 2], slot[..., 3]
                cnt = counts[:, t]
                completed = j < cnt
                inflight = (j == cnt) & (kind != 0) & (INC[:, pos] == 1)
                present = completed | inflight
                if real_time:
                    ok = ok & (~present | (consumed >= slot[..., SW:]).all(dim=2))
                # Stack semantics (host ``VecSpec.is_valid_step`` =
                # invoke-and-compare): completed Pops/Lens must observe
                # the current stack; in-flight ops generate their
                # return (always valid) but still mutate.
                top = stack.gather(2, (sp - 1).clamp(0, M - 1)[..., None])[..., 0]
                pop_ok = torch.where(
                    ret_kind == 2, (sp > 0) & (top == ret_value), sp == 0
                )
                step_ok = torch.where(kind == 2, pop_ok, (kind != 3) | (sp == ret_value))
                ok = ok & (~(present & completed) | step_ok)
                do_push = present & (kind == 1)
                do_pop = present & (kind == 2) & (sp > 0)
                at = sp.clamp(0, M - 1)[..., None]
                cur = stack.gather(2, at)[..., 0]
                stack = stack.scatter(2, at, torch.where(do_push, value, cur)[..., None])
                sp = sp + do_push.to(torch.int64) - do_pop.to(torch.int64)
                consumed = consumed + (
                    (cidx == t[:, None]) & present[..., None]
                ).to(torch.int64)
            return ok.any(dim=1)

        def fn(hist):
            key = str(hist.device)
            if key not in tables:
                tables[key] = tuple(
                    torch.from_numpy(x).to(hist.device) for x in (seq_t, seq_j, inc_t)
                )
            T, J, INC = tables[key]
            ok = torch.cat([grid(hist[lo: lo + rows], T, J, INC)
                            for lo in range(0, hist.shape[0], rows)])
            return (hist[:, 0] == 1) & ok

        return fn


# -- packing + batched predicates -------------------------------------------


def pack_history(rec: dict) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """One decoded history -> ``(packed vector, None)`` or ``(None,
    refusal reason)`` when the bounded codec cannot represent it."""
    C, O = history_shape(rec)
    tids = _thread_ids(rec)
    if rec["spec"] == "register":
        if 1 + C * O > 32:
            return None, (
                f"register history too wide for the device DP "
                f"({C} threads x {O} ops = {C * O} ops; bound is 31)"
            )
        transitions = (O + 1) ** C * C
        if transitions > MAX_REGISTER_DP_TRANSITIONS:
            return None, (
                f"register DP graph too large to compile sanely "
                f"({C} threads x {O} ops -> {transitions} unrolled "
                f"transitions; bound is {MAX_REGISTER_DP_TRANSITIONS}); "
                "split the history or audit it on the host"
            )
        codec = PackedRegisterLinearizability(tids, O, rec["default"])
        # The Lin tester records the dense real-time constraints even
        # for SC buckets (the SC predicate just ignores them).
        tester = LinearizabilityTester(Register(rec["default"]))
        drive_tester(tester, rec["events"])
        return codec.pack(tester), None
    try:
        codec = PackedVecHistory(C, O)
    except ValueError as e:
        return None, str(e)
    return codec.pack(rec["events"], tids), None


class AuditKernel:
    """The batch auditor of one shape bucket on one device:
    ``fn(hists (B, width) u32 numpy) -> (B,) bool numpy``. The packed
    vectors ride as int64 on the device; the predicate is eager torch
    there (batched over the histories, no host read inside)."""

    def __init__(self, pred, device: torch.device):
        self._pred = pred
        self.device = device

    def __call__(self, hists) -> np.ndarray:
        h = torch.from_numpy(np.asarray(hists).astype(np.int64)).to(self.device)
        with torch.no_grad():
            return self._pred(h).cpu().numpy()


_KERNELS: Dict[tuple, AuditKernel] = {}
_KERNELS_LOCK = threading.Lock()


def audit_kernel(spec: str, semantics: str, C: int, O: int,
                 default: Optional[str] = None, device=None) -> AuditKernel:
    """The batch auditor for one shape bucket, cached process-globally
    (a resident process re-audits a hot bucket without rebuilding its
    tables). ``device`` is ``"cuda"`` unless ``"cpu"`` is passed."""
    dev = resolve_device(device, "audit_kernel")
    key = (spec, semantics, C, O, default, str(dev))
    with _KERNELS_LOCK:
        fn = _KERNELS.get(key)
        if fn is not None:
            return fn
    real_time = semantics == "linearizability"
    if spec == "register":
        codec = PackedRegisterLinearizability(
            list(range(C)), O, default or "a"
        )
    else:
        codec = PackedVecHistory(C, O)
    fn = AuditKernel(codec.predicate(real_time=real_time), dev)
    with _KERNELS_LOCK:
        return _KERNELS.setdefault(key, fn)


def clear_audit_kernels() -> None:
    """Test hook: drop the process-global kernel cache."""
    with _KERNELS_LOCK:
        _KERNELS.clear()


def audit_batch(records: Sequence[dict], lanes: Optional[int] = None,
                device=None) -> List[dict]:
    """Audits one shape bucket of decoded histories in one batched
    device dispatch. All records MUST share ``bucket_key`` (the checker
    guarantees it). Returns one verdict dict per record, in order:
    ``{"id", "kind": "history", "semantics", "consistent",
    "valid_history"}`` or ``{"id", "kind": "history", "refused": ...}``.
    Runs on ``"cuda"`` unless ``device="cpu"``.

    ``lanes`` pads short batches to a fixed row count with inert
    all-zero vectors (``valid=0``; their verdicts are discarded), as the
    JAX package pads to reuse one executable a bucket.
    """
    dev = resolve_device(device, "audit_batch")
    if not records:
        return []
    C, O = history_shape(records[0])
    spec = records[0]["spec"]
    semantics = records[0]["semantics"]
    default = records[0].get("default")
    packed: List[np.ndarray] = []
    slots: List[Optional[int]] = []
    verdicts: List[Optional[dict]] = []
    for rec in records:
        vec, refusal = pack_history(rec)
        if refusal is not None:
            slots.append(None)
            verdicts.append(
                {"id": rec["id"], "kind": "history", "refused": refusal}
            )
        else:
            slots.append(len(packed))
            packed.append(vec)
            verdicts.append(None)
    if packed:
        fn = audit_kernel(spec, semantics, C, O, default, dev)
        batch = np.stack(packed)
        if lanes is not None and batch.shape[0] < lanes:
            pad = np.zeros(
                (lanes - batch.shape[0], batch.shape[1]), np.uint32
            )
            batch = np.concatenate([batch, pad])
        out = fn(batch)[: len(packed)]
    else:
        out = np.zeros((0,), bool)
    for i, rec in enumerate(records):
        if verdicts[i] is not None:
            continue
        vec = packed[slots[i]]
        verdicts[i] = {
            "id": rec["id"],
            "kind": "history",
            "semantics": semantics,
            "consistent": bool(out[slots[i]]),
            "valid_history": bool(vec[0]),
        }
    return verdicts
