"""Tenant-packed waves: many same-shape checks advanced by one wave.

The port of the JAX package's ``checker/packed_tenancy.py``. Up to
``max_tenants`` checks of one model configuration share one physical
wave and one visited table on the device. Each wave compacts the live
lanes of every resident tenant into one dense frontier (a per-lane tenant
slot ``tid`` rides through the expansion, the fingerprints and the
property evaluation), claims the candidates in the one shared table under
tenant-salted fingerprints (``ops/hashset_kernel.py::hashset_insert_salted``:
the insert kernel on a CUDA table, its plain twin on the CPU), and reduces
generated, fresh, depth and discoveries per tenant. Preempting a tenant is
dropping its lanes: its pending frontier, counters, parent log and storage
partition leave as a checkpoint payload of kind ``"gpu_bfs"`` with no
device drain, which resumes in a later pack (``admit(..., resume_from=)``)
or in ``spawn_gpu_bfs(resume_from=)``; a ``spawn_gpu_bfs`` preempt payload
is admitted the same way.

Why each tenant's results are its solo run's
--------------------------------------------

1. **XOR salting keeps each tenant's dedup.** A tenant's table key is
   ``fp ^ salt``, a bijection, so two of its states collide salted iff
   they collide raw, and two tenants' keys differ by an avalanche-mixed
   64-bit constant (``ops/fingerprint.py::tenant_salt_pair``). Frontier
   rows, parent logs, discoveries, payloads and the host-tier partitions
   keep the original fingerprints.
2. **The unsorted insert keeps lane order.** Exactly one lane per new key
   is fresh, the lowest, and the fresh lanes compact in natural lane
   order, each tenant's lanes assembled in its own FIFO frontier order. A
   tenant's claims are therefore those of the JAX package's solo run under
   ``wave_dedup="scatter"`` (its CPU default), whatever the wave widths:
   the first claimant of a key in the tenant's candidate order wins in
   every grouping. So a packed tenant's counts, depths, parent pointers,
   discoveries and golden report equal the JAX pack's tenant and that JAX
   solo run. The port's own ``spawn_gpu_bfs`` compacts in key order (the
   JAX ``wave_dedup="sort"`` order): against it a tenant has the same
   counts, depth and discovery names, with paths of its own that replay
   on the model.

Out of core (``hbm_budget_mib``), the host tiers are partitioned by tenant
(``storage.TenantPartitions``): the shared table's salted keys cannot be
attributed after the fact, but the engine knows each tenant's claims since
the last eviction (its parent-log stream), so an eviction drains each
tenant's claims into its own partition and each wave's host probe runs per
tenant. With ``async_pipeline=True`` those probes, the parent-log appends
and the survivors' re-entry run on one FIFO ``HostPipeline`` worker, behind
the same merge fence, while the next wave runs.

Device liveness (``liveness="device"``): the wave logs each lane's
condition-false edges with its tenant id (``wave_edge_rows``' ``tid``
column) over the original fingerprints, the verdict splits them into one
``LivenessEdgeStore`` per tenant, and a finished tenant's trim and reach run
over its own partition, so its verdict is its solo run's.

Host round trips: lane blocks stay on the host (numpy) between waves. A
wave makes one upload of the assembled frontier (every field in one
buffer), one read of its stats vector (counts, per-tenant reductions and
first hits, the edge count), and one copy of its fresh prefix (with its
edge rows). The table is whole tiles of the insert kernel (``TILE_ROWS``
rows): a smaller ``table_capacity`` rounds up, and ``config_notes`` says so.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.batch import BatchableModel
from ..core.model import Expectation
from ..core.path import Path
from ..native import make_fingerprint_store
from ..ops.edge_store import EDGE_COLS
from ..ops.fingerprint import fp64_pairs, fp_to_int, tenant_salt_pair
from ..ops.fused_wave import _frontier_plain, _hit_lanes, model_stage
from ..ops.hashset import hashset_new
from ..ops.hashset_kernel import TILE_ROWS, hashset_insert_salted, round_table_capacity
from ..storage import (
    LivenessEdgeStore,
    LivenessInstruments,
    TenantPartitions,
    max_table_rows_for_budget,
    validate_budget_knobs,
)
from ..telemetry import TenantInstruments, WaveInstruments, get_tracer, metrics_registry
from ..utils.faults import TenantFaultError, fault_point
from .base import Checker
from .device_liveness import LIVENESS_MODES, analyze_liveness, seed_root_mask, wave_edge_rows
from .gpu import (
    _AUTO_BUCKET_MIN_F,
    _DEFAULT_BUCKET_STEPS,
    _DEPTH_INF,
    _MAX_LOAD,
    _pow2ceil,
    bucket_for,
    bucket_ladder_widths,
    checkpoint_header,
    host_fingerprint,
    rehash_table,
    resolve_device,
    validate_checkpoint_header,
    wave_spec,
)
from .pipeline import HostPipeline

__all__ = ["TenantPackedEngine", "TenantRun"]

# Fixed batch width of the bulk (resume-admission) inserts.
_BULK_INSERT_WIDTH = 1 << 13
# The per-lane u32/int fields of a lane block, each int64 on the host.
_FIELDS = ("hi", "lo", "ebits", "depth")


# -- host trees and one-copy transfers -------------------------------------


def _tree_leaves(tree) -> list:
    """The leaves of a packed-state tree of tensors or numpy arrays, in the
    order ``core.batch.leaves`` gives."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_build(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(template)


def _upload(arrays, device) -> List[torch.Tensor]:
    """Host numpy arrays as tensors on ``device`` in one copy: their bytes,
    each padded to 8, in one buffer, then dtype views of it there."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 8) * 8
    buf = np.zeros(max(total, 8), np.uint8)
    for a, off in zip(arrays, offsets):
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out = []
    for a, off in zip(arrays, offsets):
        dtype = torch.from_numpy(a[:0]).dtype
        out.append(dev[off:off + a.nbytes].view(dtype).view(a.shape))
    return out


def _download(tensors) -> List[np.ndarray]:
    """Tensors of one device as host numpy arrays in one copy: their bytes,
    each padded to 8, concatenated on the device, then one read."""
    parts, metas = [], []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=b.device))
        metas.append((t.dtype, tuple(t.shape), b.numel(), b.numel() + pad))
    if not parts:
        return []
    host = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for dtype, shape, nbytes, span in metas:
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        out.append(host[off:off + nbytes].view(np_dtype).reshape(shape))
        off += span
    return out


# -- per-tenant host state ------------------------------------------------------


class _LaneStore:
    """One tenant's pending frontier: a FIFO of dense host lane blocks
    (``{"leaves": [...], "hi", "lo", "ebits", "depth"}``, numpy). Push
    (the pipeline worker in async mode) and take (the engine thread) are
    guarded by a lock; blocks are immutable once pushed."""

    def __init__(self):
        self._blocks = deque()
        self._lock = threading.Lock()
        self.pending = 0

    def push(self, block: dict, n: int) -> None:
        if n == 0:
            return
        with self._lock:
            self._blocks.append((block, n))
            self.pending += n

    def take(self, k: int) -> List[dict]:
        """Up to ``k`` lanes off the head, as dense blocks (a block taken
        in part is split; FIFO lane order is kept)."""
        out = []
        with self._lock:
            while k > 0 and self._blocks:
                block, n = self._blocks.popleft()
                if n <= k:
                    out.append(block)
                    self.pending -= n
                    k -= n
                else:
                    out.append(_slice_block(block, 0, k))
                    self._blocks.appendleft((_slice_block(block, k, n), n - k))
                    self.pending -= k
                    k = 0
        return out

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self.pending = 0


def _slice_block(block: dict, start: int, stop: int) -> dict:
    return {k: ([x[start:stop] for x in v] if k == "leaves" else v[start:stop])
            for k, v in block.items()}


def _take_block(block: dict, idx) -> dict:
    return {k: ([x[idx] for x in v] if k == "leaves" else v[idx]) for k, v in block.items()}


def _concat_blocks(blocks) -> Optional[dict]:
    """The blocks as one dense block (None when there are none)."""
    if not blocks:
        return None
    out = {k: np.concatenate([b[k] for b in blocks]) for k in _FIELDS}
    out["leaves"] = [np.concatenate([b["leaves"][i] for b in blocks])
                     for i in range(len(blocks[0]["leaves"]))]
    return out


class _Tenant:
    """One resident tenant's host state (slot, salt, frontier, ledgers)."""

    def __init__(self, key, run_id, slot, epoch, depth_cap, registry):
        self.key = key
        self.run_id = run_id
        self.slot = slot
        self.salt_hi, self.salt_lo = tenant_salt_pair(epoch)
        self.depth_cap = depth_cap if depth_cap is not None else _DEPTH_INF
        self.registry = registry
        self.instruments = TenantInstruments("pack", registry=registry)
        self.lanes = _LaneStore()
        self.state_count = 0
        self.unique_count = 0
        self.max_depth = 0
        self.discoveries_fp: Dict[str, int] = {}
        # (child u64, parent u64) arrays a wave: the parent-pointer stream
        # (paths, the payload, and what an eviction drains).
        self.wave_log: List = []
        self._ingested = 0
        self._ingest_lock = threading.Lock()
        self.store = make_fingerprint_store()
        # Unsalted fps claimed fresh in the table since the last eviction:
        # what an eviction drains into this tenant's partition.
        self.resident: List[np.ndarray] = []
        self.done = False      # no further lanes scheduled
        self.finished = False  # reported complete (view.is_done)
        # A fault attributed to this tenant rolls it back to its pre-wave
        # boundary and takes it off the schedule until the caller drops
        # it; ``fault_error`` is its own exception (several tenants can
        # fault in one wave).
        self.faulted = False
        self.fault_error: Optional[BaseException] = None
        self.view: Optional["TenantRun"] = None
        # Device liveness: this tenant's edge partition and its verdicts at
        # finish. Absorbs are idempotent (the store dedups), so a fault's
        # rollback never undoes them.
        self.live_store = None
        self.live_paths: Dict[str, Path] = {}
        self.live_outcomes: Dict[str, dict] = {}

    def ingest(self) -> None:
        with self._ingest_lock:
            while self._ingested < len(self.wave_log):
                children, parents = self.wave_log[self._ingested]
                self.store.insert_batch(children, parents)
                self._ingested += 1


class TenantRun(Checker):
    """The caller's handle on one packed tenant: the ``Checker`` surface
    (counts, discoveries with their paths, the golden report, assertions,
    the liveness report) over the engine's per-tenant state."""

    supports_preempt = True  # preemption is a lane drop, through the engine
    supports_device_liveness = True

    def __init__(self, engine: "TenantPackedEngine", tenant: _Tenant):
        self._engine = engine
        self._t = tenant
        self.run_id = tenant.run_id
        self._registry = tenant.registry
        self.warmup_seconds = 0.0
        self.config_notes = list(engine.config_notes)
        self._live = engine._live
        self._live_enabled = engine._live_enabled

    @property
    def _live_store(self):
        return self._t.live_store

    @property
    def _live_paths(self):
        return self._t.live_paths

    @property
    def _live_outcomes(self):
        return self._t.live_outcomes

    def model(self):
        return self._engine._model

    def state_count(self) -> int:
        return max(self._t.state_count, self._t.unique_count)

    def unique_state_count(self) -> int:
        return self._t.unique_count

    def max_depth(self) -> int:
        return self._t.max_depth

    def discoveries(self) -> Dict[str, Path]:
        out = {name: self._reconstruct(fp)
               for name, fp in list(self._t.discoveries_fp.items())}
        return self._with_device_liveness(out)

    def _discovery_names(self) -> List[str]:
        return list(set(self._t.discoveries_fp) | set(self._t.live_paths))

    def _reconstruct(self, fp: int) -> Path:
        self._t.ingest()
        chain = self._t.store.chain(fp)
        return Path.from_fingerprints(self.model(), chain, fp_of=self._engine._host_fp)

    def handles(self) -> List[threading.Thread]:
        return []

    def is_done(self) -> bool:
        return self._t.finished

    def worker_error(self) -> Optional[BaseException]:
        return None

    def state_digest(self) -> dict:
        """Where the tenant stands: counts, discoveries, its slot and
        pending lanes, whether it was dropped with a payload."""
        return {
            "backend": type(self).__name__,
            "done": self.is_done(),
            "state_count": self.state_count(),
            "unique_state_count": self.unique_state_count(),
            "max_depth": self.max_depth(),
            "discoveries": sorted(self._discovery_names()),
            "packed": True,
            "tenant_slot": self._t.slot,
            "pending_lanes": self._t.lanes.pending,
            "preempted": self.preempted,
        }


class TenantPackedEngine:
    """The packer: one shared table and one shared wave, per-tenant lane
    accounting. One caller thread drives it a wave at a time: ``admit()``
    claims a lane slot (optionally restoring a payload), ``step()``
    advances every resident tenant by one packed wave and returns the
    tenants that completed, ``drop()`` preempts one tenant into a payload,
    ``release()`` frees a completed tenant's slot.

    The JAX package's knobs and defaults (``frontier_capacity``,
    ``table_capacity``, ``max_tenants``, ``bucket_ladder``,
    ``hbm_budget_mib``, ``host_budget_mib``, ``spill_dir``,
    ``async_pipeline``, ``resume_capacity``, ``run_id``, ``liveness``),
    plus ``device``: ``"cuda"`` unless ``"cpu"`` is passed, and with no
    CUDA device and no ``device="cpu"`` it raises. ``aot_cache`` is
    accepted for the JAX API and caches nothing: the port compiles no
    executable per configuration. ``table_capacity`` rounds up to whole
    tiles of the insert kernel (``config_notes``)."""

    def __init__(
        self,
        model,
        *,
        frontier_capacity: int = 1 << 10,
        table_capacity: int = 1 << 16,
        max_tenants: int = 8,
        bucket_ladder: Optional[int] = None,
        hbm_budget_mib: Optional[float] = None,
        host_budget_mib: Optional[float] = None,
        spill_dir: Optional[str] = None,
        async_pipeline: bool = False,
        aot_cache: Optional[str] = None,
        resume_capacity: Optional[int] = None,
        run_id: Optional[str] = None,
        liveness=None,
        device=None,
    ):
        del aot_cache
        if not isinstance(model, BatchableModel):
            raise TypeError(
                "TenantPackedEngine requires a BatchableModel; "
                f"{type(model).__name__} does not implement the packed protocol"
            )
        self._device = resolve_device(device, "TenantPackedEngine")
        self._model = model
        self._properties = model.properties()
        self._conditions = model.packed_conditions()
        if len(self._conditions) != len(self._properties):
            raise ValueError(
                "packed_conditions() must align 1:1 with properties(): "
                f"{len(self._conditions)} != {len(self._properties)}"
            )
        eventually = [i for i, p in enumerate(self._properties)
                      if p.expectation == Expectation.EVENTUALLY]
        if len(eventually) > 32:
            raise ValueError("at most 32 eventually properties supported")
        self._ebit = {pi: b for b, pi in enumerate(eventually)}
        self._ebits0 = sum(1 << b for b in self._ebit.values())
        if liveness not in LIVENESS_MODES:
            raise ValueError(f"liveness must be one of {LIVENESS_MODES}, got {liveness!r}")
        self._live = "device" if liveness == "device" else None
        self._live_enabled = self._live == "device" and bool(self._ebit)
        self._A = model.packed_action_count()
        self._K = max(1, int(max_tenants))
        self._F_max = _pow2ceil(frontier_capacity)
        if bucket_ladder is None:
            bucket_ladder = _DEFAULT_BUCKET_STEPS if self._F_max >= _AUTO_BUCKET_MIN_F else 0
        self._buckets = bucket_ladder_widths(self._F_max, bucket_ladder)
        self.config_notes: List[str] = []
        cap = _pow2ceil(table_capacity)
        rounded = round_table_capacity(cap)
        if rounded != cap:
            self.config_notes.append(
                f"table_capacity rounded {cap} -> {rounded} (the insert kernel "
                f"takes whole {TILE_ROWS}-row table tiles)"
            )
        self._capacity = rounded
        self._resume_capacity = resume_capacity or table_capacity

        validate_budget_knobs(hbm_budget_mib, host_budget_mib, spill_dir)
        self._max_capacity = None
        if hbm_budget_mib is not None:
            max_cap = max_table_rows_for_budget(hbm_budget_mib)
            min_cap = _pow2ceil(int(self._F_max * self._A / _MAX_LOAD) + 1)
            if max_cap < max(min_cap, TILE_ROWS):
                raise ValueError(
                    f"hbm_budget_mib={hbm_budget_mib} allows a device table of {max_cap} "
                    f"rows, but one worst-case packed wave needs at least {min_cap} and "
                    f"the insert kernel one {TILE_ROWS}-row tile; raise the budget or "
                    "shrink frontier_capacity"
                )
            self._max_capacity = max_cap
            self._capacity = min(self._capacity, max_cap)
        self.run_id = run_id
        self._registry = metrics_registry(run_id) if run_id else None
        self._tracer = get_tracer(run_id)
        self._partitions = TenantPartitions(
            host_budget_mib=host_budget_mib, spill_dir=spill_dir, tracer=self._tracer,
        )
        self._wi = WaveInstruments("pack", registry=self._registry)
        reg = self._registry if self._registry is not None else metrics_registry()
        # Lane accounting: dispatched = width x waves (what the device ran),
        # live = tenant lanes in them; live / dispatched is the occupancy.
        self._c_lanes_dispatched = reg.counter("pack.lanes_dispatched")
        self._c_lanes_live = reg.counter("pack.lanes_live")

        self._spec = wave_spec(model, self._device)
        self._table = hashset_new(self._capacity, self._device)
        self._l0 = 0
        self._slots: List[Optional[_Tenant]] = [None] * self._K
        self._by_key: Dict[object, _Tenant] = {}
        self._salt_epochs = itertools.count(1)
        self._rr = 0  # rotating lane-allocation offset (fairness)
        # Run statistics: waves, lanes, table growths and evictions, and
        # the host seconds of a wave's parts: assembling and uploading the
        # frontier, the wave from its first launch to its stats read (where
        # the host waits for the card), the fresh prefix's copy, the
        # verdicts, and the table's growths.
        self.waves = 0
        self.lanes_dispatched = 0
        self.lanes_live = 0
        self.table_growths = 0
        self.evictions = 0
        self.assemble_s = 0.0
        self.wave_s = 0.0
        self.copy_s = 0.0
        self.verdict_s = 0.0
        self.grow_s = 0.0

        self._pipe = HostPipeline(name="pack-host") if async_pipeline else None

        # The packed state's structure and per-lane leaf shapes and dtypes,
        # for frontier assembly.
        init = model.packed_init_states("cpu")
        self._state_template = init
        self._leaf_specs = [(tuple(x.shape[1:]), x.cpu().numpy().dtype)
                            for x in _tree_leaves(init)]

    @property
    def device(self) -> torch.device:
        return self._device

    def _host_fp(self, host_state) -> int:
        return host_fingerprint(self._model, host_state)

    # -- device work ---------------------------------------------------------

    def _wave(self, table, leaves, hi, lo, ebits, depth, mask, tid, salt_hi, salt_lo,
              depth_caps):
        """One packed wave over ``F`` mixed-tenant lanes: the materializing
        wave with a tenant-lane dimension (per-lane depth caps, salted
        claims, per-tenant reductions). Nothing is read back: returns the
        table and the outputs, whose ``stats`` vector is the host's one
        read (overflow, any hit, then per tenant generated, fresh and max
        depth, with device liveness the edge rows, then per property and
        tenant the first hit and its fingerprint)."""
        spec, A, K = self._spec, self._A, self._K
        F, dev = hi.shape[0], hi.device
        B = F * A
        states = _tree_build(self._state_template, leaves)
        cond, cvalid, cand_flat = model_stage(spec, states, F)
        eval_mask, ebits_after, cvalid, terminal = _frontier_plain(
            spec, cond, cvalid, ebits, depth, depth_caps[tid], mask)
        chi, clo = spec.fingerprint(cand_flat)
        lanes = torch.arange(B, dtype=torch.int64, device=dev)
        parent_row = lanes // A
        ctid = tid[parent_row]
        # Salted claims in the one shared table, in natural lane order.
        table, fresh, _found, pending = hashset_insert_salted(
            table, chi, clo, salt_hi[ctid], salt_lo[ctid], cvalid)

        zeros = torch.zeros(K, dtype=torch.int64, device=dev)
        gen_t = zeros.index_add(0, tid, cvalid.view(F, A).sum(1))
        new_t = zeros.index_add(0, ctid, fresh.to(torch.int64))
        maxd_t = zeros.scatter_reduce(0, tid, torch.where(mask, depth, 0), "amax")
        # Fresh lanes compact to a prefix in natural lane order (slot B is
        # the trash slot).
        pos = torch.cumsum(fresh.to(torch.int64), 0) - 1
        src = torch.zeros(B + 1, dtype=torch.int64, device=dev).scatter_(
            0, torch.where(fresh, pos, B), lanes)[:B]
        out = {"src": src, "cand_flat": cand_flat, "chi": chi, "clo": clo, "ctid": ctid,
               "ebits_after": ebits_after, "depth": depth, "hi": hi, "lo": lo}
        cols = [pending.sum().view(1), torch.zeros(1, dtype=torch.int64, device=dev),
                gen_t, new_t, maxd_t]
        if self._live_enabled:
            rows, live_n = wave_edge_rows(
                spec.conditions, self._ebit, cond, cand_flat, cvalid, terminal, hi, lo,
                chi, clo, A, extra_lane={"tid": ctid}, extra_row={"tid": tid})
            out["live"] = rows
            cols.append(live_n.view(1))
        # Each (property, tenant)'s first hit in lane order, which is its
        # first hit in the tenant's own FIFO order.
        lane_f = torch.arange(F, dtype=torch.int64, device=dev)
        hits, fhis, flos = [], [], []
        for h in _hit_lanes(spec, cond, eval_mask, terminal, ebits_after):
            first = torch.full((K,), F, dtype=torch.int64, device=dev).scatter_reduce(
                0, tid, torch.where(h, lane_f, F), "amin")
            idx = torch.where(first < F, first, 0)
            hits.append((first < F).to(torch.int64))
            fhis.append(hi[idx])
            flos.append(lo[idx])
        if hits:
            hit = torch.cat(hits)
            cols[1] = hit.max().view(1)
            cols += [hit, torch.cat(fhis), torch.cat(flos)]
        out["stats"] = torch.cat(cols)
        return table, out

    def _fresh_rows(self, out, n, live_n):
        """The first ``n`` fresh lanes (and ``live_n`` edge rows) on the
        host, in one copy: their fingerprints, eventually bits, depths,
        tenant slots, parents' fingerprints and state leaves."""
        src = out["src"][:n]
        prow = src // self._A
        fields = [out["chi"][src], out["clo"][src], out["ebits_after"][prow],
                  out["depth"][prow] + 1, out["ctid"][src], out["hi"][prow], out["lo"][prow]]
        leaves = [x[src] for x in _tree_leaves(out["cand_flat"])]
        live = [out["live"][c][:live_n] for c in EDGE_COLS + ("tid",)] if live_n else []
        host = _download(fields + leaves + live)
        names = ("hi", "lo", "ebits", "depth", "tid", "parent_hi", "parent_lo")
        rows = dict(zip(names, host[:7]))
        rows["leaves"] = host[7:7 + len(leaves)]
        rows["live"] = dict(zip(EDGE_COLS + ("tid",), host[7 + len(leaves):])) if live_n else None
        return rows

    def _seed_wave(self, table, salt_hi, salt_lo):
        """Claims one tenant's init states in the shared table (salted), as
        the solo seed counts them (duplicate valid inits make one fresh
        claim). Returns the table and the inits, their valid bits and
        fingerprints, ``counts`` (fresh, pending) and, with device
        liveness, their root mask."""
        model = self._model
        states = model.packed_init_states(self._device)
        valid = model.packed_within_boundary(states)
        hi, lo = model.packed_fingerprint(states)
        table, fresh, _found, pending = hashset_insert_salted(
            table, hi, lo, salt_hi, salt_lo, valid)
        out = {"states": states, "valid": valid, "hi": hi, "lo": lo,
               "counts": torch.stack([fresh.sum(), pending.sum()])}
        if self._live_enabled:
            out["root_mask"] = seed_root_mask(self._conditions, self._ebit, states, valid)
        return table, out

    def _bulk_insert(self, table, hi, lo, salt_hi, salt_lo, active):
        """A fixed-width salted claim batch (resume admission); returns the
        table and the (fresh, pending) counts."""
        table, fresh, _found, pending = hashset_insert_salted(
            table, hi, lo, salt_hi, salt_lo, active)
        return table, torch.stack([fresh.sum(), pending.sum()])

    # -- membership ----------------------------------------------------------

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def live_count(self) -> int:
        return sum(1 for s in self._slots if s is not None and not s.finished)

    def tenants(self) -> List[_Tenant]:
        return [s for s in self._slots if s is not None]

    def view(self, key) -> Optional[TenantRun]:
        t = self._by_key.get(key)
        return t.view if t is not None else None

    def admit(self, key, run_id=None, *, depth_cap=None, resume_from=None) -> TenantRun:
        """Claims a free lane slot for one tenant. ``resume_from`` is a
        payload of kind ``"gpu_bfs"`` (an earlier ``drop()``'s, or a
        ``spawn_gpu_bfs`` preempt payload of the same model configuration):
        counters, discoveries, the parent log, the pending frontier and any
        storage partition restore, and the tenant's known keys claim slots
        under a fresh salt epoch, so keys departed tenants left in the
        table never alias it."""
        if key in self._by_key:
            raise ValueError(f"tenant {key!r} is already packed")
        if depth_cap is not None and self._live_enabled:
            raise ValueError(
                "liveness='device' packs cannot admit depth-capped tenants: a capped "
                "exploration logs a truncated edge relation, so the finish-time "
                "verdict would be unsound"
            )
        slot = next((i for i, s in enumerate(self._slots) if s is None), None)
        if slot is None:
            raise RuntimeError(f"no free lanes (max_tenants={self._K})")
        registry = metrics_registry(run_id) if run_id else (
            self._registry or metrics_registry())
        t = _Tenant(key, run_id, slot, next(self._salt_epochs), depth_cap, registry)
        # Registered before seeding or restoring: an eviction that the
        # admission's own claims set off must drain this tenant's resident
        # keys into its partition too.
        self._slots[slot] = t
        self._by_key[key] = t
        try:
            if resume_from is not None:
                self._restore_tenant(t, resume_from)
            else:
                self._seed_tenant(t)
        except BaseException:
            self._slots[slot] = None
            del self._by_key[key]
            self._partitions.drop(key)
            raise
        if not self._properties:
            # Nothing to discover: the solo wave loop exits after seeding.
            t.done = True
        t.instruments.joins.inc()
        t.view = TenantRun(self, t)
        self._tracer.instant("pack.tenant_join", tenant=str(key), slot=slot,
                             resumed=resume_from is not None)
        return t.view

    def _seed_tenant(self, t: _Tenant) -> None:
        # Fresh claims add up across growth retries: the shared table is
        # not reset between attempts (other tenants live in it), so a
        # retry's inits already claimed report found.
        n_unique = 0
        attempt = 0
        while True:
            self._table, out = self._seed_wave(self._table, t.salt_hi, t.salt_lo)
            n_fresh, n_pending = out["counts"].tolist()
            n_unique += n_fresh
            if not n_pending:
                break
            attempt += 1
            if attempt > 8:
                raise RuntimeError("packed seeding overflowed the shared table")
            self._grow(self._capacity * 2)
        self._l0 += n_unique
        extra = [out["root_mask"]] if self._live_enabled else []
        host = _download([out["valid"], out["hi"], out["lo"], *_tree_leaves(out["states"]),
                          *extra])
        valid_np, hi_np, lo_np = host[:3]
        t.state_count = int(valid_np.sum())
        child64 = fp64_pairs(hi_np, lo_np)[valid_np]
        # Distinct inits counted on the host: exact even when an eviction
        # during the seed made claims repeat.
        t.unique_count = int(len(np.unique(child64)))
        t.wave_log.append((child64, np.zeros_like(child64)))
        t.resident.append(np.unique(child64))
        if self._live_enabled:
            self._live_tenant_store(t).add_roots(child64, host[-1][valid_np])
        n_live = t.state_count
        block = {
            "leaves": [x[valid_np] for x in host[3:3 + len(self._leaf_specs)]],
            "hi": hi_np[valid_np],
            "lo": lo_np[valid_np],
            "ebits": np.full((n_live,), self._ebits0, np.int64),
            "depth": np.ones((n_live,), np.int64),
        }
        t.lanes.push(block, n_live)

    def _restore_tenant(self, t: _Tenant, payload: dict) -> None:
        validate_checkpoint_header(payload, self._model, self._A, False, None)
        t.state_count = payload["state_count"]
        t.unique_count = payload["unique_count"]
        t.max_depth = payload["max_depth"]
        t.discoveries_fp = dict(payload["discoveries"])
        children = payload["children"]
        t.wave_log.append((children, payload["parents"]))
        keys = np.unique(np.asarray(children, np.uint64))
        storage_state = payload.get("storage")
        if storage_state:
            store = self._partitions.store(t.key, registry=t.registry)
            store.load_state(storage_state)
            keys = keys[~store.probe(keys)]
        t.resident.append(keys)
        # The liveness edge partition round-trips with the tenant.
        live_state = payload.get("liveness")
        if self._live_enabled and live_state is None:
            raise ValueError(
                "liveness='device' packs cannot admit a payload written without it: "
                "edges before the checkpoint were never logged, so the finish-time "
                "verdict would be unsound"
            )
        if live_state is not None:
            if not self._live_enabled:
                raise ValueError(
                    "payload carries a liveness edge store; admit into a "
                    "liveness='device' pack (or resume solo with liveness='device')"
                )
            self._live_tenant_store(t).load_state(live_state)
        # The tenant's known keys claim slots under its fresh salt.
        W = _BULK_INSERT_WIDTH
        for start in range(0, len(keys), W):
            part = keys[start:start + W]
            n = len(part)
            bh = np.zeros((W,), np.int64)
            bl = np.zeros((W,), np.int64)
            act = np.zeros((W,), bool)
            bh[:n] = (part >> np.uint64(32)).astype(np.int64)
            bl[:n] = (part & np.uint64(0xFFFFFFFF)).astype(np.int64)
            act[:n] = True
            dh, dl, dact = _upload([bh, bl, act], self._device)
            attempt = 0
            while True:
                self._table, counts = self._bulk_insert(
                    self._table, dh, dl, t.salt_hi, t.salt_lo, dact)
                n_fresh, n_pending = counts.tolist()
                self._l0 += n_fresh
                if not n_pending:
                    break
                attempt += 1
                if attempt > 8:
                    raise RuntimeError("packed admission overflowed the shared table")
                self._grow(self._capacity * 2)
        for chunk in payload["chunks"]:
            hi = np.asarray(chunk["hi"], np.int64)
            sel = np.asarray(chunk["mask"], bool) if "mask" in chunk else slice(None)
            n = len(hi[sel])
            if n == 0:
                continue
            block = {k: np.asarray(chunk[k], np.int64)[sel] for k in _FIELDS}
            block["leaves"] = [np.asarray(x)[sel] for x in _tree_leaves(chunk["states"])]
            t.lanes.push(block, n)
        if self._properties and len(t.discoveries_fp) == len(self._properties):
            t.done = True

    def drop(self, key, *, discard: bool = False) -> Optional[dict]:
        """Preempts one tenant by dropping its lanes, with no device drain:
        its pending frontier, counters, parent log and storage partition
        leave as a payload (None with ``discard=True``, the cancel path).
        The slot frees at once; the departed tenant's salted keys stay in
        the table until the next growth or eviction."""
        t = self._by_key.get(key)
        if t is None:
            raise KeyError(f"no packed tenant {key!r}")
        if self._pipe is not None:
            self._pipe.drain()
        t.instruments.lane_drops.inc(t.lanes.pending)
        payload = None
        if not discard and not t.finished:
            payload = self._payload(t)  # takes the lane store's blocks
            if t.view is not None:
                t.view._preempt_payload = payload
        t.lanes.clear()
        self._slots[t.slot] = None
        del self._by_key[t.key]
        self._partitions.drop(t.key)
        self._tracer.instant("pack.tenant_drop", tenant=str(t.key), slot=t.slot,
                             discarded=discard)
        return payload

    def _payload(self, t: _Tenant) -> dict:
        """The tenant's state as a checkpoint payload of kind ``"gpu_bfs"``
        (version 2, 3 with device liveness), loadable by
        ``spawn_gpu_bfs(resume_from=...)`` or a later
        ``admit(resume_from=...)``: its chunks hold live lanes only, at
        most ``frontier_capacity`` each."""
        t.ingest()
        children, parents = t.store.export()
        chunks = []
        lanes = _concat_blocks(t.lanes.take(t.lanes.pending))
        if lanes is not None:
            for s in range(0, len(lanes["hi"]), self._F_max):
                piece = _slice_block(lanes, s, s + self._F_max)
                chunk = {k: piece[k] for k in _FIELDS}
                chunk["states"] = _tree_build(self._state_template, piece["leaves"])
                chunks.append(chunk)
        payload = {
            **checkpoint_header(self._model, self._A, False, None),
            "state_count": t.state_count,
            "unique_count": t.unique_count,
            "max_depth": t.max_depth,
            "discoveries": dict(t.discoveries_fp),
            "children": children,
            "parents": parents,
            "capacity": self._resume_capacity,
            "chunks": chunks,
        }
        store = self._partitions.get(t.key)
        if store is not None and not store.is_empty():
            payload["storage"] = store.export_state()
        if self._live_enabled:
            payload["liveness"] = self._live_tenant_store(t).export_state()
            payload["version"] = 3
        return payload

    # -- table management ----------------------------------------------------

    def _grow(self, min_capacity: int) -> None:
        if self._max_capacity is not None and min_capacity > self._max_capacity:
            self._evict()
            return
        capacity = self._capacity
        while capacity < min_capacity:
            capacity *= 2
        while True:
            t0 = time.perf_counter()
            with self._tracer.span("pack.table_grow", from_capacity=self._capacity,
                                   to_capacity=capacity):
                new_table, leftover = rehash_table(self._table, capacity)
            self.grow_s += time.perf_counter() - t0
            if not leftover:
                break
            capacity *= 2
            if self._max_capacity is not None and capacity > self._max_capacity:
                self._evict()
                return
        self._table = new_table
        self._capacity = capacity
        self.table_growths += 1
        self._wi.table_grows.inc()
        self._wi.capacity.set(capacity)

    def _evict(self) -> None:
        """Growth under the budget: every tenant's claims since the last
        eviction drain into its own partition and the shared table resets.
        The pipeline drains first, so verdicts in flight land their keys
        before the flush (the FIFO merge fence)."""
        if self._pipe is not None:
            self._pipe.drain()
        deferred: Optional[TenantFaultError] = None
        for t in self.tenants():
            if t.resident and not t.faulted:
                try:
                    # Injection seam: one tenant's partition eviction dies.
                    # The other tenants still absorb, and the faulted
                    # tenant's payload rebuilds its visited set from the
                    # parent log, not from ``resident``.
                    fault_point("pack.tenant.evict", tenant=t.key)
                    fps = np.unique(np.concatenate(t.resident))
                    if len(fps):
                        self._partitions.store(t.key, registry=t.registry).evict(fps)
                    t.resident = []
                except BaseException as e:  # noqa: BLE001 - contained per tenant
                    t.faulted = True
                    t.fault_error = e
                    if deferred is None:
                        deferred = TenantFaultError(t.key, e)
                        deferred.__cause__ = e
        self._capacity = self._max_capacity
        self._table = hashset_new(self._capacity, self._device)
        self._l0 = 0
        self.evictions += 1
        self._wi.capacity.set(self._capacity)
        self._tracer.instant("pack.evict", capacity=self._capacity)
        if deferred is not None:
            raise deferred

    # -- the packed wave loop ------------------------------------------------

    def _quotas(self, ready: List[_Tenant], width: int) -> Dict[int, int]:
        """Deterministic fair lane split: an equal base share in rotating
        slot order, the rest to the tenants with deeper backlogs."""
        order = sorted(ready, key=lambda t: (t.slot - self._rr) % self._K)
        self._rr = (self._rr + 1) % self._K
        base = max(1, width // len(order))
        q: Dict[int, int] = {}
        rem = width
        for t in order:
            share = min(t.lanes.pending, base, rem)
            q[t.slot] = share
            rem -= share
        for t in order:
            if rem <= 0:
                break
            extra = min(t.lanes.pending - q[t.slot], rem)
            q[t.slot] += extra
            rem -= extra
        return q

    def _assemble(self, ready: List[_Tenant]):
        total = sum(t.lanes.pending for t in ready)
        width = bucket_for(self._buckets, max(1, min(total, self._F_max)))
        quotas = self._quotas(ready, width)
        fields = {k: np.zeros((width,), np.int64) for k in _FIELDS + ("tid",)}
        mask = np.zeros((width,), bool)
        leaves = [np.zeros((width,) + shape, dtype) for shape, dtype in self._leaf_specs]
        cursor = 0
        lanes_by_slot: Dict[int, int] = {}
        for t in sorted(ready, key=lambda t: t.slot):
            take = quotas.get(t.slot, 0)
            if take <= 0:
                continue
            got = 0
            for block in t.lanes.take(take):
                n = len(block["hi"])
                sl = slice(cursor, cursor + n)
                for k in _FIELDS:
                    fields[k][sl] = block[k]
                fields["tid"][sl] = t.slot
                mask[sl] = True
                for dst, src in zip(leaves, block["leaves"]):
                    dst[sl] = src
                cursor += n
                got += n
            lanes_by_slot[t.slot] = got
        return width, lanes_by_slot, dict(fields, mask=mask, leaves=leaves)

    def _salt_arrays(self):
        sh = np.zeros((self._K,), np.int64)
        sl = np.zeros((self._K,), np.int64)
        dc = np.full((self._K,), _DEPTH_INF, np.int64)
        for t in self.tenants():
            sh[t.slot] = t.salt_hi
            sl[t.slot] = t.salt_lo
            dc[t.slot] = min(t.depth_cap, _DEPTH_INF)
        return sh, sl, dc

    def _schedulable(self) -> List[_Tenant]:
        return [t for t in self.tenants()
                if not t.done and not t.finished and not t.faulted and t.lanes.pending > 0]

    def _tenant_snapshot(self, t: _Tenant) -> dict:
        """Everything one wave can change for a tenant, taken before
        ``_assemble`` takes its lanes (blocks are immutable once pushed, so
        the deque as a list of references is exact): a fault rolls the
        tenant back to this boundary."""
        with t.lanes._lock:
            blocks = list(t.lanes._blocks)
        return dict(
            state_count=t.state_count,
            unique_count=t.unique_count,
            max_depth=t.max_depth,
            discoveries=dict(t.discoveries_fp),
            wave_log_len=len(t.wave_log),
            resident_len=len(t.resident),
            lane_blocks=blocks,
            done=t.done,
        )

    def _tenant_rollback(self, t: _Tenant, snap: dict) -> None:
        """Restores a tenant to its pre-wave snapshot after a fault:
        scalars and discoveries rewind, the logs truncate, and the lane
        deque comes back whole (inputs taken included, survivors pushed
        dropped), so ``drop()`` hands back the exact payload of the last
        good wave boundary. ``resident`` only truncates: an eviction that
        emptied it absorbed those keys into the partition, which stays."""
        t.state_count = snap["state_count"]
        t.unique_count = snap["unique_count"]
        t.max_depth = snap["max_depth"]
        t.discoveries_fp = dict(snap["discoveries"])
        del t.wave_log[snap["wave_log_len"]:]
        del t.resident[snap["resident_len"]:]
        with t.lanes._lock:
            t.lanes._blocks = deque(snap["lane_blocks"])
            t.lanes.pending = sum(n for _b, n in snap["lane_blocks"])
        t.done = snap["done"]

    def step(self) -> List[object]:
        """One packed wave (or a finish pass when no lanes are pending).
        Returns the keys of the tenants that completed in this step (their
        ``view()`` holds the results). A :class:`TenantFaultError`
        (synchronous mode) names a tenant rolled back to its pre-wave
        boundary and taken off the schedule (``drop()`` it for its exact
        payload), every other tenant's state being consistent: keep
        stepping the others. With the async pipeline a fault poisons the
        pipeline and is engine-wide."""
        ready = self._schedulable()
        if not ready:
            if self._pipe is not None and self._pipe.pending():
                # Survivors may still be in flight: only an empty queue
                # after the barrier means a tenant is exhausted.
                self._pipe.drain()
                ready = self._schedulable()
            if not ready:
                return self._finish_idle()
        if self._pipe is not None:
            self._pipe.throttle()
        snaps = {t.slot: (t, self._tenant_snapshot(t)) for t in ready}
        t0 = time.perf_counter()
        width, lanes_by_slot, frontier = self._assemble(ready)
        self.assemble_s += time.perf_counter() - t0
        live = sum(lanes_by_slot.values())
        self.waves += 1
        self.lanes_live += live
        self.lanes_dispatched += width
        self._c_lanes_live.inc(live)
        self._c_lanes_dispatched.inc(width)
        try:
            with self._tracer.span("pack.wave", wave=self.waves, bucket=width,
                                   tenants=len(lanes_by_slot)) as span:
                gens, news = self._run_attempts(frontier, width, lanes_by_slot)
                self._wi.record(
                    span, frontier=width, generated=int(gens.sum()), n_new=int(news.sum()),
                    occupancy=self._l0 / self._capacity, capacity=self._capacity,
                    max_depth=max((t.max_depth for t in self.tenants()), default=0),
                    bucket=width, compaction_ratio=live / width, tenants=len(lanes_by_slot),
                )
        except TenantFaultError as e:
            if self._pipe is None:
                if e.pre_dispatch:
                    # The wave never ran: every participant's inputs go back.
                    for t, snap in snaps.values():
                        self._tenant_rollback(t, snap)
                else:
                    # Every tenant flagged in this wave rolls back (an
                    # eviction can fault several), not only the one named.
                    for t, snap in snaps.values():
                        if t.faulted or t.key == e.tenant_key:
                            self._tenant_rollback(t, snap)
                ft = self._by_key.get(e.tenant_key)
                if ft is not None:
                    ft.faulted = True
                self._tracer.instant("pack.tenant_fault", tenant=str(e.tenant_key),
                                     pre_dispatch=e.pre_dispatch)
            raise
        return self._finish_idle()

    def faulted_keys(self) -> List[object]:
        """Every resident tenant flagged faulted: the caller drops each (a
        wave can fault several)."""
        return [t.key for t in self.tenants() if t.faulted]

    def fault_error(self, key) -> Optional[BaseException]:
        """The flagged tenant's own exception."""
        t = self._by_key.get(key)
        return t.fault_error if t is not None else None

    def _run_attempts(self, frontier, width, lanes_by_slot):
        """The wave, and its growth retries: one upload of the frontier,
        then, each attempt, the wave, its one stats read and one copy of
        its fresh prefix; each attempt's fresh lanes are verdicted apart.
        Returns the per-slot generated (first attempt) and fresh (all
        attempts) vectors."""
        K = self._K
        try:
            self._ensure_capacity(width * self._A)
        except TenantFaultError as e:
            # An eviction fault before the wave: nothing ran, so every
            # participant's inputs can go back.
            e.pre_dispatch = True
            raise
        t0 = time.perf_counter()
        sh, sl, dc = self._salt_arrays()
        n_leaves = len(self._leaf_specs)
        dev = _upload([frontier["hi"], frontier["lo"], frontier["ebits"], frontier["depth"],
                       frontier["mask"], frontier["tid"], sh, sl, dc, *frontier["leaves"]],
                      self._device)
        hi, lo, ebits, depth, mask, tid, dsh, dsl, ddc = dev[:9]
        leaves = dev[9:9 + n_leaves]
        self.assemble_s += time.perf_counter() - t0
        gens = np.zeros((K,), np.int64)
        news = np.zeros((K,), np.int64)
        attempt = 0
        deferred: Optional[TenantFaultError] = None
        while True:
            # Injection seam: a raise of the shared wave is engine-wide
            # (every tenant's lanes ride it).
            fault_point("device.wave")
            t0 = time.perf_counter()
            self._table, out = self._wave(self._table, leaves, hi, lo, ebits, depth, mask,
                                          tid, dsh, dsl, ddc)
            stats = out["stats"].tolist()  # the wave's one read
            self.wave_s += time.perf_counter() - t0
            overflow, any_hit = stats[0], stats[1]
            gen_t = np.asarray(stats[2:2 + K], np.int64)
            new_t = np.asarray(stats[2 + K:2 + 2 * K], np.int64)
            maxd_t = stats[2 + 2 * K:2 + 3 * K]
            base = 2 + 3 * K
            live_n = 0
            if self._live_enabled:
                live_n = stats[base]
                base += 1
            if attempt == 0:
                gens += gen_t
                self._apply_stats(gen_t, maxd_t, any_hit, stats[base:])
            news += new_t
            n_total = int(new_t.sum())
            self._l0 += n_total
            t0 = time.perf_counter()
            rows = self._fresh_rows(out, n_total, live_n) if n_total or live_n else None
            self.copy_s += time.perf_counter() - t0
            del out
            ticket = dict(
                rows=rows,
                new_t=new_t,
                gen_t=gen_t if attempt == 0 else np.zeros((K,), np.int64),
                width=width,
                lanes_by_slot=lanes_by_slot if attempt == 0 else {},
            )
            if self._pipe is None:
                try:
                    self._verdict(ticket)
                except TenantFaultError as e:
                    # The other tenants' growth retries still run, so their
                    # wave completes; the flagged tenant is skipped by later
                    # verdicts and rolled back by the caller.
                    if deferred is None:
                        deferred = e
            else:
                self._pipe.submit(lambda tk=ticket: self._verdict(tk))
            if not overflow:
                if deferred is not None:
                    raise deferred
                return gens, news
            if self._max_capacity is not None and attempt >= 8:
                raise RuntimeError(
                    "a packed wave's candidates overflow the budget-capped shared table "
                    "after repeated evictions; raise the budget or shrink "
                    "frontier_capacity"
                )
            try:
                self._grow(self._capacity * 2)
            except TenantFaultError as e:
                # An eviction fault between attempts: the retry never runs,
                # so every tenant's wave is incomplete.
                raise RuntimeError(
                    "packed eviction failed mid-wave (overflow retry pending); "
                    "engine-wide fault"
                ) from e
            attempt += 1

    def _apply_stats(self, gen_t, maxd_t, any_hit, props) -> None:
        """The first attempt's bookkeeping: generated and depth counters and
        each tenant's discoveries (``props``: per property and tenant, the
        hit, then the fingerprints' hi and lo words). A tenant with every
        property discovered stops, as the solo loop exits."""
        P, K = len(self._properties), self._K
        for t in self.tenants():
            k = t.slot
            t.state_count += int(gen_t[k])
            t.max_depth = max(t.max_depth, int(maxd_t[k]))
            if not (P and any_hit):
                continue
            for i, p in enumerate(self._properties):
                j = i * K + k
                if props[j] and p.name not in t.discoveries_fp:
                    t.discoveries_fp[p.name] = fp_to_int(props[P * K + j], props[2 * P * K + j])
            if len(t.discoveries_fp) == P and not t.done:
                t.done = True
                t.lanes.clear()

    def _verdict(self, ticket: dict) -> None:
        """One wave attempt's host half (the pipeline worker in async
        mode): each tenant's edge rows into its liveness partition, its
        partition probe, parent-log append and survivors' re-entry at the
        tail of its queue, and its lane accounting."""
        t0 = time.perf_counter()
        rows = ticket["rows"]
        width = ticket["width"]
        live = rows["live"] if rows is not None else None
        tid = rows["tid"] if rows is not None else None
        deferred: Optional[TenantFaultError] = None
        for t in self.tenants():
            if t.faulted:
                # A flagged tenant rolls back to its pre-wave boundary
                # anyway: applying this wave would only corrupt its payload.
                continue
            k = t.slot
            n_k = int(ticket["new_t"][k])
            survivors = 0
            stale = 0
            try:
                if live is not None and not t.done:
                    # This tenant's edge rows into its own partition, inside
                    # the per-tenant try: an absorb fault drops only this
                    # tenant (absorbs are idempotent, so a retry absorbing
                    # them again is harmless).
                    lsel = np.flatnonzero(live["tid"] == k)
                    if len(lsel):
                        self._live_tenant_store(t).absorb(
                            **{c: live[c][lsel] for c in EDGE_COLS})
                if n_k and not t.done:
                    # Injection seam: one tenant's verdict slice dies before
                    # any of its state changes.
                    fault_point("pack.tenant.verdict", tenant=t.key)
                    sel = np.flatnonzero(tid == k)
                    child = fp64_pairs(rows["hi"][sel], rows["lo"][sel])
                    keep = None
                    store = self._partitions.get(t.key)
                    if store is not None and not store.is_empty():
                        stale_mask = store.probe(child)
                        stale = int(stale_mask.sum())
                        if stale:
                            keep = np.flatnonzero(~stale_mask)
                    kept = sel if keep is None else sel[keep]
                    survivors = len(kept)
                    if survivors:
                        if keep is not None:
                            child = child[keep]
                        parent = fp64_pairs(rows["parent_hi"][kept], rows["parent_lo"][kept])
                        t.wave_log.append((child, parent))
                        t.resident.append(child)
                        t.unique_count += survivors
                        block = _take_block(
                            {"leaves": rows["leaves"], **{f: rows[f] for f in _FIELDS}}, kept)
                        t.lanes.push(block, survivors)
                # A tenant with every property discovered drops its late
                # fresh lanes: the solo loop would never expand them either.
            except BaseException as e:  # noqa: BLE001 - contained per tenant
                # Flag now (later attempts skip the tenant) and raise once
                # every other tenant's slice has applied.
                t.faulted = True
                t.fault_error = e
                if deferred is None:
                    deferred = TenantFaultError(t.key, e)
                    deferred.__cause__ = e
                continue
            lanes_k = ticket["lanes_by_slot"].get(k, 0)
            if lanes_k or n_k:
                if stale:
                    t.instruments.stale.inc(stale)
                t.instruments.record_wave(
                    lanes=lanes_k, width=width, generated=int(ticket["gen_t"][k]),
                    n_new=survivors, pending=t.lanes.pending, max_depth=t.max_depth,
                )
        self.verdict_s += time.perf_counter() - t0
        if deferred is not None:
            raise deferred

    def _live_tenant_store(self, t: _Tenant):
        """The tenant's liveness edge partition, made on first use (its own
        store; the owner tag routes the fault seam's tenant filter)."""
        if t.live_store is None:
            t.live_store = LivenessEdgeStore(
                instruments=LivenessInstruments("pack", registry=t.registry), owner=t.key)
        return t.live_store

    def _tenant_liveness(self, t: _Tenant) -> None:
        """A finished tenant's device-liveness verdicts: the trim and reach
        over its own edge partition (unsalted fps) on the engine's device,
        so the packed verdict is the solo run's."""
        t.live_paths, t.live_outcomes = analyze_liveness(
            self._model, self._properties, self._ebit, self._live_tenant_store(t),
            self._host_fp, set(t.discoveries_fp), tracer=self._tracer, device=self._device,
        )
        self._tracer.instant(
            "pack.tenant_liveness", tenant=str(t.key),
            verdicts={k: v.get("verdict") for k, v in t.live_outcomes.items()},
        )

    def _ensure_capacity(self, incoming: int) -> None:
        need = self._l0 + incoming
        if need <= _MAX_LOAD * self._capacity:
            return
        self._grow(_pow2ceil(int(need / _MAX_LOAD)))

    def _finish_idle(self) -> List[object]:
        """Completes the tenants with no pending lanes. The first scan only
        spares the pipeline barrier while every tenant has work; the
        deciding scan runs after the barrier, when every push of a verdict
        is visible (a scan before it could finish a tenant whose survivors
        a verdict was still pushing)."""
        def scan():
            return [t for t in self.tenants()
                    if not t.finished and not t.faulted and (t.done or t.lanes.pending == 0)]

        if not scan():
            return []
        if self._pipe is not None and self._pipe.pending():
            self._pipe.drain()
        finished = []
        for t in scan():
            t.done = True
            if self._live_enabled:
                # Its verdicts exist before is_done() can see the finish.
                self._tenant_liveness(t)
            t.finished = True
            t.lanes.clear()
            finished.append(t.key)
            self._tracer.instant("pack.tenant_done", tenant=str(t.key), unique=t.unique_count)
        return finished

    def release(self, key) -> None:
        """Frees a completed tenant's slot (its view keeps its results)."""
        t = self._by_key.get(key)
        if t is None:
            return
        if not t.finished:
            raise RuntimeError(
                "release() is for completed tenants; use drop() to preempt a live one")
        self._slots[t.slot] = None
        del self._by_key[t.key]
        self._partitions.drop(t.key)

    def close(self) -> None:
        if self._pipe is not None:
            try:
                self._pipe.drain()
            except Exception:  # noqa: BLE001 - poisoned: already surfaced
                pass
            finally:
                self._pipe.close()
