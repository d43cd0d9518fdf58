"""Host tier for the device condition-false edge log.

The port's copy of the JAX package's ``storage/edge_log.py``.
``ops/edge_store.py`` keeps the edge relation on the device and
capacity-budgeted; when a wave could overflow it, the checker drains the
filled rows here — the same L0→host eviction discipline as the tiered
visited store, specialized for the liveness edge relation. The store
also owns the two small side tables the end-of-run analysis needs:

- **roots**: per eventually-property fingerprints of condition-false
  *init* states (the only legal starting points of a counterexample
  path);
- **terminals**: per-property fingerprints of condition-false states
  with no within-boundary successors at all (the masked-terminal
  certificate's anchor).

Edge chunks are stored per eviction as sorted-deduped numpy arrays
(parent64, child64, emask) — duplicate edges from repeated waves (a
table growth or a probe overflow runs a wave again) collapse at absorb
time, so memory tracks the DISTINCT relation, not the dispatch count.
``host_budget_mib`` spills absorbed chunks to ``spill_dir`` as ``.npz``
files (CRC-validated on read-back), mirroring the L1→L2 discipline of
``storage/tiered.py``.

The whole store rides the checkpoint payload (format version 3, see
``checker/gpu.py``): a preempted or periodically checkpointed run
restores it bit-identically, so the final verdict never depends on where
the run was cut. The absorbs take u32 values in any integer dtype (the
port's device log carries them in int64 columns).
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.faults import fault_point

__all__ = ["LivenessEdgeStore", "LivenessInstruments"]


class LivenessInstruments:
    """Counters/gauges for one checker's liveness edge store, named
    ``<prefix>.liveness.*``."""

    def __init__(self, prefix: str, registry=None):
        if registry is None:
            from ..telemetry import metrics_registry

            registry = metrics_registry()
        p = f"{prefix}.liveness"
        self.prefix = p
        self.edges = registry.counter(f"{p}.edge_store.edges_logged")
        self.evictions = registry.counter(f"{p}.edge_store.evictions")
        self.spills = registry.counter(f"{p}.edge_store.spills")
        self.host_bytes = registry.gauge(f"{p}.edge_store.host_bytes")
        self.occupancy = registry.gauge(f"{p}.edge_store.occupancy")
        self.analysis_seconds = registry.gauge(f"{p}.analysis_seconds")
        self.trim_rounds = registry.counter(f"{p}.trim_rounds")
        self.counterexamples = registry.counter(f"{p}.counterexamples")
        self.absences = registry.counter(f"{p}.absences_certified")

    def record_evict(self, n_edges: int, host_bytes: int) -> None:
        self.edges.inc(n_edges)
        self.evictions.inc()
        self.host_bytes.set(host_bytes)

    def record_spill(self, nbytes: int) -> None:
        self.spills.inc()


def _pack_cols(parent64, child64, emask) -> np.ndarray:
    """One absorbed chunk as a (n, 3) uint64 array (emask widened) —
    a single contiguous allocation that np.unique can sort by rows."""
    out = np.empty((len(parent64), 3), np.uint64)
    out[:, 0] = parent64
    out[:, 1] = child64
    out[:, 2] = emask.astype(np.uint64)
    return out


class LivenessEdgeStore:
    """Host-resident condition-false edge relation for one checker (or
    one packed tenant). Thread discipline matches the tiered store: the
    absorbs and the analysis run on the checker's worker thread, and a
    lock guards what another thread may read (``stats``, a checkpoint
    export)."""

    def __init__(self, instruments=None, spill_dir: Optional[str] = None,
                 host_budget_mib: Optional[float] = None, owner=None):
        self._chunks: List[np.ndarray] = []
        # Spilled chunk file paths, in absorb order.
        self._spilled: List[str] = []
        self._spill_dir = spill_dir
        self._budget_bytes = (
            int(host_budget_mib * (1 << 20))
            if host_budget_mib is not None
            else None
        )
        self._host_bytes = 0
        self._owner = owner
        self._seq = 0
        self._lock = threading.Lock()
        # fp64 -> per-property bit mask (u32 bits = eventually slots).
        self.roots: Dict[int, int] = {}
        self.terminals: Dict[int, int] = {}
        self.edges_logged = 0       # rows absorbed (pre-dedup)
        self.evictions = 0
        self._ins = instruments

    # -- absorb (the eviction target) ---------------------------------------

    def absorb(self, phi, plo, chi, clo, emask, tmask) -> None:
        """One device-store eviction: raw u32 columns of the filled
        prefix. Edge rows (emask != 0) dedup into a sorted chunk;
        terminal rows (tmask != 0) land in the per-property terminal
        sets."""
        # Injection seam: the absorb is host work over device pulls —
        # a numpy OOM or spill ENOSPC here must fault the run visibly,
        # never silently drop edges (a dropped edge is an unsound
        # "absence" verdict later).
        fault_point("liveness.edge_evict", tenant=self._owner)
        phi = np.asarray(phi)
        plo = np.asarray(plo)
        emask = np.asarray(emask)
        tmask = np.asarray(tmask)
        p64 = (phi.astype(np.uint64) << np.uint64(32)) | plo.astype(
            np.uint64
        )
        esel = emask != 0
        n_edges = int(esel.sum())
        with self._lock:
            self.edges_logged += n_edges
            self.evictions += 1
        if n_edges:
            chi = np.asarray(chi)
            clo = np.asarray(clo)
            c64 = (chi.astype(np.uint64) << np.uint64(32)) | clo.astype(
                np.uint64
            )
            chunk = np.unique(
                _pack_cols(p64[esel], c64[esel], emask[esel]), axis=0
            )
            with self._lock:
                self._chunks.append(chunk)
                self._host_bytes += chunk.nbytes
            self._enforce_budget()
        tsel = tmask != 0
        if tsel.any():
            for fp, m in zip(p64[tsel], tmask[tsel]):
                self.add_terminal(int(fp), int(m))
        if self._ins is not None:
            self._ins.record_evict(n_edges, self._host_bytes)

    def add_roots(self, fp64s, masks) -> None:
        """Condition-false init fingerprints with their per-property
        bit masks (recorded once at seed time, restored on resume)."""
        with self._lock:
            for fp, m in zip(np.asarray(fp64s), np.asarray(masks)):
                if int(m):
                    self.roots[int(fp)] = self.roots.get(int(fp), 0) | int(m)

    def add_terminal(self, fp64: int, mask: int) -> None:
        with self._lock:
            self.terminals[fp64] = self.terminals.get(fp64, 0) | mask

    # -- budget / spill ------------------------------------------------------

    def _enforce_budget(self) -> None:
        if self._budget_bytes is None or self._spill_dir is None:
            return
        with self._lock:
            while self._host_bytes > self._budget_bytes and self._chunks:
                chunk = self._chunks.pop(0)
                self._seq += 1
                path = os.path.join(
                    self._spill_dir,
                    f"liveness-edges-{id(self):x}-{self._seq}.npz",
                )
                # Spill BEFORE dropping the in-memory copy (a failed
                # write must not lose the chunk from both tiers).
                fault_point("storage.spill", tenant=self._owner)
                np.savez(path, edges=chunk,
                         crc=np.uint64(zlib.crc32(chunk.tobytes())))
                self._spilled.append(path)
                self._host_bytes -= chunk.nbytes
                if self._ins is not None:
                    self._ins.record_spill(chunk.nbytes)

    def _load_spilled(self) -> List[np.ndarray]:
        out = []
        for path in self._spilled:
            with np.load(path) as z:
                chunk = z["edges"]
                if zlib.crc32(chunk.tobytes()) != int(z["crc"]):
                    raise ValueError(
                        f"liveness edge spill {path} failed CRC validation"
                    )
                out.append(chunk)
        return out

    # -- analysis-side reads -------------------------------------------------

    def edge_rows(self) -> np.ndarray:
        """The full deduped relation as one (n, 3) uint64 array
        (parent64, child64, emask) — spilled chunks re-read and
        CRC-checked. Analysis-time only."""
        with self._lock:
            chunks = list(self._chunks)
        chunks = self._load_spilled() + chunks
        if not chunks:
            return np.empty((0, 3), np.uint64)
        allr = np.concatenate(chunks)
        # Merge emasks of duplicate (parent, child) pairs across chunks
        # (a pair can log under different property bits in different
        # waves if conditions flip — masks OR together).
        order = np.lexsort((allr[:, 1], allr[:, 0]))
        allr = allr[order]
        same = np.concatenate(
            [[False], (allr[1:, 0] == allr[:-1, 0])
             & (allr[1:, 1] == allr[:-1, 1])]
        )
        group = np.cumsum(~same) - 1
        n_groups = int(group[-1]) + 1 if len(group) else 0
        emask = np.zeros((n_groups,), np.uint64)
        np.bitwise_or.at(emask, group, allr[:, 2])
        firsts = np.flatnonzero(~same)
        out = allr[firsts]
        out[:, 2] = emask
        return out

    def property_slice(self, bit: int, rows: Optional[np.ndarray] = None,
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
        """(src64, dst64, roots64, terminals64) for one eventually
        property's bit in the masks. ``rows`` (an ``edge_rows()``
        result) lets multi-property analyses pay the spill re-read and
        full-relation dedup once instead of once per property."""
        if rows is None:
            rows = self.edge_rows()
        b = np.uint64(1 << bit)
        sel = (rows[:, 2] & b) != 0
        with self._lock:
            roots = np.array(
                [fp for fp, m in self.roots.items() if m & (1 << bit)],
                np.uint64,
            )
            terms = np.array(
                [fp for fp, m in self.terminals.items() if m & (1 << bit)],
                np.uint64,
            )
        return rows[sel, 0], rows[sel, 1], roots, terms

    def stats(self) -> dict:
        with self._lock:
            return {
                "edges_logged": self.edges_logged,
                "evictions": self.evictions,
                "chunks": len(self._chunks),
                "spilled_chunks": len(self._spilled),
                "host_bytes": self._host_bytes,
                "roots": len(self.roots),
                "terminals": len(self.terminals),
            }

    # -- checkpoint (the v3 payload extension) -------------------------------

    def export_state(self) -> dict:
        """The store as a checkpoint payload fragment (spilled chunks
        folded back in — the checkpoint must be self-contained; CRC
        guards the restore)."""
        rows = self.edge_rows()
        with self._lock:
            return {
                "edges": rows,
                "crc": zlib.crc32(rows.tobytes()),
                "roots": dict(self.roots),
                "terminals": dict(self.terminals),
                "edges_logged": self.edges_logged,
                "evictions": self.evictions,
            }

    def load_state(self, state: dict) -> None:
        rows = np.asarray(state["edges"], np.uint64).reshape(-1, 3)
        if zlib.crc32(rows.tobytes()) != state["crc"]:
            raise ValueError(
                "liveness edge-store checkpoint failed CRC validation"
            )
        with self._lock:
            if len(rows):
                self._chunks.append(rows)
                self._host_bytes += rows.nbytes
            self.roots.update(
                {int(k): int(v) for k, v in state["roots"].items()}
            )
            for fp, m in state["terminals"].items():
                cur = self.terminals.get(int(fp), 0)
                self.terminals[int(fp)] = cur | int(m)
            self.edges_logged += int(state["edges_logged"])
            self.evictions += int(state["evictions"])
