"""The tiered visited-fingerprint store (host side: L1 runs + L2 spill).

The port's copy of the JAX package's ``storage/tiered.py`` without
``TenantPartitions`` (tenancy waits for its module).
``TieredVisitedStore`` owns everything below the device table: evicted
fingerprints live in delta-compressed sorted runs (``runs.py``) fronted
by per-run Bloom filters. Runs merge LSM-style once their count passes
``merge_run_threshold`` (merging also drops duplicate keys a hot
fingerprint can accumulate by re-claiming an L0 slot after eviction), and
merged bulk spills to disk files when host bytes pass ``host_budget_mib``
— the run format is identical on disk, so probes are uniform.

Probe semantics are pure membership-union: a key is visited iff it is in
the device table OR any run here. The checker therefore stays
bit-identical to the single-tier path — each key's first global
appearance is the only one that survives the two-phase filter.

All batched numpy. Runs are immutable once built (``FingerprintRun``
never mutates in place — merges build NEW runs and swap the tier lists),
and a reentrant lock makes the list swaps and the probe's run iteration
atomic, so a reader on another thread (a checkpoint export, a stats pull)
never sees a torn tier. ``export_state()`` and ``load_state()`` carry the
JAX package's payload, so its checkpoints' tiers load here and the
reverse.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from ..telemetry import get_tracer, metrics_registry
from ..utils.faults import fault_point
from .runs import FingerprintRun

__all__ = [
    "StorageInstruments",
    "TieredVisitedStore",
    "max_table_rows_for_budget",
    "validate_budget_knobs",
]


def max_table_rows_for_budget(hbm_budget_mib: float) -> int:
    """The largest power-of-two device-table capacity whose allocation
    fits ``hbm_budget_mib`` — the ONE place the table's memory layout
    (8 bytes per (hi, lo) uint32 row plus the ``MAX_PROBES`` apron,
    ``ops/hashset.py``) is priced, shared by both device checkers so a
    layout change cannot mis-size one of them."""
    from ..ops.hashset import MAX_PROBES

    budget_rows = int(hbm_budget_mib * (1 << 20)) // 8
    cap = 1
    while cap * 2 + MAX_PROBES <= budget_rows:
        cap *= 2
    return cap


def validate_budget_knobs(hbm_budget_mib, host_budget_mib, spill_dir):
    """The shared knob-consistency check: the host tiers are reachable
    only through L0 eviction, so the host knobs are meaningless without
    the HBM budget."""
    if hbm_budget_mib is None and (
        host_budget_mib is not None or spill_dir is not None
    ):
        raise ValueError(
            "host_budget_mib/spill_dir require hbm_budget_mib: "
            "without an L0 budget nothing is ever evicted to the "
            "host tiers"
        )
    if spill_dir is not None and host_budget_mib is None:
        raise ValueError(
            "spill_dir requires host_budget_mib: runs spill to disk "
            "only when the host budget overflows, so a spill_dir alone "
            "would silently never be used"
        )

# L1 runs merge into one once this many accumulate (LSM compaction): keeps
# per-probe run count bounded and reclaims cross-run duplicate space.
MERGE_RUN_THRESHOLD = 8


class StorageInstruments:
    """Counters/gauges for one checker's tiered storage, named
    ``<prefix>.storage.*``. Counters accumulate across the stores a
    bundle serves and gauges are refreshed as sums over them."""

    def __init__(self, prefix: str, registry=None):
        reg = registry if registry is not None else metrics_registry()
        p = f"{prefix}.storage"
        self.prefix = p
        self.evictions = reg.counter(f"{p}.evictions")
        self.evicted_fps = reg.counter(f"{p}.evicted_fps")
        self.merges = reg.counter(f"{p}.merges")
        self.spills = reg.counter(f"{p}.spills")
        self.probe_batches = reg.counter(f"{p}.probe_batches")
        self.probe_keys = reg.counter(f"{p}.probe_keys")
        self.probe_hits_l1 = reg.counter(f"{p}.probe_hits.l1")
        self.probe_hits_l2 = reg.counter(f"{p}.probe_hits.l2")
        self.blocks_decoded = reg.counter(f"{p}.blocks_decoded")
        self.bloom_rejects = reg.counter(f"{p}.bloom_rejects")
        # Bloom audit (correctness-grade observability for the
        # probabilistic machinery): per-run probes and the keys that
        # PASSED the prefilter but missed the binary search — observed
        # false positives, compared against the configured
        # ``bloom.DESIGN_FP_RATE`` (<1%) bound by the audit test.
        self.bloom_probes = reg.counter(f"{p}.host_probe.bloom_probe_total")
        self.bloom_fps = reg.counter(f"{p}.host_probe.bloom_fp_total")
        self.l0_resident = reg.gauge(f"{p}.l0_resident")
        self.l1_runs = reg.gauge(f"{p}.l1_runs")
        self.l1_fps = reg.gauge(f"{p}.l1_fps")
        self.l2_runs = reg.gauge(f"{p}.l2_runs")
        self.l2_fps = reg.gauge(f"{p}.l2_fps")
        self.host_bytes = reg.gauge(f"{p}.host_bytes")
        self.disk_bytes = reg.gauge(f"{p}.disk_bytes")
        self.compression = reg.gauge(f"{p}.compression_ratio")
        self._stores: List["TieredVisitedStore"] = []
        # Peaks (bench legs report them; gauges only carry last values).
        self.peak_l0 = 0
        self.peak_l1_fps = 0
        self.peak_l2_fps = 0
        self.peak_host_bytes = 0
        self.peak_disk_bytes = 0

    def attach(self, store: "TieredVisitedStore") -> None:
        self._stores.append(store)

    def set_l0(self, resident: int) -> None:
        self.l0_resident.set(resident)
        self.peak_l0 = max(self.peak_l0, int(resident))

    def refresh(self) -> None:
        """Re-aggregates the tier gauges over every attached store."""
        l1_runs = l1_fps = l2_runs = l2_fps = 0
        host_b = disk_b = raw_b = 0
        for s in self._stores:
            l1_runs += len(s.l1)
            l2_runs += len(s.l2)
            l1_fps += sum(r.count for r in s.l1)
            l2_fps += sum(r.count for r in s.l2)
            host_b += s.host_bytes
            disk_b += s.disk_bytes
            raw_b += 8 * sum(r.count for r in s.l1 + s.l2)
        self.l1_runs.set(l1_runs)
        self.l1_fps.set(l1_fps)
        self.l2_runs.set(l2_runs)
        self.l2_fps.set(l2_fps)
        self.host_bytes.set(host_b)
        self.disk_bytes.set(disk_b)
        stored = host_b + disk_b
        if stored:
            self.compression.set(raw_b / stored)
        self.peak_l1_fps = max(self.peak_l1_fps, l1_fps)
        self.peak_l2_fps = max(self.peak_l2_fps, l2_fps)
        self.peak_host_bytes = max(self.peak_host_bytes, host_b)
        self.peak_disk_bytes = max(self.peak_disk_bytes, disk_b)

    def bench_stats(self) -> dict:
        """The storage record a bench leg carries (BENCH_r06 trajectory)."""
        stored = (self.host_bytes.snapshot() or 0) + (
            self.disk_bytes.snapshot() or 0
        )
        raw = 8 * (
            (self.l1_fps.snapshot() or 0) + (self.l2_fps.snapshot() or 0)
        )
        return {
            "evictions": self.evictions.snapshot(),
            "evicted_fps": self.evicted_fps.snapshot(),
            "merges": self.merges.snapshot(),
            "spills": self.spills.snapshot(),
            "probe_batches": self.probe_batches.snapshot(),
            "probe_keys": self.probe_keys.snapshot(),
            "probe_hits_l1": self.probe_hits_l1.snapshot(),
            "probe_hits_l2": self.probe_hits_l2.snapshot(),
            "bloom_probe_total": self.bloom_probes.snapshot(),
            "bloom_fp_total": self.bloom_fps.snapshot(),
            "bloom_fp_rate": (
                self.bloom_fps.snapshot() / self.bloom_probes.snapshot()
                if self.bloom_probes.snapshot()
                else None
            ),
            "peak_l0_resident": self.peak_l0,
            "peak_l1_fps": self.peak_l1_fps,
            "peak_l2_fps": self.peak_l2_fps,
            "peak_host_bytes": self.peak_host_bytes,
            "peak_disk_bytes": self.peak_disk_bytes,
            "compression_ratio": (raw / stored) if stored else None,
        }


class TieredVisitedStore:
    """L1 (host runs) + L2 (disk runs) behind a batched probe/evict API.

    ``host_budget_mib`` bounds L1 payload bytes; exceeding it spills the
    largest runs to ``spill_dir`` (required alongside the budget). With
    no budget, runs stay host-resident and ``spill_dir`` is unused.
    """

    def __init__(
        self,
        host_budget_mib: Optional[float] = None,
        spill_dir: Optional[str] = None,
        merge_run_threshold: int = MERGE_RUN_THRESHOLD,
        instruments: Optional[StorageInstruments] = None,
        prefix: str = "gpu_bfs",
        tracer=None,
    ):
        if host_budget_mib is not None and spill_dir is None:
            raise ValueError(
                "host_budget_mib needs spill_dir: exceeding the host "
                "budget spills runs to disk files"
            )
        self._host_budget = (
            None
            if host_budget_mib is None
            else int(host_budget_mib * (1 << 20))
        )
        self._spill_dir = spill_dir
        self._merge_threshold = max(2, merge_run_threshold)
        self._instr = (
            instruments
            if instruments is not None
            else StorageInstruments(prefix)
        )
        self._instr.attach(self)
        # A run-scoped tracer (checkers spawned with run_id=) stamps the
        # evict/merge/spill spans with the run id; default otherwise.
        self._tracer = tracer if tracer is not None else get_tracer()
        self._span_prefix = self._instr.prefix
        self._seq = 0
        # The merge fence (see the module docstring): reentrant because
        # evict() holds it across the merges/spills it triggers.
        self._fence = threading.RLock()
        self.l1: List[FingerprintRun] = []
        self.l2: List[FingerprintRun] = []

    # -- introspection -----------------------------------------------------

    @property
    def instruments(self) -> StorageInstruments:
        return self._instr

    @property
    def host_bytes(self) -> int:
        return sum(r.host_nbytes for r in self.l1 + self.l2)

    @property
    def disk_bytes(self) -> int:
        return sum(r.disk_nbytes for r in self.l2)

    @property
    def total_fps(self) -> int:
        """Stored key count (an upper bound on distinct keys until the
        next merge dedups cross-run twins)."""
        return sum(r.count for r in self.l1 + self.l2)

    def is_empty(self) -> bool:
        return not self.l1 and not self.l2

    # -- mutation ----------------------------------------------------------

    def evict(self, fps: np.ndarray) -> int:
        """Absorbs one L0 drain (u64 keys, any order, dupes allowed) as a
        new L1 run; returns the run's key count."""
        fps = np.unique(np.asarray(fps, np.uint64))
        if len(fps) == 0:
            return 0
        with self._fence, self._tracer.span(
            f"{self._span_prefix}.evict", fps=int(len(fps)),
        ):
            self.l1.append(FingerprintRun.build(fps))
            self._instr.evictions.inc()
            self._instr.evicted_fps.inc(int(len(fps)))
            if len(self.l1) >= self._merge_threshold:
                self._merge_l1()
            self._enforce_host_budget()
        self._instr.refresh()
        return int(len(fps))

    def _merge_l1(self) -> None:
        """LSM compaction: every L1 run merges into one sorted run (also
        deduping keys that appear in several runs)."""
        with self._tracer.span(
            f"{self._span_prefix}.merge", runs=len(self.l1),
            fps=sum(r.count for r in self.l1),
        ):
            merged = np.unique(
                np.concatenate([r.decode_all() for r in self.l1])
            )
            self.l1 = [FingerprintRun.build(merged)]
            self._instr.merges.inc()

    def _enforce_host_budget(self) -> None:
        if self._host_budget is None:
            return
        while self.host_bytes > self._host_budget and self.l1:
            # Spill the largest L1 run: biggest single relief per file.
            # Spill FIRST, then swap tiers: an ENOSPC mid-write must
            # leave the run in L1 (membership intact, retryable on the
            # next eviction), never dropped from both tiers.
            run = max(self.l1, key=lambda r: r.count)
            spilled = self._spill_run(run)
            self.l1.remove(run)
            self.l2.append(spilled)
        if len(self.l2) >= self._merge_threshold:
            self._merge_l2()

    def _merge_l2(self) -> None:
        """L2 compaction: all spill files merge into one (dedup + one
        fd + one Bloom check per probe instead of one per retired run —
        a long tight-budget run must not grow fds and probe latency
        linearly with its eviction count). The merged keys pass through
        host memory once, like every LSM compaction."""
        with self._tracer.span(
            f"{self._span_prefix}.merge", runs=len(self.l2),
            fps=sum(r.count for r in self.l2), tier="l2",
        ):
            merged = np.unique(
                np.concatenate([r.decode_all() for r in self.l2])
            )
            # Write the merged run BEFORE destroying its sources: a
            # spill failure here must leave every old run probeable.
            new_run = self._spill_run(FingerprintRun.build(merged))
            for r in self.l2:
                r.close()
                if r.path is not None:
                    try:
                        os.remove(r.path)
                    except OSError:
                        pass
            self.l2 = [new_run]
            self._instr.merges.inc()

    def _spill_run(self, run: FingerprintRun) -> FingerprintRun:
        # Injection seam: ENOSPC / EIO at the spill write, before any
        # tier list mutates (see _enforce_host_budget's ordering).
        fault_point("storage.spill")
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir, f"run{self._seq:05d}.fpr")
        self._seq += 1
        with self._tracer.span(
            f"{self._span_prefix}.spill", fps=run.count,
            bytes=run.payload_nbytes,
        ):
            spilled = run.spill(path)
            self._instr.spills.inc()
        return spilled

    # -- probe -------------------------------------------------------------

    def probe(self, fps: np.ndarray) -> np.ndarray:
        """Membership mask over all runs (L1 first — newer, hotter — then
        L2). Keys already found skip the remaining runs."""
        fps = np.asarray(fps, np.uint64)
        found = np.zeros(len(fps), bool)
        if len(fps) == 0 or self.is_empty():
            return found
        # Injection seam: a real host probe can die on a torn spill
        # file, a failing disk read, or a poisoned mmap — always before
        # any result is applied, so a faulted probe never half-updates
        # the wave's verdict.
        fault_point("storage.host_probe")
        stats: dict = {}
        hits = {"l1": 0, "l2": 0}
        bloom_probed = 0
        bloom_fp = 0
        with self._fence, self._tracer.span(
            f"{self._span_prefix}.probe", keys=int(len(fps)),
        ) as sp:
            for tier, runs in (("l1", self.l1), ("l2", self.l2)):
                for run in runs:
                    rem = np.flatnonzero(~found)
                    if len(rem) == 0:
                        break
                    passed0 = stats.get("bloom_passed", 0)
                    sub = run.probe(fps[rem], stats)
                    found[rem] = sub
                    hits[tier] += int(sub.sum())
                    # Bloom audit: keys this run's BLOOM LAYER passed
                    # (range filters excluded — they are exact, and
                    # counting their rejects would dilute the rate) that
                    # the run then did not contain are observed false
                    # positives. Tracked against bloom.DESIGN_FP_RATE.
                    passed = stats.get("bloom_passed", 0) - passed0
                    bloom_probed += len(rem)
                    bloom_fp += max(0, passed - int(sub.sum()))
            sp.set(
                hits_l1=hits["l1"],
                hits_l2=hits["l2"],
                blocks_decoded=stats.get("blocks_decoded", 0),
                bloom_rejects=stats.get("bloom_rejects", 0),
                bloom_fp=bloom_fp,
            )
        self._instr.probe_batches.inc()
        self._instr.probe_keys.inc(int(len(fps)))
        self._instr.probe_hits_l1.inc(hits["l1"])
        self._instr.probe_hits_l2.inc(hits["l2"])
        self._instr.blocks_decoded.inc(stats.get("blocks_decoded", 0))
        self._instr.bloom_rejects.inc(stats.get("bloom_rejects", 0))
        self._instr.bloom_probes.inc(bloom_probed)
        self._instr.bloom_fps.inc(bloom_fp)
        return found

    # -- checkpoint round trip --------------------------------------------

    def export_state(self) -> dict:
        """Self-contained checkpoint payload (L2 payloads are read back in
        — a spill file may not exist on the restoring machine). The
        per-run state dicts are immutable snapshots (runs never mutate in
        place), so a payload exported at an epoch barrier stays valid
        even if later evictions merge or spill the live tier lists —
        what lets the async engine hand the pickle to its worker."""
        with self._fence:
            return {
                "seq": self._seq,
                "l1": [r.to_state() for r in self.l1],
                "l2": [r.to_state() for r in self.l2],
            }

    def load_state(self, state: dict) -> None:
        """Restores runs from a checkpoint (CRC-validated per run); L2
        runs re-spill to this store's ``spill_dir`` when it has one, else
        they stay host-resident (still budget-enforced on the next
        eviction)."""
        with self._fence:
            self._seq = int(state.get("seq", 0))
            self.l1 = [
                FingerprintRun.from_state(s) for s in state.get("l1", [])
            ]
            l2 = [FingerprintRun.from_state(s) for s in state.get("l2", [])]
            if self._spill_dir is not None:
                l2 = [self._spill_run(r) for r in l2]
            self.l2 = l2
        self._instr.refresh()
