"""Fingerprint-sharded BFS: each shard owns a slice of the visited set.

The port of the JAX package's ``parallel/sharded.py``
(``ShardedTpuBfsChecker``). Every shard of a ``ShardMesh`` owns

- a slice of the visited set, its own hash table, keyed by fingerprint
  range: ``owner = hi mod n``;
- a slice of each wave's frontier, which is purely data-parallel.

One wave, for every local shard at once:

1. the model stage expands each shard's frontier slice (F x A candidates)
   and fingerprints the candidates (the staged torch wave's stages,
   ``ops/fused_wave.py``); under symmetry the visited keys are the orbit
   keys (``checker/symmetry.py``);
2. each shard keeps one lane a distinct key (a stable sort: the lowest
   lane wins) and buckets the survivors by owner, in fixed ``(n, R)``
   buckets whose (0, 0) rows are padding; the buckets go to their owners:
   in one process a transpose of the ``(n_src, n_dst, R)`` tensor on the
   device, across processes one ``all_to_all_single``; either way an
   owner receives its rows in global source-shard order, each source's
   bucket in lane order;
3. each owner sorts what it received by (hi, lo), keeps the first copy of
   each key and inserts the batch into its table through
   ``ops/hashset_kernel.py::hashset_insert_sorted`` (the insert kernel
   ``csrc/hashset_insert.cu`` on the card, one launch a shard, its plain
   twin on the CPU), and the flags go back to the sending lanes by the
   reverse exchange: exactly one lane wins each key across the mesh, the
   one the JAX package's ``all_to_all`` order makes win;
4. each shard compacts its fresh candidates, in lane order, into its
   slice of the next frontier.

With the sieve on (``sieve=True``; ``ops/comm_sieve.py``) each shard
first drops the lanes its receipt cache proves resident at their owner,
and the exchange runs at the smallest rung of a base-4 ladder holding the
mesh-wide largest bucket (one MAX over the shards, read to the host since
the rung sets a shape); only owner-acknowledged lanes enter the cache and
the filter. Results are bit-identical with the sieve off.

The host loop is the JAX package's: a host pool of row batches cut into
chunks of ``n x bucket`` lanes (the bucket ladder), dealt round-robin to
the shards, wave at a time; or the deep drain, a loop of waves over
per-shard frontier rings (``ops/ring.py``'s arithmetic, one ring a
shard), whose fresh rows are dealt round-robin to every shard (the
balance exchange) and whose exit is a vote of the shards (one sum over
the shards, an all-reduce of one small vector a wave across processes).
The drain runs uncaptured here: a host loop whose rows stay on the
device, one read of the vote a wave. Tables grow by doubling, each shard
rehashed locally through the insert kernel (keys never change owner).

Across processes (``bootstrap_mesh``) every rank runs the same host loop:
host reads of sharded values gather (``all_gather_into_tensor``), so every
rank holds the same pool, parent map and verdicts, and each rank uploads
only its own shards' slices. Process 0 writes checkpoints.

Checkpoints (kind ``"sharded_gpu_bfs"``) store the counters, the parent
map and the pending frontier; the tables are rebuilt from the parent
map's keys through the routed insert, so a checkpoint resumes on a mesh of
any size. As in the JAX package, the deep drain's depth labels are those
of first claims (``max_depth()`` and path lengths are upper bounds); counts
and verdicts are exact, and the wave path's paths are the JAX package's.

Out of core (``hbm_budget_mib``, with ``host_budget_mib`` and
``spill_dir``): each shard's table is capped, and growth past the cap
evicts every shard's live keys into that shard's own host tier
(``storage.TieredVisitedStore``, the host budget divided by n; across
processes the keys travel delta-encoded, ``_allgather_evicted_keys``),
resets the tables at the cap and flushes the sieve, whose receipts must
only cover keys the tables hold. The fresh rows of each wave then probe
the union of the tiers at the harvest, and the ones a tier holds are
stale: results stay bit-identical to the unbounded run. The budget forces
the wave path. Checkpoints carry the tiers' runs (``"storage"``); a
payload of m shards resumed on n re-evicts each key to its new owner's
tier, and the tables are rebuilt from the keys no tier holds.

``coverage=True`` reduces each wave's coverage vector on the device (the
JAX package's per-shard reductions, summed) and the host adds it at the
reads the wave already makes. ``attribution=True`` records the solo
checker's phases and windows (prefix ``sharded_bfs``).
``liveness="device"`` builds each wave's condition-false edge rows on the
device (``checker/device_liveness.py::wave_edge_rows``), absorbs them at
every wave attempt into one ``LivenessEdgeStore`` and runs the trim and
reach at the end; it forces the wave path. ``async_pipeline=True`` (one
process) runs each wave's harvest, the tier probe and the evictions'
absorbs on a ``HostPipeline`` worker while the next wave runs: the loop
dispatches ahead only while the pool holds a full chunk without the
verdicts in flight, so the waves are those of the synchronous run.
"""

from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.batch import BatchableModel, leaves, map_leaves
from ..core.model import Expectation
from ..core.path import Path
from ..ops import comm_sieve
from ..ops.fingerprint import U32, fp_to_int
from ..ops.fused_wave import (
    _exercised,
    _frontier_plain,
    _hit_lanes,
    antecedent_stage,
    model_stage,
    sorted_dedup,
)
from ..ops.hashset import MAX_PROBES, hashset_probe_length_counts, u32_to_i32
from ..ops.hashset_kernel import TILE_ROWS, hashset_insert_sorted, round_table_capacity
from ..telemetry import CommsInstruments, WaveInstruments, metrics_registry
from ..utils.faults import fault_point
from ..checker.device_liveness import seed_root_mask, validate_liveness_mode, wave_edge_rows
from ..checker.gpu import (
    _AUTO_BUCKET_MIN_F,
    _DEFAULT_BUCKET_STEPS,
    _chunk_to_host,
    _tree_to_device,
    atomic_pickle,
    bucket_for,
    bucket_ladder_widths,
    DeviceBfsChecker,
    checkpoint_header,
    live_table_keys,
    rehash_table,
    validate_checkpoint_header,
    wave_spec,
)
from ..checker.pipeline import HostPipeline
from ..checker.symmetry import make_key_fn, sym_key_scheme
from ..ops.edge_store import EDGE_COLS
from ..storage import (
    LivenessEdgeStore,
    LivenessInstruments,
    StorageInstruments,
    TieredVisitedStore,
    max_table_rows_for_budget,
    table_budget_mib,
    validate_budget_knobs,
)
from .base_mesh import ShardMesh, default_mesh

__all__ = ["CHECKPOINT_KIND", "ShardedGpuBfsChecker", "comm_rungs", "min_hbm_budget_mib",
           "run_summary"]

CHECKPOINT_KIND = "sharded_gpu_bfs"
_DEPTH_INF = (1 << 31) - 1
# The JAX sharded checker's load cap (its ``_MAX_LOAD``).
_MAX_LOAD = 0.5
# A shard's row of a wave's stats: counts, the lanes' max depth, the
# unique keys its table received, then (hit, hi, lo) a property.
_GENERATED, _N_NEW, _OVERFLOW, _MAX_DEPTH, _RECV_UNIQ = range(5)
_N_STATS = 5
# A comms row: lanes probed, killed by the cache, sent, Bloom hits among
# the sent, Bloom false positives, lanes shipped; then a one-hot rung.
_COMMS_HEAD = 6
# The drain's exit vote, summed over the shards: fresh lanes, ring rows,
# probe overflows, undiscovered property hits, shards whose log is full,
# shards whose ring is full, shards whose generated count nears the wrap.
_V_NEW, _V_COUNT, _V_OVERFLOW, _V_HIT, _V_LOG, _V_RING, _V_GEN = range(7)
_GEN_WRAP = 1 << 30


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _min_shard_rows(frontier_per_device: int, action_count: int):
    """The smallest per-shard table the budget may cap: a freshly evicted
    shard takes one wave of received keys under the load cap, the balanced
    share with 4x skew slack, as in the JAX package (a worse skew ends in
    the retry guard's error). Returns (routed keys, rows)."""
    worst = 4 * _pow2ceil(frontier_per_device) * action_count
    return worst, _pow2ceil(int(worst / _MAX_LOAD) + 1)


def min_hbm_budget_mib(frontier_per_device: int, action_count: int) -> float:
    """The smallest ``hbm_budget_mib`` that ``spawn_sharded_gpu_bfs``
    admits for ``frontier_per_device`` lanes a shard of a model with
    ``action_count`` packed actions."""
    return table_budget_mib(max(_min_shard_rows(frontier_per_device, action_count)[1],
                                TILE_ROWS))


def comm_rungs(m: int) -> list:
    """Ascending per-destination exchange widths for an ``m``-lane shard: a
    base-4 ladder from 8 lanes (8, 32, 128, ...) capped by the full width
    ``m`` (the JAX package's ``_comm_rungs``)."""
    rungs, r = [], 8
    while r < m:
        rungs.append(r)
        r <<= 2
    return rungs + [m]


def run_summary(checker) -> dict:
    """What two sharded runs of one configuration must share: counts,
    depth, each discovery's fingerprint and its path's fingerprints, and
    the exchange's lanes shipped and rungs dispatched (from the run's
    registry: give each run its own ``run_id``)."""
    checker._ingest_wave_log()
    snap = checker.metrics().snapshot()
    rung = "sharded_bfs.comms.rung_dispatch."
    return {
        "unique": checker.unique_state_count(),
        "states": checker.state_count(),
        "depth": checker.max_depth(),
        "discoveries": dict(sorted(checker._discoveries_fp.items())),
        "paths": {k: [int(x) for x in checker._store.chain(fp)]
                  for k, fp in sorted(checker._discoveries_fp.items())},
        "lanes_shipped": snap.get("sharded_bfs.comms.lanes_shipped", 0),
        "rungs": {int(k[len(rung):]): v for k, v in sorted(snap.items()) if k.startswith(rung)},
    }


def _fp64(hi, lo):
    return (hi << 32) | lo


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, its last dimension widened (so every
    dtype rides one collective)."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if x.dim() == 0:
        x = x.view(1)
    return x.view(torch.uint8)


def _from_bytes(b: torch.Tensor, like_dtype, shape) -> torch.Tensor:
    if like_dtype == torch.bool:
        return b.view(torch.uint8).view(shape).to(torch.bool)
    return b.view(like_dtype).view(shape)


class ShardedGpuBfsChecker(DeviceBfsChecker):
    """BFS over a ``ShardMesh``; requires a ``BatchableModel``.

    The JAX constructor's knobs and defaults: ``frontier_per_device`` is
    each shard's frontier width (a chunk is ``n`` times that),
    ``table_capacity_per_device`` each shard's initial table (a power of
    two; rounded up to a whole ``TILE_ROWS`` tile of the insert kernel,
    which ``config_notes`` says), ``max_drain_waves``,
    ``drain_log_factor``, ``pool_factor`` and ``bucket_ladder`` the deep
    drain's and the ladder's, ``checkpoint_*`` and ``resume_from`` the
    checkpoint's, ``sieve``, ``sieve_slots_per_device`` and
    ``sieve_bloom_bits`` the comm sieve's, ``hbm_budget_mib``,
    ``host_budget_mib`` and ``spill_dir`` the per-shard tiers', and
    ``coverage``, ``attribution``, ``liveness`` and ``async_pipeline``
    (module docstring). ``mesh`` is a ``ShardMesh`` (default:
    ``default_mesh(device=device)``). ``wave_kernel="fused"`` is refused, as
    in the JAX package. ``aot_store`` is accepted and caches nothing.
    ``fleet=True`` raises until the fleet ledger is ported (ROADMAP Queue 1
    #12b)."""

    supports_preempt = True
    supports_device_liveness = True

    def __init__(
        self,
        options,
        mesh: Optional[ShardMesh] = None,
        frontier_per_device: int = 1 << 10,
        table_capacity_per_device: int = 1 << 15,
        checkpoint_path=None,
        checkpoint_every_chunks=32,
        checkpoint_min_interval_s=0.0,
        resume_from=None,
        max_drain_waves=100_000,
        drain_log_factor=8,
        pool_factor=16,
        bucket_ladder=None,
        hbm_budget_mib=None,
        host_budget_mib=None,
        spill_dir=None,
        attribution=False,
        coverage=False,
        run_id=None,
        async_pipeline=False,
        liveness=None,
        wave_kernel="staged",
        aot_store=None,
        sieve=None,
        sieve_slots_per_device=None,
        sieve_bloom_bits=None,
        fleet=False,
        device=None,
    ):
        model = options.model
        if not isinstance(model, BatchableModel):
            raise TypeError(
                f"spawn_sharded_gpu_bfs requires a BatchableModel; "
                f"{type(model).__name__} does not implement the packed protocol"
            )
        if wave_kernel not in ("staged", "fused"):
            raise ValueError(f"wave_kernel must be 'staged' or 'fused', got {wave_kernel!r}")
        self._wave_kernel = "staged"
        self.wave_kernel_reason = (
            "wave_kernel='fused' has no sharded path: the fused Pallas "
            "megakernel runs one device's wave as a single kernel and "
            "cannot express the cross-shard all_to_all key exchange; "
            "use the single-device checker for the fused engine, or "
            "wave_kernel='staged' here"
            if wave_kernel == "fused" else None
        )
        if wave_kernel == "fused":
            raise ValueError(self.wave_kernel_reason)
        self.run_id = run_id
        self._registry = metrics_registry(run_id) if run_id else None
        if mesh is None:
            mesh = default_mesh(device=device)
        elif device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device={device!r} disagrees with the mesh's {mesh.device}")
        self._mesh = mesh
        self._device = mesh.device
        self._n = n = mesh.n
        self._L = mesh.local
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
        self._ebit: Dict[int, int] = {pi: b for b, pi in enumerate(eventually)}
        self._ebits0 = sum(1 << b for b in self._ebit.values())
        self._A = model.packed_action_count()
        self._F_loc = _pow2ceil(frontier_per_device)
        self._G = n * self._F_loc
        if bucket_ladder is None:
            bucket_ladder = (_DEFAULT_BUCKET_STEPS if self._F_loc >= _AUTO_BUCKET_MIN_F else 0)
        if bucket_ladder < 0:
            raise ValueError(f"bucket_ladder must be >= 0, got {bucket_ladder}")
        self._buckets = bucket_ladder_widths(self._F_loc, bucket_ladder)
        self.config_notes: List[str] = []
        asked = _pow2ceil(table_capacity_per_device)
        self._cap_loc = round_table_capacity(asked)
        if self._cap_loc != asked:
            self.config_notes.append(
                f"table_capacity_per_device rounded {asked} -> {self._cap_loc} (the "
                f"insert kernel grids over {TILE_ROWS}-row table tiles)"
            )
        self._sieve = bool(sieve) if sieve is not None else False
        if sieve_slots_per_device is None:
            sieve_slots_per_device = min(1 << 16, _pow2ceil(table_capacity_per_device))
        self._sieve_slots = _pow2ceil(max(8, sieve_slots_per_device))
        if sieve_bloom_bits is None:
            sieve_bloom_bits = comm_sieve.bloom_bits_for(
                min(int(_MAX_LOAD * _pow2ceil(table_capacity_per_device)), 1 << 20))
        if sieve_bloom_bits & (sieve_bloom_bits - 1):
            raise ValueError(f"sieve_bloom_bits must be a power of two, got {sieve_bloom_bits}")
        self._sieve_bits = sieve_bloom_bits
        self._sieve_dev = None
        if fleet:
            raise NotImplementedError(
                "fleet=True on the sharded GPU checker waits for the fleet ledger "
                "(telemetry/fleet.py, ROADMAP Queue 1 #12b); it is off by default")
        self._visitor = options._visitor
        # The async pipeline (module docstring). The pool takes a lock: the
        # worker appends survivors while this thread takes chunks; the
        # verdicts in flight are the coalescing barrier's predicate.
        self._async = bool(async_pipeline)
        if self._async and self._visitor is not None:
            raise ValueError(
                "async_pipeline is incompatible with a visitor: per-chunk "
                "callbacks reconstruct paths through verdicts the "
                "pipeline defers; drop the visitor or run synchronously"
            )
        if self._async and mesh.world > 1:
            raise ValueError(
                "async_pipeline is single-controller only: deferred "
                "verdicts issue process_allgather collectives from the "
                "worker thread, which cannot be ordered against the "
                "checker thread's across processes"
            )
        self._pool_lock = threading.Lock()
        self._inflight_verdicts = 0
        self._target_state_count: Optional[int] = options._target_state_count
        self._depth_cap = options._target_max_depth or _DEPTH_INF
        self._setup_lasso(options)
        symmetry = options._symmetry is not None
        self._live = validate_liveness_mode(liveness, symmetry=symmetry, expand_fps=False,
                                            options=options)

        self._checkpoint_path = checkpoint_path
        self._checkpoint_every = max(1, checkpoint_every_chunks)
        self._checkpoint_min_interval = checkpoint_min_interval_s
        self._resume_from = resume_from
        self._max_drain_waves = max(1, max_drain_waves)
        if checkpoint_path is not None:
            self._max_drain_waves = min(self._max_drain_waves, max(2, checkpoint_every_chunks))
        self._Ll = max(max(1, drain_log_factor) * self._F_loc, self._F_loc * self._A)
        self._PCl = _pow2ceil(max(max(1, pool_factor) * self._F_loc, self._F_loc * self._A))

        # Out of core: one tier a shard, the host budget divided among them.
        validate_budget_knobs(hbm_budget_mib, host_budget_mib, spill_dir)
        self._tiers: List[TieredVisitedStore] = []
        self._si = None
        self._max_cap_loc = None
        if hbm_budget_mib is not None:
            max_cap = max_table_rows_for_budget(hbm_budget_mib)
            worst, min_cap = _min_shard_rows(self._F_loc, self._A)
            if max_cap < min_cap:
                raise ValueError(
                    f"hbm_budget_mib={hbm_budget_mib} allows a per-shard "
                    f"table of {max_cap} rows, but one wave "
                    f"({worst} routed keys at 4x skew) needs at least "
                    f"{min_cap}; raise the budget or shrink "
                    "frontier_per_device"
                )
            if max_cap < TILE_ROWS:
                raise ValueError(
                    f"the hbm_budget_mib cap of {max_cap} rows a shard is less than one "
                    f"{TILE_ROWS}-row tile of the insert kernel; raise the budget"
                )
            self._max_cap_loc = max_cap
            self._cap_loc = min(self._cap_loc, max_cap)
            self._si = StorageInstruments("sharded_bfs", registry=self._registry)
            self._tiers = [
                TieredVisitedStore(
                    host_budget_mib=(host_budget_mib / n if host_budget_mib is not None
                                     else None),
                    spill_dir=spill_dir, instruments=self._si, shard=d,
                    tracer=self._tracer, owner=f"shard-{d}",
                )
                for d in range(n)
            ]
            # The host probe runs at each wave's harvest: wave at a time.
            self._max_drain_waves = 1

        # Device liveness: the edge rows of every wave attempt go to one
        # host store at the harvest; the drain has no harvest a wave, so the
        # knob forces the wave path.
        self._live_enabled = self._live == "device" and bool(self._ebit)
        self._live_paths: Dict[str, Path] = {}
        self._live_outcomes: Dict[str, dict] = {}
        if self._live_enabled:
            self._max_drain_waves = 1
            self._live_ins = LivenessInstruments("sharded_bfs", registry=self._registry)
            self._live_store = LivenessEdgeStore(
                instruments=self._live_ins, spill_dir=spill_dir,
                host_budget_mib=host_budget_mib,
            )

        self._init_attribution("sharded_bfs", attribution)
        if self._attr is not None and self._async:
            self._attr.set_overlap_mode(True)
        self._init_coverage("sharded_bfs", coverage, self._A, symmetry=symmetry)
        self._sym_scheme = sym_key_scheme(options._symmetry)
        self._sym = make_key_fn(model, model.packed_fingerprint, options._symmetry, self._device)
        self._spec = wave_spec(model, self._device, cov_layout=self._cov_layout,
                               cov_antecedents=self._cov_antecedents, symmetry=self._sym)

        self._state_count = 0
        self._unique_count = 0
        # Keys resident in the shard tables: the unique count until the
        # first eviction.
        self._l0_count = 0
        self._max_depth = 0
        self._discoveries_fp: Dict[str, int] = {}
        self._init_wave_log()
        self._key_log: List = []
        self._pool = deque()
        self._pool_count = 0
        self._preempt_event = threading.Event()
        self._done_event = threading.Event()
        self._error: Optional[BaseException] = None
        self.warmup_seconds: Optional[float] = None
        # Run statistics: waves run (a drain's included), drains, table
        # growths, ring growths, checkpoints written, the restore's insert
        # launches; out of core, the evictions, the fresh lanes a tier held
        # (``stale_lanes``) and the host probe's seconds.
        self.waves = 0
        self.drains = 0
        self.table_growths = 0
        self.ring_growths = 0
        self.checkpoints_written = 0
        self.restore_inserts = 0
        self.evictions = 0
        self.stale_lanes = 0
        self.host_probe_s = 0.0
        self._wi = WaveInstruments("sharded_bfs", registry=self._registry)
        self._ci = CommsInstruments("sharded_bfs", registry=self._registry)
        self._pipe = HostPipeline(name="sharded-gpu-bfs-host") if self._async else None
        self._handles = [threading.Thread(target=self._run, name="sharded-gpu-bfs", daemon=True)]
        self._handles[0].start()

    # -- the mesh's collectives ------------------------------------------------

    def _exchange(self, x: torch.Tensor) -> torch.Tensor:
        """The all-to-all of per-destination buckets: ``x`` is ``(L, n, R,
        ...)``, row ``[s, d]`` this process's shard ``s``'s bucket for
        global shard ``d``; returns ``(L, n, R, ...)``, row ``[t, s]`` the
        bucket global shard ``s`` sent this process's shard ``t``. In one
        process a transpose; across processes one ``all_to_all_single``
        between the same two reorderings."""
        mesh = self._mesh
        L, W = mesh.local, mesh.world
        rest = tuple(x.shape[2:])
        got = x.reshape((L, W, L) + rest).transpose(0, 1)
        if mesh.distributed:
            import torch.distributed as dist

            send = _as_bytes(got)
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=mesh.group)
            got = _from_bytes(recv, x.dtype, (W, L, L) + rest)
        # [w, s, t]: rank w's shard s's bucket for local shard t.
        perm = (2, 0, 1) + tuple(range(3, got.dim()))
        return got.permute(perm).reshape((L, W * L) + rest).contiguous()

    def _pull(self, x: torch.Tensor) -> torch.Tensor:
        """A per-shard tensor ``(L, ...)`` (or ``(L * k, ...)``) of this
        process as the mesh's ``(n, ...)`` (``(n * k, ...)``), on this
        process's device: every rank gets the same values."""
        mesh = self._mesh
        if not mesh.distributed:
            return x
        import torch.distributed as dist

        send = _as_bytes(x)
        recv = torch.empty((mesh.world * send.shape[0],) + tuple(send.shape[1:]),
                           dtype=torch.uint8, device=send.device)
        dist.all_gather_into_tensor(recv, send, group=mesh.group)
        return _from_bytes(recv, x.dtype, (mesh.world * x.shape[0],) + tuple(x.shape[1:]))

    def _allsum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the mesh's processes of a small int64 vector (this
        process's shards already summed)."""
        if self._mesh.distributed:
            import torch.distributed as dist

            dist.all_reduce(t, group=self._mesh.group)
        return t

    def _allmax(self, t: torch.Tensor) -> int:
        if self._mesh.distributed:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._mesh.group)
        return int(t)

    def _local(self, x):
        """This process's rows of a global per-shard-sliced array: ``(n * k,
        ...)`` -> ``(L * k, ...)``."""
        mesh = self._mesh
        if mesh.world == 1:
            return x
        k = x.shape[0] // mesh.n
        s = mesh.rank * mesh.local * k
        return x[s : s + mesh.local * k]

    def _put(self, tree):
        return map_leaves(self._local, tree)

    # -- the owner exchange and insert -------------------------------------------

    def _new_table(self):
        return torch.zeros((self._L, self._cap_loc + MAX_PROBES, 2), dtype=torch.int32,
                           device=self._device)

    def _new_sieve(self):
        """A cold sieve: one receipt cache and one Bloom filter a shard."""
        slots_log2 = self._sieve_slots.bit_length() - 1
        return (comm_sieve.cache_new(slots_log2, self._device, shards=self._L),
                comm_sieve.bloom_new(self._sieve_bits, self._device, shards=self._L))

    def _route(self, table, hi, lo, valid, sieve=None):
        """The exchange and claim-insert of ``(L, m)`` keys (the JAX
        ``_route_insert``, and with ``sieve``, the shards' (cache, filter),
        ``_route_insert_sieved``); returns ``(fresh, overflow, recv_uniq,
        comms)``: per lane whether it claimed a new row somewhere in the
        mesh, per shard the keys left pending and the unique keys its table
        received, and the shard's comms row."""
        L, n = self._L, self._n
        m = hi.shape[1]
        dev = hi.device
        if sieve is not None:
            cache, bloom = sieve
            kill = comm_sieve.cache_probe(cache, hi, lo, valid)
            bhit = comm_sieve.bloom_probe(bloom, hi, lo)
            send = valid & ~kill
        else:
            send = valid
        okey = torch.where(send, hi % n, n)
        okey_s, lane_s = torch.sort(okey, dim=1, stable=True)
        counts = torch.zeros((L, n + 1), dtype=torch.int64, device=dev)
        counts.scatter_add_(1, okey, torch.ones_like(okey))
        starts = torch.cumsum(counts, 1) - counts
        lanes = torch.arange(m, dtype=torch.int64, device=dev)
        pos = lanes - starts.gather(1, okey_s)
        rungs = comm_rungs(m) if sieve is not None else [m]
        ridx = 0
        if len(rungs) > 1:
            # The smallest rung at or above the mesh-wide largest bucket.
            need = self._allmax(counts[:, :n].max().reshape(1))
            ridx = sum(1 for r in rungs if need > r)
        R = rungs[ridx]
        fresh, ack, overflow, recv_uniq = self._exchange_at(
            table, hi, lo, lane_s, okey_s, pos, R, m)
        head = torch.zeros((L, _COMMS_HEAD), dtype=torch.int64, device=dev)
        head[:, 5] = n * R
        onehot = torch.zeros((L, len(rungs)), dtype=torch.int64, device=dev)
        onehot[:, ridx] = 1
        if sieve is not None:
            acked = send & ack
            comm_sieve.cache_insert(cache, hi, lo, acked)
            comm_sieve.bloom_insert(bloom, hi, lo, acked)
            head[:, :5] = torch.stack([valid.sum(1), kill.sum(1), send.sum(1),
                                       (bhit & send).sum(1), (bhit & send & fresh).sum(1)], 1)
        return fresh, overflow, recv_uniq, torch.cat([head, onehot], 1)

    def _exchange_at(self, table, hi, lo, lane_s, okey_s, pos, R, m):
        """The owner exchange at ``R`` lanes a destination and each owner's
        insert; returns per original lane ``(fresh, acked)`` and per shard
        ``(overflow, recv_uniq)``. ``acked``: the key is resident at its
        owner after the exchange (claimed or found, not pending)."""
        L, n = self._L, self._n
        nR = n * R
        dev = hi.device
        dest = torch.where((okey_s < n) & (pos < R), okey_s * R + pos, nR)
        key_s = _fp64(hi, lo).gather(1, lane_s)
        send = torch.zeros((L, nR + 1), dtype=torch.int64, device=dev)
        send.scatter_(1, dest, key_s)
        src_slot = torch.full((L, nR + 1), m, dtype=torch.int64, device=dev)
        src_slot.scatter_(1, dest, lane_s)
        recv = self._exchange(send[:, :nR].reshape(L, n, R)).reshape(L, nR)
        # (0, 0) pads the buckets; no fingerprint is (0, 0).
        shi, slo, sidx, uniq = sorted_dedup((recv >> 32) & U32, recv & U32, recv != 0)
        shi, slo = u32_to_i32(shi), u32_to_i32(slo)
        flags = [hashset_insert_sorted(table[d], shi[d], slo[d], uniq[d])[1:]
                 for d in range(L)]
        fresh_s = torch.stack([f[0] for f in flags])
        found_s = torch.stack([f[1] for f in flags])
        pending_s = torch.stack([f[2] for f in flags])
        flags_s = fresh_s.to(torch.uint8) | ((fresh_s | found_s).to(torch.uint8) << 1)
        flags_r = torch.zeros((L, nR), dtype=torch.uint8, device=dev).scatter_(1, sidx, flags_s)
        back = self._exchange(flags_r.reshape(L, n, R)).reshape(L, nR)
        fl = torch.zeros((L, m + 1), dtype=torch.uint8, device=dev)
        fl.scatter_(1, src_slot[:, :nR], back)
        fl = fl[:, :m]
        return (fl & 1) != 0, (fl & 2) != 0, pending_s.sum(1), uniq.sum(1)

    # -- one wave, every local shard ----------------------------------------------

    def _wave_core(self, table, fr, depth_cap):
        """One wave over this process's shards: ``fr`` holds the shards'
        frontier slices back to back (``L * F`` rows, ``mask`` the live
        lanes). Returns the shards' stats rows ``(L, 5 + 3P)``, comms rows,
        and each shard's fresh candidates compacted in lane order (``new``:
        ``(L, B)`` columns and ``L * B`` state rows; rows past a shard's
        ``n_new`` are zeros, lane 0's state), ``parent_hi``/``parent_lo``,
        and under symmetry the claimed keys ``new_khi``/``new_klo``."""
        spec, L, A = self._spec, self._L, self._A
        states, hi, lo, ebits, depth, mask = (fr[k] for k in ("states", "hi", "lo", "ebits",
                                                              "depth", "mask"))
        LF = hi.shape[0]
        F = LF // L
        B = F * A
        dev = hi.device
        cond, cvalid, cand_flat = model_stage(spec, states, LF)
        eval_mask, ebits_after, cvalid, terminal = _frontier_plain(
            spec, cond, cvalid, ebits, depth, depth_cap, mask)
        chi, clo = spec.fingerprint(cand_flat)
        khi, klo = chi, clo
        if self._sym is not None:
            khi, klo, _hold = self._sym.wave_keys(cand_flat, cvalid, exact=True)
        cv = cvalid.view(L, B)
        kh, kl = khi.view(L, B), klo.view(L, B)
        # One lane a distinct key goes out: the lowest.
        _shi, _slo, sidx, uniq = sorted_dedup(kh, kl, cv)
        route = torch.zeros_like(cv).scatter_(1, sidx, uniq)
        fresh, overflow, recv_uniq, comms = self._route(table, kh, kl, route,
                                                        self._sieve_dev)

        n_new = fresh.sum(1)
        order = torch.sort((~fresh).to(torch.int8), dim=1, stable=True).indices
        lanes = torch.arange(B, dtype=torch.int64, device=dev)
        live = lanes < n_new[:, None]
        src = torch.where(live, order, 0)
        shard = torch.arange(L, dtype=torch.int64, device=dev)[:, None]
        gsrc = (shard * B + src).reshape(-1)
        gpar = (shard * F + src // A).reshape(-1)

        def lane(x):
            return torch.where(live, x[gpar].view(L, B), 0)

        new = {
            "states": map_leaves(lambda x: x[gsrc], cand_flat),
            "hi": torch.where(live, chi.view(L, B).gather(1, src), 0),
            "lo": torch.where(live, clo.view(L, B).gather(1, src), 0),
            "ebits": lane(ebits_after),
            "depth": torch.where(live, depth[gpar].view(L, B) + 1, 0),
        }
        out = {"new": new, "parent_hi": lane(hi), "parent_lo": lane(lo), "comms": comms}
        if self._sym is not None:
            out["new_khi"] = torch.where(live, kh.gather(1, src), 0)
            out["new_klo"] = torch.where(live, kl.gather(1, src), 0)
        items = [cv.sum(1), n_new, overflow,
                 torch.where(mask, depth, 0).view(L, F).max(1).values, recv_uniq]
        hv, lv = hi.view(L, F), lo.view(L, F)
        for h in _hit_lanes(spec, cond, eval_mask, terminal, ebits_after):
            h = h.view(L, F)
            idx = h.to(torch.uint8).argmax(1, keepdim=True)
            items += [h.any(1), hv.gather(1, idx)[:, 0], lv.gather(1, idx)[:, 0]]
        out["stats"] = torch.stack([x.to(torch.int64) for x in items], 1)
        if self._cov is not None:
            # The JAX package's per-shard coverage reductions, summed over
            # this process's shards: ``fresh`` marks each shard's own claim
            # winners, so the per-action fresh counts stay exact across the
            # exchange; under symmetry the in-wave distinct counts are each
            # shard's, summed, as there.
            lay = self._cov_layout
            uniq_fp = uniq_key = None
            if self._sym is not None:
                ch, cl = chi.view(L, B), clo.view(L, B)
                uniq_fp = sum(lay.count_distinct(ch[d], cl[d], cv[d]) for d in range(L))
                uniq_key = sum(lay.count_distinct(kh[d], kl[d], cv[d]) for d in range(L))
            flat = torch.arange(LF * A, dtype=torch.int64, device=dev)
            out["cov"] = lay.wave_reduce(
                eval_mask=eval_mask, cvalid=cvalid.view(LF, A), fresh=fresh.reshape(-1),
                lane_action=flat % A, new_depth=depth[flat // A] + 1,
                exercised=_exercised(spec, cond, antecedent_stage(spec, states, LF),
                                     eval_mask, ebits_after),
                uniq_fp=uniq_fp, uniq_key=uniq_key)
        if self._live_enabled:
            # The condition-false edge and terminal rows of this process's
            # lanes, compacted; pulled at the harvest (the store dedups).
            out["live"], out["live_n"] = wave_edge_rows(
                spec.conditions, dict(spec.ebit), cond, cand_flat, cvalid, terminal,
                hi, lo, chi, clo, A)
        return out

    def _call_wave(self, table, dev):
        """One wave through ``_wave_core``, its stats and comms read once
        (gathered over the mesh); returns ``(out, stats)``, ``stats`` the
        ``(n, 5 + 3P)`` rows as host lists. The same read carries the
        mesh's coverage vector (``out["cov_vec"]``) and each process's
        count of edge rows (``out["live_ns"]``)."""
        fault_point("device.wave")
        with self._phase("device"):
            out = self._wave_core(table, dev, self._depth_cap)
            stats, comms = self._read_rows(out, out["stats"], out["comms"], out.get("cov"),
                                           out.get("live_n"))
        self._consume_comms(comms, dev["hi"].shape[0] // self._L * self._A)
        self.waves += 1
        return out, stats

    def _read_rows(self, out, stats, comms, cov=None, live_n=None):
        """One host read of the shards' stats and comms rows, gathered over
        the mesh, with this process's coverage vector and edge-row count in
        its first shard's row; the mesh's sums go into ``out``. Returns the
        stats and comms rows as host lists."""
        L = self._L
        ns, nc = stats.shape[1], comms.shape[1]
        parts = [stats, comms]
        for x in (cov, live_n):
            if x is not None:
                z = torch.zeros((L, x.numel()), dtype=torch.int64, device=stats.device)
                z[:1] = x.reshape(1, -1)
                parts.append(z)
        rows = self._pull(torch.cat(parts, 1)).tolist()
        at = ns + nc
        if cov is not None:
            out["cov_vec"] = np.asarray([r[at : at + cov.numel()] for r in rows]).sum(0)
            at += cov.numel()
        if live_n is not None:
            out["live_ns"] = [rows[r * L][at] for r in range(self._mesh.world)]
        return [r[:ns] for r in rows], [r[ns : ns + nc] for r in rows]

    def _consume_comms(self, rows, m):
        """Host accounting of one dispatch's comms rows (``m``: a shard's
        candidate lanes, which fix the rung ladder)."""
        c = np.asarray(rows, np.int64).sum(axis=0)
        args = self._ci.record(probes=int(c[0]), killed=int(c[1]), bloom_probes=int(c[2]),
                               bloom_hits=int(c[3]), bloom_fps=int(c[4]), lanes=int(c[5]))
        rungs = comm_rungs(m) if self._sieve else [m]
        for i, width in enumerate(rungs[: max(0, len(c) - _COMMS_HEAD)]):
            if int(c[_COMMS_HEAD + i]):
                self._ci.rung_dispatch(width, int(c[_COMMS_HEAD + i]))
        return args

    # -- the host loop -------------------------------------------------------------

    def _run(self):
        try:
            if self._device.type == "cuda" and self._device.index is not None:
                # The worker thread's current device is the mesh's.
                torch.cuda.set_device(self._device)
            self._explore()
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            self._error = e
            self._abort_attribution()
        finally:
            self._shutdown_pipeline()
            self._finalize_coverage(set(self._discoveries_fp))
            self._done_event.set()

    def _shutdown_pipeline(self) -> None:
        """Run-end barrier and teardown of the async pipeline: a verdict
        error nothing drained yet becomes the worker error, and the host
        thread never outlives the run."""
        if self._pipe is None:
            return
        try:
            self._pipe.drain()
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            if self._error is None:
                self._error = e
        finally:
            self._pipe.close()

    def _explore(self):
        self._t_start = time.perf_counter()
        if self._resume_from is not None:
            table = self._restore(self._resume_from)
        else:
            table = self._seed()
        if self._sieve:
            # Cold at run start, seed and resume alike: receipts only ever
            # come from keys this run routed and their owners acknowledged.
            self._sieve_dev = self._new_sieve()
        # The deep drain is off for visitors, target counts and depth caps
        # (its ring order is only approximately global FIFO), and for a
        # resumed run whose tiers hold keys (each wave needs the host probe).
        if (self._max_drain_waves > 1 and self._visitor is None
                and self._target_state_count is None and self._depth_cap == _DEPTH_INF
                and not self._tier_active()):
            self._explore_deep(table)
        else:
            self._explore_waves(table)
        # Sound `eventually` verdicts (liveness="device"): the trim and
        # reach over the absorbed edge relation.
        self._run_liveness_analysis("sharded_bfs")

    def _seed(self):
        """Fingerprints and inserts the initial states through the routed
        insert; returns the tables and fills the host pool."""
        n, G, L = self._n, self._G, self._L
        model = self._model
        init = model.packed_init_states(self._device)
        n0 = leaves(init)[0].shape[0]
        width = max(G, n * _pow2ceil((n0 + n - 1) // n))

        def pad0(x):
            z = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            z[:n0] = x
            return z

        states = map_leaves(pad0, init)
        hi, lo = model.packed_fingerprint(states)
        khi, klo = (hi, lo) if self._sym is None else self._sym.keys(states)
        in_range = torch.arange(width, device=self._device) < n0
        valid = in_range & model.packed_within_boundary(states)
        w = width // n
        while True:
            table = self._new_table()
            # The routed insert of this process's slices, without the sieve.
            fresh, overflow, _recv, _comms = self._route(
                table, self._local(khi).view(L, w), self._local(klo).view(L, w),
                self._local(valid).view(L, w))
            if not int(self._allsum(overflow.sum().reshape(1))):
                break
            self._cap_loc *= 2
        fresh = self._pull(fresh).reshape(width)
        self._state_count = int(valid.sum())
        self._unique_count = self._l0_count = int(fresh.sum())
        self._wi.generated.inc(self._state_count)
        self._wi.unique.inc(self._unique_count)
        if self._cov is not None:
            self._cov.record_seed(self._unique_count)
        child = _fp64(hi, lo)
        kept = child[fresh].cpu().numpy().view(np.uint64)
        self._wave_log.append((kept, np.zeros_like(kept)))
        if self._live_enabled:
            # The analysis roots: the valid init states whose condition is
            # false.
            roots = seed_root_mask(self._conditions, self._ebit, states, valid)
            self._live_store.add_roots(child[valid].cpu().numpy().view(np.uint64),
                                       roots[valid].cpu().numpy())
        if self._sym is not None:
            self._key_log.append(_fp64(khi, klo)[valid].cpu().numpy().view(np.uint64))
        k = int(fresh.sum())
        self._pool_append({
            "states": map_leaves(lambda x: x[fresh], states),
            "hi": hi[fresh],
            "lo": lo[fresh],
            "ebits": torch.full((k,), self._ebits0, dtype=torch.int64, device=self._device),
            "depth": torch.ones(k, dtype=torch.int64, device=self._device),
        })
        return table

    # The host pool: a deque of row batches; only the rows that feed the
    # next chunk are ever copied.

    @staticmethod
    def _rows_slice(batch, a, b):
        return {k: (map_leaves(lambda x: x[a:b], v) if k == "states" else v[a:b])
                for k, v in batch.items()}

    def _pool_append(self, rows):
        k = rows["hi"].shape[0]
        if k:
            # Locked: the async pipeline's worker appends survivors while
            # this thread takes chunks.
            with self._pool_lock:
                self._pool.append(rows)
                self._pool_count += k

    def _pool_take(self, width):
        """Pops up to ``width`` rows as a chunk of exactly ``width`` lanes,
        dealt round-robin to the ``n`` contiguous shard slices (a short chunk
        gives every shard about ``got / n`` live lanes), with ``mask``."""
        parts, got = [], 0
        with self._pool_lock:
            while got < width and self._pool:
                batch = self._pool.popleft()
                k = batch["hi"].shape[0]
                if got + k > width:
                    keep = width - got
                    self._pool.appendleft(self._rows_slice(batch, keep, k))
                    batch, k = self._rows_slice(batch, 0, keep), keep
                parts.append(batch)
                got += k
            self._pool_count -= got

        def cat_pad(*xs):
            out = torch.cat(xs) if len(xs) > 1 else xs[0]
            if out.shape[0] < width:
                pad = out.new_zeros((width - out.shape[0],) + tuple(out.shape[1:]))
                out = torch.cat([out, pad])
            return out

        cols = [cat_pad(*col) for col in zip(*(leaves(p["states"]) for p in parts))]
        it = iter(cols)
        chunk = {"states": map_leaves(lambda _x: next(it), parts[0]["states"])}
        for k in ("hi", "lo", "ebits", "depth"):
            chunk[k] = cat_pad(*(p[k] for p in parts))
        n = self._n
        per = width // n
        dest = torch.arange(width, device=self._device)
        src = (dest % per) * n + dest // per
        chunk = {k: (map_leaves(lambda x: x[src], v) if k == "states" else v[src])
                 for k, v in chunk.items()}
        chunk["mask"] = src < got
        return chunk

    def _apply_wave_stats(self, stats, chunk=None):
        """A wave's first attempt's counts, max depth, discoveries and the
        visitor; returns its generated count."""
        generated = sum(r[_GENERATED] for r in stats)
        self._state_count += generated
        self._max_depth = max(self._max_depth, max(r[_MAX_DEPTH] for r in stats))
        self._note_hits(stats)
        if chunk is not None and self._visitor is not None:
            self._visit_chunk(chunk)
        return generated

    def _note_hits(self, stats):
        for i, p in enumerate(self._properties):
            if p.name in self._discoveries_fp:
                continue
            for r in stats:
                hit, phi, plo = r[_N_STATS + 3 * i : _N_STATS + 3 * i + 3]
                if hit:
                    self._discoveries_fp[p.name] = fp_to_int(phi, plo)
                    break

    def _explore_waves(self, table):
        """The wave-at-a-time loop. With the async pipeline each wave's
        harvest rides the worker while the next wave runs; the loop
        dispatches ahead of the verdicts in flight only while the pool holds
        a full chunk without them (the head ``G`` rows and the bucket are
        then those of the synchronous run), and waits for them otherwise."""
        props = self._properties
        n, G, A = self._n, self._G, self._A
        pipe = self._pipe
        chunks = 0
        last_checkpoint = time.perf_counter()
        while True:
            if pipe is not None and self._inflight_verdicts > 0 and self._pool_count < G:
                # The coalescing barrier: keyed on verdicts, which may add
                # pool rows; a deferred checkpoint or absorb adds none.
                pipe.drain()
            if not self._pool_count or not props:
                break
            if len(self._discoveries_fp) == len(props):
                break
            if (self._target_state_count is not None
                    and self._target_state_count <= self._state_count):
                break
            if self._preempt_event.is_set():
                if pipe is not None:
                    pipe.drain()
                self._preempt_payload = self.checkpoint_payload(list(self._pool))
                self._tracer.instant("sharded_bfs.preempted", batches=len(self._pool),
                                     mode="wave")
                return
            # The window covers the whole iteration, the checkpoint and the
            # growth ahead of the wave included.
            with self._wave_window():
                if (self._checkpoint_path is not None and chunks
                        and chunks % self._checkpoint_every == 0
                        and time.perf_counter() - last_checkpoint
                        >= self._checkpoint_min_interval):
                    with self._phase("checkpoint"):
                        self._save_checkpoint_maybe_async()
                    last_checkpoint = time.perf_counter()
                chunks += 1
                B_glob = G * A
                if self._l0_count + B_glob > _MAX_LOAD * n * self._cap_loc:
                    table = self._grow_table(
                        table, _pow2ceil(int((self._l0_count + B_glob) / (_MAX_LOAD * n))),
                        defer_evict=pipe is not None)
                # The chunk shrinks to n x the smallest ladder rung that
                # holds the pending rows.
                got = min(self._pool_count, G)
                width, bucket = G, None
                if len(self._buckets) > 1:
                    bucket = bucket_for(self._buckets, max(1, -(-got // n)))
                    width = n * bucket
                    self._wi.bucket.set(bucket)
                    self._wi.bucket_dispatch(bucket)
                    self._wi.compaction.set(got / width)
                    self._wi.frontier_fill.set(got / G)
                chunk = self._pool_take(width)
                if pipe is None:
                    table = self._wave_sync(table, chunk, self._put(chunk), width, bucket, got)
                else:
                    # The bounded set of pending verdicts.
                    pipe.throttle()
                    table = self._wave_async(table, self._put(chunk), width, bucket, got)
                if self.warmup_seconds is None:
                    self.warmup_seconds = time.perf_counter() - self._t_start
                    self._wi.warmup.set(self.warmup_seconds)
        if pipe is not None:
            # Counts and the parent log settle before the audit and the end.
            pipe.drain()
        self._audit_table(table)

    def _wave_sync(self, table, chunk, dev, width, bucket, got):
        """One wave and its harvest; a probe overflow grows every table (or,
        under the budget, evicts them) and runs the same chunk again, each
        attempt's fresh rows, coverage and edge rows kept."""
        attempt = 0
        generated = wave_new = 0
        while True:
            out, stats = self._call_wave(table, dev)
            if attempt == 0:
                generated = self._apply_wave_stats(stats, chunk)
            self._consume_coverage(out, attempt == 0)
            wave_new += self._harvest(out, stats)
            self._harvest_liveness(out)
            if not sum(r[_OVERFLOW] for r in stats):
                break
            self._retry_guard(attempt)
            table = self._grow_table(table, self._cap_loc * 2)
            attempt += 1
        self._record_wave_metrics(width, generated, wave_new, bucket, got)
        if self._cov is not None:
            self._cov.emit_wave_span()
        return table

    def _retry_guard(self, attempt):
        if self._max_cap_loc is not None and attempt >= 8:
            # One shard overflows even freshly evicted: a configuration
            # error, not a loop to spin in.
            raise RuntimeError(
                "a single wave's routed keys overflow one "
                "budget-capped shard after repeated "
                "evictions; raise hbm_budget_mib or shrink "
                "frontier_per_device"
            )

    def _wave_async(self, table, dev, width, bucket, got):
        """One wave's dispatch with the async pipeline (this thread): the
        stats, discoveries, coverage and growth retries, everything the
        next dispatch depends on; each attempt's harvest goes to the worker
        before any growth or eviction that follows it, so the tiers see the
        probes and evictions in the synchronous order."""
        attempt = 0
        ctx = {"wave_new": 0, "generated": 0}
        while True:
            out, stats = self._call_wave(table, dev)
            if attempt == 0:
                ctx["generated"] = self._apply_wave_stats(stats)
            self._consume_coverage(out, attempt == 0)
            n_new = [r[_N_NEW] for r in stats]
            self._l0_count += sum(n_new)
            final = not sum(r[_OVERFLOW] for r in stats)
            # Counted in before it is queued, so the barrier never misses
            # a verdict whose decrement lands first.
            with self._pool_lock:
                self._inflight_verdicts += 1
            try:
                # The wave's point-in-time figures: by verdict time a later
                # wave (or an eviction) has moved them.
                self._pipe.submit(
                    lambda o=out, nn=n_new, f=final,
                    st=(self._l0_count, self._n * self._cap_loc, self._max_depth):
                        self._harvest_verdict(ctx, o, nn, f, width, bucket, got, st))
            except BaseException:
                with self._pool_lock:
                    self._inflight_verdicts -= 1
                raise
            if final:
                if self._cov is not None:
                    self._cov.emit_wave_span()
                return table
            self._retry_guard(attempt)
            table = self._grow_table(table, self._cap_loc * 2, defer_evict=True)
            attempt += 1

    def _harvest_verdict(self, ctx, out, n_new, final, width, bucket, got, state):
        """The worker's half of an async wave attempt: its edge rows, its
        fresh rows through the tier probe (exact here: every eviction's
        absorb runs on this thread, in submission order) into the parent
        log and the pool; the final attempt records the wave."""
        try:
            self._harvest_liveness(out)
            if sum(n_new):
                ctx["wave_new"] += self._harvest_rows(out, n_new, overlapped=True)
            if final:
                self._record_wave_metrics(width, ctx["generated"], ctx["wave_new"], bucket,
                                          got, state)
        finally:
            # Even on an error: the barrier must not wait on a verdict that
            # will never append (the error surfaces at the next barrier).
            with self._pool_lock:
                self._inflight_verdicts -= 1

    def _record_wave_metrics(self, width, generated, n_new, bucket, got, state=None):
        """One wave's telemetry; ``state`` (l0, capacity, max depth) is the
        async verdict's capture, else the live fields."""
        l0, capacity, depth = state or (self._l0_count, self._n * self._cap_loc,
                                        self._max_depth)
        if self._si is not None:
            self._si.set_l0(l0)
        self._wi.record(None, frontier=width, generated=generated, n_new=n_new,
                        occupancy=l0 / capacity, capacity=capacity, max_depth=depth,
                        bucket=bucket, compaction_ratio=(got / width if bucket else None))

    def _consume_coverage(self, out, first_attempt):
        """A wave attempt's mesh-summed coverage vector; a growth retry
        re-expands the same chunk, so only its fresh-based slices count."""
        if self._cov is not None:
            self._cov.consume_device(out["cov_vec"], self._cov_layout,
                                     first_attempt=first_attempt, max_depth=self._max_depth)

    def _harvest(self, out, stats):
        """Pulls every shard's fresh rows into the host pool and the parent
        log (``_harvest_rows``); returns how many survive the tier probe."""
        n_new = [r[_N_NEW] for r in stats]
        total = sum(n_new)
        self._l0_count += total
        if not total:
            return 0
        return self._harvest_rows(out, n_new)

    def _harvest_rows(self, out, n_new, overlapped=False):
        """One wave attempt's fresh rows, shard by shard in lane order: once
        a tier holds keys, the rows whose key (the orbit key under symmetry)
        a tier holds are stale and dropped; the survivors go to the parent
        log and the pool. One site for the synchronous harvest and the
        async verdict (``overlapped``: the worker's attribution ledger).
        Returns the survivors' count."""
        new = out["new"]
        B = new["hi"].shape[1]
        cols = [new["hi"], new["lo"], new["ebits"], new["depth"], out["parent_hi"],
                out["parent_lo"]]
        if self._sym is not None:
            cols += [out["new_khi"], out["new_klo"]]
        ncol = len(cols)
        cols = self._pull(torch.stack(cols, 1))
        idx = torch.cat([d * B + torch.arange(k, device=self._device)
                         for d, k in enumerate(n_new) if k])
        flat = cols.permute(1, 0, 2).reshape(ncol, self._n * B)[:, idx]
        rows = [_fp64(flat[0], flat[1]), _fp64(flat[4], flat[5])]
        if self._sym is not None:
            rows.append(_fp64(flat[6], flat[7]))
        log = torch.stack(rows).cpu().numpy().view(np.uint64)
        if self._tier_active():
            phase = self._phase_overlapped if overlapped else self._phase
            with phase("host_probe"):
                t0 = time.perf_counter()
                stale = self._probe_tiers(log[2] if self._sym is not None else log[0])
                self.host_probe_s += time.perf_counter() - t0
            n_stale = int(stale.sum())
            self.stale_lanes += n_stale
            if n_stale:
                keep = np.flatnonzero(~stale)
                log = log[:, keep]
                keep = torch.from_numpy(keep).to(self._device)
                idx, flat = idx[keep], flat[:, keep]
        survivors = log.shape[1]
        self._unique_count += survivors
        if not survivors:
            return 0
        states = map_leaves(lambda x: self._pull(x)[idx], new["states"])
        self._wave_log.append((log[0], log[1]))
        if self._sym is not None:
            self._key_log.append(log[2])
        self._pool_append({"states": states, "hi": flat[0], "lo": flat[1],
                           "ebits": flat[2], "depth": flat[3]})
        return survivors

    def _harvest_liveness(self, out):
        """Absorbs one wave attempt's edge rows (every process's first
        ``live_ns`` rows) into the host store, zero-fresh attempts
        included: the edges that close cycles reach visited states."""
        if not self._live_enabled:
            return
        ns = out["live_ns"]
        if not sum(ns):
            return
        rows = out["live"]
        top = max(ns)
        cols = self._pull(torch.stack([rows[c][:top] for c in EDGE_COLS], 1)).cpu().numpy()
        sel = np.zeros(cols.shape[0], bool)
        for r, k in enumerate(ns):
            sel[r * top : r * top + k] = True
        self._live_store.absorb(**{c: cols[sel, i] for i, c in enumerate(EDGE_COLS)})

    def _grow_table(self, table, min_cap, defer_evict=False):
        """Doubles every shard's table to at least ``min_cap`` rows, each
        rehashed locally through the insert kernel (``rehash_table``; keys
        never change owner); a rehash that leaves a key without a slot
        doubles again. Under the budget, growth past the cap evicts instead
        (``defer_evict``: the async loop's, whose absorbs ride the
        worker)."""
        if self._max_cap_loc is not None and min_cap > self._max_cap_loc:
            return self._evict_shards(table, defer=defer_evict)
        while self._cap_loc < min_cap:
            self._cap_loc *= 2
        while True:
            with self._phase("table_grow"):
                shards = [rehash_table(table[d], self._cap_loc) for d in range(self._L)]
                leftover = torch.tensor([sum(n for _t, n in shards)], device=self._device)
                overflowed = int(self._allsum(leftover))
            if not overflowed:
                break
            self._cap_loc *= 2
            if self._max_cap_loc is not None and self._cap_loc > self._max_cap_loc:
                return self._evict_shards(table, defer=defer_evict)
        self.table_growths += 1
        self._wi.table_grows.inc()
        return torch.stack([t for t, _n in shards])

    # -- the per-shard host tiers ---------------------------------------------------

    def _tier_active(self) -> bool:
        return any(not t.is_empty() for t in self._tiers)

    def _evict_shards(self, table, defer=False):
        """Growth under the budget: every shard's live keys go to its own
        tier and the tables start empty at the cap. Across processes the
        keys travel delta-encoded (``_allgather_evicted_keys``); in one
        process they are read from the tables. ``defer`` (the async loop):
        the read and the reset stay here, the absorbs ride the worker in
        FIFO order between the verdicts around them. The sieve flushes: a
        receipt must only cover keys the tables hold, or a lane whose
        evicted key comes back would be killed where the sieve-off run
        keeps it."""
        with self._phase("evict"):
            if self._mesh.distributed:
                shard_keys = self._allgather_evicted_keys(table)
            else:
                tab = table.cpu().numpy().view(np.uint32)
                shard_keys = [live_table_keys(tab[d]) for d in range(self._n)]
            if defer and self._pipe is not None:
                self._pipe.submit(lambda ks=shard_keys: self._evict_absorb(ks))
            else:
                for tier, keys in zip(self._tiers, shard_keys):
                    tier.evict(keys)
            self._cap_loc = self._max_cap_loc
            self._l0_count = 0
            self._si.set_l0(0)
            self.evictions += 1
            if self._sieve and self._sieve_dev is not None:
                self._sieve_dev = self._new_sieve()
            return self._new_table()

    def _allgather_evicted_keys(self, table):
        """The eviction's exchange across processes: each process
        delta-encodes its shards' sorted live keys (``storage/runs.py``'s
        codec), the lengths are gathered, then the padded byte rows; every
        process decodes the same per-shard key lists. Counts the bytes on
        the wire (``comms.evict_wire_bytes``)."""
        from ..storage.runs import decode_sorted_fps, encode_sorted_fps

        tab = table.cpu().numpy().view(np.uint32)
        bufs = [encode_sorted_fps(np.sort(live_table_keys(tab[j]))) for j in range(self._L)]
        lens = self._pull(torch.tensor([len(b) for b in bufs], dtype=torch.int64,
                                       device=self._device)).tolist()
        width = max(1, max(lens))
        pad = np.zeros((self._L, width), np.uint8)
        for j, b in enumerate(bufs):
            pad[j, : len(b)] = np.frombuffer(b, np.uint8)
        rows = self._pull(torch.from_numpy(pad).to(self._device)).cpu().numpy()
        shard_keys = [decode_sorted_fps(rows[d, :ln].tobytes()) for d, ln in enumerate(lens)]
        wire_bytes = sum(lens)
        self._ci.evict_wire_bytes.inc(wire_bytes)
        self._tracer.instant("sharded_bfs.evict_wire", bytes=wire_bytes,
                             raw_bytes=self._n * int(table.shape[1]) * 8,
                             keys=sum(len(k) for k in shard_keys))
        return shard_keys

    def _evict_absorb(self, shard_keys):
        """The worker's half of a deferred eviction, every shard."""
        with self._phase_overlapped("evict"):
            for tier, keys in zip(self._tiers, shard_keys):
                tier.evict(keys)

    def _probe_tiers(self, keys):
        """Membership in the union of every shard's tier, as in the JAX
        package (a non-owner's Bloom filters reject a key in O(1))."""
        found = np.zeros(len(keys), bool)
        for tier in self._tiers:
            rem = np.flatnonzero(~found)
            if not len(rem):
                break
            found[rem] = tier.probe(keys[rem])
        return found

    def _audit_table(self, table):
        """Run-end audit in attribution mode: every shard's probe-length
        counts, summed (the shards share one hash scheme)."""
        if self._attr is None:
            return
        counts = sum(hashset_probe_length_counts(table[d]) for d in range(self._L))
        counts = self._allsum(torch.from_numpy(counts).to(self._device)).cpu().numpy()
        self._attr.observe_probe_lengths(counts)

    # -- the deep drain --------------------------------------------------------------

    def _ring_new(self, capacity):
        """Each shard's ring of ``capacity`` rows and a trash row, back to
        back, with its head and count."""
        from ..ops.ring import ring_rows

        z = torch.zeros(self._L, dtype=torch.int64, device=self._device)
        return {"pool": ring_rows(self._model, self._L * (capacity + 1), self._device),
                "head": z, "count": z.clone(), "capacity": capacity}

    def _ring_push(self, ring, rows, mask):
        """Appends each shard's masked lanes (``rows``: ``L * M`` rows,
        ``mask`` ``(L, M)``) at its ring's tail, in place."""
        C = ring["capacity"]
        pos = torch.cumsum(mask.to(torch.int64), 1) - 1
        local = torch.where(mask, (ring["head"][:, None] + ring["count"][:, None] + pos) & (C - 1),
                            C)
        shard = torch.arange(self._L, dtype=torch.int64, device=mask.device)[:, None]
        dest = (shard * (C + 1) + local).reshape(-1)
        pool = ring["pool"]
        for dst, src in zip(leaves(pool["states"]), leaves(rows["states"])):
            dst[dest] = src
        for k in ("hi", "lo", "ebits", "depth"):
            pool[k][dest] = rows[k].reshape(-1)
        ring["count"] = ring["count"] + mask.sum(1)

    def _ring_rows_at(self, ring, idx):
        """Rows ``idx`` (``(L, W)`` ring positions) of each shard's ring, as
        ``L * W`` rows."""
        C = ring["capacity"]
        shard = torch.arange(self._L, dtype=torch.int64, device=idx.device)[:, None]
        flat = (shard * (C + 1) + idx).reshape(-1)
        pool = ring["pool"]
        return {"states": map_leaves(lambda x: x[flat], pool["states"]),
                **{k: pool[k][flat] for k in ("hi", "lo", "ebits", "depth")}}

    def _ring_take(self, ring, width):
        """Takes up to ``width`` lanes from each ring's head; returns the
        frontier (``L * width`` rows with ``mask``)."""
        C = ring["capacity"]
        lanes = torch.arange(width, dtype=torch.int64, device=self._device)
        take = torch.clamp(ring["count"], max=width)
        fr = self._ring_rows_at(ring, (ring["head"][:, None] + lanes) & (C - 1))
        fr["mask"] = (lanes < take[:, None]).reshape(-1)
        ring["head"] = (ring["head"] + take) & (C - 1)
        ring["count"] = ring["count"] - take
        return fr

    def _ring_export(self, ring):
        """Each ring's rows in FIFO order (``L * capacity`` rows) with the
        ``(L, capacity)`` mask of the live ones."""
        C = ring["capacity"]
        lanes = torch.arange(C, dtype=torch.int64, device=self._device)
        rows = self._ring_rows_at(ring, (ring["head"][:, None] + lanes) & (C - 1))
        return rows, lanes < ring["count"][:, None]

    def _grow_rings(self, ring):
        """Doubles every shard's ring, keeping its FIFO order."""
        rows, mask = self._ring_export(ring)
        self._PCl *= 2
        new = self._ring_new(self._PCl)
        self._ring_push(new, rows, mask)
        self.ring_growths += 1
        return new

    def _feed_rings(self, ring, ring_est):
        """Moves the host pool into the rings, a chunk of ``G`` lanes at a
        time, growing them when the next chunk might not fit."""
        while self._pool_count:
            if ring_est + self._F_loc > self._PCl:
                ring_est = self._ring_max(ring)
                if ring_est + self._F_loc > self._PCl:
                    ring = self._grow_rings(ring)
            dev = self._put(self._pool_take(self._G))
            self._ring_push(ring, dev, dev["mask"].view(self._L, -1))
            ring_est += self._F_loc
        return ring, ring_est

    def _ring_max(self, ring):
        return int(self._pull(ring["count"]).max())

    def _balance(self, out):
        """Round-robin exchange of each shard's fresh rows: lane ``j`` goes
        to shard ``j % n``, a fixed ``ceil(B / n)`` lanes a pair. Returns
        the received rows (``L * n * q``) and their ``(L, n * q)`` mask."""
        L, n = self._L, self._n
        new = out["new"]
        B = new["hi"].shape[1]
        q = -(-B // n)
        dev = new["hi"].device
        n_new = out["stats"][:, _N_NEW]
        j = torch.arange(B, dtype=torch.int64, device=dev)
        dest = torch.where(j < n_new[:, None], (j % n) * q + j // n, n * q)
        shard = torch.arange(L, dtype=torch.int64, device=dev)[:, None].expand(L, B)

        def xch(x):  # (L, B, ...) -> (L * n * q, ...)
            z = x.new_zeros((L, n * q + 1) + tuple(x.shape[2:]))
            z[shard, dest] = x
            y = self._exchange(z[:, : n * q].reshape((L, n, q) + tuple(x.shape[2:])))
            return y.reshape((L * n * q,) + tuple(x.shape[2:]))

        cols = torch.stack([new["hi"], new["lo"], new["ebits"], new["depth"],
                            torch.ones_like(new["hi"])], 2)
        got = xch(cols).view(L, n * q, 5)
        recv = {"states": map_leaves(lambda x: xch(x.view((L, B) + tuple(x.shape[1:]))),
                                     new["states"]),
                "hi": got[..., 0], "lo": got[..., 1], "ebits": got[..., 2],
                "depth": got[..., 3]}
        return recv, got[..., 4] != 0

    def _vote(self, out, count, log_n, gen_acc, undiscovered):
        """The shards' exit vote, summed over the mesh (one all-reduce
        across processes), as a host list."""
        st = out["stats"]
        n_new = st[:, _N_NEW]
        hit = torch.zeros_like(n_new)
        if self._properties:
            hits = st[:, _N_STATS::3][:, : len(self._properties)] != 0
            hit = (hits & undiscovered).any(1).to(torch.int64)
        recv_n = out["recv_mask"].sum(1)
        v = torch.stack([
            n_new, count, st[:, _OVERFLOW], hit,
            (log_n + n_new > self._Ll).to(torch.int64),
            (count + recv_n > self._PCl).to(torch.int64),
            (gen_acc >= _GEN_WRAP).to(torch.int64),
        ]).sum(1)
        return self._allsum(v).tolist()

    def _go(self, v, budget, waves):
        return ((v[_V_NEW] > 0 or v[_V_COUNT] > 0) and v[_V_OVERFLOW] == 0 and v[_V_HIT] == 0
                and v[_V_LOG] == 0 and v[_V_RING] == 0 and budget - v[_V_NEW] >= self._G * self._A
                and waves < self._max_drain_waves and v[_V_GEN] == 0)

    def _wave_plus(self, table, fr):
        out = self._wave_core(table, fr, _DEPTH_INF)
        out["recv"], out["recv_mask"] = self._balance(out)
        return out

    def _drain(self, table, ring, undiscovered, budget):
        """One drain: waves over the rings until the vote stops (the JAX
        ``_deep_drain_local``'s loop, uncaptured). Each consumed wave's
        fresh rows go to its shard's parent log (generator side) and the
        rows a shard received in the balance exchange to its ring. Returns
        the final (unconsumed) wave, its frontier, the shards' logs and
        their accumulators."""
        L, F, B = self._L, self._F_loc, self._F_loc * self._A
        dev = self._device
        Ll = self._Ll
        ncol = 2 if self._sym is None else 3
        log = torch.zeros((L, ncol, Ll + 1), dtype=torch.int64, device=dev)
        z = torch.zeros(L, dtype=torch.int64, device=dev)
        log_n, gen_acc, consumed, max_depth = z, z.clone(), z.clone(), z.clone()
        comms_acc = cov_acc = None
        fr = self._ring_take(ring, F)
        out = self._wave_plus(table, fr)
        waves = 1
        v = self._vote(out, ring["count"], log_n, gen_acc, undiscovered)
        shard = torch.arange(L, dtype=torch.int64, device=dev)[:, None].expand(L, B)
        lanes = torch.arange(B, dtype=torch.int64, device=dev)
        while self._go(v, budget, waves):
            st = out["stats"]
            n_new = st[:, _N_NEW]
            slot = torch.where(lanes < n_new[:, None], log_n[:, None] + lanes, Ll)
            new = out["new"]
            log[shard, 0, slot] = _fp64(new["hi"], new["lo"])
            log[shard, 1, slot] = _fp64(out["parent_hi"], out["parent_lo"])
            if self._sym is not None:
                log[shard, 2, slot] = _fp64(out["new_khi"], out["new_klo"])
            self._ring_push(ring, out["recv"], out["recv_mask"])
            comms_acc = out["comms"] if comms_acc is None else comms_acc + out["comms"]
            if self._cov is not None:
                cov_acc = out["cov"] if cov_acc is None else cov_acc + out["cov"]
            log_n = log_n + n_new
            gen_acc = gen_acc + st[:, _GENERATED]
            consumed = consumed + n_new
            max_depth = torch.maximum(max_depth, st[:, _MAX_DEPTH])
            budget -= v[_V_NEW]
            fr = self._ring_take(ring, F)
            out = self._wave_plus(table, fr)
            waves += 1
            v = self._vote(out, ring["count"], log_n, gen_acc, undiscovered)
        comms_acc = out["comms"] if comms_acc is None else comms_acc + out["comms"]
        res = {"out": out, "frontier": fr, "log": log, "log_n": log_n, "generated": gen_acc,
               "consumed": consumed, "max_depth": max_depth, "waves": waves,
               "comms_acc": comms_acc}
        if self._cov is not None:
            # The consumed waves' coverage and the final wave's.
            res["cov_acc"] = out["cov"] if cov_acc is None else cov_acc + out["cov"]
        return res

    def _explore_deep(self, table):
        props = self._properties
        if not props:
            return
        n, G, A = self._n, self._G, self._A
        ring = self._ring_new(self._PCl)
        ring_est = 0
        drains = 0
        last_checkpoint = time.perf_counter()
        while True:
            if len(self._discoveries_fp) == len(props):
                break
            if self._preempt_event.is_set():
                self._preempt_payload = self.checkpoint_payload(self._rings_pool_batches(ring))
                self._tracer.instant("sharded_bfs.preempted", mode="drain")
                return
            ring, ring_est = self._feed_rings(ring, ring_est)
            if ring_est == 0:
                break
            # The window covers the whole drain iteration.
            with self._wave_window("drain"):
                if (self._checkpoint_path is not None and drains
                        and time.perf_counter() - last_checkpoint
                        >= self._checkpoint_min_interval):
                    with self._phase("checkpoint"):
                        self._save_checkpoint_maybe_async(self._rings_pool_batches(ring))
                    last_checkpoint = time.perf_counter()
                drains += 1
                self.drains += 1
                B_glob = G * A
                if self._l0_count + B_glob > _MAX_LOAD * n * self._cap_loc:
                    table = self._grow_table(
                        table, _pow2ceil(int((self._l0_count + B_glob) / (_MAX_LOAD * n))))
                undiscovered = torch.tensor([p.name not in self._discoveries_fp for p in props],
                                            dtype=torch.bool, device=self._device)
                budget = min(int(_MAX_LOAD * n * self._cap_loc) - self._l0_count,
                             (1 << 31) - 1 - G * A)
                with self._phase("device"):
                    res = self._drain(table, ring, undiscovered, budget)
                if self.warmup_seconds is None:
                    self.warmup_seconds = time.perf_counter() - self._t_start
                    self._wi.warmup.set(self.warmup_seconds)
                table, ring, ring_est = self._consume_drain(res, table, ring)
        self._audit_table(table)

    def _consume_drain(self, res, table, ring):
        """A drain's results on the host: its consumed waves' counts, comms,
        coverage and parent log, then its final wave (``_consume_final``)."""
        n = self._n
        out = res["out"]
        acc = self._pull(torch.stack([res["log_n"], res["generated"], res["consumed"],
                                      res["max_depth"], ring["count"]], 1)).tolist()
        drain_new = sum(r[2] for r in acc)
        self._state_count += sum(r[1] for r in acc)
        self._unique_count += drain_new
        self._l0_count += drain_new
        self._max_depth = max(self._max_depth, max(r[3] for r in acc))
        self.waves += res["waves"]
        self._wi.drains.inc()
        self._wi.waves.inc(res["waves"])
        self._wi.generated.inc(sum(r[1] for r in acc))
        self._wi.unique.inc(drain_new)
        stats, comms = self._read_rows(res, out["stats"], res["comms_acc"], res.get("cov_acc"))
        self._consume_comms(comms, self._F_loc * self._A)
        if self._cov is not None:
            # Every wave of the drain, its final one included.
            self._cov.consume_device(res["cov_vec"], self._cov_layout,
                                     max_depth=self._max_depth)
        ring_est = max(r[4] for r in acc)
        max_log = max(r[0] for r in acc)
        if max_log:
            pack = self._pull(res["log"][:, :, :max_log].contiguous())
            pack = pack.cpu().numpy().view(np.uint64)
            for d in range(n):
                ln = acc[d][0]
                if ln:
                    self._wave_log.append((pack[d, 0, :ln], pack[d, 1, :ln]))
                    if self._sym is not None:
                        self._key_log.append(pack[d, 2, :ln])
        return self._consume_final(res, stats, table, ring, ring_est)

    def _consume_final(self, res, stats, table, ring, ring_est):
        """The drain's final (unconsumed) wave on the host: counts,
        discoveries, its fresh rows into the parent log, the rows the
        shards received into their rings, and the growth-and-retry of a
        probe overflow (whose fresh rows go to the host pool)."""
        out = res["out"]
        self._state_count += sum(r[_GENERATED] for r in stats)
        self._wi.generated.inc(sum(r[_GENERATED] for r in stats))
        self._max_depth = max(self._max_depth, max(r[_MAX_DEPTH] for r in stats))
        self._note_hits(stats)
        n_new = [r[_N_NEW] for r in stats]
        total = sum(n_new)
        self._unique_count += total
        self._l0_count += total
        self._wi.unique.inc(total)
        if total:
            new = out["new"]
            B = new["hi"].shape[1]
            cols = [new["hi"], new["lo"], out["parent_hi"], out["parent_lo"]]
            if self._sym is not None:
                cols += [out["new_khi"], out["new_klo"]]
            cols = self._pull(torch.stack(cols, 1))
            sel = torch.arange(B, device=self._device)[None, :] < torch.tensor(
                n_new, device=self._device)[:, None]
            rows = [_fp64(cols[:, 0][sel], cols[:, 1][sel]),
                    _fp64(cols[:, 2][sel], cols[:, 3][sel])]
            if self._sym is not None:
                rows.append(_fp64(cols[:, 4][sel], cols[:, 5][sel]))
            log = torch.stack(rows).cpu().numpy().view(np.uint64)
            self._wave_log.append((log[0], log[1]))
            if self._sym is not None:
                self._key_log.append(log[2])
            recv_per_shard = out["recv_mask"].shape[1]
            # Grow until the received rows provably fit (a push past the
            # capacity would wrap over queued rows).
            while ring_est + recv_per_shard > self._PCl:
                ring_est = self._ring_max(ring)
                if ring_est + recv_per_shard <= self._PCl:
                    break
                ring = self._grow_rings(ring)
            self._ring_push(ring, out["recv"], out["recv_mask"])
            ring_est += recv_per_shard
        if sum(r[_OVERFLOW] for r in stats):
            # Grow and run the final frontier again through the wave path.
            fr = res["frontier"]
            while True:
                table = self._grow_table(table, self._cap_loc * 2)
                wave, wstats = self._call_wave(table, fr)
                # The final frontier's evaluation already rode the drain's
                # coverage: only the retry's fresh lanes count.
                self._consume_coverage(wave, False)
                self._wi.unique.inc(self._harvest(wave, wstats))
                if not sum(r[_OVERFLOW] for r in wstats):
                    break
        if self._cov is not None:
            self._cov.emit_wave_span()
        return table, ring, ring_est

    def _rings_pool_batches(self, ring):
        """The whole pending frontier between drains: the host pool's
        leftovers and the rings' rows (shard by shard, FIFO) as one batch."""
        rows, mask = self._ring_export(ring)
        keep = self._pull(mask.reshape(-1))
        batch = {"states": map_leaves(lambda x: self._pull(x)[keep], rows["states"])}
        for k in ("hi", "lo", "ebits", "depth"):
            batch[k] = self._pull(rows[k])[keep]
        return list(self._pool) + [batch]

    # -- checkpoint, preempt and resume ----------------------------------------------

    def save_checkpoint(self, path, pool) -> None:
        """Writes ``checkpoint_payload(pool)`` atomically; every process
        builds the same payload and process 0 writes it."""
        payload = self.checkpoint_payload(pool)
        if self._mesh.rank == 0:
            atomic_pickle(path, payload)
        self.checkpoints_written += 1

    def _save_checkpoint_maybe_async(self, batches=None):
        """A checkpoint at a boundary: with the async pipeline the payload
        is built after the barrier (the verdicts in flight append pool
        rows) and its pickle rides the worker. ``batches`` stands for the
        host pool (the drain passes its rings' rows)."""
        if self._pipe is None:
            self.save_checkpoint(self._checkpoint_path,
                                 batches if batches is not None else self._pool)
            return
        self._pipe.drain()
        payload = self.checkpoint_payload(list(batches) if batches is not None
                                          else list(self._pool))
        path = self._checkpoint_path
        self._pipe.submit(lambda: self._checkpoint_write(path, payload))
        self.checkpoints_written += 1

    def _checkpoint_write(self, path, payload):
        """The worker's half of a deferred checkpoint: the pickle and the
        rename (one process: the async pipeline refuses more)."""
        with self._phase_overlapped("checkpoint"):
            atomic_pickle(path, payload)

    def checkpoint_payload(self, pool) -> dict:
        """The checkpoint as an in-memory payload: counters, discoveries,
        the parent map, the shards' capacity and count, the pending
        frontier (``pool``, row batches) as numpy, and the claimed keys
        under symmetry. The tables are not stored: they are the parent
        map's keys, re-routed by ``hi % n`` on resume, so a payload resumes
        on a mesh of any size."""
        self._ingest_wave_log()
        children, parents = self._store.export()
        payload = {
            **checkpoint_header(self._model, self._A, self._sym is not None, self._sym_scheme,
                                kind=CHECKPOINT_KIND),
            "state_count": self._state_count,
            "unique_count": self._unique_count,
            "max_depth": self._max_depth,
            "discoveries": dict(self._discoveries_fp),
            "children": children,
            "parents": parents,
            "cap_loc": self._cap_loc,
            "n_shards": self._n,
            "pool": [_chunk_to_host(b) for b in pool],
        }
        if self._sym is not None:
            payload["keys"] = (np.concatenate(self._key_log) if self._key_log
                               else np.zeros((0,), np.uint64))
        if self._tier_active():
            # Every shard's runs; the tables rebuild from the keys no run
            # holds.
            payload["storage"] = [t.export_state() for t in self._tiers]
        if self._live_enabled:
            payload["liveness"] = self._live_store.export_state()
            payload["version"] = 3
        return payload

    def _restore(self, source):
        if isinstance(source, dict):
            payload = source
        else:
            with open(source, "rb") as f:
                payload = pickle.load(f)
        validate_checkpoint_header(
            payload, self._model, self._A, self._sym is not None, self._sym_scheme,
            kind=CHECKPOINT_KIND,
            hint="single-device gpu_bfs checkpoints do not carry the frontier pool "
                 "this restore needs")
        self._state_count = payload["state_count"]
        self._unique_count = payload["unique_count"]
        self._max_depth = payload["max_depth"]
        self._discoveries_fp = dict(payload["discoveries"])
        children, parents = payload["children"], payload["parents"]
        self._wave_log.append((children, parents))
        keys = children
        if self._sym is not None:
            keys = payload["keys"]
            self._key_log.append(keys)
        for batch in payload["pool"]:
            self._pool_append(_tree_to_device(batch, self._device))
        # The edge store round-trips with the run: resuming across the
        # liveness mode would end with a truncated relation.
        live_state = payload.get("liveness")
        if self._live_enabled and live_state is None:
            raise ValueError(
                "liveness='device' cannot resume a checkpoint written "
                "without it: pre-checkpoint edges were never logged, so "
                "the final verdict would be unsound"
            )
        if live_state is not None:
            if not self._live_enabled:
                raise ValueError(
                    "checkpoint carries a liveness edge store; resume "
                    "with liveness='device' (dropping it would discard "
                    "the soundness the original run paid for)"
                )
            self._live_store.load_state(live_state)
        n, L = self._n, self._L
        storage = payload.get("storage")
        if storage:
            if not self._tiers:
                # Resumed without a budget: the runs stay probed, the
                # tables grow without a cap from here on.
                self._si = StorageInstruments("sharded_bfs", registry=self._registry)
                self._tiers = [TieredVisitedStore(instruments=self._si, shard=d,
                                                  tracer=self._tracer) for d in range(n)]
            if len(storage) == n:
                for tier, state in zip(self._tiers, storage):
                    tier.load_state(state)
            else:
                # Elastic: every key goes to its owner's tier on this mesh
                # (the probe takes the union, so only the balance moves).
                from ..storage.runs import FingerprintRun

                allk = np.unique(np.concatenate(
                    [FingerprintRun.from_state(r).decode_all() for st in storage
                     for r in list(st.get("l1", [])) + list(st.get("l2", []))]))
                owner = ((allk >> np.uint64(32)) % np.uint64(n)).astype(np.int64)
                for d, tier in enumerate(self._tiers):
                    tier.evict(allk[owner == d])
        keys = np.asarray(keys, np.uint64)
        if self._tier_active():
            keys = keys[~self._probe_tiers(keys)]
        if payload["n_shards"] == n:
            self._cap_loc = max(self._cap_loc, payload["cap_loc"])
        self._cap_loc = _pow2ceil(max(int(len(keys) / (_MAX_LOAD * n)), self._cap_loc))
        W = n * (1 << 13)
        if self._max_cap_loc is not None:
            self._cap_loc = min(self._cap_loc, self._max_cap_loc)
            # A batch fits a freshly evicted shard under the load cap even
            # if every key routes there.
            W = min(W, n * max(1, int(self._max_cap_loc * _MAX_LOAD) // n))
        table = self._new_table()
        hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.int64)).to(self._device)
        lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64)).to(self._device)
        w = W // n
        for start in range(0, len(keys), W):
            bh, bl = hi[start : start + W], lo[start : start + W]
            m = bh.shape[0]
            if self._l0_count + m > _MAX_LOAD * n * self._cap_loc:
                # As ahead of a wave: the tables stay under the load cap
                # (under the budget: they evict).
                table = self._grow_table(
                    table, _pow2ceil(int((self._l0_count + m) / (_MAX_LOAD * n))))
            valid = torch.arange(W, device=self._device) < m
            if m < W:
                bh = torch.cat([bh, bh.new_zeros(W - m)])
                bl = torch.cat([bl, bl.new_zeros(W - m)])
            while True:
                # The routed insert: each owner's batch arrives sorted and
                # deduplicated for the insert kernel.
                fresh, overflow, _recv, _comms = self._route(
                    table, self._local(bh).view(L, w), self._local(bl).view(L, w),
                    self._local(valid).view(L, w))
                self.restore_inserts += L
                got = self._allsum(torch.stack([fresh.sum(), overflow.sum()])).tolist()
                self._l0_count += got[0]
                if not got[1]:
                    break
                table = self._grow_table(table, self._cap_loc * 2)
        if self._si is not None:
            self._si.set_l0(self._l0_count)
        return table

    def request_preempt(self) -> None:
        """Stops the run at the next wave or drain boundary with its state
        in ``preempt_payload()``; ``resume_from=<payload>`` finishes it."""
        self._preempt_event.set()

    # -- path reconstruction ------------------------------------------------------------

    def _visit_chunk(self, chunk):
        mask = chunk["mask"].tolist()
        depth = chunk["depth"].tolist()
        hi, lo = chunk["hi"].tolist(), chunk["lo"].tolist()
        for i, live in enumerate(mask):
            if live and depth[i] < self._depth_cap:
                self._visitor.visit(self._model, self._reconstruct(fp_to_int(hi[i], lo[i])))

    # -- Checker surface ------------------------------------------------------------------

    def discoveries(self) -> Dict[str, Path]:
        out = {name: self._reconstruct(fp) for name, fp in list(self._discoveries_fp.items())}
        out = self._with_device_liveness(out)
        return self._with_lassos(out, self._done_event.is_set(),
                                 set(self._discoveries_fp) | set(self._live_paths))

    def _discovery_names(self) -> List[str]:
        return list(set(self._discoveries_fp) | set(self._live_paths))

    def table_capacity_per_shard(self) -> int:
        return self._cap_loc

    def state_digest(self) -> dict:
        digest = {
            "backend": type(self).__name__,
            "done": self.is_done(),
            "state_count": self.state_count(),
            "unique_state_count": self.unique_state_count(),
            "max_depth": self.max_depth(),
            "discoveries": sorted(self._discoveries_fp),
            "shards": self._n,
            "processes": self._mesh.world,
            "table_capacity_per_shard": self._cap_loc,
            "frontier_per_device": self._F_loc,
            "warmup_seconds": self.warmup_seconds,
            "checkpoint_path": self._checkpoint_path,
            "preempted": self.preempted,
            "wave_kernel": self._wave_kernel,
            "sieve": self._sieve,
        }
        if self._sieve:
            digest["comm_sieve"] = {"cache_slots": self._sieve_slots,
                                    "bloom_bits": self._sieve_bits}
        if self._si is not None:
            digest["storage"] = self._si.bench_stats()
        if self._live_store is not None:
            digest["liveness_edge_store"] = self._live_store.stats()
        return digest
