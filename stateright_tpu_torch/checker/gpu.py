"""GPU breadth-first checker: frontier waves in torch and CUDA.

The port of the JAX package's ``TpuBfsChecker`` as configured with
``hashset_impl="pallas"``, ``wave_dedup="sort"`` and either wave engine.
Each wave takes at most ``frontier_capacity`` frontier states and

    evaluates the property conditions (clearing ``eventually`` bits)
      -> expands the F x A action grid (``packed_expand``), drops lanes
         outside ``packed_within_boundary``, marks terminal states
      -> fingerprints the candidates (``ops/fingerprint.py``)
      -> sorts them stably by unsigned (hi, lo) and keeps the first
         occurrence of each key (the lowest lane decides the parent)
      -> inserts the wave-unique keys into the visited set through the
         CUDA tile-sweep kernel (``ops/hashset_kernel.py``)
      -> compacts the fresh lanes, in key order, into the next frontier,
         and logs (child, parent) fingerprints for path replay.

``wave_kernel="staged"`` runs that wave in torch with the
CUDA insert (``ops/fused_wave.py::torch_wave``); for a model with the
fingerprint-only expansion (``core/batch.py::supports_expand_fps``, the
packed actor models) the staged wave takes the candidates' fingerprints
from ``packed_expand_fps`` and makes only its fresh children with
``packed_take`` (``torch_wave_fps``; ``expand_fps``, below); ``wave_kernel="fused"``
runs the model's stage in torch and every other stage in the hand-written
kernels of ``csrc/fused_wave.cu`` (``ops/fused_wave.py::fused_wave``). The
default, ``wave_kernel=None``, resolves to ``"fused"``, or to ``"staged"``
under symmetry or with ``expand_fps=True``, which the fused wave refuses
(the JAX package's default is ``"staged"``); ``config_notes`` names the
engine it chose. The
two give the same results bit for bit, and both take every model: the
fused wave fingerprints the default fold in ``fw_keys``, a
``PackedActorModel``'s component hash in ``fw_comphash_keys``, and any other
``packed_fingerprint`` in torch, handing its pairs to ``fw_keys_pairs``
(``keys_route``, chosen once here).

The waves are driven in one of two ways, as in the reference:

- the deep drain (``_explore_deep``, the default): the pending frontier
  lives in a device FIFO ring (``ops/ring.py``); a drain takes waves of one
  rung of the bucket ladder (``bucket_ladder_widths``) from the ring head,
  logs their (child, parent) fingerprints on the device and pushes their
  fresh rows at the ring tail, until a wave cannot be consumed on the
  device: nothing left, a probe overflow, a hit of an undiscovered
  property, a full log, a full ring, a frontier that outgrew a narrow rung
  (promote), the table's insert budget, ``max_drain_waves`` or 2^30
  generated states. The host then reads one stats vector and the log
  prefix and consumes that final wave itself. On the card a drain is a
  pair of CUDA Graphs of ``_GRAPH_WAVES`` waves each, captured once per
  (rung width, table capacity, ring capacity) and replayed in turns: every
  wave is predicated on a device ``go`` flag that stays false once it
  falls, so the waves after the exit take no lanes and write only trash
  rows, and the host never drains the stream inside a drain. On the CPU
  the same step runs uncaptured, one wave at a time;
- wave at a time (``_explore_waves``, ``max_drain_waves=1``, and any run
  with a visitor or a ``target_state_count``): the host reads one stats
  vector per wave and copies the parent log, two syncs a wave.

Counts, depths, verdicts and counterexample paths equal the JAX
package's. The table grows (doubling + rehash) before a wave whose
worst case would pass a load of ``_MAX_LOAD``, and a wave whose keys
overflow a probe window is consumed, the table grown, and the wave run
again, as in the reference. The rehash sorts the old table's live rows
and inserts them through the same kernel, so the table layout after a
growth is the port's own (deterministic, but not the JAX package's
scatter layout).

``coverage=True`` records the JAX package's coverage ledger
(``telemetry/coverage.py``, ``coverage_report()``): each wave also returns
its coverage vector (the staged wave reduces it in torch, the fused wave
adds it inside ``fw_frontier`` and ``fw_compact``); wave at a time the host
reads it with the wave's stats, and a drain adds the consumed waves'
vectors on the device, under the same ``consume`` gate as its other
counters, and reads the sum and the final wave's vector in its one read.
With coverage off no wave runs any of it.

``expand_fps`` (the JAX package's knob and resolution): None turns the
fingerprint-only wave on for a staged run of a model that supports it
(under the default engine None resolves for the engine picked: off on the
fused wave, and off on the staged wave that symmetry picks);
True requires it and raises with ``wave_kernel="fused"`` (the fused chain
gathers the candidates' leaves) or for a model without it (2pc); False
forces the materializing wave. ``_use_fps`` holds the choice. Wave at a
time the host makes exactly a wave's ``n_new`` children in one take and
queues them ``F_max`` rows a chunk. A drain's captured wave has fixed
shapes, so at rung width F it makes a fixed count S of children and
pushes those: ``take_width(F)`` (``_TAKE_FACTOR`` times F, at most the
wave's F x A lanes) to start. A wave with more fresh lanes than S stops
the drain ("take full"); the host makes its children exactly, as it
finishes any drain's final wave, S for that rung grows to the power of two
at or past twice that wave's fresh count (a new capture), and the next
drain keeps the rung, so the ring holds the same rows in the same order
either way.

Symmetry reduction (``.symmetry()`` / ``.symmetry_fn(f)``, the JAX
package's semantics; ``checker/symmetry.py``) runs on the staged engine
only: ``wave_kernel="fused"`` raises, and ``expand_fps`` resolves to off
(True raises: the keys need the candidate states). The visited set is keyed
on orbit-proper canonical fingerprints (the seed, every wave, every
rehash); the frontier, the parent log, discoveries and paths keep the
original fingerprints, and ``_key_log`` gathers the keys each wave claimed.
Wave at a time the host reads which valid lanes failed the refined key's
check and keys them on the orbit minimum, as the JAX package's ``lax.cond``
does. A captured drain wave cannot branch: one with such a lane inserts
nothing and stops the drain ("orbit fallback", the last bit of
``EXIT_REASONS``); the host runs that wave exactly, and the next drain
keeps the rung.

``complete_liveness()`` (``checker/liveness.py``, as ``TpuBfsChecker``
honors it) refuses a capped run and, once the device run is done, searches
the condition-false region of each ``eventually`` property still without a
discovery for a lasso or a masked terminal path, on the model's host
``actions``/``next_state``; ``discoveries()`` merges those paths in. A
crashed run skips the pass and says so (``liveness_report()``).

Semantics parity notes (mirrored from the reference): ``eventually`` bits
propagate along paths and are not part of the fingerprint;
``target_state_count``/``target_max_depth`` may overshoot by up to a wave.
"""

from __future__ import annotations

import math
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..actor.packed import PackedActorModel
from ..core.batch import BatchableModel, map_leaves, supports_expand_fps
from ..core.model import Expectation
from ..core.path import Path
from ..native import make_fingerprint_store
from ..ops import fused_wave as fw
from ..ops import hashset_kernel as hk
from ..ops.fingerprint import fp_to_int
from ..ops.fused_wave import (
    FusedWaveSpec,
    comphash_tables,
    fused_wave,
    sorted_dedup,
    take_children,
    torch_wave,
    torch_wave_fps,
)
from ..ops.hashset import hashset_new, i32_to_u32, u32_to_i32
from ..ops.hashset_kernel import (
    TILE_ROWS,
    hashset_insert_sorted,
    round_table_capacity,
    sort_key,
    split_key,
)
from ..ops.ring import ring_export, ring_push, ring_rows, ring_take
from .base import Checker
from .symmetry import make_key_fn, sym_key_scheme

_DEPTH_INF = (1 << 31) - 1
# Grow the visited set before its load factor can pass this.
_MAX_LOAD = 0.55

# The bucket ladder (the JAX package's ``checker/tpu.py``): the narrowest
# rung, the default depth of the ladder, and the frontier capacity from
# which ``bucket_ladder=None`` turns it on.
_MIN_BUCKET = 8
_DEFAULT_BUCKET_STEPS = 4
_AUTO_BUCKET_MIN_F = 512

# Waves in one captured drain graph. A drain overshoots its exit by at
# most this many no-op waves in its last graph and as many again in the
# graph queued behind it.
_GRAPH_WAVES = 4
# The drain exits to the host before its generated counter reaches this.
_GENERATED_CAP = 1 << 30
# With the fingerprint-only wave, a drain wave of rung width F first makes
# this many times F fresh children on the device (``take_width``).
_TAKE_FACTOR = 4
# The kernels' launch counts (module, attribute) that a captured drain
# graph adds to at every replay.
_LAUNCH_COUNTERS = (
    (fw, "launches"), (fw, "frontier_launches"), (fw, "keys_launches"),
    (fw, "comphash_launches"), (fw, "coverage_launches"), (fw, "coverage_fresh_launches"),
    (fw, "sort_launches"), (fw, "dedup_launches"), (fw, "compact_launches"),
    (fw, "gather_launches"),
    (hk, "launches"),
)

# The drain's device scalars (one int64 vector): the ring's head and
# count, the consumed waves' totals, the budget left, the waves run, the
# go flag, what the exit recorded, and the most fresh lanes of one of its
# waves.
(_HEAD, _COUNT, _LOG_N, _GENERATED, _CONSUMED, _MAX_DEPTH, _BUDGET, _WAVES,
 _GO, _REASON, _FINAL_SLOT, _FINAL_TAKE, _MAX_FRESH) = range(13)
_N_SCALARS = 13
# Why a drain exits, by bit of ``_REASON``, in the order of the
# reference's loop condition; ``drain_exits`` counts a drain under the
# first of its reasons.
EXIT_REASONS = (
    "nothing left", "probe overflow", "property hit", "log full", "ring full",
    "promote", "budget", "max waves", "generated cap", "take full", "orbit fallback",
)
_TAKE_FULL = 1 << EXIT_REASONS.index("take full")
# A drain wave under symmetry whose refined keys failed their check on a
# valid lane inserts nothing and records this reason alone.
_ORBIT_FALLBACK = 1 << EXIT_REASONS.index("orbit fallback")


def take_width(width: int, action_count: int) -> int:
    """The fresh children a drain wave of rung ``width`` makes on the device
    with the fingerprint-only wave: ``_TAKE_FACTOR`` times the width, at
    least one and at most the wave's lanes."""
    return max(1, min(width * action_count, math.ceil(_TAKE_FACTOR * width)))


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def bucket_ladder_widths(f_max: int, steps: int) -> list:
    """The descending power-of-two wave-width ladder for a checker with
    frontier capacity ``f_max``: ``[F_max, F_max/2, ...]`` down to
    ``max(F_max >> steps, _MIN_BUCKET)``; ``steps=0`` is one rung."""
    floor = max(min(f_max, _MIN_BUCKET), f_max >> max(0, steps))
    return [f_max >> i for i in range(steps + 1) if (f_max >> i) >= floor]


def bucket_for(widths, live: int) -> int:
    """The smallest ladder width that holds ``live`` lanes (``widths``
    descending; the widest rung when nothing smaller fits)."""
    chosen = widths[0]
    for w in widths[1:]:
        if live <= w:
            chosen = w
    return chosen


def resolve_device(device) -> torch.device:
    """The checker's device: CUDA unless the caller asks for the CPU. With
    no CUDA device and no ``device="cpu"`` it raises — the run never goes
    on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spawn_gpu_bfs runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain torch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    elif dev.type != "cpu":
        raise ValueError(f"spawn_gpu_bfs runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def _fp64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 pairs as int64 whose bits are the u64 fingerprint."""
    return (hi << 32) | lo


class GpuBfsChecker(Checker):
    """Requires the model to implement ``BatchableModel``.

    ``frontier_capacity`` caps lanes per wave (larger frontiers split into
    chunks); ``table_capacity`` is the initial visited-set size, a power
    of two and a multiple of ``TILE_ROWS`` (grows by doubling + rehash;
    ``wave_kernel="fused"`` rounds it up to a tile-aligned power of two
    instead, and says so in ``config_notes``); ``device`` is ``"cuda"``
    (the default) or ``"cpu"``; ``wave_kernel`` is ``"fused"``,
    ``"staged"`` or None (the default: ``"fused"``, or ``"staged"`` under
    symmetry or ``expand_fps=True``; ``config_notes`` names the choice).

    The deep drain's options are the JAX package's, with its defaults:
    ``max_drain_waves`` caps the waves of one drain (1 runs wave at a
    time); the parent log holds ``drain_log_factor * F_max`` rows (at least
    one worst-case wave) and the ring ``pool_factor * F_max`` (rounded up
    to a power of two, at least one worst-case wave; it doubles when the
    host queue does not fit); ``bucket_ladder`` is the number of rungs
    below ``F_max`` a drain may run at (None: 4 from ``F_max >= 512``, else
    none). ``coverage=True`` records the coverage ledger
    (``coverage_report()``, prefix ``gpu_bfs``). ``expand_fps`` chooses
    the fingerprint-only wave (module docstring). Symmetry reduction
    (``.symmetry()``, ``.symmetry_fn(f)``) runs on the staged engine only
    (module docstring)."""

    def __init__(
        self,
        options,
        frontier_capacity=1 << 13,
        table_capacity=1 << 16,
        device=None,
        wave_kernel=None,
        max_drain_waves=100_000,
        drain_log_factor=8,
        pool_factor=16,
        bucket_ladder=None,
        coverage=False,
        expand_fps=None,
    ):
        model = options.model
        if not isinstance(model, BatchableModel):
            raise TypeError(
                f"spawn_gpu_bfs requires a BatchableModel; {type(model).__name__} "
                "does not implement the packed protocol (see "
                "stateright_tpu_torch.core.batch)"
            )
        if wave_kernel not in (None, "staged", "fused"):
            raise ValueError(
                f"wave_kernel must be 'staged' or 'fused' (None: the default), got "
                f"{wave_kernel!r}"
            )
        symmetry = options._symmetry is not None
        # The default engine: fused, unless the run asks for what only the
        # staged wave does (symmetry keys, the fingerprint-only expansion).
        engine_note = None
        if wave_kernel is None:
            if symmetry:
                wave_kernel, why = "staged", "symmetry reduction runs on the staged wave"
            elif expand_fps:
                wave_kernel, why = "staged", "expand_fps=True runs on the staged wave"
            else:
                wave_kernel = "fused"
                why = "it rounds table_capacity up to a tile-aligned power of two"
            engine_note = f"wave_kernel resolved to '{wave_kernel}' ({why})"
        self._wave_kernel = wave_kernel
        self._device = resolve_device(device)
        self._setup_lasso(options)
        # Dedup keys: the fingerprints, or under symmetry the orbit keys of
        # checker/symmetry.py (the permutation tables go to the device now).
        if wave_kernel == "fused" and symmetry:
            raise ValueError(
                "wave_kernel='fused' does not support symmetry reduction (the orbit "
                "keys run in torch over the candidate states); use wave_kernel='staged'"
            )
        self._sym_scheme = sym_key_scheme(options._symmetry)
        self._sym = make_key_fn(model, model.packed_fingerprint, options._symmetry,
                                self._device)
        # The fingerprint-only wave (the JAX package's resolution): off
        # under the fused wave and under symmetry, whose keys need the
        # candidate states.
        has_fps = supports_expand_fps(model)
        if expand_fps is None:
            self._use_fps = has_fps and wave_kernel != "fused" and not symmetry
        elif expand_fps:
            if wave_kernel == "fused":
                raise ValueError(
                    "expand_fps=True is incompatible with wave_kernel='fused' (the "
                    "fused chain gathers the candidates' leaves); use "
                    "wave_kernel='staged'"
                )
            if not has_fps:
                raise ValueError(
                    "expand_fps=True requires the model to implement packed_expand_fps "
                    "and packed_take (and packed_expand_fps_supported() to allow them)"
                )
            if symmetry:
                raise ValueError(
                    "expand_fps is incompatible with symmetry reduction (orbit keys "
                    "need candidate states)"
                )
            self._use_fps = True
        else:
            self._use_fps = False
        self._model = model
        self._properties = model.properties()
        self._conditions = model.packed_conditions()
        if len(self._conditions) != len(self._properties):
            raise ValueError(
                "packed_conditions() must align 1:1 with properties(): "
                f"{len(self._conditions)} != {len(self._properties)}"
            )
        eventually = [
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        ]
        if len(eventually) > 32:
            raise ValueError("at most 32 eventually properties supported")
        self._ebit: Dict[int, int] = {pi: b for b, pi in enumerate(eventually)}
        self._ebits0 = sum(1 << b for b in self._ebit.values())
        self._A = model.packed_action_count()
        self._F_max = _pow2ceil(frontier_capacity)
        if bucket_ladder is None:
            bucket_ladder = (
                _DEFAULT_BUCKET_STEPS if self._F_max >= _AUTO_BUCKET_MIN_F else 0
            )
        if bucket_ladder < 0:
            raise ValueError(f"bucket_ladder must be >= 0, got {bucket_ladder}")
        self._buckets = bucket_ladder_widths(self._F_max, bucket_ladder)
        self._max_drain_waves = max(1, int(max_drain_waves))
        # The log holds at least one worst-case wave (F_max * A fresh
        # states), and so does the ring.
        self._drain_log_capacity = max(
            max(1, drain_log_factor) * self._F_max, self._F_max * self._A
        )
        self._pool_capacity = _pow2ceil(
            max(max(1, pool_factor) * self._F_max, self._F_max * self._A)
        )
        # Run-configuration notes, reported once at run end
        # (``Reporter.report_config_notes``).
        self.config_notes: List[str] = [engine_note] if engine_note else []
        cap = int(table_capacity)
        if wave_kernel == "fused":
            # The fused wave's sweep grids over TILE_ROWS-row tiles: round
            # the capacity up and say so, as the JAX package does. The
            # staged insert keeps its refusal below.
            rounded = round_table_capacity(cap)
            if rounded != cap:
                self.config_notes.append(
                    f"table_capacity rounded {cap} -> {rounded} (tile-sweep "
                    f"kernels grid over {TILE_ROWS}-row table tiles)"
                )
                cap = rounded
        if cap <= 0 or cap & (cap - 1) or cap % TILE_ROWS:
            raise ValueError(
                "table_capacity must be a power of two and a multiple of "
                f"{TILE_ROWS} (the insert kernel's tile), got {table_capacity}"
            )
        self._capacity = cap
        self._visitor = options._visitor
        self._target_state_count: Optional[int] = options._target_state_count
        self._depth_cap = options._target_max_depth or _DEPTH_INF
        # The fused wave's key route (``ops/fused_wave.py``): the default
        # fold, the component hash of a packed actor model, or the model's
        # own pairs. The comphash constants go to the device now, before
        # any capture.
        fp = getattr(model.packed_fingerprint, "__func__", None)
        if fp is BatchableModel.packed_fingerprint:
            self.keys_route = "fold"
        elif fp is PackedActorModel.packed_fingerprint:
            self.keys_route = "comphash"
        else:
            self.keys_route = "pairs"
        comphash = None
        if self.keys_route == "comphash":
            comphash = comphash_tables(model.packed_comphash_layout(), self._device)
        self._init_coverage("gpu_bfs", coverage, self._A, symmetry=symmetry)
        self._spec = FusedWaveSpec(
            expand=model.packed_expand,
            within_boundary=model.packed_within_boundary,
            conditions=tuple(self._conditions),
            expectations=tuple(p.expectation.value for p in self._properties),
            ebit=tuple(sorted(self._ebit.items())),
            action_count=self._A,
            fingerprint=model.packed_fingerprint,
            keys_route=self.keys_route,
            comphash=comphash,
            cov_layout=self._cov_layout,
            cov_antecedents=tuple(self._cov_antecedents or ()),
            expand_fps=model.packed_expand_fps if self._use_fps else None,
            take=model.packed_take if self._use_fps else None,
            symmetry=self._sym,
        )

        self._state_count = 0
        self._unique_count = 0
        self._max_depth = 0
        self._discoveries_fp: Dict[str, int] = {}
        # (child fps, parent fps — 0 encodes "init state") per wave, as
        # u64 numpy arrays, ingested lazily into the parent-pointer store.
        self._wave_log: List = []
        # Under symmetry: the visited-set keys claimed so far (u64 numpy
        # arrays a wave; first the seed's valid lanes), as the JAX package
        # keeps them.
        self._key_log: List = []
        self._store = make_fingerprint_store()
        self._ingested = 0
        self._ingest_lock = threading.Lock()
        self._host_fps: Dict = {}
        # Run statistics (read by chip_smoke.py and the tests): waves run
        # with live lanes, table growths, drains, drains by exit reason and
        # by rung width, and, on the card, the no-op waves after the exits,
        # the warm-up waves before the captures (both take no lanes but
        # launch the wave's kernels), the drain graphs captured and
        # replayed and the host seconds the captures took (their warm-up
        # waves included); with the fingerprint-only wave, the children the host
        # made for the waves it finished (``host_take_rows``, in
        # ``host_takes`` takes, one a wave); and the most fresh lanes of one
        # drain wave, by rung width (``max_fresh``).
        self.waves = 0
        self.table_growths = 0
        self.drains = 0
        self.drain_exits: Counter = Counter()
        self.rungs: Counter = Counter()
        self.noop_waves = 0
        self.warmup_waves = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self.capture_s = 0.0
        self.host_takes = 0
        self.host_take_rows = 0
        # The fresh children a drain wave makes on the device, by rung.
        self._take_widths: Dict[int, int] = {}
        self.max_fresh: Dict[int, int] = {}
        self._drain = None
        self._graphs: Dict = {}
        self._go_host = None
        self._done_event = threading.Event()
        self._error: Optional[BaseException] = None
        self._handles = [
            threading.Thread(target=self._run, name="gpu-bfs", daemon=True)
        ]
        self._handles[0].start()

    # -- device work ---------------------------------------------------------

    def _dedup_insert(self, table, khi, klo, valid):
        shi, slo, sidx, unique = sorted_dedup(khi, klo, valid)
        table, fresh, _found, pending = hashset_insert_sorted(
            table, u32_to_i32(shi), u32_to_i32(slo), unique
        )
        return table, sidx, fresh, pending

    def _wave(self, table, chunk, mask=None, exact=True):
        """One wave over a frontier chunk (its live lanes marked by
        ``mask``; None: all); returns ``(table, out)``, the output of
        ``ops/fused_wave.py`` (a device stats vector and B-row outputs
        whose first ``n_new`` rows are the fresh states). Under symmetry
        ``exact=False`` keys it with no host read (``out["hold"]``)."""
        args = (
            self._spec, table, chunk["states"], chunk["hi"], chunk["lo"],
            chunk["ebits"], chunk["depth"], self._depth_cap,
        )
        if self._wave_kernel == "fused":
            return fused_wave(*args, mask=mask)
        if self._use_fps:
            return torch_wave_fps(*args, mask=mask)
        return torch_wave(*args, mask=mask, exact=exact)

    def _rehash(self, table, capacity):
        """The old table's live rows, sorted, inserted into an empty table
        of ``capacity`` rows through the same insert; returns the new table
        and the count of rows that found no slot."""
        rows_hi, rows_lo = i32_to_u32(table[:, 0]), i32_to_u32(table[:, 1])
        live = (rows_hi != 0) | (rows_lo != 0)
        key, _ = torch.sort(sort_key(rows_hi[live], rows_lo[live]))
        khi, klo = split_key(key)
        new_table, _fresh, _found, pending = hashset_insert_sorted(
            hashset_new(capacity, self._device), u32_to_i32(khi),
            u32_to_i32(klo), torch.ones_like(key, dtype=torch.bool),
        )
        return new_table, int(pending.sum())

    def _grow_table(self, table, min_capacity):
        capacity = self._capacity
        while capacity < min_capacity:
            capacity *= 2
        while True:
            new_table, leftover = self._rehash(table, capacity)
            if not leftover:
                break
            # A pathological key cluster can exhaust the probe cap during
            # rehash; the next doubling shortens probe chains.
            capacity *= 2
        self._capacity = capacity
        self.table_growths += 1
        return new_table

    # -- host exploration loop ----------------------------------------------

    def _run(self):
        try:
            table, queue = self._seed()
            # As in the reference: the drain is off when a visitor needs
            # each chunk or a target count caps the run (a drain would
            # overshoot by whole drains).
            if (
                self._max_drain_waves > 1
                and self._visitor is None
                and self._target_state_count is None
            ):
                self._explore_deep(table, queue)
            else:
                self._explore_waves(table, queue)
            self._finalize_coverage(set(self._discoveries_fp))
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            self._error = e
        finally:
            # The drain's ring, log and graphs hold device memory that the
            # finished checker no longer needs.
            self._drain = None
            self._graphs = {}
            self._done_event.set()

    def _seed(self):
        """Inserts + enqueues the initial states; returns (table, queue)."""
        model = self._model
        states = model.packed_init_states(self._device)
        valid = model.packed_within_boundary(states)
        hi, lo = model.packed_fingerprint(states)
        khi, klo = (hi, lo) if self._sym is None else self._sym.keys(states)
        while True:
            table = hashset_new(self._capacity, self._device)
            table, _sidx, fresh, pending = self._dedup_insert(table, khi, klo, valid)
            if not int(pending.sum()):
                break
            self._capacity *= 2
        self._state_count = int(valid.sum())
        self._unique_count = int(fresh.sum())
        if self._cov is not None:
            self._cov.record_seed(self._unique_count)
        child = _fp64(hi, lo)[valid].cpu().numpy().view(np.uint64)
        self._wave_log.append((child, np.zeros_like(child)))
        if self._sym is not None:
            self._key_log.append(_fp64(khi, klo)[valid].cpu().numpy().view(np.uint64))

        # Chunks of F_max lanes over all init lanes, each keeping its valid
        # lanes (the reference masks the others out).
        F0 = hi.shape[0]
        ebits = torch.full((F0,), self._ebits0, dtype=torch.int64, device=self._device)
        depth = torch.ones(F0, dtype=torch.int64, device=self._device)
        queue = deque()
        for s in range(0, F0, self._F_max):
            keep = s + torch.nonzero(valid[s : s + self._F_max]).squeeze(1)
            queue.append({
                "states": map_leaves(lambda x: x[keep], states),
                "hi": hi[keep],
                "lo": lo[keep],
                "ebits": ebits[keep],
                "depth": depth[keep],
            })
        return table, queue

    def _explore_waves(self, table, queue):
        props = self._properties
        while queue:
            if not props:
                break
            if len(self._discoveries_fp) == len(props):
                break
            if (
                self._target_state_count is not None
                and self._target_state_count <= self._state_count
            ):
                break
            chunk = queue.popleft()
            # Worst case of a full-width chunk, as the reference sizes it.
            B = self._F_max * self._A
            if (self._unique_count + B) > _MAX_LOAD * self._capacity:
                table = self._grow_table(
                    table, _pow2ceil(int((self._unique_count + B) / _MAX_LOAD))
                )
            table, _ = self._consume_wave(table, chunk, queue)

    def _consume_wave(self, table, chunk, queue, out=None, stats=None, cov=None):
        """Applies one wave host-side (counters, discoveries, coverage, log,
        requeue), growing the table and running the same chunk again while
        keys overflow their probe windows; each attempt's fresh states are
        kept. ``out`` and its ``stats`` (a list), when given, are the first
        attempt, already run (a drain's final wave; ``chunk`` holds its
        live lanes; ``cov`` its coverage vector, with coverage on). Returns
        ``(table, fresh states kept)``."""
        if chunk["hi"].shape[0] == 0 and out is None:
            return table, 0
        attempt = 0
        wave_new = 0
        while True:
            if out is None:
                table, out = self._wave(table, chunk)
                if self._cov is None:
                    stats = out["stats"].tolist()  # the wave's one read of its counters
                else:
                    read = torch.cat([out["stats"], out["cov"]]).tolist()
                    stats, cov = read[: out["stats"].shape[0]], read[out["stats"].shape[0]:]
            self.waves += 1
            if self._cov is not None:
                # A table-growth retry re-expands the same frontier: only
                # its fresh-based slices accumulate.
                self._cov.consume_device(cov, self._cov_layout,
                                         first_attempt=(attempt == 0),
                                         max_depth=stats[3])
            if attempt == 0:
                self._apply_wave_stats(stats, chunk)
            n_new = stats[1]
            self._unique_count += n_new
            wave_new += n_new
            if n_new:
                # Copies of the fresh rows: the queued chunks are views of
                # these, so the wave's B-row outputs are freed now rather
                # than held until its last chunk runs. The fingerprint-only
                # wave makes its n_new fresh children here, in one take.
                new = {k: out["new"][k][:n_new].clone() for k in ("hi", "lo", "ebits", "depth")}
                if self._use_fps:
                    states = take_children(self._spec, chunk["states"],
                                           out["new"]["src"][:n_new])
                    self.host_takes += 1
                    self.host_take_rows += n_new
                else:
                    states = map_leaves(lambda x: x[:n_new].clone(), out["new"]["states"])
                rows = [_fp64(new["hi"], new["lo"]),
                        _fp64(out["parent_hi"][:n_new], out["parent_lo"][:n_new])]
                if self._sym is not None:
                    rows.append(_fp64(out["key_hi"][:n_new], out["key_lo"][:n_new]))
                log = torch.stack(rows).cpu().numpy().view(np.uint64)
                self._wave_log.append((log[0], log[1]))
                if self._sym is not None:
                    self._key_log.append(log[2])
                for s in range(0, n_new, self._F_max):
                    piece = {k: v[s : s + self._F_max] for k, v in new.items()}
                    piece["states"] = map_leaves(lambda x: x[s : s + self._F_max], states)
                    queue.append(piece)
            if not stats[2]:
                if self._cov is not None:
                    self._cov.emit_wave_span()
                return table, wave_new
            table = self._grow_table(table, self._capacity * 2)
            attempt += 1
            out = None

    def _apply_wave_stats(self, stats, chunk):
        self._state_count += stats[0]
        self._max_depth = max(self._max_depth, stats[3])
        for i, p in enumerate(self._properties):
            hit, phi, plo = stats[5 + 3 * i : 8 + 3 * i]
            if hit and p.name not in self._discoveries_fp:
                self._discoveries_fp[p.name] = fp_to_int(phi, plo)
        if self._visitor is not None:
            depth = chunk["depth"].tolist()
            hi = chunk["hi"].tolist()
            lo = chunk["lo"].tolist()
            for d, h, lo_ in zip(depth, hi, lo):
                if d < self._depth_cap:
                    self._visitor.visit(
                        self._model, self._reconstruct(fp_to_int(h, lo_))
                    )

    # -- the deep drain ---------------------------------------------------------

    def _explore_deep(self, table, queue):
        """The host side of the deep drain (the reference's
        ``_explore_deep``): on every pass it pushes the whole host queue
        into the ring (growing the ring when it must), grows the table
        ahead of the drain, picks the rung, runs one drain and consumes its
        final wave, whose fresh states go to the host queue."""
        props = self._properties
        if not props:
            return
        F_max = self._F_max
        B = F_max * self._A
        self._drain = self._drain_state(self._pool_capacity)
        pool_count = 0  # host view: exact after a drain, a bound after pushes
        # Exact pending live lanes (ring + spilled queue), the rung
        # selector's input; None until the first drain exit, so the first
        # drain runs at F_max.
        live_est = None
        # Votes of consecutive drains for a rung not yet entered: a new
        # rung is entered only when two drains in a row select it.
        rung_votes: Dict[int, int] = {}
        entered = set()
        # A drain that stopped only because its wave had more fresh lanes
        # than the device makes: the next drain runs at its rung.
        keep_width = None
        while True:
            if len(self._discoveries_fp) == len(props):
                break
            # The queue must drain fully into the ring: its states are
            # older than anything the drain will push (exact BFS order).
            while queue:
                if pool_count + F_max > self._pool_capacity:
                    # The host bound counts F_max a push; read the device
                    # count before doubling the ring.
                    pool_count = int(self._drain["scalars"][_COUNT])
                    if pool_count + F_max > self._pool_capacity:
                        self._grow_pool()
                self._ring_push_chunk(queue.popleft())
                pool_count += F_max
            if pool_count == 0:
                break
            self.drains += 1
            if self._unique_count + B > _MAX_LOAD * self._capacity:
                table = self._grow_table(
                    table, _pow2ceil(int((self._unique_count + B) / _MAX_LOAD))
                )
            width = F_max
            if keep_width is not None:
                width = keep_width
            elif live_est is not None and len(self._buckets) > 1:
                want = bucket_for(self._buckets, max(1, min(live_est, F_max)))
                if want in entered or want == F_max:
                    width = want
                    rung_votes = {}
                else:
                    votes = rung_votes.get(want, 0) + 1
                    rung_votes = {want: votes}
                    if votes >= 2:
                        width = want
                    else:
                        # The narrowest rung already entered that holds
                        # the load.
                        width = min((w for w in entered if w >= want),
                                    default=F_max)
            entered.add(width)
            self.rungs[width] += 1
            budget = min(
                int(_MAX_LOAD * self._capacity) - self._unique_count, (1 << 31) - 1 - B
            )
            table, summary, out, frontier = self._deep_drain(table, width, budget)

            P = len(props)
            sc, stats = summary[:_N_SCALARS], summary[_N_SCALARS:_N_SCALARS + 5 + 3 * P]
            reason = sc[_REASON]
            self.drain_exits[EXIT_REASONS[(reason & -reason).bit_length() - 1]] += 1
            keep_width = width if reason in (_TAKE_FULL, _ORBIT_FALLBACK) else None
            if reason & _TAKE_FULL:
                # The device's take was too narrow for this wave: widen it
                # for the rung's next capture, with room for growth.
                self._take_widths[width] = min(width * self._A, _pow2ceil(2 * stats[1]))
            self.max_fresh[width] = max(self.max_fresh.get(width, 0), sc[_MAX_FRESH])
            log_n = sc[_LOG_N]
            self._state_count += sc[_GENERATED]
            self._unique_count += sc[_CONSUMED]
            self._max_depth = max(self._max_depth, sc[_MAX_DEPTH])
            # The final wave is counted by _consume_wave below.
            self.waves += sc[_WAVES] - 1
            pool_count = sc[_COUNT]
            final_cov = None
            if self._cov is not None:
                # The consumed waves' sum with the drain's max depth, then
                # (in _consume_wave) the final wave's own vector.
                size = self._cov_layout.size
                base = _N_SCALARS + 5 + 3 * P
                self._cov.consume_device(summary[base : base + size], self._cov_layout,
                                         max_depth=sc[_MAX_DEPTH])
                final_cov = summary[base + size : base + 2 * size]
            if log_n:
                log = self._drain["log"][:, :log_n].contiguous().cpu().numpy().view(np.uint64)
                self._wave_log.append((log[0], log[1]))
                if self._sym is not None:
                    self._key_log.append(log[2])
            # The final wave, which the device could not consume: its live
            # lanes are the prefix it took.
            n = sc[_FINAL_TAKE]
            chunk = {
                k: (map_leaves(lambda x: x[:n], v) if k == "states" else v[:n])
                for k, v in frontier.items()
                if k != "mask"
            }
            if reason == _ORBIT_FALLBACK:
                # The wave inserted nothing: the host runs it again, keying
                # its failed lanes on the orbit minimum.
                out = stats = final_cov = None
            table, spilled = self._consume_wave(table, chunk, queue, out=out,
                                                stats=stats, cov=final_cov)
            live_est = pool_count + spilled

    def _drain_state(self, capacity):
        """The drain's device state around a ring of ``capacity`` rows (and
        a trash row): the ring, the scalars, the parent log (child and
        parent fingerprints, ``(hi << 32) | lo``, and a trash column), the
        final wave's stats and the undiscovered-property mask; with coverage
        on, the consumed waves' coverage sum and the final wave's vector.
        Under symmetry the log has a third row, the claimed keys."""
        dev, P = self._device, len(self._properties)
        cov = {}
        if self._cov is not None:
            size = self._cov_layout.size
            cov = {"cov_acc": torch.zeros(size, dtype=torch.int64, device=dev),
                   "final_cov": torch.zeros(size, dtype=torch.int64, device=dev)}
        return {
            **cov,
            "capacity": capacity,
            "pool": ring_rows(self._model, capacity + 1, dev),
            "scalars": torch.zeros(_N_SCALARS, dtype=torch.int64, device=dev),
            "log": torch.zeros((2 if self._sym is None else 3,
                                self._drain_log_capacity + 1), dtype=torch.int64, device=dev),
            "final_stats": torch.zeros(5 + 3 * P, dtype=torch.int64, device=dev),
            "undiscovered": torch.zeros(P, dtype=torch.bool, device=dev),
        }

    def _ring_push_chunk(self, chunk):
        """Pushes a host-queue chunk (live lanes only) at the ring tail."""
        d = self._drain
        sc = d["scalars"]
        mask = torch.ones(chunk["hi"].shape[0], dtype=torch.bool, device=self._device)
        sc[_COUNT] = ring_push(d["pool"], sc[_HEAD], sc[_COUNT], chunk, mask,
                               d["capacity"])

    def _grow_pool(self):
        """Doubles the ring, keeping its FIFO order (export, then push into
        the new ring from row 0)."""
        d = self._drain
        sc = d["scalars"]
        exported = ring_export(d["pool"], sc[_HEAD], sc[_COUNT], d["capacity"])
        self._pool_capacity *= 2
        d["capacity"] = self._pool_capacity
        d["pool"] = ring_rows(self._model, self._pool_capacity + 1, self._device)
        zero = torch.zeros((), dtype=torch.int64, device=self._device)
        sc[_COUNT] = ring_push(d["pool"], zero, zero, exported, exported["mask"],
                               self._pool_capacity)
        sc[_HEAD] = 0

    def _take_width(self, width):
        """The fresh children a drain wave of rung ``width`` makes on the
        device with the fingerprint-only wave (``take_width`` until a
        ``take full`` exit widens it)."""
        return self._take_widths.setdefault(width, take_width(width, self._A))

    def _drain_step(self, table, width, slot):
        """One wave of a drain, every shape fixed and no value read back:
        takes ``n = go * min(count, width)`` lanes from the ring, runs the
        wave over them, and, while the drain goes on, checks that the
        device can consume the wave (the reference's loop condition) and
        consumes it: its fresh rows are logged and pushed at the ring tail.
        The wave that fails the check stops the drain: ``go`` falls, and
        the exit's reasons, the wave's ``slot`` and its take are recorded.
        With the fingerprint-only wave it makes the rung's take width of
        children of the wave's fresh lanes and pushes those (more fresh
        lanes stop the drain). Under symmetry the wave keys its lanes with no
        host read; one whose refined keys failed on a valid lane inserts
        nothing and stops the drain with the "orbit fallback" reason alone.
        Returns ``(table, out, frontier)``."""
        d = self._drain
        sc = d["scalars"]
        PC, L, F = d["capacity"], self._drain_log_capacity, width
        B = F * self._A
        go = sc[_GO]
        frontier, head, count, n = ring_take(d["pool"], sc[_HEAD], sc[_COUNT], PC, F,
                                             go)
        table, out = self._wave(table, frontier, frontier["mask"], exact=False)
        stats = out["stats"]
        generated, n_new, overflow, depth = stats[0], stats[1], stats[2], stats[3]
        waves = sc[_WAVES] + go
        log_n, budget = sc[_LOG_N], sc[_BUDGET]
        false = torch.zeros((), dtype=torch.bool, device=stats.device)
        hit = stats[5::3] != 0
        fails = [
            (n_new == 0) & (count == 0),
            overflow != 0,
            (hit & d["undiscovered"]).any() if hit.numel() else false,
            log_n + n_new > L,
            count + n_new > PC,
            count > F if F < self._F_max else false,
            budget - n_new < B,
            waves >= self._max_drain_waves,
            sc[_GENERATED] >= _GENERATED_CAP,
        ]
        new, parent_hi, parent_lo = out["new"], out["parent_hi"], out["parent_lo"]
        if self._use_fps:
            # The device makes the first S fresh children; a wave with
            # more stops the drain and the host makes them all.
            S = self._take_width(F)
            fails.append(n_new > S)
            rows = {k: new[k][:S] for k in ("hi", "lo", "ebits", "depth")}
            rows["states"] = take_children(self._spec, frontier["states"], new["src"][:S])
            new, parent_hi, parent_lo = rows, parent_hi[:S], parent_lo[:S]
        reason = sum(f.to(torch.int64) << i for i, f in enumerate(fails))
        if "hold" in out:
            reason = torch.where(out["hold"], _ORBIT_FALLBACK, reason)
        ok = (reason == 0).to(torch.int64)
        consume = go * ok
        stop = (go * (1 - ok)).to(torch.bool)

        lanes = torch.arange(new["hi"].shape[0], dtype=torch.int64, device=stats.device)
        fresh = (lanes < n_new) & (consume == 1)
        dest = torch.where(fresh, log_n + lanes, L)
        d["log"][0][dest] = (new["hi"] << 32) | new["lo"]
        d["log"][1][dest] = (parent_hi << 32) | parent_lo
        if self._sym is not None:
            d["log"][2][dest] = (out["key_hi"] << 32) | out["key_lo"]
        count = ring_push(d["pool"], head, count, new, fresh, PC)
        sc.copy_(torch.stack([
            head,
            count,
            log_n + consume * n_new,
            sc[_GENERATED] + consume * generated,
            sc[_CONSUMED] + consume * n_new,
            torch.maximum(sc[_MAX_DEPTH], consume * depth),
            budget - consume * n_new,
            waves,
            consume,
            torch.where(stop, reason, sc[_REASON]),
            torch.where(stop, slot, sc[_FINAL_SLOT]),
            torch.where(stop, n, sc[_FINAL_TAKE]),
            torch.maximum(sc[_MAX_FRESH], go * n_new),
        ]))
        d["final_stats"].copy_(torch.where(stop, stats, d["final_stats"]))
        if self._cov is not None:
            # A consumed wave's vector joins the sum; the stopping wave's is
            # kept for the host (a no-op wave after the exit adds nothing).
            d["cov_acc"].add_(consume * out["cov"])
            d["final_cov"].copy_(torch.where(stop, out["cov"], d["final_cov"]))
        return table, out, frontier

    def _deep_drain(self, table, width, budget):
        """One drain at rung ``width``; returns ``(table, summary, out,
        frontier)``: the drain's scalars followed by the final wave's stats
        and, with coverage on, the consumed waves' coverage sum and the
        final wave's vector (one read), and the final wave's output and
        frontier."""
        d = self._drain
        sc = d["scalars"]
        sc[_LOG_N:] = torch.tensor(
            [0, 0, 0, 0, budget, 0, 1, 0, 0, 0, 0], dtype=torch.int64
        )
        if self._cov is not None:
            d["cov_acc"].zero_()
        d["undiscovered"].copy_(torch.tensor(
            [p.name not in self._discoveries_fp for p in self._properties],
            dtype=torch.bool,
        ))
        if self._device.type == "cuda":
            slots = self._replay_drain(table, width)
        else:
            while True:
                table, out, frontier = self._drain_step(table, width, 0)
                if not int(sc[_GO]):
                    break
            slots = [(out, frontier)]
        parts = [sc, d["final_stats"]]
        if self._cov is not None:
            parts += [d["cov_acc"], d["final_cov"]]
        summary = torch.cat(parts).tolist()  # the drain's one read
        out, frontier = slots[summary[_FINAL_SLOT]]
        return table, summary, out, frontier

    def _replay_drain(self, table, width):
        """Runs a drain on the card: replays the pair of captured graphs of
        ``_GRAPH_WAVES`` waves in turns, two queued at a time. Before
        queueing a graph again the host waits for its last replay and reads
        the ``go`` flag copied after it: the graph queued behind it keeps
        the card busy, and a graph is replayed again only once every wave
        of its last replay was consumed, so the final wave is never
        overwritten. Returns the graphs' (out, frontier) slots."""
        d = self._drain
        key = (width, self._capacity, d["capacity"],
               self._take_width(width) if self._use_fps else None)
        entry = self._graphs.get(key)
        if entry is None or entry["table"] != table.data_ptr():
            # Capacities only grow: graphs of other capacities are done.
            self._graphs = {
                k: v for k, v in self._graphs.items() if k[1:3] == key[1:3]
                and k[0] != width and v["table"] == table.data_ptr()
            }
            t0 = time.perf_counter()
            entry = self._graphs[key] = self._capture_drain(table, width)
            self.capture_s += time.perf_counter() - t0
        if self._go_host is None:
            self._go_host = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        graphs, events, flag = entry["graphs"], entry["events"], self._go_host
        per_replay = entry["launches"]

        def launch(i):
            # A replay launches every kernel of its waves, no-op waves
            # included, with no Python call of the wrappers.
            for (mod, name), n in zip(_LAUNCH_COUNTERS, per_replay):
                setattr(mod, name, getattr(mod, name) + n)
            graphs[i % 2].replay()
            flag[i % 2].copy_(d["scalars"][_GO], non_blocking=True)
            events[i % 2].record()

        launch(0)
        launch(1)
        q = 2
        while True:
            events[q % 2].synchronize()
            if not int(flag[q % 2]):
                break
            launch(q)
            q += 1
        self.graph_replays += q
        self.noop_waves += q * _GRAPH_WAVES - int(d["scalars"][_WAVES])
        return entry["slots"]

    def _capture_drain(self, table, width):
        """Captures the pair of drain graphs for ``width`` over the current
        table and ring, after a warm-up wave that takes no lanes (it builds
        the kernels and sets up the libraries' workspaces). A capture that
        fails raises: nothing falls back to the uncaptured loop. Returns the
        graphs with the kernel launches each replay makes."""
        d = self._drain
        sc = d["scalars"]
        sc[_GO] = 0
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._drain_step(table, width, 0)
        torch.cuda.current_stream().wait_stream(side)
        self.warmup_waves += 1
        sc[_GO] = 1
        # A capture records the kernels and launches none: its counts are
        # undone here and added at every replay instead.
        counts = [getattr(mod, name) for mod, name in _LAUNCH_COUNTERS]
        graphs, slots = [], []
        for g in range(2):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for j in range(_GRAPH_WAVES):
                    _table, out, frontier = self._drain_step(
                        table, width, g * _GRAPH_WAVES + j
                    )
                    slots.append((out, frontier))
            graphs.append(graph)
        per_replay = []
        for (mod, name), before in zip(_LAUNCH_COUNTERS, counts):
            per_replay.append((getattr(mod, name) - before) // 2)
            setattr(mod, name, before)
        self.graph_captures += 2
        return {
            "graphs": graphs,
            "slots": slots,
            "events": [torch.cuda.Event(), torch.cuda.Event()],
            "table": table.data_ptr(),
            "launches": per_replay,
        }

    # -- path reconstruction ------------------------------------------------

    def _host_fp(self, host_state) -> int:
        try:
            return self._host_fps[host_state]
        except (KeyError, TypeError):
            pass
        packed = map_leaves(lambda x: x[None], self._model.pack_state(host_state))
        hi, lo = self._model.packed_fingerprint(packed)
        fp = fp_to_int(hi[0], lo[0])
        try:
            self._host_fps[host_state] = fp
        except TypeError:
            pass
        return fp

    def _ingest_wave_log(self):
        # Raced by the worker (visitor reconstruction) and the user thread
        # (mid-run discoveries()); first-writer-wins keeps the BFS parent.
        with self._ingest_lock:
            while self._ingested < len(self._wave_log):
                children, parents = self._wave_log[self._ingested]
                self._store.insert_batch(children, parents)
                self._ingested += 1

    def _reconstruct(self, fp: int) -> Path:
        self._ingest_wave_log()
        chain = self._store.chain(fp)
        return Path.from_fingerprints(self._model, chain, fp_of=self._host_fp)

    # -- Checker surface -----------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    def model(self):
        return self._model

    def state_count(self) -> int:
        return max(self._state_count, self._unique_count)

    def unique_state_count(self) -> int:
        return self._unique_count

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        out = {
            name: self._reconstruct(fp)
            for name, fp in list(self._discoveries_fp.items())
        }
        return self._with_lassos(
            out, self._done_event.is_set(), set(self._discoveries_fp)
        )

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._done_event.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._error

    def table_capacity(self) -> int:
        return self._capacity
