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

Device liveness (``liveness="device"``, the JAX package's knob and
``edge_log_capacity``; ``checker/device_liveness.py``): every staged wave
appends its condition-false edges and terminal rows to a device edge log
(``ops/edge_store.py``), on the wave path and inside the captured drain;
the seed records the condition-false roots. The log holds
``edge_log_capacity`` rows (default four worst-case waves, at least one)
and the host evicts it to ``storage.LivenessEdgeStore`` before a wave
could overflow it: wave at a time from the fill count the wave's one
stats read carries, and between drains, a drain exiting ("edge log full",
the last bit of ``EXIT_REASONS``) when its log could not take one more
wave. At run end the trim and reach on the checker's device decide each
undiscovered ``eventually`` property, with a certificate replayed on the
host; ``discoveries()`` merges the counterexamples in and
``liveness_report()`` gives each verdict's record. The knob runs the
staged, materializing wave (``wave_kernel=None`` resolves to
``"staged"``; ``"fused"``, ``expand_fps=True``, symmetry and a capped run
are refused, as in the JAX package). A wave's outputs do not depend on
the log: counts, depths and paths are those of the run without it.

Checkpoint, preempt and resume (the JAX package's format v2, and v3 with
device liveness, whose payload adds the edge store; and its
knobs): ``checkpoint_path`` writes a checkpoint atomically every
``checkpoint_every_chunks`` dequeued chunks wave at a time, and at every
drain exit after the first through the drain (whose waves are then capped
at ``max(2, checkpoint_every_chunks)``), no more often than
``checkpoint_min_interval_s``; ``request_preempt()`` stops the run at the
next wave or drain boundary with the same payload in memory
(``preempt_payload()``); ``resume_from`` (a path or a payload) restores
counters, discoveries, the parent map, the pending frontier and the
storage tiers, and rebuilds the table from the keys no run holds, sorted,
through the insert kernel. The payload's kind is ``"gpu_bfs"``; its chunks
hold live lanes only. A resumed run is bit-identical to the uninterrupted
one; a drain's payload also carries the rung selector's state, so the
resumed drains take the same waves.

Out-of-core tiering (``hbm_budget_mib``, ``host_budget_mib``,
``spill_dir``; ``storage/``): the table never grows past the budget; a
growth that would pass it evicts every live row to host runs (L1, spilled
to files as L2 past the host budget) and resets the table. From then on
each wave's fresh keys are probed against the runs on the host, and only
the survivors are counted, logged and queued, in lane order, so the run
stays bit-identical to the unbounded one. The first eviction ends the
drain: the ring, then the host queue, go back to the wave path.

Wave-timeline attribution (``attribution=True``, or an engine already
built; ``telemetry/attribution.py``, ``attribution_report()``, prefix
``gpu_bfs``): each wave at a time is a ``wave`` window with a
``gpu_bfs.wave`` span, each drain a ``drain`` window with a
``gpu_bfs.drain`` span (and a ``gpu_bfs.wave`` span over its final wave),
and their wall is classified into the device phase (``wave_kernel`` on the
fused engine, ``device`` on the staged one: the wave's launches, or a
drain's replays, fenced inside the phase), ``host_probe``, ``evict``,
``table_grow`` (with a ``gpu_bfs.table_grow`` span), ``checkpoint`` and
``compile`` (one window for each drain graph captured, its warm-up wave
with the first, under a ``gpu_bfs.compile`` span; a replay of a held graph
never enters it), the rest being the ``gap``. The restore's table rebuild
lands in ``outside_wave_s``. At run end the table's probe-length counts
feed the ledger and the ``gpu_bfs.hashset.probe_length`` histogram.
Attribution adds fences and nothing else: waves, rungs, exits, captures
and results are those of the run without it. With it off no hook reads a
clock, fences or emits a span.

Semantics parity notes (mirrored from the reference): ``eventually`` bits
propagate along paths and are not part of the fingerprint;
``target_state_count``/``target_max_depth`` may overshoot by up to a wave.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import pickle
import threading
import time
from collections import Counter, deque
from hashlib import blake2b
from typing import Dict, List, Optional

import numpy as np
import torch

from ..actor.packed import PackedActorModel
from ..core.batch import BatchableModel, leaves, map_leaves, supports_expand_fps
from ..core.model import Expectation
from ..core.path import Path
from ..native import make_fingerprint_store
from ..ops import fused_wave as fw
from ..ops import hashset_kernel as hk
from ..ops.fingerprint import FP_SCHEME, fp_to_int
from ..ops.fused_wave import (
    FusedWaveSpec,
    comphash_tables,
    fused_wave,
    sorted_dedup,
    take_children,
    torch_wave,
    torch_wave_fps,
)
from ..ops.hashset import (
    MAX_PROBES,
    hashset_new,
    hashset_probe_length_counts,
    i32_to_u32,
    u32_to_i32,
)
from ..ops.hashset_kernel import (
    TILE_ROWS,
    hashset_insert_sorted,
    round_table_capacity,
    sort_key,
    split_key,
)
from ..ops.edge_store import EDGE_COLS, edge_log_new
from ..ops.ring import ring_export, ring_push, ring_rows, ring_take
from ..storage import (
    LivenessEdgeStore,
    LivenessInstruments,
    StorageInstruments,
    TieredVisitedStore,
    max_table_rows_for_budget,
    validate_budget_knobs,
)
from ..telemetry.trace import _NULL_SPAN
from ..utils.faults import fault_point
from .base import Checker
from .device_liveness import seed_root_mask, validate_liveness_mode
from .symmetry import SYM_KEY_SCHEME, make_key_fn, sym_key_scheme

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
# reference's loop condition, the port's own reasons after them;
# ``drain_exits`` counts a drain under the first of its reasons.
EXIT_REASONS = (
    "nothing left", "probe overflow", "property hit", "log full", "ring full",
    "promote", "budget", "max waves", "generated cap", "take full", "orbit fallback",
    "edge log full",
)
_TAKE_FULL = 1 << EXIT_REASONS.index("take full")
# A drain wave under symmetry whose refined keys failed their check on a
# valid lane inserts nothing and records this reason alone.
_ORBIT_FALLBACK = 1 << EXIT_REASONS.index("orbit fallback")
# A drain wave after which the device liveness edge log could not take one
# more worst-case wave of the rung stops the drain; the host evicts it.
_EDGE_LOG_FULL_BIT = EXIT_REASONS.index("edge log full")


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic collector paused for a CUDA Graph capture: a
    collection inside the capture can free a graph that became garbage
    (another run's), and destroying a graph while this thread captures
    invalidates the capture. ``torch.cuda.graph`` collects once on entry."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


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


def keys_route(model) -> str:
    """The fused wave's key route for ``model`` (``ops/fused_wave.py``):
    ``"fold"`` for the default fold, ``"comphash"`` for a packed actor
    model's component hash, ``"pairs"`` for any other
    ``packed_fingerprint``."""
    fp = getattr(model.packed_fingerprint, "__func__", None)
    if fp is BatchableModel.packed_fingerprint:
        return "fold"
    if fp is PackedActorModel.packed_fingerprint:
        return "comphash"
    return "pairs"


def wave_spec(model, device, use_fps=False, cov_layout=None, cov_antecedents=None,
              symmetry=None) -> FusedWaveSpec:
    """What a wave of ``model`` closes over (``FusedWaveSpec``), as the
    checker builds it: the properties' kinds and eventually bits, the key
    route, and on the ``"comphash"`` route its constants, on ``device``
    now, before any capture. ``use_fps`` takes the fingerprint-only
    expansion; ``cov_layout`` and ``cov_antecedents`` turn coverage on;
    ``symmetry`` is the checker's ``SymmetryKeys``."""
    props = model.properties()
    eventually = [i for i, p in enumerate(props) if p.expectation == Expectation.EVENTUALLY]
    route = keys_route(model)
    comphash = None
    if route == "comphash":
        comphash = comphash_tables(model.packed_comphash_layout(), device)
    return FusedWaveSpec(
        expand=model.packed_expand,
        within_boundary=model.packed_within_boundary,
        conditions=tuple(model.packed_conditions()),
        expectations=tuple(p.expectation.value for p in props),
        ebit=tuple((pi, b) for b, pi in enumerate(eventually)),
        action_count=model.packed_action_count(),
        fingerprint=model.packed_fingerprint,
        keys_route=route,
        comphash=comphash,
        cov_layout=cov_layout,
        cov_antecedents=tuple(cov_antecedents or ()),
        expand_fps=model.packed_expand_fps if use_fps else None,
        take=model.packed_take if use_fps else None,
        symmetry=symmetry,
    )


def resolve_device(device, entry: str = "spawn_gpu_bfs") -> torch.device:
    """The checker's device: CUDA unless the caller asks for the CPU. With
    no CUDA device and no ``device="cpu"`` it raises — the run never goes
    on quietly on the CPU. ``entry`` names the caller in the errors."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{entry} runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain torch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    elif dev.type != "cpu":
        raise ValueError(f"{entry} runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def _fp64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 pairs as int64 whose bits are the u64 fingerprint."""
    return (hi << 32) | lo


def _u64(x: torch.Tensor) -> np.ndarray:
    """An int64 tensor of u64 bits as a host u64 array."""
    return x.cpu().numpy().view(np.uint64)


CHECKPOINT_KIND = "gpu_bfs"


def min_admissible_hbm_budget_mib(model, frontier_capacity: int) -> float:
    """The smallest ``hbm_budget_mib`` a checker with this model and
    frontier width accepts, i.e. the most eviction pressure: one worst-case
    wave (frontier x action count candidates) must fit a freshly evicted
    table under ``_MAX_LOAD``, and the table is at least one tile of the
    insert kernels (``TILE_ROWS`` rows). Priced as
    ``storage.max_table_rows_for_budget`` prices a table: 8 bytes a row and
    the ``MAX_PROBES`` apron."""
    rows = _pow2ceil(
        int(_pow2ceil(frontier_capacity) * model.packed_action_count() / _MAX_LOAD) + 1
    )
    return ((max(rows, TILE_ROWS) + MAX_PROBES) * 8) / (1 << 20)


def packed_model_digest(model, action_count: int) -> str:
    """Digest of a model's packed configuration, guarding a resume: the
    class name alone would let a 3-RM checkpoint resume a 4-RM model. It
    hashes the packed initial states' leaves, in the port's leaf order."""
    h = blake2b(digest_size=16)
    h.update(type(model).__name__.encode())
    h.update(str(action_count).encode())
    for leaf in leaves(model.packed_init_states("cpu")):
        arr = leaf.cpu().numpy()
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def host_fingerprint(model, host_state) -> int:
    """The packed fingerprint of one host state, as the device checkers key
    it: the ``fp_of`` their path replays match the trails with."""
    packed = map_leaves(lambda x: x[None], model.pack_state(host_state))
    hi, lo = model.packed_fingerprint(packed)
    return fp_to_int(hi[0], lo[0])


# The swarm's payload kind, whose format is version 3 (the JAX package's
# swarm payload's).
SWARM_CHECKPOINT_KIND = "gpu_swarm"


def checkpoint_header(model, action_count: int, symmetry: bool, sym_scheme=None, *,
                      kind: str = CHECKPOINT_KIND) -> dict:
    """The checkpoint header: the checker kind (``CHECKPOINT_KIND`` for
    this checker, ``SWARM_CHECKPOINT_KIND`` for the swarm), its format
    version (2 for this checker, with the optional ``"storage"`` payload of
    the tiers' runs, which ``checkpoint_payload`` stamps 3 when it adds the
    device liveness edge store; 3 for the swarm), the model and its digest,
    and the key schemes."""
    if symmetry and sym_scheme is None:
        sym_scheme = SYM_KEY_SCHEME
    return {
        "version": 3 if kind == SWARM_CHECKPOINT_KIND else 2,
        "kind": kind,
        "model": type(model).__name__,
        "model_digest": packed_model_digest(model, action_count),
        "symmetry": symmetry,
        "sym_scheme": sym_scheme if symmetry else None,
        "fp_scheme": FP_SCHEME,
    }


def validate_checkpoint_header(payload: dict, model, action_count: int, symmetry: bool,
                               sym_scheme=None, *, kind: str = CHECKPOINT_KIND,
                               hint: Optional[str] = None) -> None:
    """Refuses a checkpoint that another checker kind, model, model
    configuration or symmetry setting wrote. A payload without a ``kind``
    was written by the JAX package's ``tpu_bfs`` checker. Versions 1 to 3
    are read (3: this checker's payload with a device liveness edge store,
    whose mode ``_restore`` matches; the swarm's payloads). ``hint`` ends
    the message of a refused kind (default: resume with the package that
    wrote it)."""
    if payload.get("version") not in (1, 2, 3):
        raise ValueError(f"unsupported checkpoint version: {payload.get('version')!r}")
    found_kind = payload.get("kind", "tpu_bfs")
    if found_kind != kind:
        raise ValueError(
            f"checkpoint kind {found_kind!r} does not match this checker "
            f"({kind!r}): "
            + (hint or "resume a checkpoint with the checker of the package that wrote it")
        )
    if payload["model"] != type(model).__name__:
        raise ValueError(
            f"checkpoint was written by model {payload['model']!r}, "
            f"resuming with {type(model).__name__!r}"
        )
    if payload.get("model_digest") != packed_model_digest(model, action_count):
        raise ValueError(
            "checkpoint was written by a differently-configured model "
            "(packed init states / action count do not match); resuming "
            "would mix two state spaces"
        )
    if payload.get("symmetry", False) != symmetry:
        raise ValueError(
            "checkpoint symmetry setting does not match this checker "
            "(visited keys are canonical-form fingerprints under symmetry, "
            "plain fingerprints otherwise; the two key spaces cannot mix)"
        )
    if symmetry:
        want = sym_scheme if sym_scheme is not None else SYM_KEY_SCHEME
        if payload.get("sym_scheme") != want:
            raise ValueError(
                f"checkpoint symmetry-key scheme {payload.get('sym_scheme')!r} does "
                f"not match this checker ({want!r}); its visited keys cannot be "
                "mixed into a resumed run"
            )
    if payload.get("fp_scheme") != FP_SCHEME:
        raise ValueError(
            f"checkpoint fingerprint scheme {payload.get('fp_scheme')!r} does not "
            f"match this build ({FP_SCHEME!r}); its visited keys and parent fps "
            "cannot be mixed into a resumed run"
        )


def atomic_pickle(path, payload) -> int:
    """Writes the pickle to ``path`` atomically (a temporary file, then a
    rename), so a kill or a failed write never corrupts the previous
    checkpoint; returns the bytes written."""
    # A real write fails on ENOSPC or a torn rename: the seam sits before
    # the rename, so the previous checkpoint survives the fault.
    fault_point("checkpoint.write")
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
        size = f.tell()
    os.replace(tmp, path)
    return size


def sorted_key_halves(keys: np.ndarray, device):
    """u64 keys as the insert kernel takes them: sorted ascending, split
    into int32 (hi, lo) halves on ``device``."""
    keys = np.sort(np.asarray(keys, np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def rehash_table(table, capacity: int):
    """The table's live rows, sorted, inserted into an empty table of
    ``capacity`` rows on its device through the insert kernel (the plain
    twin on the CPU); returns the new table and the count of rows that
    found no slot."""
    rows_hi, rows_lo = i32_to_u32(table[:, 0]), i32_to_u32(table[:, 1])
    live = (rows_hi != 0) | (rows_lo != 0)
    key, _ = torch.sort(sort_key(rows_hi[live], rows_lo[live]))
    khi, klo = split_key(key)
    new_table, _fresh, _found, pending = hashset_insert_sorted(
        hashset_new(capacity, table.device), u32_to_i32(khi),
        u32_to_i32(klo), torch.ones_like(key, dtype=torch.bool),
    )
    return new_table, int(pending.sum())


def _chunk_to_host(chunk) -> dict:
    """A queue chunk as numpy arrays (the payload's form)."""
    return {k: (map_leaves(lambda x: x.cpu().numpy(), v) if k == "states"
                else v.cpu().numpy()) for k, v in chunk.items()}


def _tree_to_device(tree, device):
    """A payload's numpy tree as fresh tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_device(v, device) for v in tree)
    return torch.tensor(tree, device=device)


class DeviceBfsChecker(Checker):
    """What the port's device BFS checkers share: the parent map their
    waves log, path reconstruction from it, and the worker thread's
    accessors. A subclass calls ``_init_wave_log()`` in its constructor
    and keeps ``_model``, ``_device``, the counts, ``_done_event``,
    ``_error`` and ``_handles``."""

    def _init_wave_log(self) -> None:
        # (child fps, parent fps — 0 encodes "init state") per wave, as
        # u64 numpy arrays, ingested lazily into the parent-pointer store.
        self._wave_log: List = []
        self._store = make_fingerprint_store()
        self._ingested = 0
        self._ingest_lock = threading.Lock()
        self._host_fps: Dict = {}

    # -- path reconstruction ------------------------------------------------

    def _host_fp(self, host_state) -> int:
        try:
            return self._host_fps[host_state]
        except (KeyError, TypeError):
            pass
        fp = host_fingerprint(self._model, host_state)
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

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._done_event.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._error


class GpuBfsChecker(DeviceBfsChecker):
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
    (module docstring). ``liveness="device"`` decides the ``eventually``
    properties soundly from a device edge log of ``edge_log_capacity``
    rows (module docstring).

    Checkpoints and tiering take the JAX package's knobs and defaults
    (module docstring): ``checkpoint_path``, ``checkpoint_every_chunks``,
    ``checkpoint_min_interval_s`` and ``resume_from``; ``hbm_budget_mib``
    caps the table (at least one worst-case wave,
    ``min_admissible_hbm_budget_mib``), ``host_budget_mib`` and
    ``spill_dir`` spill the host runs to disk.

    ``attribution`` (False, True, or a ``WaveAttribution`` built by the
    caller, say with a ``profile_dir``) records the wave-timeline ledger
    (module docstring, ``attribution_report()``)."""

    supports_preempt = True

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
        checkpoint_path=None,
        checkpoint_every_chunks=32,
        checkpoint_min_interval_s=0.0,
        resume_from=None,
        hbm_budget_mib=None,
        host_budget_mib=None,
        spill_dir=None,
        attribution=False,
        liveness=None,
        edge_log_capacity=None,
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
        self._live = validate_liveness_mode(liveness, symmetry=symmetry,
                                            expand_fps=(expand_fps is True), options=options)
        # The default engine: fused, unless the run asks for what only the
        # staged wave does (symmetry keys, the fingerprint-only expansion,
        # the device liveness edge log).
        engine_note = None
        if wave_kernel is None:
            if symmetry:
                wave_kernel, why = "staged", "symmetry reduction runs on the staged wave"
            elif expand_fps:
                wave_kernel, why = "staged", "expand_fps=True runs on the staged wave"
            elif self._live:
                wave_kernel, why = "staged", "liveness='device' runs on the staged wave"
            else:
                wave_kernel = "fused"
                why = "it rounds table_capacity up to a tile-aligned power of two"
            engine_note = f"wave_kernel resolved to '{wave_kernel}' ({why})"
        if wave_kernel == "fused" and self._live:
            raise ValueError(
                "liveness='device' is incompatible with wave_kernel='fused' (the "
                "edge-log append is not fused yet); use wave_kernel='staged' or "
                "the host liveness post-pass"
            )
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
        # under the fused wave, under symmetry, whose keys need the
        # candidate states, and with device liveness, whose edge log needs
        # the children's conditions.
        has_fps = supports_expand_fps(model)
        if expand_fps is None:
            self._use_fps = (has_fps and wave_kernel != "fused" and not symmetry
                             and not self._live)
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
        # Device liveness: the edge log (allocated at run start) and its
        # host tier.
        self._live_enabled = self._live == "device" and bool(self._ebit)
        self._live_paths: Dict[str, Path] = {}
        self._live_outcomes: Dict[str, dict] = {}
        self._elog = None
        self._elog_count = 0
        if self._live_enabled:
            # One worst-case wave appends F·A edge rows + F terminal rows;
            # the default log holds four of them, so evictions are rare.
            self._elog_capacity = _pow2ceil(
                edge_log_capacity or 4 * (self._F_max * self._A + self._F_max))
            if self._elog_capacity < self._F_max * (self._A + 1):
                raise ValueError(
                    f"edge_log_capacity={edge_log_capacity} cannot hold one worst-case "
                    f"wave ({self._F_max * (self._A + 1)} rows)"
                )
            self._live_ins = LivenessInstruments("gpu_bfs", registry=self.metrics())
            self._live_store = LivenessEdgeStore(
                instruments=self._live_ins, spill_dir=spill_dir,
                host_budget_mib=host_budget_mib,
            )
        if bucket_ladder is None:
            bucket_ladder = (
                _DEFAULT_BUCKET_STEPS if self._F_max >= _AUTO_BUCKET_MIN_F else 0
            )
        if bucket_ladder < 0:
            raise ValueError(f"bucket_ladder must be >= 0, got {bucket_ladder}")
        self._buckets = bucket_ladder_widths(self._F_max, bucket_ladder)
        self._max_drain_waves = max(1, int(max_drain_waves))
        self._checkpoint_path = checkpoint_path
        # Counts dequeued chunks wave at a time; the time floor keeps wide
        # frontiers from checkpointing back to back.
        self._checkpoint_every = max(1, checkpoint_every_chunks)
        self._checkpoint_min_interval = checkpoint_min_interval_s
        self._resume_from = resume_from
        if checkpoint_path is not None:
            # A drain can span the whole run: with a checkpoint path a drain
            # exits at least every N waves (2 at least, so it stays a drain).
            self._max_drain_waves = min(
                self._max_drain_waves, max(2, checkpoint_every_chunks)
            )
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
        # Out-of-core tiering: the budget caps the table; growth past the
        # cap evicts the table to the host tiers (``_evict_l0``).
        validate_budget_knobs(hbm_budget_mib, host_budget_mib, spill_dir)
        self._tier = None
        self._max_capacity = None
        if hbm_budget_mib is not None:
            max_cap = max_table_rows_for_budget(hbm_budget_mib)
            # A freshly evicted table must take one worst-case wave under
            # the load cap, or the grow-and-retry loop could not end.
            min_cap = _pow2ceil(int(self._F_max * self._A / _MAX_LOAD) + 1)
            if max_cap < min_cap:
                raise ValueError(
                    f"hbm_budget_mib={hbm_budget_mib} allows a device table of {max_cap} "
                    f"rows, but one worst-case wave (frontier_capacity x action_count = "
                    f"{self._F_max * self._A} candidates) needs at least {min_cap}; "
                    "raise the budget or shrink frontier_capacity"
                )
            self._max_capacity = max_cap
            cap = min(cap, max_cap)
            self._tier = TieredVisitedStore(
                host_budget_mib=host_budget_mib, spill_dir=spill_dir,
                instruments=StorageInstruments("gpu_bfs"), tracer=self._tracer,
            )
        if wave_kernel == "fused":
            # The fused wave's sweep grids over TILE_ROWS-row tiles: round
            # the capacity up and say so, as the JAX package does. The
            # staged insert keeps its refusal below.
            rounded = round_table_capacity(cap)
            if rounded != cap:
                if self._max_capacity is not None and rounded > self._max_capacity:
                    raise ValueError(
                        f"table_capacity={cap} rounds up to {rounded} rows for the "
                        f"tile-sweep kernels ({TILE_ROWS}-row tiles), which exceeds the "
                        f"hbm_budget_mib cap of {self._max_capacity} rows; raise the "
                        "budget or shrink table_capacity"
                    )
                self.config_notes.append(
                    f"table_capacity rounded {cap} -> {rounded} (tile-sweep "
                    f"kernels grid over {TILE_ROWS}-row table tiles)"
                )
                cap = rounded
        elif self._max_capacity is not None and self._max_capacity < TILE_ROWS:
            raise ValueError(
                f"the hbm_budget_mib cap of {self._max_capacity} rows is less than one "
                f"{TILE_ROWS}-row tile of the insert kernel; raise the budget "
                "(min_admissible_hbm_budget_mib)"
            )
        if cap <= 0 or cap & (cap - 1) or cap % TILE_ROWS:
            raise ValueError(
                "table_capacity must be a power of two and a multiple of "
                f"{TILE_ROWS} (the insert kernel's tile), got {table_capacity}"
            )
        self._capacity = cap
        self._visitor = options._visitor
        self._target_state_count: Optional[int] = options._target_state_count
        self._depth_cap = options._target_max_depth or _DEPTH_INF
        self._init_coverage("gpu_bfs", coverage, self._A, symmetry=symmetry)
        self._init_attribution("gpu_bfs", attribution)
        # The attribution phase of a wave's device work, by engine.
        self._device_phase = "wave_kernel" if wave_kernel == "fused" else "device"
        self._spec = wave_spec(
            model, self._device, use_fps=self._use_fps, cov_layout=self._cov_layout,
            cov_antecedents=self._cov_antecedents, symmetry=self._sym,
        )
        self.keys_route = self._spec.keys_route

        self._state_count = 0
        self._unique_count = 0
        # Keys resident in the table: the unique count until the first
        # eviction, then the working set and the keys it claimed again.
        self._l0_count = 0
        self._max_depth = 0
        self._discoveries_fp: Dict[str, int] = {}
        self._init_wave_log()
        # Under symmetry: the visited-set keys claimed so far (u64 numpy
        # arrays a wave; first the seed's valid lanes), as the JAX package
        # keeps them.
        self._key_log: List = []
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
        # Tiering and checkpoint statistics: table evictions, the fresh lanes
        # the host probe found in a run (``stale_lanes``) and its seconds,
        # the wave count at the drain's handoff to the wave path (None: no
        # handoff), and the checkpoints written, their seconds and bytes.
        self.evictions = 0
        self.stale_lanes = 0
        self.host_probe_s = 0.0
        self.handoff_wave = None
        self.checkpoints_written = 0
        self.checkpoint_s = 0.0
        self.checkpoint_bytes = 0
        # Insert-kernel launches of the restore's table rebuild.
        self.restore_inserts = 0
        # The rung selector's state a drain payload restores.
        self._resume_drain = None
        # request_preempt() sets it; the worker stops at the next wave or
        # drain boundary with its state in ``_preempt_payload``.
        self._preempt_event = threading.Event()
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
        return torch_wave(*args, mask=mask, exact=exact, elog=self._elog)

    def _device_wave(self, table, chunk):
        """``_wave`` on the wave path; in attribution mode inside the device
        phase, fenced."""
        if self._attr is None:
            return self._wave(table, chunk)
        with self._attr.phase(self._device_phase):
            table, out = self._wave(table, chunk)
            self._attr.fence(out)
        return table, out

    def _span(self, name, **args):
        """A trace span in attribution mode; the tracer's null span
        otherwise."""
        if self._attr is None:
            return _NULL_SPAN
        return self._tracer.span(name, **args)

    def _span_counts(self, span, frontier, generated, n_new, **extra):
        """A wave or drain span's counts, in the JAX package's names (what
        ``scripts/trace_summary.py`` reads); nothing with attribution off."""
        if self._attr is None:
            return
        span.set(frontier=frontier, generated=generated, new_unique=n_new,
                 dedup_hit_rate=(generated - n_new) / generated if generated else 0.0,
                 occupancy=self._l0_count / self._capacity, capacity=self._capacity,
                 max_depth=self._max_depth, **extra)

    def _audit_table(self, table):
        """Run-end audit in attribution mode: the table's probe-length
        counts into the ledger and the ``gpu_bfs.hashset.probe_length``
        histogram."""
        if self._attr is not None:
            self._attr.observe_probe_lengths(hashset_probe_length_counts(table))

    def _grow_table(self, table, min_capacity):
        """Doubles the table (rehash) to at least ``min_capacity`` rows, or,
        under a budget, evicts it when that would pass the cap."""
        if self._max_capacity is not None and min_capacity > self._max_capacity:
            return self._evict_l0(table)
        capacity = self._capacity
        while capacity < min_capacity:
            capacity *= 2
        while True:
            with self._span("gpu_bfs.table_grow", from_capacity=self._capacity,
                            to_capacity=capacity), self._phase("table_grow"):
                new_table, leftover = rehash_table(table, capacity)
                if self._attr is not None:
                    self._attr.fence(new_table)
            if not leftover:
                break
            # A pathological key cluster can exhaust the probe cap during
            # rehash; the next doubling shortens probe chains. Under a
            # budget the next doubling may not exist: evict instead.
            capacity *= 2
            if self._max_capacity is not None and capacity > self._max_capacity:
                return self._evict_l0(table)
        self._capacity = capacity
        self.table_growths += 1
        return new_table

    def _evict_l0(self, table):
        """Growth under the budget: the table's live rows go to the host
        tiers as a new L1 run and the table starts empty at the cap; older
        keys answer through the host probe from here on."""
        with self._phase("evict"):
            rows = table.cpu().numpy().view(np.uint32).astype(np.uint64)
            live = (rows[:, 0] != 0) | (rows[:, 1] != 0)
            self._tier.evict((rows[live, 0] << np.uint64(32)) | rows[live, 1])
        self._capacity = self._max_capacity
        self._l0_count = 0
        self.evictions += 1
        self._tier.instruments.set_l0(0)
        return hashset_new(self._capacity, self._device)

    # -- host exploration loop ----------------------------------------------

    def _run(self):
        try:
            if self._live_enabled:
                self._elog = edge_log_new(self._elog_capacity, self._device)
            if self._resume_from is not None:
                table, queue = self._restore(self._resume_from)
            else:
                table, queue = self._seed()
            # As in the reference: the drain is off when a visitor needs
            # each chunk or a target count caps the run (a drain would
            # overshoot by whole drains), and for a resumed run that has
            # evicted (each wave needs the host probe).
            if (
                self._max_drain_waves > 1
                and self._visitor is None
                and self._target_state_count is None
                and (self._tier is None or self._tier.is_empty())
            ):
                handoff = self._explore_deep(table, queue)
                if handoff is not None:
                    # The first eviction ended the drain: the rest of the
                    # frontier goes on wave at a time.
                    table, queue = handoff
                    self._explore_waves(table, queue)
            else:
                self._explore_waves(table, queue)
            # Sound `eventually` verdicts (liveness="device"): the trim and
            # reach over the logged condition-false edges, with a
            # certificate.
            self._run_liveness_analysis("gpu_bfs")
            self._finalize_coverage(set(self._discoveries_fp))
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            self._error = e
        finally:
            # A window a crash left open closes, and a profiler window
            # still running stops, on this thread.
            self._abort_attribution()
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
        self._unique_count = self._l0_count = int(fresh.sum())
        if self._cov is not None:
            self._cov.record_seed(self._unique_count)
        child = _u64(_fp64(hi, lo)[valid])
        self._wave_log.append((child, np.zeros_like(child)))
        if self._live_enabled:
            # The analysis roots: condition-false init states.
            roots = seed_root_mask(self._conditions, self._ebit, states, valid)
            self._live_store.add_roots(child, roots[valid].cpu().numpy())
        if self._sym is not None:
            self._key_log.append(_u64(_fp64(khi, klo)[valid]))

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
        chunks = 0
        last_checkpoint = time.perf_counter()
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
            if self._preempt_event.is_set():
                # The queue is the whole pending frontier here.
                self._preempt_payload = self.checkpoint_payload(queue)
                self._tracer.instant("gpu_bfs.preempted", chunks=len(queue), mode="wave")
                return
            # The window covers the whole iteration (the checkpoint and the
            # growth ahead of the wave included).
            with self._wave_window():
                if (
                    self._checkpoint_path is not None
                    and chunks
                    and chunks % self._checkpoint_every == 0
                    and time.perf_counter() - last_checkpoint
                    >= self._checkpoint_min_interval
                ):
                    with self._phase("checkpoint"):
                        self.save_checkpoint(self._checkpoint_path, queue)
                    last_checkpoint = time.perf_counter()
                chunks += 1
                chunk = queue.popleft()
                # Worst case of a full-width chunk, as the reference sizes it.
                B = self._F_max * self._A
                if (self._l0_count + B) > _MAX_LOAD * self._capacity:
                    table = self._grow_table(
                        table, _pow2ceil(int((self._l0_count + B) / _MAX_LOAD))
                    )
                with self._span("gpu_bfs.wave", wave=chunks) as sp:
                    generated = self._state_count
                    table, n_new = self._consume_wave(table, chunk, queue)
                    self._span_counts(sp, chunk["hi"].shape[0],
                                      self._state_count - generated, n_new)
        self._audit_table(table)

    def _consume_wave(self, table, chunk, queue, out=None, stats=None, cov=None):
        """Applies one wave host-side (counters, discoveries, coverage, log,
        requeue), growing the table and running the same chunk again while
        keys overflow their probe windows; each attempt's fresh states are
        kept. Once the table has evicted, only the fresh lanes whose keys
        no host run holds count as new (``_probe_fresh``), in lane order.
        ``out`` and its ``stats`` (a list), when given, are the first
        attempt, already run (a drain's final wave; ``chunk`` holds its
        live lanes; ``cov`` its coverage vector, with coverage on). Returns
        ``(table, fresh states kept)``."""
        if chunk["hi"].shape[0] == 0 and out is None:
            return table, 0
        attempt = 0
        wave_new = 0
        while True:
            if out is None:
                if self._live_enabled:
                    self._maybe_evict_elog()
                table, out = self._device_wave(table, chunk)
                # The wave's one read: its counters, with coverage on its
                # vector, with device liveness the edge log's fill count.
                parts = [out["stats"]]
                if self._cov is not None:
                    parts.append(out["cov"])
                if self._live_enabled:
                    parts.append(self._elog["count"].view(1))
                read = torch.cat(parts).tolist()
                ns = out["stats"].shape[0]
                stats = read[:ns]
                if self._cov is not None:
                    cov = read[ns:ns + self._cov_layout.size]
                if self._live_enabled:
                    self._elog_count = read[-1]
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
            keep = self._probe_fresh(out, n_new)
            survivors = n_new if keep is None else keep.shape[0]
            self._l0_count += n_new
            self._unique_count += survivors
            wave_new += survivors
            if self._tier is not None:
                self._tier.instruments.set_l0(self._l0_count)
            if survivors:
                # Copies of the fresh rows (or of the survivors of the host
                # probe): the queued chunks are views of these, so the
                # wave's B-row outputs are freed now rather than held until
                # its last chunk runs. The fingerprint-only wave makes its
                # children here, in one take.
                def fresh(x):
                    return x[:n_new].clone() if keep is None else x[:n_new][keep]

                new = {k: fresh(out["new"][k]) for k in ("hi", "lo", "ebits", "depth")}
                if self._use_fps:
                    states = take_children(self._spec, chunk["states"],
                                           fresh(out["new"]["src"]))
                    self.host_takes += 1
                    self.host_take_rows += survivors
                else:
                    states = map_leaves(fresh, out["new"]["states"])
                rows = [_fp64(new["hi"], new["lo"]),
                        _fp64(fresh(out["parent_hi"]), fresh(out["parent_lo"]))]
                if self._sym is not None:
                    rows.append(_fp64(fresh(out["key_hi"]), fresh(out["key_lo"])))
                log = _u64(torch.stack(rows))
                self._wave_log.append((log[0], log[1]))
                if self._sym is not None:
                    self._key_log.append(log[2])
                for s in range(0, survivors, self._F_max):
                    piece = {k: v[s : s + self._F_max] for k, v in new.items()}
                    piece["states"] = map_leaves(lambda x: x[s : s + self._F_max], states)
                    queue.append(piece)
            if not stats[2]:
                if self._cov is not None:
                    self._cov.emit_wave_span()
                return table, wave_new
            if self._max_capacity is not None and attempt >= 8:
                # The wave overflows even freshly evicted tables: a
                # configuration error, not a loop to spin in.
                raise RuntimeError(
                    "a wave's candidates overflow the budget-capped table after "
                    "repeated evictions; raise hbm_budget_mib or shrink "
                    "frontier_capacity"
                )
            table = self._grow_table(table, self._capacity * 2)
            attempt += 1
            out = None

    def _probe_fresh(self, out, n_new):
        """The host half of the two-phase probe, once the table has
        evicted: the table vouches only for the keys it holds, so the
        wave's ``n_new`` fresh lanes whose keys (orbit keys under symmetry)
        a host run holds are stale. One batched probe a wave attempt.
        Returns the survivors' lanes (a device index tensor, ascending) or
        None when every fresh lane survives."""
        if not n_new or self._tier is None or self._tier.is_empty():
            return None
        # The phase and host_probe_s time the same work.
        with self._phase("host_probe"):
            t0 = time.perf_counter()
            if self._sym is not None:
                keys = _fp64(out["key_hi"][:n_new], out["key_lo"][:n_new])
            else:
                keys = _fp64(out["new"]["hi"][:n_new], out["new"]["lo"][:n_new])
            stale = self._tier.probe(_u64(keys))
            self.host_probe_s += time.perf_counter() - t0
        n_stale = int(stale.sum())
        if not n_stale:
            return None
        self.stale_lanes += n_stale
        return torch.from_numpy(np.flatnonzero(~stale)).to(self._device)

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
        final wave, whose fresh states go to the host queue. Checkpoints
        and preemption happen between drains. Returns None, or, after the
        first eviction, ``(table, queue)``: the whole pending frontier for
        the wave path, the ring first."""
        props = self._properties
        if not props:
            return None
        F_max = self._F_max
        B = F_max * self._A
        self._drain = self._drain_state(self._pool_capacity)
        pool_count = 0  # host view: exact after a drain, a bound after pushes
        # The rung selector's state, which a drain payload carries so a
        # resumed run takes the same waves: the exact pending live lanes
        # (ring + spilled queue; None until the first drain exit, so the
        # first drain runs at F_max); votes of consecutive drains for a
        # rung not yet entered (a new rung is entered only when two drains
        # in a row select it); the rungs entered; and the rung the next
        # drain keeps after a drain that stopped only because its wave had
        # more fresh lanes than the device makes, or an orbit fallback.
        rungs = {"live_est": None, "rung_votes": {}, "entered": set(),
                 "keep_width": None}
        if self._resume_drain is not None:
            rungs.update({k: self._resume_drain[k] for k in rungs})
            rungs["entered"] = set(rungs["entered"])
            self._take_widths.update(self._resume_drain["take_widths"])

        def drain_state():
            return {**rungs, "frontier_capacity": F_max, "entered": sorted(rungs["entered"]),
                    "rung_votes": dict(rungs["rung_votes"]),
                    "take_widths": dict(self._take_widths)}

        drains = 0
        last_checkpoint = time.perf_counter()
        while True:
            if len(self._discoveries_fp) == len(props):
                break
            if self._preempt_event.is_set():
                # The ring's rows are older than the host queue's (the
                # final wave spilled after everything the drain consumed):
                # ring, then queue, is the exact FIFO order.
                chunks = self._export_pool_chunks() + list(queue)
                self._preempt_payload = self.checkpoint_payload(chunks, drain_state())
                self._tracer.instant("gpu_bfs.preempted", chunks=len(chunks), mode="drain")
                return None
            # From the first eviction on every wave's fresh keys need the
            # host probe, which a drain on the device cannot run.
            if self._tier is not None and not self._tier.is_empty():
                return table, self._handoff_queue(queue)
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
            # The window covers the whole drain: the checkpoint, the growth
            # ahead of it, the drain and its final wave.
            drain_window = self._wave_window("drain")
            with drain_window:
                # Every drain exit after the first is a checkpoint opportunity;
                # the ring holds the whole pending frontier here.
                if (
                    self._checkpoint_path is not None
                    and drains
                    and time.perf_counter() - last_checkpoint >= self._checkpoint_min_interval
                ):
                    with self._phase("checkpoint"):
                        self.save_checkpoint(self._checkpoint_path, self._export_pool_chunks(),
                                             drain_state())
                    last_checkpoint = time.perf_counter()
                drains += 1
                self.drains += 1
                if self._l0_count + B > _MAX_LOAD * self._capacity:
                    table = self._grow_table(
                        table, _pow2ceil(int((self._l0_count + B) / _MAX_LOAD))
                    )
                    if self._tier is not None and not self._tier.is_empty():
                        # The growth evicted: the queue was flushed above, and
                        # the ring goes back to the wave path. The window closes
                        # first, so the handoff is not this drain's (a second
                        # exit is a no-op).
                        drain_window.__exit__(None, None, None)
                        return table, self._handoff_queue(queue)
                width = self._drain_width(rungs)
                if self._live_enabled:
                    # Room in the edge log for the drain's first wave; the
                    # drain stops itself once it could not take another.
                    self._maybe_evict_elog()
                budget = min(
                    int(_MAX_LOAD * self._capacity) - self._l0_count, (1 << 31) - 1 - B
                )
                with self._span("gpu_bfs.drain", drain=drains, bucket=width) as sp:
                    table, summary, out, frontier = self._deep_drain(table, width, budget)
                    sc, stats, final_cov = self._apply_drain(summary, width, rungs)
                    self._span_counts(sp, width, sc[_GENERATED], sc[_CONSUMED],
                                      waves=max(sc[_WAVES] - 1, 0), log_n=sc[_LOG_N],
                                      ring_count=sc[_COUNT], bucket=width)
                pool_count = sc[_COUNT]
                # The final wave, which the device could not consume: its live
                # lanes are the prefix it took.
                n = sc[_FINAL_TAKE]
                chunk = {
                    k: (map_leaves(lambda x: x[:n], v) if k == "states" else v[:n])
                    for k, v in frontier.items()
                    if k != "mask"
                }
                if sc[_REASON] == _ORBIT_FALLBACK:
                    # The wave inserted nothing: the host runs it again, keying
                    # its failed lanes on the orbit minimum.
                    out = stats = final_cov = None
                with self._span("gpu_bfs.wave", drain=drains) as sp:
                    generated = self._state_count
                    table, spilled = self._consume_wave(table, chunk, queue, out=out,
                                                        stats=stats, cov=final_cov)
                    self._span_counts(sp, n, self._state_count - generated, spilled)
            rungs["live_est"] = pool_count + spilled
        self._audit_table(table)
        return None

    def _drain_width(self, rungs):
        """The next drain's rung width from the selector's state
        (``rungs``), which it updates: the rung a ``take full`` or orbit
        fallback exit keeps, else the ladder's rung for the pending live
        lanes, entered only when two drains in a row select it."""
        F_max = self._F_max
        width = F_max
        live_est, entered = rungs["live_est"], rungs["entered"]
        if rungs["keep_width"] is not None:
            width = rungs["keep_width"]
        elif live_est is not None and len(self._buckets) > 1:
            want = bucket_for(self._buckets, max(1, min(live_est, F_max)))
            if want in entered or want == F_max:
                width = want
                rungs["rung_votes"] = {}
            else:
                votes = rungs["rung_votes"].get(want, 0) + 1
                rungs["rung_votes"] = {want: votes}
                if votes >= 2:
                    width = want
                else:
                    # The narrowest rung already entered that holds the
                    # load.
                    width = min((w for w in entered if w >= want), default=F_max)
        entered.add(width)
        self.rungs[width] += 1
        return width

    def _apply_drain(self, summary, width, rungs):
        """Applies a drain's one read (``summary``) on the host: exits,
        rung and take state, counters, coverage of the consumed waves, and
        the parent log. Returns the drain's scalars, the final wave's stats
        and its coverage vector (None with coverage off)."""
        P = len(self._properties)
        sc, stats = summary[:_N_SCALARS], summary[_N_SCALARS:_N_SCALARS + 5 + 3 * P]
        reason = sc[_REASON]
        self.drain_exits[EXIT_REASONS[(reason & -reason).bit_length() - 1]] += 1
        rungs["keep_width"] = width if reason in (_TAKE_FULL, _ORBIT_FALLBACK) else None
        if reason & _TAKE_FULL:
            # The device's take was too narrow for this wave: widen it
            # for the rung's next capture, with room for growth.
            self._take_widths[width] = min(width * self._A, _pow2ceil(2 * stats[1]))
        self.max_fresh[width] = max(self.max_fresh.get(width, 0), sc[_MAX_FRESH])
        log_n = sc[_LOG_N]
        self._state_count += sc[_GENERATED]
        self._unique_count += sc[_CONSUMED]
        # Drains run while no run exists: every fresh key is resident.
        self._l0_count += sc[_CONSUMED]
        if self._tier is not None:
            self._tier.instruments.set_l0(self._l0_count)
        self._max_depth = max(self._max_depth, sc[_MAX_DEPTH])
        # The final wave is counted by _consume_wave.
        self.waves += sc[_WAVES] - 1
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
            log = _u64(self._drain["log"][:, :log_n].contiguous())
            self._wave_log.append((log[0], log[1]))
            if self._sym is not None:
                self._key_log.append(log[2])
        return sc, stats, final_cov

    def _export_pool_chunks(self):
        """The ring's live rows in FIFO order, head first, as chunks of
        ``F_max`` lanes (a checkpoint's or the handoff's queue). The
        drain's graphs are done: the host has read the scalars."""
        d = self._drain
        sc = d["scalars"]
        n = int(sc[_COUNT])
        rows = ring_export(d["pool"], sc[_HEAD], sc[_COUNT], d["capacity"])
        del rows["mask"]
        bounds = [(s, min(s + self._F_max, n)) for s in range(0, n, self._F_max)]
        return [
            {k: (map_leaves(lambda x: x[s:e], v) if k == "states" else v[s:e])
             for k, v in rows.items()}
            for s, e in bounds
        ]

    def _handoff_queue(self, queue):
        """The wave path's queue at the first eviction: the ring's rows,
        then the host queue's (exact FIFO order). The drain's ring, log and
        graphs (which hold the evicted table's address) are dropped."""
        newq = deque(self._export_pool_chunks())
        newq.extend(queue)
        self._tracer.instant("gpu_bfs.storage.wave_mode", ring_chunks=len(newq) - len(queue),
                             spilled_chunks=len(queue))
        self._drain = None
        self._graphs = {}
        self.handoff_wave = self.waves
        return newq

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
        With device liveness the wave appends its rows to the edge log, and
        one after which the log could not take another wave of the rung
        stops the drain ("edge log full"). Returns ``(table, out,
        frontier)``."""
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
        if self._live_enabled:
            # The edge log must take another worst-case wave of this rung
            # (B edge rows + F terminal rows), or the host evicts it first.
            full = self._elog["count"] + (B + F) > self._elog_capacity
            reason = reason | (full.to(torch.int64) << _EDGE_LOG_FULL_BIT)
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
            with self._phase(self._device_phase):
                while True:
                    table, out, frontier = self._drain_step(table, width, 0)
                    if not int(sc[_GO]):
                        break
            slots = [(out, frontier)]
        parts = [sc, d["final_stats"]]
        if self._cov is not None:
            parts += [d["cov_acc"], d["final_cov"]]
        if self._live_enabled:
            # The edge log's fill count, the final wave's rows included.
            parts.append(self._elog["count"].view(1))
        summary = torch.cat(parts).tolist()  # the drain's one read
        if self._live_enabled:
            self._elog_count = summary[-1]
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
            with self._span("gpu_bfs.compile", kind="drain", bucket=width,
                            table_capacity=self._capacity):
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

        with self._phase(self._device_phase):
            launch(0)
            launch(1)
            q = 2
            while True:
                events[q % 2].synchronize()
                if not int(flag[q % 2]):
                    break
                launch(q)
                q += 1
            if self._attr is not None:
                # The graph queued behind the last one read may still run.
                self._attr.fence(d["scalars"])
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
        graphs, slots = [], []
        for g in range(2):
            # One attribution compile window a graph captured (as
            # graph_captures counts them); the warm-up wave rides the first.
            with self._phase("compile"):
                if g == 0:
                    sc[_GO] = 0
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        self._drain_step(table, width, 0)
                    torch.cuda.current_stream().wait_stream(side)
                    self.warmup_waves += 1
                    sc[_GO] = 1
                    # A capture records the kernels and launches none: its
                    # counts are undone below and added at every replay.
                    counts = [getattr(mod, name) for mod, name in _LAUNCH_COUNTERS]
                graph = torch.cuda.CUDAGraph()
                with _collector_paused(), torch.cuda.graph(
                        graph, capture_error_mode="thread_local"):
                    for j in range(_GRAPH_WAVES):
                        _table, out, frontier = self._drain_step(
                            table, width, g * _GRAPH_WAVES + j
                        )
                        slots.append((out, frontier))
                graphs.append(graph)
                if self._attr is not None:
                    self._attr.fence(sc)
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

    # -- checkpoint, preempt and resume ----------------------------------------

    def save_checkpoint(self, path, queue, drain=None) -> None:
        """Writes ``checkpoint_payload(queue, drain)`` to ``path``
        atomically. The visited set is not stored apart: it is the parent
        map's keys (the key log under symmetry) and the host tiers' runs."""
        t0 = time.perf_counter()
        size = atomic_pickle(path, self.checkpoint_payload(queue, drain))
        self.checkpoints_written += 1
        self.checkpoint_s += time.perf_counter() - t0
        self.checkpoint_bytes += size

    def checkpoint_payload(self, queue, drain=None) -> dict:
        """The checkpoint as an in-memory payload (format v2): counters,
        discoveries, the parent map, the capacity, the pending chunks
        (``queue``, live lanes only) as numpy, the claimed keys under
        symmetry, the tiers' runs once the table has evicted, and, from a
        drain, the rung selector's state (``drain``). With device liveness
        the edge log is evicted first and the payload, format v3, carries
        the edge store (``"liveness"``). Pass it to a new checker's
        ``resume_from=``."""
        self._ingest_wave_log()
        children, parents = self._store.export()
        payload = {
            **checkpoint_header(self._model, self._A, self._sym is not None, self._sym_scheme),
            "state_count": self._state_count,
            "unique_count": self._unique_count,
            "max_depth": self._max_depth,
            "discoveries": dict(self._discoveries_fp),
            "children": children,
            "parents": parents,
            "capacity": self._capacity,
            "chunks": [_chunk_to_host(c) for c in queue],
        }
        if self._sym is not None:
            payload["keys"] = (np.concatenate(self._key_log) if self._key_log
                               else np.zeros((0,), np.uint64))
        if self._tier is not None and not self._tier.is_empty():
            payload["storage"] = self._tier.export_state()
        if drain is not None:
            payload["drain"] = drain
        if self._live_enabled:
            # The condition-false relation so far (the device log flushed
            # first) and the roots and terminals: the resumed run's verdict
            # does not depend on where the run was cut.
            self._evict_elog()
            payload["liveness"] = self._live_store.export_state()
            payload["version"] = 3
        return payload

    def _restore(self, source):
        """Restores a checkpoint (a path, or a payload dict from
        ``preempt_payload()``); returns ``(table, queue)``. The table is
        rebuilt from the keys no host run holds, through the insert kernel,
        in batches of the payload's order, each sorted: one batch with no
        budget, else at most a freshly evicted table's load. A batch that
        would take the table past ``_MAX_LOAD`` grows it first (under a
        budget: evicts it), and one that leaves a key without a slot grows
        it and runs again. A chunk wider than this checker's
        ``frontier_capacity`` is split."""
        if isinstance(source, dict):
            payload = source
        else:
            with open(source, "rb") as f:
                payload = pickle.load(f)
        validate_checkpoint_header(payload, self._model, self._A, self._sym is not None,
                                   self._sym_scheme)
        self._state_count = payload["state_count"]
        self._unique_count = payload["unique_count"]
        self._max_depth = payload["max_depth"]
        self._discoveries_fp = dict(payload["discoveries"])
        self._wave_log.append((payload["children"], payload["parents"]))
        keys = payload["children"]
        if self._sym is not None:
            keys = payload["keys"]
            self._key_log.append(keys)
        storage = payload.get("storage")
        if storage:
            if self._tier is None:
                # Resumed without a budget: the runs stay probed, the table
                # grows without a cap from here on.
                self._tier = TieredVisitedStore(instruments=StorageInstruments("gpu_bfs"),
                                                tracer=self._tracer)
            self._tier.load_state(storage)
        # Device-liveness state must round-trip with the run: resuming a
        # liveness="device" run without the knob (or the reverse) would end
        # with a silently truncated edge relation, an unsound verdict.
        live_state = payload.get("liveness")
        if self._live_enabled and live_state is None:
            raise ValueError(
                "liveness='device' cannot resume a checkpoint written "
                "without it: the edges explored before the checkpoint "
                "were never logged, so the final verdict would be "
                "unsound"
            )
        if live_state is not None:
            if not self._live_enabled:
                raise ValueError(
                    "checkpoint carries a liveness edge store; resume "
                    "with liveness='device' (dropping it would discard "
                    "the soundness the original run paid for)"
                )
            self._live_store.load_state(live_state)
        if self._tier is not None and not self._tier.is_empty():
            keys = keys[~self._tier.probe(keys)]
        self._capacity = max(self._capacity, payload["capacity"])
        if self._max_capacity is not None:
            self._capacity = min(self._capacity, self._max_capacity)
        table = hashset_new(self._capacity, self._device)
        self._l0_count = 0
        # A batch must fit a freshly evicted table under the load cap, or
        # the retry below could overflow again.
        batch = max(1, len(keys)) if self._max_capacity is None \
            else int(self._max_capacity * _MAX_LOAD)
        for start in range(0, len(keys), batch):
            khi, klo = sorted_key_halves(keys[start : start + batch], self._device)
            n = khi.shape[0]
            if self._l0_count + n > _MAX_LOAD * self._capacity:
                # As ahead of a wave: the table stays under the load cap.
                table = self._grow_table(
                    table, _pow2ceil(int((self._l0_count + n) / _MAX_LOAD)))
            active = torch.ones(n, dtype=torch.bool, device=self._device)
            table, fresh, _found, pending = hashset_insert_sorted(table, khi, klo, active)
            self.restore_inserts += 1
            self._l0_count += int(fresh.sum())
            if int(pending.sum()):
                table = self._grow_table(table, self._capacity * 2)
                table, fresh, _found, pending = hashset_insert_sorted(table, khi, klo, active)
                self.restore_inserts += 1
                self._l0_count += int(fresh.sum())
                if int(pending.sum()):
                    raise RuntimeError("checkpoint restore overflowed the table")
        if self._tier is not None:
            self._tier.instruments.set_l0(self._l0_count)
        drain = payload.get("drain")
        # The rung selector's state holds widths of the writer's ladder.
        if drain is not None and drain.get("frontier_capacity") == self._F_max:
            self._resume_drain = drain
        queue = deque()
        for chunk in payload["chunks"]:
            chunk = _tree_to_device(chunk, self._device)
            n = chunk["hi"].shape[0]
            if n <= self._F_max:
                queue.append(chunk)
                continue
            for s in range(0, n, self._F_max):
                queue.append({k: (map_leaves(lambda x: x[s : s + self._F_max], v)
                                  if k == "states" else v[s : s + self._F_max])
                              for k, v in chunk.items()})
        return table, queue

    def request_preempt(self) -> None:
        """Asks the worker to stop at the next wave or drain boundary: the
        run's state (counters, parent map, pending frontier, tiers) goes
        into an in-memory payload (``preempt_payload()``) and the worker
        exits. A new checker of the same configuration with
        ``resume_from=<payload>`` finishes the run bit-identically. A run
        that ends before a boundary finishes normally and
        ``preempt_payload()`` stays None."""
        self._preempt_event.set()

    # -- device liveness (liveness="device") ----------------------------------

    def _maybe_evict_elog(self) -> None:
        """Evicts the device edge log to the host store when one more
        worst-case wave (F_max·A edge rows + F_max terminal rows) could
        overflow it."""
        self._live_ins.occupancy.set(self._elog_count / self._elog_capacity)
        if self._elog_count + self._F_max * (self._A + 1) > self._elog_capacity:
            self._evict_elog()

    def _evict_elog(self) -> None:
        """Drains the filled prefix of the device edge log into the host
        ``LivenessEdgeStore`` (one copy of the six columns) and resets the
        fill count on the device."""
        n = self._elog_count
        if self._elog is None or n == 0:
            return
        if n > self._elog_capacity:
            raise RuntimeError(
                "liveness edge store overflowed despite headroom checks "
                f"({n} > {self._elog_capacity}); this is a bug"
            )
        with self._tracer.span("gpu_bfs.liveness.evict", rows=n):
            cols = torch.stack([self._elog[c][:n] for c in EDGE_COLS]).cpu().numpy()
            self._live_store.absorb(**dict(zip(EDGE_COLS, cols)))
            self._elog["count"].zero_()
            self._elog_count = 0
        self._live_ins.occupancy.set(0.0)

    def _flush_live_edges(self) -> None:
        """The analysis's pre-hook: the log is on the device, so it drains
        before any host read."""
        self._evict_elog()

    @property
    def storage_fps(self) -> int:
        """Keys held in the host tiers' runs (0 with no budget)."""
        return 0 if self._tier is None else self._tier.total_fps

    def state_digest(self) -> dict:
        """A cheap summary of where the run stands: counts, the table, the
        checkpoint path, whether it was preempted, the liveness mode (and
        the edge store's statistics with device liveness), and the tiers'
        storage statistics once they exist."""
        digest = {
            "backend": type(self).__name__,
            "done": self.is_done(),
            "state_count": self.state_count(),
            "unique_state_count": self.unique_state_count(),
            "max_depth": self.max_depth(),
            "discoveries": sorted(set(self._discoveries_fp) | set(self._live_paths)),
            "table_capacity": self._capacity,
            "frontier_capacity": self._F_max,
            "wave_kernel": self._wave_kernel,
            "checkpoint_path": self._checkpoint_path,
            "preempted": self.preempted,
            "liveness_mode": self.liveness_mode,
        }
        if self._live_store is not None:
            digest["liveness_edge_store"] = self._live_store.stats()
        if self._tier is not None:
            digest["storage"] = self._tier.instruments.bench_stats()
        return digest

    # -- Checker surface -----------------------------------------------------

    supports_device_liveness = True

    def discoveries(self) -> Dict[str, Path]:
        out = {
            name: self._reconstruct(fp)
            for name, fp in list(self._discoveries_fp.items())
        }
        out = self._with_device_liveness(out)
        return self._with_lassos(
            out, self._done_event.is_set(),
            set(self._discoveries_fp) | set(self._live_paths),
        )

    def table_capacity(self) -> int:
        return self._capacity
