"""Per-stage cost of one wave of the GPU checker, and the bytes each stage
must move.

The port's counterpart of the JAX package's ``checker/breakdown.py``. A
wave of ``checker/gpu.py`` runs as one chain of launches with no host sync,
so a run cannot say where a wave's time goes. ``measure_wave_breakdown``
drives a few real waves to a representative frontier, picks the bucket of
the ladder the checker would dispatch it at, and times each stage of that
wave: on the card with CUDA events recorded between the stages of one wave
(the stage functions' ``mark`` hooks), on the CPU with ``perf_counter``
over the plain twins. The wave runs eagerly, so a stage's time on the card
holds the host's launch gaps between its marks as well as its device work
(``chip_smoke.py``'s in-graph profile gives each stage's device time
alone). It also times the whole wave at the bucket, at ``F_max`` and at
every rung, and prices it against the card's memory rate.

The bytes. XLA's cost analysis has no counterpart here, so the roofline's
bytes are the must-move counts of the stages (``*_must_move`` below): each
input a stage needs read once, each output written once, counted from this
wave's shapes and data. ``chip_smoke.py`` takes its kernels' bounds from
the same functions, so a stage's bound in ``PERF.md`` and this module's
roofline are one count of the same work, whatever implements the stage.
u32 values count 4 B, though the port carries them in int64.

``measure_pipeline_choice`` times one calibration wave of the staged
engine with the fingerprint-only expansion on and off.

Symmetry-reduced runs and coverage are not measured (the key function and
the coverage epilogue would need stages of their own).
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict

import numpy as np
import torch

from ..core.batch import leaves, map_leaves, supports_expand_fps
from ..ops import fused_wave as fw
from ..ops.hashset import MAX_PROBES, hashset_new, u32_to_i32
from ..ops.hashset_kernel import (
    TILE_ROWS,
    hashset_insert_sorted,
    round_table_capacity,
)
from .gpu import (
    _AUTO_BUCKET_MIN_F,
    _DEFAULT_BUCKET_STEPS,
    bucket_for,
    bucket_ladder_widths,
    resolve_device,
    wave_spec,
)

__all__ = [
    "DEVICE_PEAKS",
    "compact_must_move",
    "comphash_must_move",
    "coverage_must_move",
    "dedup_must_move",
    "frontier_must_move",
    "fused_wave_must_move",
    "gather_must_move",
    "insert_must_move",
    "keys_must_move",
    "measure_pipeline_choice",
    "measure_wave_breakdown",
    "pairs_keys_must_move",
    "probed_rows",
    "sort_must_move",
    "stats_must_move",
    "sweep_must_move",
]

# Device memory rates for the roofline, keyed on torch.cuda.get_device_name()
# (NVIDIA's data sheets). The wave is integer work bound by memory, so the
# memory rate is the roofline's axis.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0},
    "NVIDIA H100 PCIe": {"hbm_gbps": 2000.0},
}

_DEPTH_INF = (1 << 31) - 1


# -- the bytes each stage must move ------------------------------------------------


def probed_rows(after, k) -> int:
    """The distinct table rows that the probes of the sorted, distinct u64
    keys ``k`` read in the table ``after`` the insert (a ``(rows, 2)`` u32
    numpy array): a probe reads from its home to the row where it stops
    (its match, its claim, or the window's last row when it is pending)."""
    cap = after.shape[0] - MAX_PROBES
    home = (k >> np.uint64(64 - (cap.bit_length() - 1))).astype(np.int64)
    rows = (after[:, 0].astype(np.uint64) << np.uint64(32)) | after[:, 1].astype(np.uint64)
    stop = np.empty_like(home)
    for s in range(0, k.shape[0], 1 << 14):
        hit = (rows[home[s : s + (1 << 14), None] + np.arange(MAX_PROBES)]
               == k[s : s + (1 << 14), None])
        stop[s : s + (1 << 14)] = np.where(hit.any(1), hit.argmax(1), MAX_PROBES - 1)
    end = home + stop
    # Rows of [home, end] not already read by an earlier key (homes are
    # monotone, so the earlier probes end at most at the running maximum).
    reach = np.concatenate([[-1], np.maximum.accumulate(end)[:-1]])
    return int(np.clip(end - np.maximum(home, reach + 1) + 1, 0, None).sum())


def insert_must_move(after, hi, lo, active, fresh) -> int:
    """Bytes the insert must move on this input (numpy arrays): the distinct
    table rows that the keys' probes read (a later copy of a key is settled
    by the first, its neighbour in the sorted batch), the claimed rows
    written, the keys (hi, lo, active) read and the three flags written."""
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    k = keys[active]
    k = k[np.concatenate([[True], k[1:] != k[:-1]])]
    B = hi.shape[0]
    return probed_rows(after, k) * 8 + int(fresh.sum()) * 8 + B * 9 + B * 3


def keys_must_move(B, W, F, masked, n_valid) -> int:
    """Bytes the fold route's keys stage must move on this wave: the W words
    of each of the ``n_valid`` valid lanes (an invalid lane's key does not
    depend on its row), every lane's valid byte, the frontier's depth and
    mask bytes, and each lane's key (8 B) and idx (4 B) written. Reading
    int64 leaves in place moves each word's 8 B: about twice the words'
    share."""
    return n_valid * W * 4 + B * (1 + 12) + F * (4 + (1 if masked else 0))


def pairs_keys_must_move(B, F, masked) -> int:
    """Bytes the ``"pairs"`` route's keys stage must move: each lane's
    (hi, lo) pair and valid byte read, the frontier's depth and mask bytes,
    and each lane's key (8 B) and idx (4 B) written."""
    return B * (8 + 1 + 12) + F * (4 + (1 if masked else 0))


def frontier_must_move(spec, F, masked) -> int:
    """Bytes ``fw_frontier`` must move: each frontier lane's depth and
    ebits read and ``ebits_after`` written, its mask byte and condition
    bytes, its A valid bytes only when an eventually property needs the
    terminal test, and the (4 + P) int64 counters written."""
    P = len(spec.conditions)
    ev = spec.action_count if "eventually" in spec.expectations else 0
    return F * (12 + (1 if masked else 0) + P + ev) + (4 + P) * 8


def comphash_must_move(spec, cand, valid, F) -> int:
    """Bytes ``fw_comphash_keys`` must move on this wave: every lane's
    valid bit and its frontier lane's depth and mask; for each valid lane
    its actor rows and timer words and its history row; its network: on an
    unordered one every envelope count and the src, dst and message words
    of its active envelopes, on an ordered one every flow's length and the
    words of the messages it holds; the key (8 B) and lane index (4 B) of
    every lane. ``cand`` holds the candidate leaves, ``valid`` their keyed
    lanes."""
    lay = spec.comphash["layout"]
    B = valid.shape[0]
    N, R, E, P, W, H = (lay[k] for k in ("N", "R", "E", "P", "W", "H"))
    n_valid = int(valid.sum())
    if lay["ordered"]:
        msgs = int((cand["flow_len"] * valid[:, None]).sum())
        words = n_valid * (N * (R + 1) + H + P) + msgs * W
    else:
        active_envs = int(((cand["net_cnt"] != 0) & valid[:, None]).sum())
        words = n_valid * (N * (R + 1) + H + E) + active_envs * (2 + W)
    return B * 1 + F * (4 + 1) + words * 4 + B * 12


def sort_must_move(B) -> int:
    """Bytes the sort must move: each lane's key (8 B) and idx (4 B) read
    once and written once, whatever its passes move."""
    return B * 24


def dedup_must_move(B, n_tiles) -> int:
    """Bytes ``fw_dedup`` must move: each sorted position's key (8 B) read
    and its active byte written, and the ``n_tiles + 1`` int64 starts
    written (a first ``~0`` position's lane and valid byte are a few bytes
    more, left out)."""
    return B * 9 + (n_tiles + 1) * 8


def sweep_must_move(B, n_tiles, probed, n_new) -> int:
    """Bytes the tile sweep must move: the sorted keys (8 B), active bytes
    and tile starts read, the distinct table rows its probes read
    (``probed``), and the outcome bytes and claimed rows written."""
    return B * 8 + B + (n_tiles + 1) * 8 + probed * 8 + B + n_new * 8


def compact_must_move(B, n_new) -> int:
    """Bytes ``fw_compact`` must move on this wave: the B outcome bytes; at
    each fresh position its key (8 B) and lane (4 B) and the parent's
    ebits, depth, hi and lo read (16 B), and the seven per-slot outputs
    written (28 B)."""
    return B + 56 * n_new


def stats_must_move(P) -> int:
    """Bytes of the stats vector ``fw_compact`` writes: the counters read,
    each hit's (hi, lo) read, the ``(5 + 3P,)`` vector written."""
    return (4 + P) * 8 + 2 * P * 8 + (5 + 3 * P) * 8


def gather_must_move(n_new, row_bytes) -> int:
    """Bytes the leaf gather must move: each fresh slot's lane (8 B), its
    candidate row read and its new row written."""
    return n_new * (8 + 2 * row_bytes)


def coverage_must_move(spec, F, n_eval, n_valid, n_new, masked) -> int:
    """Bytes the coverage epilogue must move on this wave, each input at
    the width it is stored in: each frontier lane's int64 depth and, when
    masked, its mask byte; for each of the ``n_eval`` evaluated lanes its
    A valid bytes, its int64 ``ebits_after`` when a property is
    ``eventually``, and a byte for each ``sometimes`` condition and each
    ``always`` antecedent; the sweep's outcome byte at each of the
    ``n_valid`` sorted positions that hold a key (the sort sinks the
    others to the end); the u32 sorted lane of each of the ``n_new``
    fresh positions; and the int64 vector written."""
    A, kinds = spec.action_count, spec.expectations
    ants = spec.cov_antecedents or (None,) * len(kinds)
    per_eval = (A + (8 if "eventually" in kinds else 0) + kinds.count("sometimes")
                + sum(k == "always" and a is not None for k, a in zip(kinds, ants)))
    return (F * (8 + (1 if masked else 0)) + n_eval * per_eval + n_valid + 4 * n_new
            + 8 * spec.cov_layout.size)


def fused_wave_must_move(n_words, B, F, P, probed, n_new, row_bytes) -> int:
    """Bytes a whole fused wave must move with the fold's words matrix:
    the ``n_words`` u32 words, the valid bits, the four u32 frontier arrays
    and the conditions read; the distinct table rows its probes read
    (``probed``); the claimed rows, the fresh candidates' rows (read and
    written, ``row_bytes`` each), the six u32 per-lane outputs and the
    int64 stats written."""
    return (n_words * 4 + B + 4 * F * 4 + P * F + probed * 8
            + n_new * 8 + 2 * n_new * row_bytes + 6 * n_new * 4 + (5 + 3 * P) * 8)


# -- timing ------------------------------------------------------------------------


def _time_marked(run, iters, cuda, reset=None):
    """Median ms of ``run(mark)`` over ``iters`` runs after one warm-up run,
    and the median ms of each stage, from one ``mark(name)`` to the next
    (``mark(None)`` ends a stage; a name marked twice in a run sums). On
    the card the marks record CUDA events (device time); on the CPU they
    read ``perf_counter``. ``reset`` runs before each run, outside the
    interval."""
    totals, stages = [], {}
    for i in range(iters + 1):
        if reset is not None:
            reset()
        points = []
        if cuda:
            torch.cuda.synchronize()

            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                points.append((name, e))
        else:
            def mark(name):
                points.append((name, time.perf_counter()))

        mark("start")
        run(mark)
        mark(None)
        if cuda:
            points[-1][1].synchronize()
            times = [0.0] + [points[0][1].elapsed_time(e) for _n, e in points[1:]]
        else:
            times = [(t - points[0][1]) * 1e3 for _n, t in points]
        if i == 0:
            continue
        totals.append(times[-1])
        run_stages = {}
        for (name, _p), a, b in zip(points[1:-1], times[1:-1], times[2:]):
            if name is not None:
                run_stages[name] = run_stages.get(name, 0.0) + (b - a)
        for name, ms in run_stages.items():
            stages.setdefault(name, []).append(ms)
    return statistics.median(totals), {k: statistics.median(v) for k, v in stages.items()}


# -- the representative wave ------------------------------------------------------


def _seed(model, spec, F, table_capacity, device):
    """The model's initial states as a masked F-lane frontier (the first F
    of them), claimed in a fresh table."""
    init = model.packed_init_states(device)
    n0 = min(leaves(init)[0].shape[0], F)

    def pad(x):
        out = torch.zeros((F,) + tuple(x.shape[1:]), dtype=x.dtype, device=device)
        out[:n0] = x[:n0]
        return out

    states = map_leaves(pad, init)
    mask = torch.arange(F, device=device) < n0
    mask &= model.packed_within_boundary(states)
    hi, lo = spec.fingerprint(states)
    shi, slo, _sidx, unique = fw.sorted_dedup(hi, lo, mask)
    table, _f, _found, _p = hashset_insert_sorted(
        hashset_new(table_capacity, device), u32_to_i32(shi), u32_to_i32(slo), unique)
    ebits = torch.full((F,), sum(1 << b for _pi, b in spec.ebit), dtype=torch.int64,
                       device=device)
    depth = torch.ones(F, dtype=torch.int64, device=device)
    return table, {"states": states, "hi": hi, "lo": lo, "ebits": ebits, "depth": depth,
                   "mask": mask}


def _next_frontier(spec, frontier, out, F):
    """A wave's first F fresh rows as the next masked frontier."""
    n = min(int(out["stats"][1]), F)
    new = out["new"]
    if "states" in new:
        states = map_leaves(lambda x: x[:F], new["states"])
    else:
        states = fw.take_children(spec, frontier["states"], new["src"][:F])
    cut = {k: new[k][:F] for k in ("hi", "lo", "ebits", "depth")}
    return {"states": states, **cut, "mask": torch.arange(F, device=new["hi"].device) < n}


def _wave_fn(spec, wave_kernel, use_fps):
    if wave_kernel == "fused":
        return fw.fused_wave
    return fw.torch_wave_fps if use_fps else fw.torch_wave


def _advance(model, spec, F, table_capacity, warmup_waves, wave, device):
    """Seeds and drives ``warmup_waves`` real waves; returns the table and
    the last non-empty frontier."""
    table, frontier = _seed(model, spec, F, table_capacity, device)
    for _ in range(warmup_waves):
        table, out = wave(spec, table, frontier["states"], frontier["hi"], frontier["lo"],
                          frontier["ebits"], frontier["depth"], _DEPTH_INF,
                          mask=frontier["mask"])
        if not int(out["stats"][1]):
            break  # the space is exhausted: measure on the last non-empty wave
        frontier = _next_frontier(spec, frontier, out, F)
    return table, frontier


def _prefix(frontier, w):
    return {k: (map_leaves(lambda x: x[:w], v) if k == "states" else v[:w])
            for k, v in frontier.items()}


def _compact_dispatch(states, mask):
    """The live lanes of a masked frontier moved to a dense prefix (a stable
    cumsum scatter), the compaction a bucketed dispatch needs: what the
    deep drain's ring take hands a rung."""
    f_in = mask.shape[0]
    dest = torch.where(mask, torch.cumsum(mask, 0) - 1, f_in)

    def scatter(x):
        out = torch.zeros((f_in + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out[dest] = x
        return out[:f_in]

    return map_leaves(scatter, states)


def _plain_chain(spec, table, hi, lo, ebits, depth, depth_cap, cond, cvalid, kin, cand_flat,
                 mark, mask):
    """``kernel_chain``'s stages on CPU tensors, each its plain twin, with
    the same ``mark`` names."""
    A, P = spec.action_count, len(spec.conditions)
    cap = table.shape[0] - MAX_PROBES
    acc = torch.zeros(4 + P, dtype=torch.int64)
    mark("frontier")
    ebits_after = fw.frontier_plain(spec, cond, cvalid, ebits, depth, depth_cap, acc, mask)
    mark("keys")
    chi, clo = kin if spec.keys_route == "pairs" else spec.fingerprint(cand_flat)
    key, idx = fw.keys_plain(chi, clo, cvalid, depth, depth_cap, A, mask)
    acc[0] = (key != -1).sum()
    mark("sort")
    fw.sort_plain(key, idx)
    mark("dedup")
    active, _starts = fw.dedup_plain(key, idx, cap, cvalid, A, depth, depth_cap, mask)
    mark("sweep")
    khi, klo = (key >> 32) & 0xFFFFFFFF, key & 0xFFFFFFFF
    table, fresh, _found, pending = hashset_insert_sorted(
        table, u32_to_i32(khi), u32_to_i32(klo), active)
    acc[2] = pending.sum()
    mark("compact")
    c, n_new = fw.compact_plain(fresh, key, idx, A, ebits_after, depth, hi, lo)
    acc[1] = n_new
    fw.stats_from_acc(acc, P, hi, lo)
    mark("gather")
    fw.gather_plain(c["src"], acc, cand_flat)
    mark(None)


def _wave_bytes(spec, table_after, frontier, cand_flat, cvalid, out):
    """The must-move bytes of each stage of this wave, by stage name of
    the chain, from its shapes and data (``table_after``: the table after
    the wave)."""
    F, A, P = frontier["hi"].shape[0], spec.action_count, len(spec.conditions)
    B = F * A
    cap = table_after.shape[0] - MAX_PROBES
    n_tiles = cap // TILE_ROWS
    parent = torch.arange(B, device=cvalid.device) // A
    keyed = cvalid & frontier["mask"][parent] & (frontier["depth"][parent] < _DEPTH_INF)
    hi, lo = spec.fingerprint(cand_flat)
    keys = ((hi << 32) | lo)[keyed].cpu().numpy().view(np.uint64)
    after = table_after.cpu().numpy().view(np.uint32)
    n_new = int(out["stats"][1])
    row_bytes = sum(x[0].numel() * x.element_size() for x in leaves(cand_flat))
    if spec.keys_route == "fold":
        W = sum(math.prod(x.shape[1:]) for x in fw.keys_input(spec, cand_flat))
        keys_bytes = keys_must_move(B, W, F, True, int(keyed.sum()))
    elif spec.keys_route == "comphash":
        keys_bytes = comphash_must_move(spec, cand_flat, keyed, F)
    else:
        keys_bytes = pairs_keys_must_move(B, F, True)
    return {
        "frontier": frontier_must_move(spec, F, True),
        "keys": keys_bytes,
        "sort": sort_must_move(B),
        "dedup": dedup_must_move(B, n_tiles),
        "sweep": sweep_must_move(B, n_tiles, probed_rows(after, np.unique(keys)), n_new),
        "compact": compact_must_move(B, n_new) + stats_must_move(P),
        "gather": gather_must_move(n_new, row_bytes),
    }


def measure_wave_breakdown(
    model,
    frontier_capacity: int = 1 << 11,
    table_capacity: int = 1 << 20,
    warmup_waves: int = 6,
    iters: int = 20,
    wave_kernel: str = "fused",
    bucket_ladder: int | None = None,
    device=None,
) -> Dict:
    """Per-stage times of a representative wave and its roofline.

    Seeds ``model`` in a table of ``table_capacity`` rows (rounded up to
    whole tiles on the fused engine, as the checker rounds it) and drives
    ``warmup_waves`` real waves of ``frontier_capacity`` lanes, so the
    measured frontier holds real states at a real fill; picks the ladder's
    bucket for its live lanes as the checker does (``bucket_ladder_widths``,
    ``bucket_for``; ``bucket_ladder`` None: the checker's default), and
    times each stage of a wave at that bucket, ``iters`` runs after one
    warm-up. ``wave_kernel="fused"``: the model stage (``expand``: the
    expansion, the boundary and ``keys_input``; ``properties``) and the
    stages of ``ops/fused_wave.py::kernel_chain`` (``frontier``, ``keys``,
    ``sort``, ``dedup``, ``sweep``, ``compact``, ``gather``); on the CPU
    their plain twins. ``"staged"``: the torch stages of ``torch_wave``
    (``expand``, ``properties``, ``fingerprint``, ``frontier``,
    ``sort_dedup``, ``insert``, ``stats``, ``compact``, ``gather``), or
    with the fingerprint-only expansion, which the checker picks for a
    model that has it, those of ``torch_wave_fps`` and ``materialize``
    (the children's take). Runs on the card unless ``device="cpu"``.

    Returns the JAX package's keys where they have a meaning here:
    ``stages_ms``; ``fused_wave_ms`` (the whole wave at the bucket),
    ``fused_wave_fixed_ms`` (at ``F_max``) and ``bucket_fused_ms`` (each
    rung); ``compact_ms`` (the live lanes to a dense prefix);
    ``candidates_per_wave``; ``live_lanes``; ``device_kind``;
    ``fused_wave_hbm_bytes`` (the stages' must-move bytes, ``stage_bytes``)
    and ``hbm_bytes_per_candidate``; and on a card of ``DEVICE_PEAKS``
    ``hbm_peak_gbps`` and ``hbm_roofline_attainment`` (the bytes over the
    card's memory rate, over ``fused_wave_ms``; None elsewhere). The JAX
    keys that read XLA's compiled cost analysis (``flops_per_candidate``,
    ``bytes_per_candidate``, ``stage_cost``) have no counterpart and are
    left out."""
    if wave_kernel not in ("staged", "fused"):
        raise ValueError(f"wave_kernel must be 'staged' or 'fused': {wave_kernel!r}")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if wave_kernel == "fused":
        table_capacity = round_table_capacity(table_capacity)
    F = 1 << max(0, (frontier_capacity - 1).bit_length())
    if bucket_ladder is None:
        bucket_ladder = _DEFAULT_BUCKET_STEPS if F >= _AUTO_BUCKET_MIN_F else 0
    ladder = bucket_ladder_widths(F, bucket_ladder)
    use_fps = wave_kernel == "staged" and supports_expand_fps(model)
    spec = wave_spec(model, device, use_fps=use_fps)
    A = spec.action_count
    wave = _wave_fn(spec, wave_kernel, use_fps)
    table0, frontier = _advance(model, spec, F, table_capacity, warmup_waves, wave, device)
    live = int(frontier["mask"].sum())
    bucket = bucket_for(ladder, max(1, live))
    # The waves leave their fresh rows as a dense prefix: the bucket is the
    # frontier's first rows, as after the dispatch's compaction.
    wf = _prefix(frontier, bucket)
    B = bucket * A
    work = table0.clone()

    def reset():
        work.copy_(table0)

    def run_wave(fr):
        return lambda mark: wave(spec, work, fr["states"], fr["hi"], fr["lo"], fr["ebits"],
                                 fr["depth"], _DEPTH_INF, mask=fr["mask"])

    # The stages of the wave at the bucket.
    if wave_kernel == "fused":
        def run_stages(mark):
            cond, cvalid, cand = fw.model_stage(spec, wf["states"], bucket, mark)
            mark("expand")
            kin = fw.keys_input(spec, cand)
            chain = fw.kernel_chain if cuda else _plain_chain
            chain(spec, work, wf["hi"], wf["lo"], wf["ebits"], wf["depth"], _DEPTH_INF,
                  cond, cvalid, kin, cand, mark=mark, mask=wf["mask"])
    else:
        def run_stages(mark):
            _t, out = wave(spec, work, wf["states"], wf["hi"], wf["lo"], wf["ebits"],
                           wf["depth"], _DEPTH_INF, mask=wf["mask"], mark=mark)
            if use_fps:
                mark("materialize")
                n = int(out["stats"][1])
                fw.take_children(spec, wf["states"], out["new"]["src"][:n])

    _total, stages_ms = _time_marked(run_stages, iters, cuda, reset)
    wave_ms, _ = _time_marked(run_wave(wf), iters, cuda, reset)
    fixed_ms, _ = _time_marked(run_wave(frontier), iters, cuda, reset)
    bucket_ms = {}
    for w in ladder:
        if w == bucket:
            bucket_ms[str(w)] = wave_ms
        elif w == F:
            bucket_ms[str(w)] = fixed_ms
        else:
            bucket_ms[str(w)] = _time_marked(run_wave(_prefix(frontier, w)), iters, cuda,
                                             reset)[0]
    compact_ms, _ = _time_marked(lambda mark: _compact_dispatch(frontier["states"],
                                                                frontier["mask"]), iters, cuda)

    # The must-move bytes of this wave's stages, from one more run of it.
    reset()
    _cond, cvalid, cand = fw.model_stage(spec, wf["states"], bucket)
    _t, out = wave(spec, work, wf["states"], wf["hi"], wf["lo"], wf["ebits"], wf["depth"],
                   _DEPTH_INF, mask=wf["mask"])
    stage_bytes = _wave_bytes(spec, work, wf, cand, cvalid, out)
    moved = sum(stage_bytes.values())
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = DEVICE_PEAKS.get(kind) if cuda else None
    return {
        "frontier_capacity": F,
        "action_count": A,
        "frontier_fill": round(live / F, 4),
        "live_lanes": live,
        "bucket": bucket,
        "bucket_ladder": ladder,
        "compaction_ratio": round(live / bucket, 4),
        "device": device.type,
        "device_kind": kind,
        "wave_kernel": wave_kernel,
        "keys_route": spec.keys_route,
        "pipeline": "fps" if use_fps else "materialize",
        "table_capacity": table_capacity,
        "stages_ms": stages_ms,
        "fused_wave_ms": wave_ms,
        "fused_wave_fixed_ms": fixed_ms,
        "bucket_fused_ms": bucket_ms,
        "compact_ms": compact_ms,
        "candidates_per_wave": B,
        "candidates_per_wave_fixed": F * A,
        "n_new": int(out["stats"][1]),
        "stage_bytes": stage_bytes,
        "fused_wave_hbm_bytes": moved,
        "hbm_bytes_per_candidate": moved / B,
        "hbm_peak_gbps": peak["hbm_gbps"] if peak else None,
        "hbm_roofline_attainment": (
            moved / (peak["hbm_gbps"] * 1e9) / (wave_ms / 1e3) if peak else None),
    }


def measure_pipeline_choice(
    model,
    frontier_capacity: int = 1 << 10,
    table_capacity: int = 1 << 16,
    warmup_waves: int = 4,
    iters: int = 5,
    device=None,
) -> Dict:
    """The fingerprint-only expansion as a measured choice: times one
    calibration wave of the staged engine with it (``fps``: ``torch_wave_fps``
    and the take of its fresh children) and without it (``materialize``:
    ``torch_wave`` over the whole candidate grid) on the same
    representative frontier and table, reached through the materializing
    wave. Returns ``{"supported": False}`` for a model without the hooks,
    else ``fps_ms``, ``materialize_ms`` (median of ``iters`` after a
    warm-up), ``measured_faster`` and ``pipeline``, what the checker runs
    by default on the staged engine (``"fps"``). Runs on the card unless
    ``device="cpu"``."""
    out: Dict = {"supported": bool(supports_expand_fps(model))}
    if not out["supported"]:
        return out
    device = resolve_device(device)
    cuda = device.type == "cuda"
    F = 1 << max(0, (frontier_capacity - 1).bit_length())
    mat = wave_spec(model, device)
    fps = wave_spec(model, device, use_fps=True)
    table0, fr = _advance(model, mat, F, table_capacity, warmup_waves, fw.torch_wave, device)
    work = table0.clone()

    def reset():
        work.copy_(table0)

    def mat_wave(mark):
        fw.torch_wave(mat, work, fr["states"], fr["hi"], fr["lo"], fr["ebits"], fr["depth"],
                      _DEPTH_INF, mask=fr["mask"])

    def fps_wave(mark):
        _t, o = fw.torch_wave_fps(fps, work, fr["states"], fr["hi"], fr["lo"], fr["ebits"],
                                  fr["depth"], _DEPTH_INF, mask=fr["mask"])
        fw.take_children(fps, fr["states"], o["new"]["src"][:int(o["stats"][1])])

    out["frontier_capacity"] = F
    out["live_lanes"] = int(fr["mask"].sum())
    out["device_kind"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    out["materialize_ms"] = _time_marked(mat_wave, iters, cuda, reset)[0]
    out["fps_ms"] = _time_marked(fps_wave, iters, cuda, reset)[0]
    out["measured_faster"] = "fps" if out["fps_ms"] <= out["materialize_ms"] else "materialize"
    out["pipeline"] = "fps"
    return out
