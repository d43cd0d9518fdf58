"""One BFS wave: the model's stage in torch, every other stage in CUDA.

``fused_wave`` is the port of the JAX package's TPU kernel
``ops/pallas_wave.py::fused_wave``. The Pallas kernel traces the model's
own code (expand, boundary, conditions) into its prologue; a CUDA kernel
cannot hold another program's code, so the wave splits in two:

- the model stage, in torch (``model_stage``): the ``(P, F)`` condition
  matrix, the candidates and their valid bits (``packed_expand`` &
  ``packed_within_boundary``), and what the keys stage reads
  (``keys_input``);
- every model-independent stage, in the hand-written kernels of
  ``csrc/fused_wave.cu``, launched back to back with no host sync: the
  frontier lanes (eval mask, ``eventually`` bits, terminal lanes, property
  hits), the fingerprints (by the spec's ``keys_route``, below), a stable
  radix sort of the keys, dedup and tile ranges, the tile sweep shared
  with the insert kernel (``csrc/tile_sweep.cuh``), compaction of the
  fresh keys, which also writes the stats vector; with coverage
  on, the frontier and compaction kernels also add the wave's coverage
  vector (below).

The Pallas kernel fingerprints with the model's own ``fp_fn``
(``pallas_wave.py:180``). A model takes one of three key routes, chosen once
by the checker (``keys_route``), none falling back to another:

- ``"fold"``: the model keeps the default fold; ``fw_keys`` hashes the
  candidate leaves in place, word for word as ``state_words`` lays them
  out (``keys_input`` hands it the leaves, and no words matrix is built);
- ``"comphash"``: the model is a ``PackedActorModel``; ``fw_comphash_keys``
  computes its component hash from the candidate leaves, with the layout
  and constants of ``comphash_tables`` (made once, before any capture);
- ``"pairs"``: any other ``packed_fingerprint`` runs in the torch model
  stage, as ``packed_expand`` does, and ``fw_keys_pairs`` applies the
  validity, the sentinel and the count to its (hi, lo) pairs.

On a CUDA table ``fused_wave`` launches the kernels or raises; on a CPU
table it runs ``fused_wave_plain``, the same function in plain torch and
the specification the kernels are held against. Nothing falls back from
one to the other.

Outputs (both paths): the table, updated in place, and a dict with
``stats``, a ``(5 + 3P,)`` int64 tensor ``[generated, n_new, overflow,
max_depth, any_hit]`` followed by ``(hit, hi, lo)`` of each property's
first hit lane (lane 0 when none hit), and B-row per-lane outputs
``new`` (``states``, ``hi``, ``lo``, ``ebits``, ``depth``), ``parent_hi``
and ``parent_lo`` whose first ``n_new`` rows hold the fresh states in key
order; the rows past ``n_new`` are unspecified. The caller reads
``stats`` once and slices. With ``spec.cov_layout`` set (coverage on) the
dict also holds ``cov``, the wave's int64 coverage vector in
``telemetry/coverage.py::DeviceCoverage``'s layout: the Pallas kernel's
coverage epilogue (``pallas_wave.py:152-177``, ``:495-507``), computed by
``DeviceCoverage.wave_reduce`` in torch on the staged path and, on the
fused path, inside ``fw_frontier`` (the frontier half) and ``fw_compact``
(the fresh half), with no kernel or memset of its own. With coverage off
neither the model's antecedents nor any coverage work runs. u32 values ride in int64, as everywhere in
the port. An optional ``(F,)`` bool ``mask`` marks the live frontier
lanes (None: all live): the deep drain's fixed-width ring takes carry
stale rows in their masked lanes, and no stage reads those unmasked.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.batch import leaves, map_leaves
from .fingerprint import (
    _leaves,
    component_seeds,
    fingerprint_state,
    lin_consts,
    multiset_salts,
    row_salts,
)
from .hashset import u32_to_i32
from .hashset_kernel import (
    TILE_ROWS,
    _check_capacity,
    hashset_insert_sorted,
    sort_key,
    split_key,
    sweep_scratch,
)

__all__ = [
    "FusedWaveSpec",
    "antecedent_stage",
    "comphash_keys_stage",
    "comphash_tables",
    "compact_plain",
    "compact_stage",
    "coverage_fresh_plain",
    "coverage_frontier_plain",
    "coverage_plain",
    "coverage_stage",
    "dedup_plain",
    "dedup_stage",
    "fold_leaves",
    "frontier_plain",
    "frontier_stage",
    "fused_wave",
    "fused_wave_plain",
    "gather_plain",
    "gather_stage",
    "keys_input",
    "keys_pairs_stage",
    "keys_plain",
    "keys_stage",
    "kernel_chain",
    "launches",
    "model_stage",
    "sort_plain",
    "sort_stage",
    "sorted_dedup",
    "stats_from_acc",
    "take_children",
    "torch_wave",
    "torch_wave_fps",
]

# Fused waves launched on the card in this process (each is one run of
# ``kernel_chain``), the frontier stages (``fw_frontier``: each queues
# ``frontier_device_ops`` device operations), the keys stages on the fold
# route (``fw_keys``) and on the comphash route (``fw_comphash_keys``), the
# sorts (``fw_sort``: each queues ``sort_device_ops`` device operations),
# the dedups (``fw_dedup``), the compactions (``fw_compact``: each queues
# ``compact_device_ops``), the leaf-gather kernel launches (``fw_gather``:
# one for every 16 leaves), and the launches of ``fw_frontier`` and of
# ``fw_compact`` that carry the coverage epilogue (``coverage_launches``
# and ``coverage_fresh_launches``: one each a wave with coverage on).
launches = 0
frontier_launches = 0
keys_launches = 0
comphash_launches = 0
coverage_launches = 0
coverage_fresh_launches = 0
sort_launches = 0
dedup_launches = 0
compact_launches = 0
gather_launches = 0
frontier_device_ops = 0
sort_device_ops = 0
compact_device_ops = 0
KEY_ROUTES = ("fold", "comphash", "pairs")

KINDS = {"always": 0, "sometimes": 1, "eventually": 2}
MAX_PROPS = 64  # csrc/fused_wave.cu: MAX_PROPS
MAX_FOLD_LEAVES = 64  # csrc/fused_wave.cu: MAX_FOLD_LEAVES
# The element kinds of fw_keys (csrc/fused_wave.cu: LEAF_*) by dtype: the
# dtypes ``ops/fingerprint.py::_leaf_words`` converts.
_LEAF_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
               torch.int32: 4, torch.float32: 4, torch.int64: 5}
_SORT_TILE = 2048  # csrc/fused_wave.cu: SORT_TILE
_PART_TILE = 2048  # csrc/fused_wave.cu: PART_TILE
_SORT_SCRATCH_HEAD = 16 + 8 * 256  # csrc/fused_wave.cu: SC_PSTAT
_COMPACT_TILE = 2048  # csrc/fused_wave.cu: COMPACT_TILE
_INT64_MIN = -(1 << 63)
_SENTINEL = (1 << 63) - 1  # sort_key of the (MAX, MAX) invalid-lane key


@dataclasses.dataclass(frozen=True, eq=False)
class FusedWaveSpec:
    """What a wave closes over, so the wave stays checker-agnostic:
    the model's batched callables, the property kinds as strings
    (``"always" | "sometimes" | "eventually"``, aligned with
    ``conditions``), the (property index, eventually bit) pairs, the
    action count, the model's ``packed_fingerprint`` and the fused wave's
    key route (``KEY_ROUTES``; ``comphash`` holds ``comphash_tables`` on
    the ``"comphash"`` route). ``cov_layout`` (a ``DeviceCoverage``, or
    None with coverage off) and ``cov_antecedents`` (the model's
    ``packed_antecedents()``, aligned with ``conditions``) are the Pallas
    spec's. ``expand_fps`` and ``take`` are the model's
    ``packed_expand_fps`` and ``packed_take`` (``torch_wave_fps``; None
    where the checker runs the materializing wave). ``symmetry`` is the
    checker's ``checker/symmetry.py::SymmetryKeys`` under symmetry
    reduction (None: the keys are the fingerprints); only ``torch_wave``
    takes it."""

    expand: Callable
    within_boundary: Callable
    conditions: Tuple[Callable, ...]
    expectations: Tuple[str, ...]
    ebit: Tuple[Tuple[int, int], ...]
    action_count: int
    fingerprint: Callable = fingerprint_state
    keys_route: str = "fold"
    comphash: Optional[dict] = None
    cov_layout: Any = None
    cov_antecedents: Tuple[Optional[Callable], ...] = ()
    expand_fps: Optional[Callable] = None
    take: Optional[Callable] = None
    symmetry: Any = None


# -- the model stage (torch on both paths) ---------------------------------


def model_stage(spec: FusedWaveSpec, states, F: int):
    """The model's own code over F frontier states: ``(cond, cvalid,
    cand_flat)`` with ``cond`` the ``(P, F)`` bool condition matrix,
    ``cvalid`` the ``(F * A,)`` bool valid bits of the candidates (guard and
    boundary; the depth cap is applied later) and ``cand_flat`` the
    candidates with their leaves flattened to ``(F * A, ...)``, contiguous."""
    B = F * spec.action_count
    cand, valid = spec.expand(states)
    cand_flat = map_leaves(
        lambda x: x.reshape((B,) + x.shape[2:]).contiguous(), cand
    )
    cvalid = (valid.reshape(B) & spec.within_boundary(cand_flat)).contiguous()
    return _conditions(spec, states, F, cvalid.device), cvalid, cand_flat


def _conditions(spec, states, F, device):
    """The ``(P, F)`` bool condition matrix of the frontier, contiguous."""
    if spec.conditions:
        return torch.stack([c(states).to(torch.bool) for c in spec.conditions]).contiguous()
    return torch.zeros((0, F), dtype=torch.bool, device=device)


def antecedent_stage(spec: FusedWaveSpec, states, F: int):
    """The model's antecedents over F frontier states, run beside the
    conditions and only with coverage on: a ``(P, F)`` bool matrix whose
    row of an ``always`` property with an antecedent is that antecedent,
    and every other row all true."""
    dev = leaves(states)[0].device
    rows = []
    for i, kind in enumerate(spec.expectations):
        ant = spec.cov_antecedents[i] if spec.cov_antecedents else None
        if kind == "always" and ant is not None:
            rows.append(ant(states).to(torch.bool))
        else:
            rows.append(torch.ones(F, dtype=torch.bool, device=dev))
    if not rows:
        return torch.zeros((0, F), dtype=torch.bool, device=dev)
    return torch.stack(rows).contiguous()


def _exercised(spec, cond, ant, eval_mask, ebits_after):
    """Each property's exercise mask over the frontier (the Pallas
    prologue's ``ex_mat``): ``always``, the eval mask and its antecedent;
    ``sometimes``, the eval mask and its condition; ``eventually``, the
    eval mask and its unmet bit already cleared."""
    ebit = dict(spec.ebit)
    out = []
    for i, kind in enumerate(spec.expectations):
        if kind == "always":
            out.append(eval_mask & ant[i])
        elif kind == "sometimes":
            out.append(eval_mask & cond[i])
        else:
            out.append(eval_mask & (((ebits_after >> ebit[i]) & 1) == 0))
    return out


def _eval_mask(depth, depth_cap, mask):
    eval_mask = depth < depth_cap
    return eval_mask if mask is None else eval_mask & mask


def coverage_frontier_plain(spec, cvalid, depth, depth_cap, mask, cond, ant, ebits_after):
    """The frontier half of a wave's coverage vector, the part
    ``fw_frontier`` adds: ``DeviceCoverage.wave_reduce`` of the wave's
    frontier with no fresh lane (evaluated, terminal, fired, exercised,
    successor bins; the fresh and depth bins 0). The inputs are
    ``coverage_plain``'s."""
    F, A = depth.shape[0], spec.action_count
    eval_mask = _eval_mask(depth, depth_cap, mask)
    none = torch.zeros(0, dtype=torch.int64, device=depth.device)
    return spec.cov_layout.wave_reduce(
        eval_mask=eval_mask,
        cvalid=cvalid.view(F, A) & eval_mask[:, None],
        fresh=none.bool(),
        lane_action=none,
        new_depth=none,
        exercised=_exercised(spec, cond, ant, eval_mask, ebits_after),
    )


def coverage_fresh_plain(spec, depth, flag, idx):
    """The fresh half of a wave's coverage vector, the part ``fw_compact``
    adds: ``DeviceCoverage.wave_reduce`` of the sorted positions (``flag``,
    the sweep's outcome bytes, fresh = 1, or a bool fresh mask; ``idx``,
    each position's lane) over an empty frontier: each fresh lane's action
    and its child's depth bin, every other counter 0."""
    A, dev = spec.action_count, depth.device
    sidx = idx.to(torch.int64)
    return spec.cov_layout.wave_reduce(
        eval_mask=torch.zeros(0, dtype=torch.bool, device=dev),
        cvalid=torch.zeros((0, A), dtype=torch.bool, device=dev),
        fresh=flag if flag.dtype == torch.bool else (flag & 1) != 0,
        lane_action=sidx % A,
        new_depth=depth[sidx // A] + 1,
        exercised=[torch.zeros(0, dtype=torch.bool, device=dev)] * len(spec.expectations),
    )


def coverage_plain(spec, cvalid, depth, depth_cap, mask, cond, ant, ebits_after, flag,
                   idx):
    """A wave's coverage vector in torch (``DeviceCoverage.wave_reduce``,
    int64): the staged wave's reduction and the plain twin of the fused
    chain's coverage epilogue on the same inputs, the sum of its frontier
    half (``coverage_frontier_plain``, ``fw_frontier``'s) and its fresh half
    (``coverage_fresh_plain``, ``fw_compact``'s). The inputs are the model
    stage's valid bits (not yet under the eval mask), the frontier's depth
    and ``mask`` (None: all live), the condition and antecedent matrices,
    ``ebits_after``, and, in sorted order, the sweep's outcome bytes (fresh
    = 1; or a bool fresh mask) and each position's lane."""
    return (coverage_frontier_plain(spec, cvalid, depth, depth_cap, mask, cond, ant,
                                    ebits_after)
            + coverage_fresh_plain(spec, depth, flag, idx))


# -- the plain twin ------------------------------------------------------------


def sorted_dedup(khi, klo, valid):
    """Stable sort of the (hi, lo) keys with invalid lanes sunk to the
    (MAX, MAX) sentinel; returns ``(shi, slo, sidx, unique)`` where
    ``unique`` marks each valid key's first (lowest-lane) occurrence —
    ``jax.lax.sort(num_keys=2)`` over ``(hi, lo, lane)`` in the reference."""
    key = torch.where(valid, sort_key(khi, klo), torch.full_like(khi, _SENTINEL))
    skey, sidx = torch.sort(key, stable=True)
    first = torch.ones_like(valid)
    first[1:] = skey[1:] != skey[:-1]
    shi, slo = split_key(skey)
    return shi, slo, sidx, valid[sidx] & first


def _frontier_plain(spec, cond, cvalid, ebits, depth, depth_cap, mask=None):
    """Stage (a): the eval mask (live, under the depth cap), the
    ``eventually`` bits cleared where their condition holds, the valid
    bits under the eval mask, and the terminal lanes (evaluated, with no
    valid candidate). ``mask`` marks the live lanes (None: all)."""
    F, A = depth.shape[0], spec.action_count
    eval_mask = _eval_mask(depth, depth_cap, mask)
    ebits_after = ebits
    for pi, b in spec.ebit:
        ebits_after = torch.where(cond[pi], ebits_after & ~(1 << b), ebits_after)
    cvalid = (cvalid.view(F, A) & eval_mask[:, None]).reshape(F * A)
    terminal = eval_mask & ~cvalid.view(F, A).any(dim=1)
    return eval_mask, ebits_after, cvalid, terminal


def _hit_lanes(spec, cond, eval_mask, terminal, ebits_after):
    """Each property's (F,) bool hit lanes: ``always``, an evaluated lane
    where its condition fails; ``sometimes``, where it holds;
    ``eventually``, a terminal lane whose unmet bit is still set."""
    ebit = dict(spec.ebit)
    out = []
    for i, kind in enumerate(spec.expectations):
        if kind == "always":
            out.append(eval_mask & ~cond[i])
        elif kind == "sometimes":
            out.append(eval_mask & cond[i])
        else:
            out.append(terminal & (((ebits_after >> ebit[i]) & 1) == 1))
    return out


def frontier_plain(spec, cond, cvalid, ebits, depth, depth_cap, acc, mask=None):
    """The plain twin of ``frontier_stage``: returns ``ebits_after`` and
    writes ``acc`` as ``fw_frontier`` does, its counters 0, then the max
    depth of the live lanes, then each property's first hit lane ``f`` as
    the int64 bits of ``~f`` (0 when no lane hit)."""
    eval_mask, ebits_after, _cvalid, terminal = _frontier_plain(
        spec, cond, cvalid, ebits, depth, depth_cap, mask
    )
    F, dev = depth.shape[0], depth.device
    sentinel = torch.full((1,), F, dtype=torch.int64, device=dev)
    lane = torch.arange(F, dtype=torch.int64, device=dev)
    live = depth if mask is None else torch.where(mask, depth, 0)
    acc.zero_()
    acc[3:4].copy_(torch.cat([live, torch.zeros_like(sentinel)]).max().view(1))
    for i, h in enumerate(_hit_lanes(spec, cond, eval_mask, terminal, ebits_after)):
        first = torch.cat([torch.where(h, lane, F), sentinel]).min()
        acc[4 + i:5 + i].copy_(torch.where(first < F, ~first, 0).view(1))
    return ebits_after


def _stats(spec, cond, eval_mask, terminal, ebits_after, hi, lo, depth,
           generated, fresh, pending, mask=None):
    """The stats vector: counts (the max depth over the live lanes), then
    each property's hit and the fingerprint of its first hit lane (lane 0
    when none hit, as ``jnp.argmax``). The plain twin of what
    ``fw_compact`` writes on the card."""
    zero = torch.zeros((), dtype=torch.int64, device=hi.device)
    F = hi.shape[0]
    hits, props = [], []
    for h in _hit_lanes(spec, cond, eval_mask, terminal, ebits_after):
        hits.append(h.any())
        if F:
            idx = h.to(torch.uint8).argmax().view(1)
            props += [hits[-1], hi.index_select(0, idx)[0], lo.index_select(0, idx)[0]]
        else:
            props += [hits[-1], zero, zero]
    if mask is not None:
        depth = torch.where(mask, depth, 0)
    items = [
        generated,
        fresh.sum(),
        pending.sum(),
        depth.max() if F else zero,
        torch.stack(hits).any() if hits else zero,
    ] + props
    return torch.stack([x.to(torch.int64) for x in items])


def torch_wave(spec, table, states, hi, lo, ebits, depth, depth_cap, mask=None,
               exact=True):
    """The whole wave in torch, fingerprinting with ``spec.fingerprint``
    (the model's ``packed_fingerprint``), with the visited-set insert
    through ``hashset_insert_sorted`` (the CUDA kernel on a CUDA table, its
    plain twin on a CPU table). It is the staged path of ``checker/gpu.py``
    and, on a CPU table, ``fused_wave_plain``. ``mask`` (F,) bool marks
    the live lanes; None means every lane is live. Masked lanes may hold
    stale rows: nothing of them reaches the outputs.

    Under symmetry (``spec.symmetry``) the sort, dedup and insert run on
    the candidates' orbit keys, the fresh rows and parent pointers keep
    the original fingerprints, and ``out`` also holds the fresh lanes'
    keys (``key_hi``, ``key_lo``). ``exact=False`` computes the keys with
    no host read (``SymmetryKeys.wave_keys``): ``out["hold"]`` is then a
    0-d bool tensor, and a wave that holds inserts nothing."""
    F = hi.shape[0]
    cond, cvalid, cand_flat = model_stage(spec, states, F)
    chi, clo = spec.fingerprint(cand_flat)
    keys = None
    if spec.symmetry is not None:
        def keys(valid):
            return spec.symmetry.wave_keys(cand_flat, valid, exact)
    table, out = _staged_wave(spec, table, states, cond, cvalid, chi, clo, hi, lo, ebits,
                              depth, depth_cap, mask, keys)
    # The leaves' rows past n_new are lane 0's.
    src = out["new"].pop("src")
    out["new"]["states"] = map_leaves(lambda x: x[src], cand_flat)
    return table, out


def torch_wave_fps(spec, table, states, hi, lo, ebits, depth, depth_cap, mask=None):
    """``torch_wave`` with the fingerprint-only expansion (the JAX staged
    wave with ``expand_fps`` on): the candidates' fingerprints and validity
    come from ``spec.expand_fps`` with no candidate state made, then the
    same sort, dedup, insert, compaction, stats and coverage. ``new`` holds
    no ``states``: it holds ``src``, each slot's candidate lane (parent
    ``src // A``, action ``src % A``; 0 past ``n_new``), and the caller
    makes the fresh children it keeps with ``take_children``."""
    F = hi.shape[0]
    B = F * spec.action_count
    cond = _conditions(spec, states, F, hi.device)
    chi, clo, valid = spec.expand_fps(states)
    return _staged_wave(spec, table, states, cond, valid.reshape(B), chi.reshape(B),
                        clo.reshape(B), hi, lo, ebits, depth, depth_cap, mask)


def _staged_wave(spec, table, states, cond, cvalid, chi, clo, hi, lo, ebits, depth,
                 depth_cap, mask, keys=None):
    """The staged wave from the candidates' valid bits and fingerprints on:
    the frontier, the sort and dedup, the insert, the stats, the coverage
    and the JAX staged wave's cumsum compaction (the Pallas epilogue's,
    ``pallas_wave.py:444-463``); ``new`` holds ``src``, each slot's
    candidate lane, and no ``states``. ``keys``, under symmetry, maps the
    valid bits under the eval mask to ``(khi, klo, hold)``
    (``SymmetryKeys.wave_keys``): the dedup and insert run on those keys,
    none of them when ``hold`` is true."""
    F, A = hi.shape[0], spec.action_count
    eval_mask, ebits_after, cvalid, terminal = _frontier_plain(
        spec, cond, cvalid, ebits, depth, depth_cap, mask
    )
    khi, klo, hold = chi, clo, None
    if keys is not None:
        khi, klo, hold = keys(cvalid)
    insert_valid = cvalid if hold is None else cvalid & ~hold
    shi, slo, sidx, unique = sorted_dedup(khi, klo, insert_valid)
    table, fresh, _found, pending = hashset_insert_sorted(
        table, u32_to_i32(shi), u32_to_i32(slo), unique
    )
    stats = _stats(spec, cond, eval_mask, terminal, ebits_after, hi, lo,
                   depth, cvalid.sum(), fresh, pending, mask)
    c, _n_new = compact_plain(fresh, (shi << 32) | slo, sidx, A, ebits_after, depth, hi, lo)
    new = {k: c[k] for k in ("src", "hi", "lo", "ebits", "depth")}
    out = {"stats": stats, "new": new, "parent_hi": c["parent_hi"],
           "parent_lo": c["parent_lo"]}
    if keys is not None:
        # The keys the fresh lanes claimed are the table's rows (the JAX
        # wave's ``key_hi``/``key_lo``); the fresh rows keep the
        # candidates' own fingerprints, so paths replay through them.
        out["key_hi"], out["key_lo"] = new["hi"], new["lo"]
        new["hi"], new["lo"] = chi[new["src"]], clo[new["src"]]
        if hold is not None:
            out["hold"] = hold
    if spec.cov_layout is not None:
        # The JAX staged wave's coverage (checker/tpu.py:1337-1380): the
        # claim winners in sorted order, each with its lane's action and
        # its child's depth; under symmetry also the wave's distinct
        # fingerprints and distinct orbit keys (uniq_fp, uniq_key).
        cov = coverage_plain(spec, cvalid, depth, depth_cap, mask, cond,
                             antecedent_stage(spec, states, F), ebits_after, fresh, sidx)
        if keys is not None:
            lay = spec.cov_layout
            head = torch.zeros_like(cov)
            head[2:4] = torch.stack([lay.count_distinct(chi, clo, cvalid),
                                     lay.count_distinct(khi, klo, cvalid)])
            cov = cov + head
        out["cov"] = cov
    return table, out


def take_children(spec, states, src):
    """The children of candidate lanes ``src`` (``(L,)``) of a wave over the
    frontier ``states``: ``spec.take`` of parent row ``src // A`` and action
    ``src % A``, one row each."""
    A = spec.action_count
    parents = map_leaves(lambda x: x[src // A], states)
    return spec.take(parents, src % A)


def fused_wave_plain(spec, table, states, hi, lo, ebits, depth, depth_cap,
                     mask=None):
    """The plain torch twin of the fused kernels (CPU tables only): the
    model's ``packed_fingerprint`` (on every key route), a stable
    ``torch.sort``, ``hashset_insert_sorted_plain`` and cumsum
    compaction."""
    if table.device.type != "cpu":
        raise ValueError(f"fused_wave_plain runs on CPU tensors, got {table.device}")
    return torch_wave(spec, table, states, hi, lo, ebits, depth, depth_cap,
                      mask=mask)


# -- the CUDA path ---------------------------------------------------------------

_c_ptr, _c_int, _c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The C entry points of csrc/fused_wave.cu and their parameter types
# (c_void_p for every pointer and the stream).
ARGTYPES = {
    "fw_frontier": [_c_i64, _c_int, _c_i64] + [_c_ptr] * 6 + [_c_int] + [_c_ptr] * 4 + [_c_int]
    + [_c_ptr] * 2,
    "fw_keys": [_c_i64, _c_int, _c_int] + [_c_ptr] * 6 + [_c_i64] + [_c_ptr] * 4,
    "fw_keys_pairs": [_c_i64, _c_int] + [_c_ptr] * 5 + [_c_i64] + [_c_ptr] * 4,
    "fw_comphash_keys": [_c_i64] + [_c_int] * 8 + [_c_ptr] * 13 + [_c_i64] + [_c_ptr] * 4,
    "fw_sort": [_c_i64] + [_c_ptr] * 7,
    "fw_dedup": [_c_i64, _c_ptr, _c_ptr, _c_int] + [_c_ptr] * 3 + [_c_i64] + [_c_ptr] * 2
    + [_c_int] * 2 + [_c_ptr],
    "fw_sweep": [_c_ptr] * 4 + [_c_i64] + [_c_int] * 2 + [_c_ptr] * 4,
    "fw_compact": [_c_i64, _c_int] + [_c_ptr] * 17 + [_c_int, _c_ptr, _c_int] + [_c_ptr] * 2,
    "fw_gather": [_c_i64, _c_ptr, _c_ptr, _c_int] + [_c_ptr] * 4 + [_c_int] + [_c_ptr] * 2,
}


_fns = {}


def _lib():
    """The C entry points of ``csrc/fused_wave.cu`` by name, built and
    typed on first use."""
    if not _fns:
        from ._build import load

        lib = load("fused_wave")
        fns = {name: getattr(lib, name) for name in ARGTYPES}
        for name, fn in fns.items():
            fn.restype = ctypes.c_int
            fn.argtypes = ARGTYPES[name]
        _fns.update(fns)
    return _fns


def _call(name, *args):
    err = _lib()[name](*args)
    if err != 0:
        raise RuntimeError(f"fused_wave {name} launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _host_ints(values, ctype=ctypes.c_int):
    arr = (ctype * max(1, len(values)))(*values)
    return arr, ctypes.addressof(arr)


def _ptr(x):
    return x.data_ptr() if x is not None else None


def frontier_stage(spec, cond, cvalid, ebits, depth, depth_cap, acc, mask=None, ant=None):
    """Stage (a): resets ``acc`` and returns ``ebits_after``; ``acc``
    gathers the max depth of the live lanes (``mask``; None: all) and each
    property's first hit lane (as ``frontier_plain`` writes them). With
    ``ant`` (coverage on: ``antecedent_stage``'s matrix) ``acc`` holds
    ``4 + P + spec.cov_layout.size`` words, and its tail, the wave's
    coverage vector, gets the frontier half (``coverage_frontier_plain``)
    and counts one ``coverage_launches``. Launches ``fw_frontier`` (a
    memset of all of ``acc`` and one kernel, ``frontier_device_ops``) and
    counts one ``frontier_launches``."""
    global frontier_launches, frontier_device_ops, coverage_launches

    F, P = depth.shape[0], len(spec.conditions)
    cov_size = 0
    if ant is not None:
        cov_size = spec.cov_layout.size
        if acc.shape[0] != 4 + P + cov_size:
            raise ValueError(f"acc must hold {4 + P + cov_size} words with coverage on, "
                             f"got {acc.shape[0]}")
    ebit = dict(spec.ebit)
    kinds, kind_p = _host_ints([KINDS[k] for k in spec.expectations])
    bits, bit_p = _host_ints([ebit.get(i, -1) for i in range(P)])
    ebits_after = torch.empty_like(ebits)
    ops = ctypes.c_int(0)
    frontier_launches += 1
    if ant is not None:
        coverage_launches += 1
    _call("fw_frontier", F, spec.action_count, int(depth_cap), cond.data_ptr(),
          cvalid.data_ptr(), depth.data_ptr(), ebits.data_ptr(), _ptr(mask),
          ebits_after.data_ptr(), P, kind_p, bit_p, acc.data_ptr(), _ptr(ant), cov_size,
          ctypes.addressof(ops), _stream(depth))
    frontier_device_ops = ops.value
    return ebits_after


def fold_leaves(state, B, device):
    """The leaves ``fw_keys`` reads for a packed ``state`` of B lanes, in
    ``state_words``' order: a dtype that ``_leaf_words`` does not convert
    raises ``TypeError``; a leaf that is not contiguous, not B rows long or
    not on ``device``, or more than ``MAX_FOLD_LEAVES`` leaves, raise
    ``ValueError``."""
    out = _leaves(state)
    if not out:
        raise ValueError("packed state has no array leaves")
    for x in out:
        if x.dtype not in _LEAF_KINDS:
            raise TypeError(f"cannot fingerprint leaf dtype {x.dtype}")
        if x.dim() == 0 or x.shape[0] != B or x.device != device or not x.is_contiguous():
            raise ValueError(
                f"fw_keys takes contiguous leaves of {B} rows on {device}, got "
                f"{tuple(x.shape)} on {x.device}, contiguous={x.is_contiguous()}"
            )
    if len(out) > MAX_FOLD_LEAVES:
        raise ValueError(f"fw_keys takes at most {MAX_FOLD_LEAVES} leaves, got {len(out)}")
    return out


def keys_stage(state, cvalid, depth=None, depth_cap=0, action_count=1, acc=None,
               mask=None):
    """Stage (b) on the ``"fold"`` route: ``(key, idx)``, each lane's
    ``fingerprint_state`` of the packed ``state`` (its leaves, B rows each;
    a ``(B, W)`` words tensor is a one-leaf state) as the int64 bits of
    ``(hi << 32) | lo`` (all ones for a lane that is not valid: not
    ``cvalid``, with ``mask`` a lane of a frontier lane that is not live,
    or, with ``depth``, at or past ``depth_cap``) and the lane index
    (int32). Counts the valid lanes into ``acc`` when given. Launches
    ``fw_keys``, which reads the leaves in place, and counts one
    ``keys_launches``; its plain twin is ``keys_plain`` over
    ``fingerprint_state``."""
    global keys_launches

    B = cvalid.shape[0]
    xs = fold_leaves(state, B, cvalid.device)
    ptrs, ptr_p = _host_ints([x.data_ptr() for x in xs], ctypes.c_uint64)
    widths, width_p = _host_ints([math.prod(x.shape[1:]) for x in xs])
    kinds, kind_p = _host_ints([_LEAF_KINDS[x.dtype] for x in xs])
    key = torch.empty(B, dtype=torch.int64, device=cvalid.device)
    idx = torch.empty(B, dtype=torch.int32, device=cvalid.device)
    keys_launches += 1
    _call("fw_keys", B, action_count, len(xs), ptr_p, width_p, kind_p, cvalid.data_ptr(),
          _ptr(depth), _ptr(mask), int(depth_cap), key.data_ptr(), idx.data_ptr(), _ptr(acc),
          _stream(cvalid))
    return key, idx


def keys_pairs_stage(chi, clo, cvalid, depth=None, depth_cap=0, action_count=1,
                     acc=None, mask=None):
    """Stage (b) on the ``"pairs"`` route: ``keys_stage`` over the model's
    own (hi, lo) fingerprints, ``(B,)`` int64 each."""
    B = chi.shape[0]
    key = torch.empty(B, dtype=torch.int64, device=chi.device)
    idx = torch.empty(B, dtype=torch.int32, device=chi.device)
    _call("fw_keys_pairs", B, action_count, chi.data_ptr(), clo.data_ptr(),
          cvalid.data_ptr(), _ptr(depth), _ptr(mask), int(depth_cap), key.data_ptr(),
          idx.data_ptr(), _ptr(acc), _stream(chi))
    return key, idx


def comphash_tables(layout, device):
    """The ``"comphash"`` route's constants for a ``PackedActorModel``'s
    ``packed_comphash_layout()``: the layout and one int64 device tensor
    of the hash's coefficients and seeds, in ``csrc/fused_wave.cu``'s
    ``CompHash`` order (actor row ‖ timer; then an unordered network's
    envelope row and digest, or an ordered network's flow row; the history;
    then the tags' seeds), the same ``lin_consts`` and ``component_seeds``
    as ``ops/fingerprint.py``. Made once, before any capture."""
    N, R, W, H = layout["N"], layout["R"], layout["W"], layout["H"]
    ordered = layout["ordered"]
    net_comps = layout["P"] if ordered else 1
    if (layout["actor_tag"], layout["network_tag"], layout["history_tag"]) != (
        0, N, N + net_comps
    ):
        raise ValueError(f"fw_comphash_keys takes tags 0..N+{net_comps}, got {layout}")
    if ordered:
        net = ((layout["Q"] * W + 1, row_salts),)
    else:
        net = ((3 + W, multiset_salts), (4, row_salts))
    parts = []
    for width, salts in ((R + 1, row_salts),) + net + ((H, row_salts),):
        if width:
            parts += [lin_consts(width, salt) for salt in salts(width)]
    C = N + net_comps + (1 if H else 0)
    parts += [x.numpy() for x in component_seeds(list(range(C)))]
    consts = np.concatenate([np.asarray(p, np.int64) for p in parts])
    return {"layout": dict(layout), "consts": torch.from_numpy(consts).to(device)}


def comphash_keys_stage(tables, cand_flat, cvalid, depth=None, depth_cap=0,
                        action_count=1, acc=None, mask=None):
    """Stage (b) on the ``"comphash"`` route: ``keys_stage`` with each
    valid lane's ``PackedActorModel.packed_fingerprint``, computed by
    ``fw_comphash_keys`` from the candidate leaves (int64, contiguous): the
    actor rows and timers, then the envelope table of an unordered network
    or the flows of an ordered one, then the history. A leaf that is
    missing or of another shape raises. Counts one ``comphash_launches``."""
    global comphash_launches

    lay = tables["layout"]
    N, R, E, P, Q, W, H = (lay[k] for k in ("N", "R", "E", "P", "Q", "W", "H"))
    B = cvalid.shape[0]
    want = {lay["actors"][0]: (B, N, R), lay["actors"][1]: (B, N)}
    if lay["ordered"]:
        want.update(zip(lay["network"], [(B, P, Q, W), (B, P)]))
    else:
        want.update(zip(lay["network"], [(B, E), (B, E), (B, E, W), (B, E)]))
    if H:
        want[lay["history"]] = (B, H)
    for k, shape in want.items():
        x = cand_flat.get(k)
        if x is None or x.dtype != torch.int64 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            got = None if x is None else (tuple(x.shape), x.dtype)
            raise ValueError(
                f"fw_comphash_keys takes the contiguous int64 leaf {k!r} of shape "
                f"{shape}, got {got}"
            )

    def leaf(k):
        return _ptr(cand_flat[k]) if k in want else None

    comphash_launches += 1
    key = torch.empty(B, dtype=torch.int64, device=cvalid.device)
    idx = torch.empty(B, dtype=torch.int32, device=cvalid.device)
    _call("fw_comphash_keys", B, action_count, N, R, E, P, Q, W, H,
          *(leaf(k) for k in lay["actors"]),
          *(leaf(k) for k in ("net_src", "net_dst", "net_msg", "net_cnt", "flow_msg",
                              "flow_len")),
          leaf(lay["history"]), tables["consts"].data_ptr(),
          cvalid.data_ptr(), _ptr(depth), _ptr(mask), int(depth_cap), key.data_ptr(),
          idx.data_ptr(), _ptr(acc), _stream(cvalid))
    return key, idx


def keys_plain(chi, clo, cvalid, depth=None, depth_cap=0, action_count=1, mask=None):
    """The plain twin of every keys stage, given the lanes' fingerprints
    (on the ``"comphash"`` route the model's torch ``packed_fingerprint``):
    ``(key, idx)`` as the kernels write them."""
    B = cvalid.shape[0]
    parent = torch.arange(B, device=cvalid.device) // action_count
    valid = cvalid
    if mask is not None:
        valid = valid & mask[parent]
    if depth is not None:
        valid = valid & (depth[parent] < depth_cap)
    key = torch.where(valid, (chi << 32) | clo, -1)
    return key, torch.arange(B, dtype=torch.int32, device=cvalid.device)


def keys_input(spec, cand_flat):
    """What the keys stage reads, by ``spec.keys_route``: the candidate
    leaves in ``state_words``' order, a tuple, read in place by ``fw_keys``
    (``"fold"``: no words matrix is built), the model's own (hi, lo) pairs,
    computed here in torch (``"pairs"``), or nothing (``"comphash"``: the
    kernel reads the candidate leaves)."""
    if spec.keys_route == "fold":
        return tuple(_leaves(cand_flat))
    if spec.keys_route == "pairs":
        return tuple(x.contiguous() for x in spec.fingerprint(cand_flat))
    if spec.keys_route == "comphash":
        return None
    raise ValueError(f"keys_route must be one of {KEY_ROUTES}, got {spec.keys_route!r}")


def route_keys_stage(spec, kin, cand_flat, cvalid, depth, depth_cap, acc, mask=None):
    """Stage (b) on ``spec.keys_route`` over ``kin = keys_input(...)``."""
    A = spec.action_count
    if spec.keys_route == "fold":
        return keys_stage(kin, cvalid, depth, depth_cap, A, acc, mask)
    if spec.keys_route == "pairs":
        return keys_pairs_stage(kin[0], kin[1], cvalid, depth, depth_cap, A, acc, mask)
    return comphash_keys_stage(spec.comphash, cand_flat, cvalid, depth, depth_cap, A,
                               acc, mask)


def sort_plain(key, idx):
    """The plain twin of ``sort_stage``: a stable ``torch.sort`` of ``key``
    as unsigned 64-bit values, carrying ``idx``, in place."""
    skey, perm = torch.sort(key ^ _INT64_MIN, stable=True)
    idx.copy_(idx[perm])
    key.copy_(skey ^ _INT64_MIN)
    return key, idx


def sort_stage(key, idx):
    """Stage (c): sorts ``key`` (int64 bits of u64 values) as unsigned
    64-bit values, stably, carrying ``idx`` (int32), in place: ``fw_sort``
    (a partition that sends the ``~0`` sentinel lanes to their final tail,
    then 8 digit passes over the keyed lanes only), counting one
    ``sort_launches``."""
    global sort_launches, sort_device_ops

    n = key.shape[0]
    nt, nb = -(-n // _PART_TILE), -(-n // _SORT_TILE)
    key_tmp = torch.empty(2 * n, dtype=key.dtype, device=key.device)
    idx_tmp = torch.empty(2 * n, dtype=idx.dtype, device=key.device)
    scratch = torch.empty(max(1, _SORT_SCRATCH_HEAD + nt + 2 * nb * 256), dtype=torch.int32,
                          device=key.device)
    ops = ctypes.c_int(0)
    sort_launches += 1
    _call("fw_sort", n, key.data_ptr(), idx.data_ptr(), key_tmp.data_ptr(),
          idx_tmp.data_ptr(), scratch.data_ptr(), ctypes.addressof(ops), _stream(key))
    sort_device_ops = ops.value
    return key, idx


def dedup_plain(key, idx, capacity, cvalid, action_count, depth, depth_cap, mask):
    """The plain twin of ``dedup_stage``, as the reference computes it
    (``pallas_wave.py:189-206``): ``active``, the first sorted occurrence
    of each key whose lane ``idx`` is valid (``cvalid``, under ``depth_cap``
    with ``depth``, live under ``mask``; the reference's ``cvalid[sidx] &
    uniq``), and the ``(n_tiles + 1,)`` int64 ``starts``, 0 and then each
    tile's first row searched (side left) among the homes of the sorted
    keys (int64 bits of u64 values)."""
    B, n_tiles = key.shape[0], capacity // TILE_ROWS
    uniq = torch.ones(B, dtype=torch.bool, device=key.device)
    uniq[1:] = key[1:] != key[:-1]
    lane = idx.to(torch.int64)
    parent = lane // action_count
    valid = cvalid[lane]
    if mask is not None:
        valid = valid & mask[parent]
    if depth is not None:
        valid = valid & (depth[parent] < depth_cap)
    homes = ((key >> 32) & 0xFFFFFFFF) >> (32 - (capacity.bit_length() - 1))
    bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=key.device) * TILE_ROWS
    return valid & uniq, torch.searchsorted(homes, bounds)


def dedup_stage(key, idx, capacity, cvalid, action_count, depth, depth_cap, mask):
    """Stage (d): ``(active, starts)``: each sorted position holding the
    first occurrence of its key whose lane (``idx``) is valid, as the keys
    stage decides it from ``cvalid``, ``depth`` and ``mask`` (the
    reference's ``cvalid[sidx] & uniq``; ``mask`` None: all live), and the
    ``(n_tiles + 1,)`` bounds of each tile's keys. On CUDA tensors it
    launches ``fw_dedup`` (one pass over the positions, the tile bounds
    from the homes' run boundaries) and counts one ``dedup_launches``; on
    CPU tensors it runs ``dedup_plain``."""
    global dedup_launches

    if key.device.type == "cpu":
        return dedup_plain(key, idx, capacity, cvalid, action_count, depth, depth_cap, mask)
    B, n_tiles = key.shape[0], capacity // TILE_ROWS
    active = torch.empty(B, dtype=torch.bool, device=key.device)
    starts = torch.empty(n_tiles + 1, dtype=torch.int64, device=key.device)
    dedup_launches += 1
    _call("fw_dedup", B, key.data_ptr(), idx.data_ptr(), action_count, cvalid.data_ptr(),
          _ptr(depth), _ptr(mask), int(depth_cap), active.data_ptr(), starts.data_ptr(),
          n_tiles, capacity.bit_length() - 1, _stream(key))
    return active, starts


def sweep_stage(table, key, active, starts, acc):
    """Stage (e): the tile sweep; returns each sorted position's outcome
    byte (1 fresh, 2 found, 4 pending, 0 inactive) and the sweep's scratch
    (``tiles_redone`` reads it), and counts the pending keys into
    ``acc``."""
    cap = _check_capacity(table)
    B, n_tiles = key.shape[0], cap // TILE_ROWS
    flag = torch.empty(B, dtype=torch.uint8, device=key.device)
    scratch = sweep_scratch(B, n_tiles, key.device)
    _call("fw_sweep", table.data_ptr(), key.data_ptr(), active.data_ptr(),
          starts.data_ptr(), B, n_tiles, cap.bit_length() - 1,
          flag.data_ptr(), acc.data_ptr(), scratch.data_ptr(), _stream(table))
    return flag, scratch


_COMPACT_OUTS = ("hi", "lo", "ebits", "depth", "parent_hi", "parent_lo", "src")


def compact_plain(flag, key, idx, action_count, ebits_after, depth, hi, lo):
    """The compaction in plain torch, as the JAX epilogue writes it
    (``pallas_wave.py:444-463``): each fresh sorted position (``flag``, the
    sweep's outcome bytes, fresh = 1, or a bool fresh mask) goes to slot
    ``cumsum(fresh) - 1``, its rank among the fresh positions. Returns the
    B-row int64 outputs of ``compact_stage`` (the key's hi and lo halves,
    the parent's ``ebits_after``, ``depth + 1``, hi and lo, and the lane
    ``idx`` in ``src``; 0 past ``n_new``) and ``n_new``, a 0-d int64
    tensor. ``fw_compact``'s plain twin and the staged wave's compaction."""
    fresh = flag if flag.dtype == torch.bool else (flag & 1) != 0
    B = fresh.shape[0]
    slot = torch.where(fresh, torch.cumsum(fresh, 0) - 1, B)
    sidx = idx.to(torch.int64)
    parent = sidx // action_count
    vals = ((key >> 32) & 0xFFFFFFFF, key & 0xFFFFFFFF, ebits_after[parent],
            depth[parent] + 1, hi[parent], lo[parent], sidx)
    out = {}
    for name, v in zip(_COMPACT_OUTS, vals):
        x = torch.zeros(B + 1, dtype=torch.int64, device=fresh.device)
        x[slot] = v
        out[name] = x[:B]
    return out, fresh.sum()


def stats_from_acc(acc, P, hi, lo):
    """The ``(5 + 3P,)`` stats vector decoded from the wave's counters
    ``acc`` (``frontier_plain``'s layout, ``n_new`` in ``acc[1]``) and the
    frontier's ``hi`` and ``lo``, as ``fw_compact`` writes it:
    ``compact_stage``'s stats on CPU tensors."""
    F = hi.shape[0]
    zero = torch.zeros(1, dtype=torch.int64, device=acc.device)
    first = acc[4:4 + P]
    hit = first != 0
    lane = torch.where(hit, ~first, 0)
    props = [hit.to(torch.int64),
             hi[lane] if F else zero.expand(P), lo[lane] if F else zero.expand(P)]
    any_hit = hit.any().view(1).to(torch.int64)
    return torch.cat([acc[:4], any_hit, torch.stack(props, dim=1).reshape(3 * P)])


def compact_stage(flag, key, idx, action_count, ebits_after, depth, hi, lo, acc, cov=None,
                  stats=None):
    """Stage (f): writes ``n_new`` into ``acc`` and returns the B-row
    per-lane outputs and ``src``, each slot's candidate lane (rows past
    ``n_new`` unspecified). With ``stats``, a ``(5 + 3P,)`` int64 tensor
    for ``acc``'s P properties, the kernel also writes the wave's stats
    vector from the counters, which every stage before it has finished
    (``stats_from_acc``; the wave's ``_stats``). On CUDA tensors it
    launches ``fw_compact`` (a memset and one kernel,
    ``compact_device_ops``) and counts one ``compact_launches``; with
    ``cov`` (coverage on: the wave's coverage vector, which
    ``frontier_stage`` zeroed) the kernel adds its fresh half
    (``coverage_fresh_plain``) and counts one ``coverage_fresh_launches``.
    On CPU tensors it runs ``compact_plain`` and ``stats_from_acc`` (and
    takes no ``cov``)."""
    global compact_launches, compact_device_ops, coverage_fresh_launches

    P = 0
    if stats is not None:
        P = (stats.shape[0] - 5) // 3
        if stats.dtype != torch.int64 or stats.shape[0] != 5 + 3 * P or acc.shape[0] < 4 + P:
            raise ValueError(f"stats must be a (5 + 3P,) int64 tensor for acc's P properties, "
                             f"got {tuple(stats.shape)} {stats.dtype} and acc of {acc.shape[0]}")
    if flag.device.type == "cpu":
        if cov is not None:
            raise ValueError("compact_stage adds coverage on the card only; "
                             "coverage_fresh_plain is its twin")
        out, n_new = compact_plain(flag, key, idx, action_count, ebits_after, depth, hi, lo)
        acc[1:2].copy_(n_new.view(1))
        if stats is not None:
            stats.copy_(stats_from_acc(acc, P, hi, lo))
        return out
    B = key.shape[0]
    scratch = torch.empty(1 + max(1, -(-B // _COMPACT_TILE)), dtype=torch.int32,
                          device=key.device)
    out = {k: torch.empty(B, dtype=torch.int64, device=key.device) for k in _COMPACT_OUTS}
    ops = ctypes.c_int(0)
    compact_launches += 1
    if cov is not None:
        coverage_fresh_launches += 1
    _call("fw_compact", B, action_count, flag.data_ptr(), key.data_ptr(),
          idx.data_ptr(), ebits_after.data_ptr(), depth.data_ptr(), hi.data_ptr(),
          lo.data_ptr(), scratch.data_ptr(), acc.data_ptr(), out["hi"].data_ptr(),
          out["lo"].data_ptr(), out["ebits"].data_ptr(), out["depth"].data_ptr(),
          out["parent_hi"].data_ptr(), out["parent_lo"].data_ptr(),
          out["src"].data_ptr(), _ptr(cov), 0 if cov is None else cov.shape[0],
          _ptr(stats), P, ctypes.addressof(ops), _stream(key))
    compact_device_ops = ops.value
    return out


def _unit(row_bytes, *ptrs):
    u = 16
    while u > 1 and (row_bytes % u or any(p % u for p in ptrs)):
        u //= 2
    return u


def _group(units):
    """The lanes that copy one row: the smallest power of two holding the
    widest leaf's units a row, between 4 and 32."""
    g = 4
    while g < 32 and g < max(units, default=1):
        g *= 2
    return g


def gather_plain(src, acc, cand_flat):
    """The plain twin of ``gather_stage``: row ``pos < n_new`` of each leaf
    is the candidates' row ``src[pos]``; B rows each, the rest undefined."""
    n = min(int(acc[1]), src.shape[0])

    def take(x):
        out = torch.empty_like(x)
        out[:n] = x[src[:n]]
        return out

    return map_leaves(take, cand_flat)


def gather_stage(src, acc, cand_flat):
    """Stage (f), leaves: the first ``n_new`` (``acc[1]``, read on the
    device) rows of each candidate leaf, gathered by ``src`` as byte rows
    (any dtype); B rows each: ``fw_gather`` (``_group`` of the leaves'
    widths lanes a row), counting its launches in ``gather_launches``."""
    global gather_launches

    pairs = []

    def alloc(x):
        dst = torch.empty_like(x)
        pairs.append((x, dst))
        return dst

    new_states = map_leaves(alloc, cand_flat)
    rows = [x[0].numel() * x.element_size() if x.shape[0] else 0 for x, _ in pairs]
    unit_list = [_unit(rb, x.data_ptr(), d.data_ptr()) for rb, (x, d) in zip(rows, pairs)]
    group = _group([rb // u for rb, u in zip(rows, unit_list)])
    srcs, src_p = _host_ints([x.data_ptr() for x, _ in pairs], ctypes.c_uint64)
    dsts, dst_p = _host_ints([d.data_ptr() for _, d in pairs], ctypes.c_uint64)
    rbs, rb_p = _host_ints(rows, ctypes.c_int64)
    units, unit_p = _host_ints(unit_list)
    n_launched = ctypes.c_int(0)
    _call("fw_gather", src.shape[0], src.data_ptr(), acc.data_ptr(), len(pairs),
          src_p, dst_p, rb_p, unit_p, group, ctypes.addressof(n_launched), _stream(src))
    gather_launches += n_launched.value
    return new_states


def coverage_stage(spec, cvalid, depth, depth_cap, mask, cond, ant, ebits_after, flag,
                   idx):
    """The coverage vector of a wave on CPU tensors: ``coverage_plain``. On
    the card no stage of its own computes it: ``kernel_chain`` has
    ``fw_frontier`` and ``fw_compact`` add it, so a CUDA tensor raises."""
    if flag.device.type != "cpu":
        raise ValueError("the fused chain's coverage runs inside fw_frontier and fw_compact; "
                         "coverage_stage takes CPU tensors only")
    return coverage_plain(spec, cvalid, depth, depth_cap, mask, cond, ant, ebits_after,
                          flag, idx)


def _check_inputs(table, named):
    for name, x, dtype, shape in named:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be a {shape} {dtype} tensor, got "
                f"{tuple(x.shape)} {x.dtype}"
            )
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, the table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def kernel_chain(spec, table, hi, lo, ebits, depth, depth_cap, cond, cvalid,
                 kin, cand_flat, mark=None, mask=None, ant=None, taps=None):
    """Every kernel of the wave, launched back to back on the current
    stream over the model stage's outputs (``model_stage`` and
    ``keys_input``, and with coverage on ``antecedent_stage``'s ``ant``);
    counts one launch. ``mask`` (F,) bool marks the live frontier lanes
    (None: all). With ``spec.cov_layout`` set (coverage on; ``ant`` then
    required) the wave's coverage vector rides in the counters' buffer,
    after them: ``fw_frontier`` zeroes it with the counters and adds its
    frontier half, ``fw_compact`` its fresh half. ``mark(name)``, when
    given, is called before each stage and once after the last
    (``chip_smoke.py`` records CUDA events there). ``taps``, a dict when
    given, receives the scratch the coverage halves read (``ebits_after``,
    the sweep's ``flag`` and the sorted ``idx``), the sorted ``key`` the
    dedup and the compaction read, the dedup's ``active`` and ``starts``,
    the gather's (``src``, ``acc``) and ``cov``.
    Returns ``(table, out)``."""
    global launches

    mark = mark or (lambda name: None)
    cap = _check_capacity(table)
    F, A, P = hi.shape[0], spec.action_count, len(spec.conditions)
    cov_size = 0
    if spec.cov_layout is not None:
        if ant is None:
            raise ValueError("a wave with coverage on needs the antecedent matrix (ant)")
        cov_size = spec.cov_layout.size
    launches += 1
    acc = torch.empty(4 + P + cov_size, dtype=torch.int64, device=table.device)
    cov = acc[4 + P:] if cov_size else None
    mark("frontier")
    ebits_after = frontier_stage(spec, cond, cvalid, ebits, depth, depth_cap, acc,
                                 mask, ant if cov_size else None)
    mark("keys")
    key, idx = route_keys_stage(spec, kin, cand_flat, cvalid, depth, depth_cap, acc,
                                mask)
    mark("sort")
    sort_stage(key, idx)
    mark("dedup")
    active, starts = dedup_stage(key, idx, cap, cvalid, A, depth, depth_cap, mask)
    mark("sweep")
    flag, _scratch = sweep_stage(table, key, active, starts, acc)
    mark("compact")
    stats = torch.empty(5 + 3 * P, dtype=torch.int64, device=table.device)
    c = compact_stage(flag, key, idx, A, ebits_after, depth, hi, lo, acc, cov, stats)
    if taps is not None:
        taps.update(ebits_after=ebits_after, flag=flag, key=key, idx=idx, active=active,
                    starts=starts, src=c["src"], acc=acc, cov=cov)
    mark("gather")
    new_states = gather_stage(c["src"], acc, cand_flat)
    mark(None)
    new = {"states": new_states}
    new.update((k, c[k]) for k in ("hi", "lo", "ebits", "depth"))
    out = {"stats": stats, "new": new, "parent_hi": c["parent_hi"],
           "parent_lo": c["parent_lo"]}
    if cov is not None:
        out["cov"] = cov
    return table, out


def fused_wave(spec, table, states, hi, lo, ebits, depth, depth_cap, mask=None):
    """One wave over F frontier states (``hi``, ``lo``, ``ebits`` and
    ``depth`` are ``(F,)`` int64; ``mask``, ``(F,)`` bool, marks the live
    lanes, None meaning all). Returns ``(table, out)`` as the module
    docstring says. A CPU table runs ``fused_wave_plain``; a CUDA table
    runs the model stage in torch and launches the kernels, or raises."""
    if table.device.type == "cpu":
        return fused_wave_plain(spec, table, states, hi, lo, ebits, depth, depth_cap,
                                mask)
    if table.device.type != "cuda":
        raise ValueError(f"no fused wave kernels for device {table.device}")
    _check_capacity(table)
    if table.data_ptr() % 16 or not table.is_contiguous():
        raise ValueError("table must be contiguous and 16-byte aligned")
    P = len(spec.conditions)
    if P > MAX_PROPS or len(spec.expectations) != P:
        raise ValueError(
            f"the fused wave takes at most {MAX_PROPS} properties, one "
            f"expectation each; got {P} conditions, "
            f"{len(spec.expectations)} expectations"
        )
    F = hi.shape[0]
    B = F * spec.action_count
    cond, cvalid, cand_flat = model_stage(spec, states, F)
    ant = antecedent_stage(spec, states, F) if spec.cov_layout is not None else None
    kin = keys_input(spec, cand_flat)
    if spec.keys_route == "pairs":
        keyed = [("chi", kin[0], torch.int64, (B,)), ("clo", kin[1], torch.int64, (B,))]
    else:
        keyed = []
    _check_inputs(table, [
        ("hi", hi, torch.int64, (F,)),
        ("lo", lo, torch.int64, (F,)),
        ("ebits", ebits, torch.int64, (F,)),
        ("depth", depth, torch.int64, (F,)),
        ("cond", cond, torch.bool, (P, F)),
        ("cvalid", cvalid, torch.bool, (B,)),
    ] + keyed + ([] if mask is None else [("mask", mask, torch.bool, (F,))])
      + ([] if ant is None else [("ant", ant, torch.bool, (P, F))]))
    return kernel_chain(spec, table, hi, lo, ebits, depth, depth_cap, cond,
                        cvalid, kin, cand_flat, mask=mask, ant=ant)
