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
  radix sort of the keys, dedup and
  tile ranges, the tile sweep shared with the insert kernel
  (``csrc/tile_sweep.cuh``), compaction of the fresh keys, and the stats.

The Pallas kernel fingerprints with the model's own ``fp_fn``
(``pallas_wave.py:180``). A model takes one of three key routes, chosen once
by the checker (``keys_route``), none falling back to another:

- ``"fold"``: the model keeps the default fold; ``fw_keys`` hashes the
  candidates' u32 words (``state_words``);
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
``stats`` once and slices. u32 values ride in int64, as everywhere in
the port. An optional ``(F,)`` bool ``mask`` marks the live frontier
lanes (None: all live): the deep drain's fixed-width ring takes carry
stale rows in their masked lanes, and no stage reads those unmasked.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.batch import map_leaves
from .fingerprint import (
    component_seeds,
    fingerprint_state,
    lin_consts,
    multiset_salts,
    row_salts,
    state_words,
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
    "comphash_keys_stage",
    "comphash_tables",
    "fused_wave",
    "fused_wave_plain",
    "keys_input",
    "keys_pairs_stage",
    "keys_plain",
    "kernel_chain",
    "launches",
    "model_stage",
    "sorted_dedup",
    "torch_wave",
]

# Fused waves launched on the card in this process (each is one run of
# ``kernel_chain``), and of them the ones whose keys stage was
# ``fw_comphash_keys``.
launches = 0
comphash_launches = 0
KEY_ROUTES = ("fold", "comphash", "pairs")

KINDS = {"always": 0, "sometimes": 1, "eventually": 2}
MAX_PROPS = 64  # csrc/fused_wave.cu: MAX_PROPS
_SORT_TILE = 2048  # csrc/fused_wave.cu: SORT_TILE
_COMPACT_TILE = 1024  # csrc/fused_wave.cu: COMPACT_TILE
_SENTINEL = (1 << 63) - 1  # sort_key of the (MAX, MAX) invalid-lane key


@dataclasses.dataclass(frozen=True, eq=False)
class FusedWaveSpec:
    """What a wave closes over, so the wave stays checker-agnostic:
    the model's batched callables, the property kinds as strings
    (``"always" | "sometimes" | "eventually"``, aligned with
    ``conditions``), the (property index, eventually bit) pairs, the
    action count, the model's ``packed_fingerprint`` and the fused wave's
    key route (``KEY_ROUTES``; ``comphash`` holds ``comphash_tables`` on
    the ``"comphash"`` route)."""

    expand: Callable
    within_boundary: Callable
    conditions: Tuple[Callable, ...]
    expectations: Tuple[str, ...]
    ebit: Tuple[Tuple[int, int], ...]
    action_count: int
    fingerprint: Callable = fingerprint_state
    keys_route: str = "fold"
    comphash: Optional[dict] = None


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
    if spec.conditions:
        cond = torch.stack([c(states).to(torch.bool) for c in spec.conditions])
    else:
        cond = torch.zeros((0, F), dtype=torch.bool, device=cvalid.device)
    return cond.contiguous(), cvalid, cand_flat


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
    eval_mask = depth < depth_cap
    if mask is not None:
        eval_mask = eval_mask & mask
    ebits_after = ebits
    for pi, b in spec.ebit:
        ebits_after = torch.where(cond[pi], ebits_after & ~(1 << b), ebits_after)
    cvalid = (cvalid.view(F, A) & eval_mask[:, None]).reshape(F * A)
    terminal = eval_mask & ~cvalid.view(F, A).any(dim=1)
    return eval_mask, ebits_after, cvalid, terminal


def _stats(spec, cond, eval_mask, terminal, ebits_after, hi, lo, depth,
           generated, fresh, pending, mask=None):
    """The stats vector: counts (the max depth over the live lanes), then
    each property's hit and the fingerprint of its first hit lane (lane 0
    when none hit, as ``jnp.argmax``)."""
    zero = torch.zeros((), dtype=torch.int64, device=hi.device)
    F = hi.shape[0]
    ebit = dict(spec.ebit)
    hits, props = [], []
    for i, kind in enumerate(spec.expectations):
        if kind == "always":
            h = eval_mask & ~cond[i]
        elif kind == "sometimes":
            h = eval_mask & cond[i]
        else:  # eventually: unmet bit at a terminal state
            h = terminal & (((ebits_after >> ebit[i]) & 1) == 1)
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


def torch_wave(spec, table, states, hi, lo, ebits, depth, depth_cap, mask=None):
    """The whole wave in torch, fingerprinting with ``spec.fingerprint``
    (the model's ``packed_fingerprint``), with the visited-set insert
    through ``hashset_insert_sorted`` (the CUDA kernel on a CUDA table, its
    plain twin on a CPU table). It is the staged path of ``checker/gpu.py``
    and, on a CPU table, ``fused_wave_plain``. ``mask`` (F,) bool marks
    the live lanes; None means every lane is live. Masked lanes may hold
    stale rows: nothing of them reaches the outputs."""
    F, A = hi.shape[0], spec.action_count
    B = F * A
    cond, cvalid, cand_flat = model_stage(spec, states, F)
    eval_mask, ebits_after, cvalid, terminal = _frontier_plain(
        spec, cond, cvalid, ebits, depth, depth_cap, mask
    )
    chi, clo = spec.fingerprint(cand_flat)
    shi, slo, sidx, unique = sorted_dedup(chi, clo, cvalid)
    table, fresh, _found, pending = hashset_insert_sorted(
        table, u32_to_i32(shi), u32_to_i32(slo), unique
    )
    stats = _stats(spec, cond, eval_mask, terminal, ebits_after, hi, lo,
                   depth, cvalid.sum(), fresh, pending, mask)
    # Cumsum compaction: fresh key i (in sorted order) goes to slot
    # rank(i); the rows past n_new are unspecified (here lane 0's).
    slot = torch.where(fresh, torch.cumsum(fresh, 0) - 1, B)
    src = torch.zeros(B + 1, dtype=torch.int64, device=hi.device)
    src[slot] = sidx
    src = src[:B]
    parent = src // A
    new = {
        "states": map_leaves(lambda x: x[src], cand_flat),
        "hi": chi[src],
        "lo": clo[src],
        "ebits": ebits_after[parent],
        "depth": depth[parent] + 1,
    }
    out = {"stats": stats, "new": new, "parent_hi": hi[parent],
           "parent_lo": lo[parent]}
    return table, out


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
    "fw_frontier": [_c_i64, _c_int, _c_i64] + [_c_ptr] * 6 + [_c_int] + [_c_ptr] * 4,
    "fw_keys": [_c_i64, _c_int, _c_int] + [_c_ptr] * 4 + [_c_i64] + [_c_ptr] * 4,
    "fw_keys_pairs": [_c_i64, _c_int] + [_c_ptr] * 5 + [_c_i64] + [_c_ptr] * 4,
    "fw_comphash_keys": [_c_i64] + [_c_int] * 6 + [_c_ptr] * 11 + [_c_i64] + [_c_ptr] * 4,
    "fw_sort": [_c_i64] + [_c_ptr] * 6,
    "fw_dedup": [_c_i64] + [_c_ptr] * 3 + [_c_int] * 2 + [_c_ptr],
    "fw_sweep": [_c_ptr] * 4 + [_c_i64] + [_c_int] * 2 + [_c_ptr] * 4,
    "fw_compact": [_c_i64, _c_int] + [_c_ptr] * 17,
    "fw_gather": [_c_i64, _c_ptr, _c_ptr, _c_int] + [_c_ptr] * 5,
    "fw_stats": [_c_int, _c_i64] + [_c_ptr] * 5,
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


def frontier_stage(spec, cond, cvalid, ebits, depth, depth_cap, acc, mask=None):
    """Stage (a): resets ``acc`` and returns ``ebits_after``; ``acc``
    gathers the max depth of the live lanes (``mask``; None: all) and each
    property's first hit lane."""
    F, P = depth.shape[0], len(spec.conditions)
    ebit = dict(spec.ebit)
    kinds, kind_p = _host_ints([KINDS[k] for k in spec.expectations])
    bits, bit_p = _host_ints([ebit.get(i, -1) for i in range(P)])
    ebits_after = torch.empty_like(ebits)
    _call("fw_frontier", F, spec.action_count, int(depth_cap), cond.data_ptr(),
          cvalid.data_ptr(), depth.data_ptr(), ebits.data_ptr(), _ptr(mask),
          ebits_after.data_ptr(), P, kind_p, bit_p, acc.data_ptr(),
          _stream(depth))
    return ebits_after


def keys_stage(words, cvalid, depth=None, depth_cap=0, action_count=1, acc=None,
               mask=None):
    """Stage (b): ``(key, idx)``, each lane's fingerprint as the int64 bits
    of ``(hi << 32) | lo`` (all ones for a lane that is not valid: not
    ``cvalid``, with ``mask`` a lane of a frontier lane that is not live,
    or, with ``depth``, at or past ``depth_cap``) and the lane index
    (int32). Counts the valid lanes into ``acc`` when given."""
    B, W = words.shape
    key = torch.empty(B, dtype=torch.int64, device=words.device)
    idx = torch.empty(B, dtype=torch.int32, device=words.device)
    _call("fw_keys", B, action_count, W, words.data_ptr(), cvalid.data_ptr(),
          _ptr(depth), _ptr(mask), int(depth_cap), key.data_ptr(),
          idx.data_ptr(), _ptr(acc), _stream(words))
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
    ``CompHash`` order (actor row ‖ timer, envelope row, digest, history,
    then the tags' seeds), the same ``lin_consts`` and ``component_seeds``
    as ``ops/fingerprint.py``. Made once, before any capture."""
    N, R, W, H = layout["N"], layout["R"], layout["W"], layout["H"]
    if (layout["actor_tag"], layout["network_tag"], layout["history_tag"]) != (
        0, N, N + 1
    ):
        raise ValueError(f"fw_comphash_keys takes tags 0..N+1, got {layout}")
    parts = []
    for width, salts in ((R + 1, row_salts), (3 + W, multiset_salts), (4, row_salts),
                         (H, row_salts)):
        if width:
            parts += [lin_consts(width, salt) for salt in salts(width)]
    C = N + 1 + (1 if H else 0)
    parts += [x.numpy() for x in component_seeds(list(range(C)))]
    consts = np.concatenate([np.asarray(p, np.int64) for p in parts])
    return {"layout": dict(layout), "consts": torch.from_numpy(consts).to(device)}


def comphash_keys_stage(tables, cand_flat, cvalid, depth=None, depth_cap=0,
                        action_count=1, acc=None, mask=None):
    """Stage (b) on the ``"comphash"`` route: ``keys_stage`` with each
    valid lane's ``PackedActorModel.packed_fingerprint``, computed by
    ``fw_comphash_keys`` from the candidate leaves (int64, contiguous);
    counts one ``comphash_launches``."""
    global comphash_launches

    lay = tables["layout"]
    N, R, E, W, H = (lay[k] for k in ("N", "R", "E", "W", "H"))
    rows_k, timers_k = lay["actors"]
    leaves = [cand_flat[rows_k], cand_flat[timers_k]] + [cand_flat[k] for k in lay["network"]]
    hist = cand_flat[lay["history"]] if lay["history"] else None
    B = cvalid.shape[0]
    shapes = [(B, N, R), (B, N), (B, E), (B, E), (B, E, W), (B, E)]
    for x, shape in zip(leaves + ([hist] if hist is not None else []),
                        shapes + [(B, H)]):
        if x.dtype != torch.int64 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"fw_comphash_keys takes contiguous int64 leaves of shape {shape}, "
                f"got {tuple(x.shape)} {x.dtype}"
            )
    comphash_launches += 1
    key = torch.empty(B, dtype=torch.int64, device=cvalid.device)
    idx = torch.empty(B, dtype=torch.int32, device=cvalid.device)
    _call("fw_comphash_keys", B, action_count, N, R, E, W, H,
          *(x.data_ptr() for x in leaves), _ptr(hist), tables["consts"].data_ptr(),
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
    """What the keys stage reads, by ``spec.keys_route``: the candidates'
    u32 words (``"fold"``), the model's own (hi, lo) pairs, computed here
    in torch (``"pairs"``), or nothing (``"comphash"``: the kernel reads
    the candidate leaves)."""
    if spec.keys_route == "fold":
        return state_words(cand_flat)
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


def sort_stage(key, idx):
    """Stage (c): sorts ``key`` as unsigned 64-bit values, stably, carrying
    ``idx``, in place."""
    n = key.shape[0]
    nb = max(1, -(-n // _SORT_TILE))
    key_tmp, idx_tmp = torch.empty_like(key), torch.empty_like(idx)
    hist = torch.empty(256 * nb, dtype=torch.int32, device=key.device)
    _call("fw_sort", n, key.data_ptr(), idx.data_ptr(), key_tmp.data_ptr(),
          idx_tmp.data_ptr(), hist.data_ptr(), _stream(key))
    return key, idx


def dedup_stage(key, capacity):
    """Stage (d): ``(active, starts)``, the first occurrence of each valid
    sorted key, and the ``(n_tiles + 1,)`` bounds of each tile's keys."""
    B, n_tiles = key.shape[0], capacity // TILE_ROWS
    active = torch.empty(B, dtype=torch.bool, device=key.device)
    starts = torch.empty(n_tiles + 1, dtype=torch.int64, device=key.device)
    _call("fw_dedup", B, key.data_ptr(), active.data_ptr(), starts.data_ptr(),
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


def compact_stage(flag, key, idx, action_count, ebits_after, depth, hi, lo, acc):
    """Stage (f): writes ``n_new`` into ``acc`` and returns the B-row
    per-lane outputs and ``src``, each slot's candidate lane."""
    B = key.shape[0]
    bsum = torch.empty(max(1, -(-B // _COMPACT_TILE)), dtype=torch.int32,
                       device=key.device)
    out = {k: torch.empty(B, dtype=torch.int64, device=key.device)
           for k in ("hi", "lo", "ebits", "depth", "parent_hi", "parent_lo", "src")}
    _call("fw_compact", B, action_count, flag.data_ptr(), key.data_ptr(),
          idx.data_ptr(), ebits_after.data_ptr(), depth.data_ptr(), hi.data_ptr(),
          lo.data_ptr(), bsum.data_ptr(), acc.data_ptr(), out["hi"].data_ptr(),
          out["lo"].data_ptr(), out["ebits"].data_ptr(), out["depth"].data_ptr(),
          out["parent_hi"].data_ptr(), out["parent_lo"].data_ptr(),
          out["src"].data_ptr(), _stream(key))
    return out


def _unit(row_bytes, *ptrs):
    u = 8
    while u > 1 and (row_bytes % u or any(p % u for p in ptrs)):
        u //= 2
    return u


def gather_stage(src, acc, cand_flat):
    """Stage (f), leaves: the first ``n_new`` rows of each candidate leaf,
    gathered by ``src`` as byte rows (any dtype); B rows each."""
    pairs = []

    def alloc(x):
        dst = torch.empty_like(x)
        pairs.append((x, dst))
        return dst

    new_states = map_leaves(alloc, cand_flat)
    rows = [x[0].numel() * x.element_size() if x.shape[0] else 0 for x, _ in pairs]
    srcs, src_p = _host_ints([x.data_ptr() for x, _ in pairs], ctypes.c_uint64)
    dsts, dst_p = _host_ints([d.data_ptr() for _, d in pairs], ctypes.c_uint64)
    rbs, rb_p = _host_ints(rows, ctypes.c_int64)
    units, unit_p = _host_ints(
        [_unit(rb, x.data_ptr(), d.data_ptr()) for rb, (x, d) in zip(rows, pairs)]
    )
    _call("fw_gather", src.shape[0], src.data_ptr(), acc.data_ptr(), len(pairs),
          src_p, dst_p, rb_p, unit_p, _stream(src))
    return new_states


def stats_stage(P, acc, hi, lo):
    """The ``(5 + 3P,)`` int64 stats vector, reduced in one block."""
    stats = torch.empty(5 + 3 * P, dtype=torch.int64, device=acc.device)
    _call("fw_stats", P, hi.shape[0], acc.data_ptr(), hi.data_ptr(),
          lo.data_ptr(), stats.data_ptr(), _stream(acc))
    return stats


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
                 kin, cand_flat, mark=None, mask=None):
    """Every kernel of the wave, launched back to back on the current
    stream over the model stage's outputs (``model_stage`` and
    ``keys_input``); counts one launch. ``mask`` (F,) bool marks the live
    frontier lanes (None: all). ``mark(name)``, when given, is called
    before each stage and once after the last (``chip_smoke.py`` records
    CUDA events there). Returns ``(table, out)``."""
    global launches

    mark = mark or (lambda name: None)
    cap = _check_capacity(table)
    F, A, P = hi.shape[0], spec.action_count, len(spec.conditions)
    launches += 1
    acc = torch.empty(4 + P, dtype=torch.int64, device=table.device)
    mark("frontier")
    ebits_after = frontier_stage(spec, cond, cvalid, ebits, depth, depth_cap, acc,
                                 mask)
    mark("keys")
    key, idx = route_keys_stage(spec, kin, cand_flat, cvalid, depth, depth_cap, acc,
                                mask)
    mark("sort")
    sort_stage(key, idx)
    mark("dedup")
    active, starts = dedup_stage(key, cap)
    mark("sweep")
    flag, _scratch = sweep_stage(table, key, active, starts, acc)
    mark("compact")
    c = compact_stage(flag, key, idx, A, ebits_after, depth, hi, lo, acc)
    mark("gather")
    new_states = gather_stage(c["src"], acc, cand_flat)
    mark("stats")
    stats = stats_stage(P, acc, hi, lo)
    mark(None)
    new = {"states": new_states}
    new.update((k, c[k]) for k in ("hi", "lo", "ebits", "depth"))
    out = {"stats": stats, "new": new, "parent_hi": c["parent_hi"],
           "parent_lo": c["parent_lo"]}
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
    kin = keys_input(spec, cand_flat)
    if spec.keys_route == "fold":
        keyed = [("words", kin, torch.int64, (B, kin.shape[1]))]
    elif spec.keys_route == "pairs":
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
    ] + keyed + ([] if mask is None else [("mask", mask, torch.bool, (F,))]))
    return kernel_chain(spec, table, hi, lo, ebits, depth, depth_cap, cond,
                        cvalid, kin, cand_flat, mask=mask)
