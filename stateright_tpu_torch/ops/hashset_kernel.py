"""The visited-set insert for sorted batches: CUDA kernel and plain twin.

``hashset_insert_sorted`` is the port of the JAX package's TPU kernel
``ops/pallas_hashset.py::pallas_hashset_insert``. For a CUDA table it
launches the hand-written kernel ``csrc/hashset_insert.cu`` (built on
first use, see ``ops/_build.py``) or raises; for a CPU table it runs
``hashset_insert_sorted_plain``, the plain torch twin, which is the
specification the kernel is tested against. Nothing falls back from one
to the other.

Contract (the Pallas kernel's, bit for bit): the table is
``(cap + MAX_PROBES, 2)`` ``int32`` holding u32 (hi, lo) rows, with
``cap`` a power of two and a multiple of ``TILE_ROWS``; ``key_hi`` and
``key_lo`` are ``(B,)`` ``int32`` u32 bit patterns sorted ascending by the
unsigned pair (hi, lo) over all lanes (inactive lanes are the checkers'
(MAX, MAX) sentinels, sorted last); ``active`` is ``(B,)`` bool. The keys
are resolved one at a time in order against one table: a match before the
first empty row of the key's ``MAX_PROBES``-row window is ``found``,
otherwise the key claims that empty row and is ``fresh``, otherwise it is
``pending``. The table is updated in place and returned with the three
``(B,)`` bool flags.
"""

from __future__ import annotations

import ctypes

import torch

from .fingerprint import U32, salt_keys
from .hashset import MAX_PROBES, _home, i32_to_u32, u32_to_i32

__all__ = [
    "TILE_ROWS",
    "hashset_insert_sorted",
    "hashset_insert_salted",
    "hashset_insert_sorted_plain",
    "hashset_insert_unsorted",
    "launches",
    "round_table_capacity",
    "sort_key",
    "split_key",
    "sweep_scratch",
    "tile_starts",
    "tiles_redone",
]

# Table rows per tile: a 2,048-row tile plus its apron is a 17,408-byte
# window, which the kernel keeps in shared memory.
TILE_ROWS = 2048

# Kernel launches made by ``hashset_insert_sorted`` in this process.
launches = 0

_INT64_MIN = -(1 << 63)


def round_table_capacity(capacity: int) -> int:
    """The smallest power-of-two multiple of ``TILE_ROWS`` that holds
    ``capacity`` rows."""
    c = max(int(capacity), TILE_ROWS)
    return 1 << (c - 1).bit_length()


def _check_capacity(table: torch.Tensor) -> int:
    if table.dim() != 2 or table.shape[1] != 2 or table.dtype != torch.int32:
        raise ValueError(
            "table must be an int32 tensor of shape (capacity + "
            f"{MAX_PROBES}, 2), got {tuple(table.shape)} {table.dtype}"
        )
    cap = table.shape[0] - MAX_PROBES
    if cap <= 0 or cap & (cap - 1) or cap % TILE_ROWS:
        raise ValueError(
            f"table capacity must be a power of two and a multiple of "
            f"TILE_ROWS={TILE_ROWS}, got {cap}"
        )
    return cap


def _check_keys(table, key_hi, key_lo, active) -> None:
    B = key_hi.shape[0] if key_hi.dim() == 1 else -1
    for name, x, dtype in (
        ("key_hi", key_hi, torch.int32),
        ("key_lo", key_lo, torch.int32),
        ("active", active, torch.bool),
    ):
        if x.dim() != 1 or x.shape[0] != B or x.dtype != dtype:
            raise ValueError(
                f"{name} must be a ({B},) {dtype} tensor, got "
                f"{tuple(x.shape)} {x.dtype}"
            )
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, the table on {table.device}")


def sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the unsigned order of the u32
    (hi, lo) pairs (carried in int64): ``torch.sort`` of these is the sort
    by (hi, lo)."""
    return ((hi << 32) | lo) ^ _INT64_MIN


def split_key(key: torch.Tensor):
    """The inverse of ``sort_key``: the u32 (hi, lo) pair, in int64."""
    k = key ^ _INT64_MIN
    return (k >> 32) & U32, k & U32


def _validate_batch(key_hi, key_lo, active) -> None:
    """Refuses what the kernel does not take: unsorted keys, and active
    (0, 0) keys (the empty-row sentinel)."""
    hi, lo = i32_to_u32(key_hi), i32_to_u32(key_lo)
    k = sort_key(hi, lo)
    if k.shape[0] > 1 and bool((k[1:] < k[:-1]).any()):
        raise ValueError("keys must be sorted ascending by unsigned (hi, lo)")
    if bool((active & (hi == 0) & (lo == 0)).any()):
        raise ValueError("an active key is (0, 0), the empty-row sentinel")


def tile_starts(key_hi: torch.Tensor, capacity: int) -> torch.Tensor:
    """``(n_tiles + 1,)`` int64 bounds of each tile's key range: the homes
    of sorted keys are monotone, so tile ``t`` owns keys
    ``[starts[t], starts[t + 1])``."""
    homes = _home(i32_to_u32(key_hi), capacity)
    n_tiles = capacity // TILE_ROWS
    bounds = torch.arange(
        0, n_tiles + 1, dtype=torch.int64, device=key_hi.device
    ) * TILE_ROWS
    starts = torch.searchsorted(homes, bounds)
    starts[:1].zero_()  # in place: no host value, so a graph can capture it
    return starts


def hashset_insert_sorted(table, key_hi, key_lo, active):
    """Inserts a sorted batch; returns ``(table, fresh, found, pending)``.

    A CUDA table launches the CUDA kernel (or raises), which trusts the
    caller's sort as the Pallas kernel does; a CPU table runs the plain
    twin after refusing unsorted keys and active (0, 0) keys."""
    cap = _check_capacity(table)
    _check_keys(table, key_hi, key_lo, active)
    if table.device.type == "cpu":
        _validate_batch(key_hi, key_lo, active)
        return hashset_insert_sorted_plain(table, key_hi, key_lo, active)
    if table.device.type != "cuda":
        raise ValueError(f"no insert kernel for device {table.device}")
    for name, x in (("table", table), ("key_hi", key_hi),
                    ("key_lo", key_lo), ("active", active)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    B = key_hi.shape[0]
    flags = [torch.empty(B, dtype=torch.bool, device=table.device) for _ in range(3)]
    if B:
        _launch(table, key_hi, key_lo, active, tile_starts(key_hi, cap), *flags)
    return (table, *flags)


def hashset_insert_unsorted(table, key_hi, key_lo, active):
    """Inserts a batch in lane order, duplicates allowed; returns
    ``(table, fresh, found, pending)`` in lane order.

    The JAX package's ``ops/hashset.py::hashset_insert_unsorted`` contract,
    which its swarm's visited sample inserts through: exactly one lane per
    distinct new key reports ``fresh`` (the lowest lane, as the JAX owner
    ticket, a scatter-min of lane ids, picks), its duplicates report
    ``found``, a key already in the table is ``found`` in every lane, and a
    key whose ``MAX_PROBES`` window is full is ``pending`` in every lane.
    The table's layout is this package's (each key at the first empty row
    of its window, claimed in key order), not the JAX race's, so the two
    tables hold the same key set in other rows.

    The keys are sorted stably by ``sort_key`` (inactive lanes take the
    (MAX, MAX) sentinel and sort last), the first active occurrence of
    each key goes through ``hashset_insert_sorted`` (the CUDA kernel on a
    CUDA table, the plain twin on the CPU), and the flags go back to lane
    order.
    Nothing reads a host value, so the call runs inside a captured CUDA
    Graph."""
    hi, lo = i32_to_u32(key_hi), i32_to_u32(key_lo)
    key = torch.where(active, sort_key(hi, lo), torch.full_like(hi, ~_INT64_MIN))
    skey, order = torch.sort(key, stable=True)
    B = skey.shape[0]
    sactive = active[order]
    # A group starts at a new key, and also where the active flag changes:
    # an active (MAX, MAX) key shares the inactive lanes' sentinel, and
    # must not be taken for a duplicate of an inactive lane before it.
    first = torch.ones_like(active)
    first[1:] = (skey[1:] != skey[:-1]) | (sactive[1:] != sactive[:-1])
    shi, slo = split_key(skey)
    table, fresh, found, pending = hashset_insert_sorted(
        table, u32_to_i32(shi), u32_to_i32(slo), sactive & first)
    # Each duplicate takes its key's first occurrence's outcome: found
    # where that one was fresh or found, pending where it was pending.
    pos = torch.arange(B, dtype=torch.int64, device=skey.device)
    head = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    dup = sactive & ~first
    found = found | (dup & (fresh[head] | found[head]))
    pending = pending | (dup & pending[head])
    out = []
    for flag in (fresh, found, pending):
        lane = torch.empty_like(flag)
        lane[order] = flag
        out.append(lane)
    return (table, *out)


def hashset_insert_salted(table, key_hi, key_lo, salt_hi, salt_lo, active):
    """The tenant-salted insert of a packed multi-tenant wave
    (``checker/packed_tenancy.py``; the JAX package's
    ``ops/hashset.py::hashset_insert_salted``): each lane's (hi, lo) key is
    XOR-salted by its tenant's salt (``ops/fingerprint.py::salt_keys``;
    per-lane tensors or scalars), then ``hashset_insert_unsorted`` inserts
    the batch, the kernel on a CUDA table. The flags come back in lane
    order and the lowest lane of each new key is the fresh one, so each
    tenant's fresh lanes keep its own frontier order."""
    shi, slo = salt_keys(i32_to_u32(key_hi), i32_to_u32(key_lo), salt_hi, salt_lo)
    return hashset_insert_unsorted(table, shi, slo, active)


def _kernel():
    """The C entry point of ``csrc/hashset_insert.cu``, built and typed on
    first use."""
    from ._build import load

    fn = load("hashset_insert").hashset_insert_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 5
    )
    return fn


def sweep_scratch(B: int, n_tiles: int, device) -> torch.Tensor:
    """The tile sweep's scratch (``csrc/tile_sweep.cuh``): the count of
    tiles its ordered repair redid (int32, padded to 8 bytes), each tile's
    end (u64), a spill byte per tile and an outcome byte per sorted
    position."""
    return torch.empty(8 + 9 * n_tiles + B, dtype=torch.uint8, device=device)


def tiles_redone(scratch: torch.Tensor) -> int:
    """How many tiles the sweep that used ``scratch`` redid in order
    (synchronises)."""
    return int(scratch[:4].view(torch.int32)[0])


def _launch(table, key_hi, key_lo, active, starts, fresh, found, pending):
    """Launches the kernel on the current stream (no sync) over checked
    inputs, the tile bounds ``starts`` and the allocated flags; counts it
    and returns the sweep's scratch."""
    global launches

    cap = table.shape[0] - MAX_PROBES
    B, n_tiles = key_hi.shape[0], cap // TILE_ROWS
    scratch = sweep_scratch(B, n_tiles, table.device)
    launch = _kernel()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    launches += 1
    err = launch(
        table.data_ptr(), key_hi.data_ptr(), key_lo.data_ptr(),
        active.data_ptr(), starts.data_ptr(), B, n_tiles,
        cap.bit_length() - 1, fresh.data_ptr(), found.data_ptr(),
        pending.data_ptr(), scratch.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"hashset_insert kernel launch failed: cudaError {err}")
    return scratch


# -- the plain twin ------------------------------------------------------

_CLAIM, _FOUND, _PENDING = 0, 1, 2


def _first_match(rows: torch.Tensor, home, keys, chunk: int = 1 << 13):
    """Offset of each key's first match in its probe window of the given
    row keys (``MAX_PROBES`` when absent)."""
    probe = torch.arange(MAX_PROBES, dtype=torch.int64)
    out = torch.empty_like(home)
    for s in range(0, home.shape[0], chunk):
        hit = torch.take(rows, home[s : s + chunk, None] + probe) == keys[s : s + chunk, None]
        out[s : s + chunk] = torch.where(
            hit.any(dim=1), hit.to(torch.int8).argmax(dim=1),
            torch.full_like(home[s : s + chunk], MAX_PROBES),
        )
    return out


def hashset_insert_sorted_plain(table, key_hi, key_lo, active):
    """The plain torch twin of the kernel (CPU). Same contract, same
    table and flags bit for bit, without a per-key loop:

    - Only the first active copy of each key decides; a later copy is
      ``found`` unless the first copy was ``pending``.
    - Homes are monotone, so claims consume the table's initially empty
      rows in increasing order: a claim takes the first empty row at or
      after ``max(home, last claim + 1)``. With ``g`` the rank of the first
      empty row at or after a key's home, the claims' ranks are
      ``s_j = max(g_j, s_{j-1} + 1)``, a running maximum (``cummax``).
    - A key is ``found`` when its first match in the initial table lies
      before the row it would claim, and ``pending`` when that row lies
      past its window. Each key is first assumed found when the initial
      table matches it in its window and claiming otherwise; the first key
      whose outcome disagrees with the assumption is fixed and everything
      after it is recomputed, so the loop runs once per pending key (rare
      by design) and once more."""
    cap = _check_capacity(table)
    hi, lo = i32_to_u32(key_hi), i32_to_u32(key_lo)
    B = hi.shape[0]
    fresh = torch.zeros(B, dtype=torch.bool)
    found = torch.zeros(B, dtype=torch.bool)
    pending = torch.zeros(B, dtype=torch.bool)
    lanes = torch.nonzero(active).squeeze(1)
    if lanes.numel() == 0:
        return table, fresh, found, pending
    khi, klo = hi[lanes], lo[lanes]
    keys = (khi << 32) | klo
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    group = torch.cumsum(first.to(torch.int64), 0) - 1
    uhi, ulo, ukey = khi[first], klo[first], keys[first]
    home = _home(uhi, cap)
    U = ukey.shape[0]

    rows = (i32_to_u32(table[:, 0]) << 32) | i32_to_u32(table[:, 1])
    m0 = _first_match(rows, home, ukey)
    # Initially empty rows in order, padded with a row past every window.
    free = torch.cat([
        torch.nonzero(rows == 0).squeeze(1),
        torch.tensor([cap + 2 * MAX_PROBES], dtype=torch.int64),
    ])
    g = torch.searchsorted(free, home)
    match_row = torch.where(m0 < MAX_PROBES, home + m0, torch.full_like(home, -1))

    cls = torch.where(m0 < MAX_PROBES, _FOUND, _CLAIM).to(torch.int8)
    rank = torch.full((U,), -1, dtype=torch.int64)
    start, s_prev = 0, -1
    while start < U:
        c = cls[start:]
        claim = c == _CLAIM
        gs = g[start:]
        gc = gs[claim]
        j = torch.arange(gc.shape[0], dtype=torch.int64)
        s = torch.maximum(
            j + torch.cummax(gc - j, 0).values if gc.numel() else j,
            s_prev + 1 + j,
        )
        # Last claimed rank before each key (s_prev for the first).
        last = torch.full((c.shape[0],), -1, dtype=torch.int64)
        last[claim] = s
        last = torch.cummax(last, 0).values
        before = torch.cat([torch.tensor([s_prev]), last[:-1]])
        before = torch.maximum(before, torch.full_like(before, s_prev))
        cur = torch.maximum(gs, before + 1)
        empty_row = free[cur.clamp(max=free.shape[0] - 1)]
        hs = home[start:]
        mr = match_row[start:]
        want = torch.where(
            (mr >= 0) & (mr < empty_row),
            _FOUND,
            torch.where(empty_row < hs + MAX_PROBES, _CLAIM, _PENDING),
        ).to(torch.int8)
        bad = torch.nonzero(want != c).squeeze(1)
        if bad.numel() == 0:
            rank[start:][claim] = s
            break
        # Keys before the first disagreement are settled; fix that key and
        # go on from the next with its claimed rank carried.
        i = int(bad[0])
        rank[start:start + i][claim[:i]] = s[: int(claim[:i].sum())]
        cls[start + i] = want[i]
        if want[i] == _CLAIM:
            rank[start + i] = cur[i]
            s_prev = int(cur[i])
        else:
            s_prev = int(before[i])
        start += i + 1

    claimed = cls == _CLAIM
    dest = free[rank[claimed]]
    table[dest, 0] = u32_to_i32(uhi[claimed])
    table[dest, 1] = u32_to_i32(ulo[claimed])

    lane_cls = cls[group]
    dup = ~first
    fresh[lanes] = (lane_cls == _CLAIM) & first
    found[lanes] = (lane_cls == _FOUND) | ((lane_cls == _CLAIM) & dup)
    pending[lanes] = lane_cls == _PENDING
    return table, fresh, found, pending
