"""Test fixtures of the port, shared by its test files and later slices.

``Chain`` is the torch port of the JAX package's liveness-semantics
fixture (``tests/test_tpu_bfs.py``): 0 -> 1 -> ... -> n (terminal).
``Cycler`` is the port of its lasso fixture (``tests/test_liveness.py``):
0 -> 1 -> 2 -> 1, whose ``eventually`` counterexample is a cycle that only
``complete_liveness()`` reports.

``sweep_case`` and ``sweep_table`` build visited-set inputs that reach
the hard cases of the tile sweep's ordered repair (``csrc/tile_sweep.cuh``):
spills into the next tile's apron, chains of redone tiles, probe overflow
across a tile boundary, high load and claims in the overflow rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.batch import BatchableModel
from .core.model import Model, Property


class Chain(Model, BatchableModel):
    """0 -> 1 -> ... -> n (terminal).

    ``reach`` sets the eventually target; a target > n is unreachable and
    must produce a counterexample path ending at the terminal state.
    ``bound`` limits the space through ``within_boundary``.
    """

    def __init__(self, n, reach=None, bound=None):
        self.n = n
        self.reach = reach
        self.bound = bound

    # host side
    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < self.n:
            actions.append("inc")

    def next_state(self, state, action):
        return state + 1

    def within_boundary(self, state):
        return self.bound is None or state <= self.bound

    def properties(self):
        props = []
        if self.reach is not None:
            props.append(
                Property.eventually("reach", lambda _m, s: s == self.reach)
            )
        props.append(Property.always("small", lambda _m, s: s <= self.n))
        return props

    # packed side: a state is one int64 lane carrying a u32 counter
    def packed_action_count(self):
        return 1

    def packed_init_states(self, device="cpu"):
        return torch.zeros((1,), dtype=torch.int64, device=device)

    def packed_expand(self, states):
        return (states + 1)[:, None], (states < self.n)[:, None]

    def packed_within_boundary(self, states):
        if self.bound is None:
            return torch.ones_like(states, dtype=torch.bool)
        return states <= self.bound

    def packed_conditions(self):
        conds = []
        if self.reach is not None:
            conds.append(lambda s: s == self.reach)
        conds.append(lambda s: s <= self.n)
        return conds

    def pack_state(self, host_state):
        return torch.tensor(host_state, dtype=torch.int64)

    def unpack_state(self, packed):
        return int(packed)


class PackedScalar(Model, BatchableModel):
    """A packed state is ``{"s": u32}`` (in an int64 lane): the JAX twins'
    layout, so both packages fingerprint and order the states alike."""

    def packed_init_states(self, device="cpu"):
        return {"s": torch.tensor(self.init_states(), dtype=torch.int64, device=device)}

    def pack_state(self, host_state):
        return {"s": torch.tensor(host_state, dtype=torch.int64)}

    def unpack_state(self, packed):
        return int(packed["s"])


class Cycler(PackedScalar):
    """0 -> 1 -> 2 -> 1: the cycle {1, 2} never reaches 3."""

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        actions.append("step")

    def next_state(self, state, action):
        return {0: 1, 1: 2, 2: 1}[state]

    def properties(self):
        return [Property.eventually("three", lambda _, s: s == 3)]

    def packed_action_count(self):
        return 1

    def packed_expand(self, states):
        s = states["s"]
        nxt = torch.where(s == 1, 2, 1)
        return {"s": nxt[:, None]}, torch.ones_like(s, dtype=torch.bool)[:, None]

    def packed_conditions(self):
        return [lambda st: st["s"] == 3]


# -- inputs for the tile sweep -----------------------------------------------

_TILE, _PROBES = 2048, 128
_LATTICE = 100  # rows between the empty rows of a lattice


def _homed(homes, cap, lo0):
    """Distinct (hi, lo) u32 keys homing at ``homes``: hi carries the home
    in its top bits, lo counts up from ``lo0`` (below 2**31)."""
    shift = 32 - (cap.bit_length() - 1)
    hi = (np.asarray(homes, np.uint64) << np.uint64(shift)).astype(np.uint32)
    return hi, np.arange(lo0, lo0 + len(hi), dtype=np.uint32)


def _fill(table, rows, rng):
    """Occupies ``rows`` with keys no batch key equals (lo's top bit set)."""
    rows = np.asarray(rows, np.int64)
    table[rows, 0] = rng.integers(0, 1 << 32, size=rows.size, dtype=np.uint64)
    table[rows, 1] = rng.integers(1 << 31, 1 << 32, size=rows.size, dtype=np.uint64)


def _lattice(table, first, last, rng):
    """Rows ``first - 10`` to ``last + LATTICE`` full but for an empty row
    every LATTICE rows (``first``, ..., ``last``, and ``last + LATTICE``
    with no key at it); returns the homes of one key 10 rows before each
    empty row and of one more key at the first home. Resolved in order,
    each key claims its own empty row until the extra key arrives; from
    there each takes the next one, a cascade over every tile on the way,
    which stops at the last empty row."""
    empties = np.arange(first, last + 2 * _LATTICE, _LATTICE)
    rows = np.setdiff1d(np.arange(first - 10, empties[-1] + 1), empties)
    _fill(table, rows, rng)
    homes = empties[:-1] - 10
    return np.concatenate([homes[:1], homes])


def _random_homes(rng, lo, hi, n):
    return np.sort(rng.integers(lo, hi, size=n))


def _greedy_load(table, cap, load, rng):
    """Inserts random keys one at a time (first empty row of the probe
    window) until ``load`` of the ``cap`` rows hold a key; returns them."""
    shift = 32 - (cap.bit_length() - 1)
    taken = bytearray(table.shape[0])
    keys = []
    while len(keys) < int(load * cap):
        hi = int(rng.integers(0, 1 << 32))
        home = hi >> shift
        for r in range(home, home + _PROBES):
            if not taken[r]:
                taken[r] = 1
                lo = int(rng.integers(1, 1 << 32))
                table[r] = (hi, lo)
                keys.append((hi, lo))
                break
    return np.asarray(keys, np.uint32).reshape(-1, 2)


def _batch(hi, lo, active=None):
    """Sorted by (hi, lo); inactive lanes carry the (MAX, MAX) sentinel."""
    hi, lo = np.asarray(hi, np.uint32), np.asarray(lo, np.uint32)
    active = np.ones(hi.shape, bool) if active is None else np.asarray(active, bool)
    hi = np.where(active, hi, np.uint32(0xFFFFFFFF))
    lo = np.where(active, lo, np.uint32(0xFFFFFFFF))
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], active[order]


def _empty(cap):
    return np.zeros((cap + _PROBES, 2), np.uint32)


def _keys(cap, *groups):
    homes = np.concatenate([np.asarray(g, np.int64) for g in groups])
    return _homed(homes, cap, 1)


def _one_spill(rng):
    """Tile 0 spills into tile 1, whose keys are redone; tile 1 does not
    spill, so the walk stops there."""
    cap = 4 * _TILE
    hi, lo = _keys(cap, np.full(20, 2040), np.full(10, 2050),
                   _random_homes(rng, 2 * _TILE, cap, 200))
    return (_empty(cap), *_batch(hi, lo))


def _chain_three_tiles(rng):
    """A lattice from tile 0 to tile 3 with no speculative spill past tile
    0: the extra key's cascade makes tile 0 spill, and each redone tile's
    cascade pushes its last key across its own boundary, so tiles 1, 2 and
    3 are redone in a chain (2 and 3 only because a redo made them
    spill)."""
    cap = 8 * _TILE
    t = _empty(cap)
    homes = _lattice(t, 1030, 7530, rng)
    hi, lo = _keys(cap, homes, _random_homes(rng, 4 * _TILE, cap, 300))
    return (t, *_batch(hi, lo))


def _redo_moves_apron_claims(rng):
    """Tile 1 spills speculatively (its last key claims row 4,100), and the
    cascade from tile 0 moves that claim to row 4,200 on the redo: tile
    2's first key (home 4,190) must see the final apron, not the
    speculated one."""
    cap = 4 * _TILE
    t = _empty(cap)
    hi, lo = _keys(cap, _lattice(t, 1000, 7000, rng))
    return (t, *_batch(hi, lo))


def _pending_straddles_boundary(rng):
    """150 keys homing at row 2,030: 128 claim rows across the boundary, 22
    go pending. Tile 1's keys homing at 2,100 claim on the pre-call table
    but go pending once tile 0's claims are in (rows 2,158-2,299 full)."""
    cap = 4 * _TILE
    t = _empty(cap)
    _fill(t, np.arange(2158, 2300), rng)
    hi, lo = _keys(cap, np.full(150, 2030), np.full(5, 2100), np.full(5, 2250),
                   np.full(100, 4000), np.full(20, 4100),
                   _random_homes(rng, 3 * _TILE, cap, 100))
    return (t, *_batch(hi, lo))


def _load_0_9(rng):
    """A table at load 0.9 and a batch with keys already present,
    duplicates and inactive lanes: most tiles spill, and some keys go
    pending."""
    cap = 8 * _TILE
    t = _empty(cap)
    old = _greedy_load(t, cap, 0.9, rng)
    n = 2000
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, old.shape[0], size=n * 3 // 10)
    hi[: pick.size], lo[: pick.size] = old[pick, 0], old[pick, 1]
    dup = rng.integers(0, n, size=n // 10)
    hi[-dup.size:], lo[-dup.size:] = hi[dup], lo[dup]
    return (t, *_batch(hi, lo, rng.random(n) < 0.9))


def _overflow_rows(rng):
    """The last tile, redone after a cascade from tile 2, claims rows in
    the overflow rows past the last tile; keys homing at its last row
    claim there too."""
    cap = 4 * _TILE
    t = _empty(cap)
    homes = _lattice(t, 5030, 8130, rng)
    hi, lo = _keys(cap, _random_homes(rng, 0, 2 * _TILE, 200), homes,
                   np.full(40, cap - 1))
    return (t, *_batch(hi, lo))


SWEEP_CASES = {
    f.__name__[1:]: f
    for f in (_one_spill, _chain_three_tiles, _redo_moves_apron_claims,
              _pending_straddles_boundary, _load_0_9, _overflow_rows)
}


def sweep_case(name, seed=0):
    """``(table, hi, lo, active)`` of one of ``SWEEP_CASES``: a
    ``(cap + 128, 2)`` uint32 table before the insert and a sorted batch
    (u32 ``hi``, ``lo``, bool ``active``) built to reach one hard case of
    the tile sweep's ordered repair. Tables hold at most 2**14 rows."""
    return SWEEP_CASES[name](np.random.default_rng(seed))


def tiles_to_redo(before, after, hi, lo, active):
    """How many tiles the tile sweep's ordered repair must redo for a
    sorted batch (u32 ``hi``, ``lo``, bool ``active``) whose insert took
    the table from ``before`` to ``after``: the tiles with active keys
    whose predecessor, in the ordered result, claimed a row past its own
    last row."""
    cap = after.shape[0] - _PROBES
    shift = 32 - (cap.bit_length() - 1)
    homes = hi.astype(np.int64) >> shift
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    rows = (after[:, 0].astype(np.uint64) << np.uint64(32)) | after[:, 1].astype(np.uint64)
    h, k = homes[active], key[active]
    # Each active key's row in the final table (the first at its home).
    row = np.empty_like(h)
    for s in range(0, h.size, 1 << 14):
        hit = rows[h[s : s + (1 << 14), None] + np.arange(_PROBES)] == k[s : s + (1 << 14), None]
        row[s : s + (1 << 14)] = h[s : s + (1 << 14)] + hit.argmax(axis=1)
    n_tiles = cap // _TILE
    spilled = np.zeros(n_tiles, bool)
    claimed = (before[row] == 0).all(axis=1)
    spilled[(h // _TILE)[claimed & (row >= (h // _TILE + 1) * _TILE)]] = True
    has_keys = np.bincount(h // _TILE, minlength=n_tiles) > 0
    return int((spilled[:-1] & has_keys[1:]).sum())


def sweep_table(cap, hi, lo, kind, seed=0):
    """A ``(cap + 128, 2)`` uint32 table before a batch of the distinct
    keys ``hi``, ``lo`` (u32, sorted), built for a batch whose keys are
    given (a wave's fingerprints):

    - ``"empty_after_home"``: every row full but the row 100 past each
      key's home, so every tile with a key in its last 100 rows spills
      into the next tile's apron, and the overflow rows fill;
    - ``"load_0_9"``: 0.9 of the rows taken by keys inserted one at a time.
    """
    rng = np.random.default_rng(seed)
    table = np.zeros((cap + _PROBES, 2), np.uint32)
    if kind == "empty_after_home":
        homes = np.asarray(hi, np.int64) >> (32 - (cap.bit_length() - 1))
        _fill(table, np.setdiff1d(np.arange(table.shape[0]), homes + _LATTICE), rng)
    elif kind == "load_0_9":
        _greedy_load(table, cap, 0.9, rng)
    else:
        raise ValueError(f"unknown sweep table kind {kind!r}")
    return table
