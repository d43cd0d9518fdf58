"""Sorted waves for the dedup stage's tests, made with numpy from a seed.

Shared by ``test_torch_dedup.py`` (CPU, against the JAX reference) and
``test_torch_cuda_kernels.py`` (the card, against ``dedup_plain``); it
imports neither JAX nor the JAX package. A case is a wave of B = F * A
candidate lanes over a table of ``capacity`` rows: each lane's (hi, lo)
fingerprint with its home in chosen tiles, its valid byte, and the
frontier's depth and mask. ``sorted_wave`` hands the port what its sort
hands the dedup: the keys (invalid lanes sunk to ``~0``) sorted as
unsigned values, stably, with their lanes.
"""

import numpy as np
import torch

from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops.hashset_kernel import TILE_ROWS

U32 = 0xFFFFFFFF
A = 4
DEPTH_CAP = 7

# name: (capacity, frontier lanes F, tiles the keys' homes lie in (None:
# any), share of valid lanes, masked and depth-capped lanes)
CASES = {
    "random": (1 << 15, 1024, None, 0.3, True),
    "empty_tiles_at_start": (1 << 15, 512, range(10, 16), 0.5, False),
    "empty_tiles_in_middle": (1 << 15, 512, [0, 1, 2, 13, 14, 15], 0.5, True),
    # Every lane valid: no sentinel homes into the last tile.
    "empty_tiles_at_end": (1 << 15, 512, range(0, 4), 1.0, False),
    "all_sentinel": (1 << 15, 512, None, 0.0, False),
    "single_keyed_lane": (1 << 15, 512, None, 0.0, False),
    "last_tile_only": (1 << 15, 512, [15], 0.5, True),
    "one_tile": (TILE_ROWS, 512, None, 0.5, True),
    "valid_all_ones": (1 << 15, 512, None, 0.5, False),
    "empty_wave": (1 << 15, 0, None, 0.5, False),
    # A drain's sparse last waves: at most 64 keyed lanes of skv4x4's width
    # (8,192 lanes of 24 actions) into its 2^25-row table, spread over
    # its tiles or all in one.
    "sparse_64_lanes_2p25": (1 << 25, 8192 * 24 // A, None, 0.0, False),
    "sparse_one_tile_2p25": (1 << 25, 8192 * 24 // A, [7000], 0.0, False),
}
CPU_CASES = [c for c in CASES if not c.endswith("2p25")]


def wave_lanes(case, seed=0):
    """``(hi, lo, cvalid, depth, mask, capacity)``: u32 fingerprints, the
    model stage's valid bytes (B,), the frontier's depths (F,) and its
    mask (F,) or None."""
    capacity, F, tiles, share, masked = CASES[case]
    rng = np.random.default_rng(seed)
    B = F * A
    shift = 32 - (capacity.bit_length() - 1)
    if tiles is None:
        home = rng.integers(0, capacity, size=B)
    else:
        home = rng.choice(np.asarray(list(tiles)), size=B) * TILE_ROWS \
            + rng.integers(0, TILE_ROWS, size=B)
    hi = ((home << shift) | rng.integers(0, 1 << shift, size=B)).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=B, dtype=np.uint64).astype(np.uint32)
    # In-wave duplicates: a tenth of the lanes repeat another lane's key.
    dup = rng.random(B) < 0.1
    src = rng.integers(0, max(B, 1), size=B)
    hi, lo = np.where(dup, hi[src], hi), np.where(dup, lo[src], lo)
    cvalid = rng.random(B) < share
    depth = np.full(F, 3, np.int64)
    mask = None
    if masked:
        depth = rng.integers(0, DEPTH_CAP + 3, size=F)
        mask = rng.random(F) < 0.8
    if case == "single_keyed_lane":
        cvalid[B // 3] = True
    elif case.startswith("sparse"):
        cvalid[rng.choice(B, size=64 if "64" in case else 40, replace=False)] = True
    elif case == "valid_all_ones":
        # The lowest lane holding the sentinel's value is valid (its key is
        # inserted), and a later valid one repeats it.
        cvalid[:10] = True
        hi[5], lo[5] = U32, U32
        hi[B - 5], lo[B - 5], cvalid[B - 5] = U32, U32, True
    return hi, lo, cvalid, depth, mask, capacity


def lane_valid(cvalid, depth, mask):
    """The keys stage's validity of each lane: valid, live, under the cap."""
    parent = np.arange(cvalid.shape[0]) // A
    ok = cvalid & (depth[parent] < DEPTH_CAP)
    return ok if mask is None else ok & mask[parent]


def sorted_wave(hi, lo, cvalid, depth, mask, device="cpu"):
    """``(key, idx, cvalid, depth, mask)`` as the dedup stage takes them: the
    sort stage's output (``sort_plain``) over the keys stage's keys."""
    valid = lane_valid(cvalid, depth, mask)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    key = torch.from_numpy(np.where(valid, keys, np.uint64(2**64 - 1)).view(np.int64).copy())
    idx = torch.arange(key.shape[0], dtype=torch.int32)
    fw.sort_plain(key, idx)
    on = lambda x: None if x is None else torch.from_numpy(x).to(device)  # noqa: E731
    return key.to(device), idx.to(device), on(cvalid), on(depth), on(mask)


def run_starts(key, capacity):
    """The tile starts as ``fw_dedup`` writes them, in numpy: position i
    writes i to every tile in (tile(i - 1), tile(i)], position 0 writes 0
    to tiles up to tile(0), and the last position writes B past tile(B -
    1). Returns the starts and how often each entry was written."""
    B, n_tiles = key.shape[0], capacity // TILE_ROWS
    shift = 32 - (capacity.bit_length() - 1)
    tile = (((key.view(np.uint64) >> np.uint64(32)) >> np.uint64(shift))
            // TILE_ROWS).astype(np.int64)
    starts = np.full(n_tiles + 1, -1, np.int64)
    writes = np.zeros(n_tiles + 1, np.int64)
    for i in range(B):
        lo = 0 if i == 0 else tile[i - 1] + 1
        starts[lo:tile[i] + 1] = i
        writes[lo:tile[i] + 1] += 1
    tail = tile[-1] + 1 if B else 0
    starts[tail:] = B
    writes[tail:] += 1
    return starts, writes
