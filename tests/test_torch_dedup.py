"""The port's dedup stage on the CPU, against the reference.

``ops/fused_wave.py::dedup_plain`` is the plain twin of the fused wave's
``fw_dedup``: the ``active`` mask and each table tile's ``starts``. It is
held here to the JAX Pallas prologue's expressions
(``stateright_tpu/ops/pallas_wave.py:189-206``), recomputed with ``jnp``
from the same numpy lanes: invalid lanes sink to the (MAX, MAX) sentinel,
``jax.lax.sort((shi, slo, lane), num_keys=2)``, ``active = cvalid[sidx] &
uniq``, and ``starts`` a 0 and then a ``searchsorted`` of each tile's first
row over the monotone homes. The cases (``torch_dedup_cases.py``) put
empty tile runs at the start, in the middle and at the end, hold only
sentinels or a single keyed lane, put every key in the last tile, use a
one-tile table, and hold a valid all-ones fingerprint. The kernel's own
rule, every tile's start written once from the run boundaries of the
sorted homes, is held to the same reference in numpy (``run_starts``).
Everything compared is an integer: the tolerance is 0. The kernel itself
is held to ``dedup_plain`` on the card (``test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops.hashset_kernel import TILE_ROWS

from torch_dedup_cases import (
    A,
    CPU_CASES,
    DEPTH_CAP,
    U32,
    lane_valid,
    run_starts,
    sorted_wave,
    wave_lanes,
)


def reference(hi, lo, valid, capacity):
    """The Pallas prologue's sorted dedup and tile starts: ``(skey, sidx,
    active, starts)``, the keys as u64."""
    cap_bits = capacity.bit_length() - 1
    n_tiles = capacity // TILE_ROWS
    cvalid = jnp.asarray(valid)
    shi = jnp.where(cvalid, jnp.asarray(hi, jnp.uint32), jnp.uint32(U32))
    slo = jnp.where(cvalid, jnp.asarray(lo, jnp.uint32), jnp.uint32(U32))
    shi, slo, sidx = jax.lax.sort((shi, slo, jnp.arange(hi.shape[0], dtype=jnp.int32)),
                                  num_keys=2)
    uniq = jnp.concatenate([jnp.ones((1,), bool), (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    active = cvalid[sidx] & uniq[:hi.shape[0]]
    homes = (shi >> jnp.uint32(32 - cap_bits)).astype(jnp.int32)
    bounds = jnp.arange(1, n_tiles + 1, dtype=jnp.int32) * TILE_ROWS
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.searchsorted(homes, bounds).astype(jnp.int32)])
    skey = (np.asarray(shi).astype(np.uint64) << np.uint64(32)) | np.asarray(slo)
    return skey, np.asarray(sidx), np.asarray(active), np.asarray(starts)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CPU_CASES)
def test_dedup_plain_matches_reference(case, seed):
    hi, lo, cvalid, depth, mask, capacity = wave_lanes(case, seed)
    rkey, ridx, ractive, rstarts = reference(hi, lo, lane_valid(cvalid, depth, mask), capacity)
    key, idx, *ins = sorted_wave(hi, lo, cvalid, depth, mask)
    assert np.array_equal(key.numpy().view(np.uint64), rkey)
    assert np.array_equal(idx.numpy(), ridx)
    active, starts = fw.dedup_plain(key, idx, capacity, ins[0], A, ins[1], DEPTH_CAP, ins[2])
    assert np.array_equal(active.numpy(), ractive)
    assert starts.dtype == torch.int64
    assert np.array_equal(starts.numpy(), rstarts.astype(np.int64))
    # The CPU wrapper runs the twin.
    got = fw.dedup_stage(key, idx, capacity, ins[0], A, ins[1], DEPTH_CAP, ins[2])
    assert all(np.array_equal(g.numpy(), w.numpy()) for g, w in zip(got, (active, starts)))
    if case == "valid_all_ones":
        all_ones = key.numpy().view(np.uint64) == np.uint64(2**64 - 1)
        assert active.numpy()[all_ones].sum() == 1
    if case in ("all_sentinel", "empty_wave"):
        assert not active.numpy().any()
    if case == "single_keyed_lane":
        assert active.numpy().sum() == 1


@pytest.mark.parametrize("case", CPU_CASES)
def test_run_boundaries_give_the_reference_starts(case):
    """``fw_dedup``'s rule for the tile starts (no search: each position
    fills the tiles between its predecessor's home tile and its own) writes
    every entry exactly once and gives the reference's ``searchsorted``."""
    hi, lo, cvalid, depth, mask, capacity = wave_lanes(case, 3)
    _rkey, _ridx, _ractive, rstarts = reference(hi, lo, lane_valid(cvalid, depth, mask),
                                                capacity)
    key, *_rest = sorted_wave(hi, lo, cvalid, depth, mask)
    starts, writes = run_starts(key.numpy(), capacity)
    assert (writes == 1).all()
    assert np.array_equal(starts, rstarts.astype(np.int64))
