"""The port's visited-set insert against the JAX package's TPU kernel.

``hashset_insert_sorted_plain`` (the plain twin of the CUDA kernel, which
is what a CPU table runs) must leave the same table and report the same
``fresh``/``found``/``pending`` flags as ``pallas_hashset_insert`` in
interpret mode, bit for bit. Inputs are made with numpy from a seed and
carried across with ``interop``; tables hold a few tiles so interpret mode
stays fast. The CUDA kernel itself is held against the twin in
``test_torch_cuda_kernels.py``, which runs only where there is a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops.pallas_hashset import TILE_ROWS as JAX_TILE_ROWS
from stateright_tpu.ops.pallas_hashset import pallas_hashset_insert
from stateright_tpu_torch.interop import (
    keys_from_numpy,
    table_from_numpy,
    table_to_numpy,
)
from stateright_tpu_torch.ops import _build
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.ops.hashset import (
    MAX_PROBES,
    hashset_contains,
    hashset_new,
)

TILE_ROWS = hk.TILE_ROWS
CAP = TILE_ROWS * 2


def sorted_batch(rng, n, active_frac=0.9, dup_frac=0.0, span=None):
    hi = rng.integers(0, span or (1 << 32), size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    if dup_frac:
        k = max(1, int(n * dup_frac))
        hi[:k] = hi[n // 2 : n // 2 + k]
        lo[:k] = lo[n // 2 : n // 2 + k]
    active = rng.random(n) < active_frac
    hi = np.where(active, hi, 0xFFFFFFFF).astype(np.uint32)
    lo = np.where(active, lo, 0xFFFFFFFF).astype(np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], active[order]


def empty_table(cap=CAP):
    return np.zeros((cap + MAX_PROBES, 2), np.uint32)


def insert_both(table, hi, lo, active):
    """Runs both inserts on the same inputs; asserts they agree exactly and
    returns the resulting numpy table and flags."""
    jt, jfresh, jfound, jpend = pallas_hashset_insert(
        jnp.asarray(table), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(active), interpret=True,
    )
    khi, klo = keys_from_numpy(hi, lo)
    tt, tfresh, tfound, tpend = hk.hashset_insert_sorted(
        table_from_numpy(table), khi, klo, torch.from_numpy(np.asarray(active))
    )
    jt = np.asarray(jt)
    assert np.array_equal(jt, table_to_numpy(tt))
    for j, t in ((jfresh, tfresh), (jfound, tfound), (jpend, tpend)):
        assert np.array_equal(np.asarray(j), t.numpy())
    return jt, tfresh.numpy(), tfound.numpy(), tpend.numpy()


def test_same_tile_size():
    assert TILE_ROWS == JAX_TILE_ROWS == 2048
    assert hk.round_table_capacity(3000) == 4096
    assert hk.round_table_capacity(10) == TILE_ROWS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_sorted_batches(seed):
    rng = np.random.default_rng(seed)
    hi, lo, active = sorted_batch(rng, 1024)
    table, fresh, found, pend = insert_both(empty_table(), hi, lo, active)
    assert fresh.sum() == active.sum() and not pend.any()
    # A second batch mixing old and new keys against the filled table.
    hi2, lo2, act2 = sorted_batch(rng, 1024)
    hi2 = np.concatenate([hi2, hi[:256]])
    lo2 = np.concatenate([lo2, lo[:256]])
    act2 = np.concatenate([act2, active[:256]])
    order = np.lexsort((lo2, hi2))
    insert_both(table, hi2[order], lo2[order], act2[order])


def test_clustered_keys_cross_tile_margin():
    """Keys homing at the last row of tile 0 claim rows in tile 1's first
    128 rows; tile 1's keys must see those claims."""
    shift = 32 - (CAP.bit_length() - 1)
    n = 64
    lo = np.arange(1, n + 1, dtype=np.uint32)
    hi = np.full(n, (TILE_ROWS - 1) << shift, np.uint32)
    active = np.ones(n, bool)
    table, fresh, _found, pend = insert_both(empty_table(), hi, lo, active)
    assert fresh.all() and not pend.any()
    assert (table[TILE_ROWS : TILE_ROWS + n - 1, 1] != 0).any()
    hi2 = np.full(n, TILE_ROWS << shift, np.uint32)
    insert_both(table, hi2, lo, active)
    # Both tiles' keys in one batch.
    both_hi = np.concatenate([hi, hi2])
    both_lo = np.concatenate([lo, lo + n])
    order = np.lexsort((both_lo, both_hi))
    insert_both(empty_table(), both_hi[order], both_lo[order], np.ones(2 * n, bool))


def test_probe_overflow_reports_pending():
    n = MAX_PROBES + 16
    hi = np.zeros(n, np.uint32)  # all home at row 0
    lo = np.arange(1, n + 1, dtype=np.uint32)
    _t, fresh, _found, pend = insert_both(empty_table(), hi, lo, np.ones(n, bool))
    assert fresh.sum() == MAX_PROBES and pend.sum() == 16


def test_dense_table_overflow_with_duplicates():
    """Half the table's homes carry more keys than rows: claims, pendings
    and duplicates of pending keys interleave."""
    rng = np.random.default_rng(5)
    hi, lo, active = sorted_batch(rng, 3500, active_frac=1.0, dup_frac=0.2, span=1 << 31)
    _t, fresh, found, pend = insert_both(empty_table(), hi, lo, active)
    assert pend.any() and found.any() and fresh.any()


def test_in_batch_duplicates_report_found():
    rng = np.random.default_rng(3)
    hi, lo, active = sorted_batch(rng, 512, active_frac=1.0, dup_frac=0.25)
    _t, fresh, found, pend = insert_both(empty_table(), hi, lo, active)
    n_unique = len(set(zip(hi.tolist(), lo.tolist())))
    assert fresh.sum() == n_unique
    assert found.sum() == len(hi) - n_unique
    assert not pend.any()


def test_second_insert_reports_found():
    rng = np.random.default_rng(7)
    hi, lo, active = sorted_batch(rng, 512, active_frac=1.0)
    table, fresh1, _f, _p = insert_both(empty_table(), hi, lo, active)
    _t, fresh2, found2, pend2 = insert_both(table, hi, lo, active)
    assert fresh1.all() and not fresh2.any() and found2.all() and not pend2.any()


def test_prefilled_table_through_interop():
    """A table filled by the JAX kernel, carried into the port through
    ``interop``, then both insert the next batch: same table, same flags;
    and the port's ``hashset_contains`` finds exactly the inserted keys."""
    rng = np.random.default_rng(11)
    cap = TILE_ROWS * 4
    hi, lo, active = sorted_batch(rng, 4000, active_frac=1.0)
    jt, *_ = pallas_hashset_insert(
        jnp.asarray(empty_table(cap)), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(active), interpret=True,
    )
    table = np.asarray(jt)
    assert np.array_equal(table_to_numpy(table_from_numpy(table)), table)
    hi2, lo2, act2 = sorted_batch(rng, 1500, dup_frac=0.1)
    insert_both(table, hi2, lo2, act2)
    t = table_from_numpy(table)
    present = hashset_contains(
        t, torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    )
    absent = hashset_contains(
        t, torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64) ^ 1)
    )
    assert bool(present.all()) and not bool(absent.any())


def test_refusals():
    khi, klo = keys_from_numpy(np.array([1, 2], np.uint32), np.array([3, 4], np.uint32))
    act = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="power of two"):
        hk.hashset_insert_sorted(torch.zeros((3000 + MAX_PROBES, 2), dtype=torch.int32), khi, klo, act)
    with pytest.raises(ValueError, match="power of two"):
        hk.hashset_insert_sorted(torch.zeros((1024 + MAX_PROBES, 2), dtype=torch.int32), khi, klo, act)
    with pytest.raises(ValueError, match="must be sorted"):
        hk.hashset_insert_sorted(hashset_new(CAP), khi.flip(0), klo.flip(0), act)
    with pytest.raises(ValueError, match="int32"):
        hk.hashset_insert_sorted(hashset_new(CAP).to(torch.int64), khi, klo, act)
    with pytest.raises(ValueError, match="key_lo"):
        hk.hashset_insert_sorted(hashset_new(CAP), khi, klo[:1], act)
    with pytest.raises(ValueError, match="active"):
        hk.hashset_insert_sorted(hashset_new(CAP), khi, klo, act.to(torch.int32))
    with pytest.raises(ValueError, match="empty-row sentinel"):
        z = torch.zeros(1, dtype=torch.int32)
        hk.hashset_insert_sorted(hashset_new(CAP), z, z, torch.ones(1, dtype=torch.bool))


def test_cpu_table_never_touches_the_cuda_build(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must not build a CUDA kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = hk.launches
    rng = np.random.default_rng(2)
    hi, lo, active = sorted_batch(rng, 256)
    khi, klo = keys_from_numpy(hi, lo)
    _t, fresh, _found, _pend = hk.hashset_insert_sorted(
        hashset_new(CAP), khi, klo, torch.from_numpy(active)
    )
    assert int(fresh.sum()) == int(active.sum())
    assert hk.launches == before


def test_kernel_binding_types_every_argument(monkeypatch):
    """The ctypes binding must declare every argument: left undeclared,
    ctypes passes the pointers and the stream as 32-bit ints."""
    import ctypes
    import types

    fresh_fn = ctypes.CDLL(None).strlen  # a ctypes function with defaults
    monkeypatch.setattr(
        _build, "load", lambda name: types.SimpleNamespace(hashset_insert_launch=fresh_fn)
    )
    fn = hk._kernel()
    assert fn is fresh_fn
    assert fn.argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    assert fn.restype is ctypes.c_int


def test_tile_starts_partition_the_batch():
    rng = np.random.default_rng(4)
    hi, lo, _active = sorted_batch(rng, 2000, active_frac=0.7)
    khi, _klo = keys_from_numpy(hi, lo)
    starts = hk.tile_starts(khi, TILE_ROWS * 8)
    assert starts.shape == (9,)
    assert int(starts[0]) == 0 and int(starts[-1]) == 2000
    assert bool((starts[1:] >= starts[:-1]).all())
    homes = hi.astype(np.int64) >> (32 - (TILE_ROWS * 8).bit_length() + 1)
    for t in range(8):
        s, e = int(starts[t]), int(starts[t + 1])
        assert ((homes[s:e] // TILE_ROWS) == t).all()
