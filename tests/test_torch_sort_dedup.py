"""The port's sorted dedup and plain sort on the CPU, against the reference.

``ops/fused_wave.py::sorted_dedup`` is the plain twin of the fused wave's
sort and dedup stages (``fw_sort``, ``fw_dedup``). It is held here to the
expression of the JAX package's staged wave
(``stateright_tpu/checker/tpu.py:1259-1270``, the same as the Pallas
prologue, ``stateright_tpu/ops/pallas_wave.py:184-195``): invalid lanes sink
to the (MAX, MAX) sentinel, ``jax.lax.sort((shi, slo, lane), num_keys=2)``,
and ``active = cvalid[sidx] & uniq``. The batches are made with numpy from a
seed: valid and invalid all-ones fingerprints in either order, all
sentinels, no sentinel, and heavy duplicates. ``sort_plain``, the plain
twin of the sort stage, is held to the same ``jax.lax.sort`` on u64 keys.
Everything compared is an integer: the tolerance is 0. The kernels
themselves are held to the twins on the card
(``test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch.ops import fused_wave as fw

U32_MAX = 0xFFFFFFFF
B = 4096


def reference_dedup(hi, lo, valid):
    """The JAX staged wave's sorted dedup: ``(shi, slo, sidx, active)``."""
    cvalid = jnp.asarray(valid)
    shi = jnp.where(cvalid, jnp.asarray(hi, jnp.uint32), jnp.uint32(U32_MAX))
    slo = jnp.where(cvalid, jnp.asarray(lo, jnp.uint32), jnp.uint32(U32_MAX))
    n = hi.shape[0]
    shi, slo, sidx = jax.lax.sort((shi, slo, jnp.arange(n, dtype=jnp.int32)), num_keys=2)
    uniq = jnp.concatenate([jnp.ones((1,), bool), (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    active = cvalid[sidx] & uniq
    return tuple(np.asarray(x) for x in (shi, slo, sidx, active))


def batch(case, seed):
    """``(hi, lo, valid)`` as u32 numpy arrays and a bool mask."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 32, size=B, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=B, dtype=np.uint64).astype(np.uint32)
    valid = rng.random(B) < 0.3
    if case == "valid_all_ones_first":
        # The lowest all-ones lane is valid: the reference inserts it.
        valid[:10] = True
        hi[5], lo[5] = U32_MAX, U32_MAX
        hi[3000], lo[3000], valid[3000] = U32_MAX, U32_MAX, True
    elif case == "valid_all_ones_after_invalid":
        # An invalid lane sorts first among the all-ones keys: its lane
        # decides, and the valid all-ones key after it is not active.
        valid[0], valid[1] = False, True
        hi[1], lo[1] = U32_MAX, U32_MAX
    elif case == "all_sentinel":
        valid[:] = False
    elif case == "none_sentinel":
        valid[:] = True
    elif case == "heavy_duplicates":
        # 40 distinct keys, some of them all ones; most lanes valid.
        pick = rng.integers(0, 40, size=B)
        hi, lo = hi[:40][pick], lo[:40][pick]
        hi[pick < 3], lo[pick < 3] = U32_MAX, U32_MAX
        valid = rng.random(B) < 0.8
    return hi, lo, valid


CASES = ["random", "valid_all_ones_first", "valid_all_ones_after_invalid", "all_sentinel",
         "none_sentinel", "heavy_duplicates"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_sorted_dedup_matches_reference(case, seed):
    hi, lo, valid = batch(case, seed)
    rhi, rlo, ridx, ractive = reference_dedup(hi, lo, valid)
    shi, slo, sidx, active = fw.sorted_dedup(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)),
        torch.from_numpy(valid))
    assert np.array_equal(shi.numpy(), rhi.astype(np.int64))
    assert np.array_equal(slo.numpy(), rlo.astype(np.int64))
    assert np.array_equal(sidx.numpy(), ridx.astype(np.int64))
    assert np.array_equal(active.numpy(), ractive)
    if case == "valid_all_ones_first":
        assert active[(shi == U32_MAX) & (slo == U32_MAX)].sum() == 1
    if case in ("valid_all_ones_after_invalid", "all_sentinel"):
        assert not active[(shi == U32_MAX) & (slo == U32_MAX)].any()


@pytest.mark.parametrize("sentinels", [0.0, 0.1, 0.76, 1.0])
@pytest.mark.parametrize("n", [1, 2047, 2049, 9000])
def test_sort_plain_matches_reference_sort(n, sentinels):
    """``sort_plain``, the twin that ``fw_sort`` is held to on the card,
    against the reference's ``jax.lax.sort((hi, lo, lane), num_keys=2)``
    on the same u64 keys: repeats, values at and above 2^63, and a share of
    ``~0`` sentinel lanes, which must stay in lane order at the end."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    keys[rng.integers(0, n, size=n // 2)] = keys[rng.integers(0, n, size=n // 2)]
    keys[rng.random(n) < sentinels] = np.uint64(2**64 - 1)
    hi, lo = (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)
    shi, slo, sidx = jax.lax.sort(
        (jnp.asarray(hi), jnp.asarray(lo), jnp.arange(n, dtype=jnp.int32)), num_keys=2)
    want = (np.asarray(shi).astype(np.uint64) << np.uint64(32)) | np.asarray(slo)
    key = torch.from_numpy(keys.view(np.int64).copy())
    idx = torch.arange(n, dtype=torch.int32) * 3
    fw.sort_plain(key, idx)
    assert np.array_equal(key.numpy().view(np.uint64), want)
    assert np.array_equal(idx.numpy(), np.asarray(sidx) * 3)
