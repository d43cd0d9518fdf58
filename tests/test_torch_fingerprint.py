"""The port's fingerprints against the JAX package's, bit for bit.

Same inputs (made with numpy from a seed, or the reachable 2pc-3 states)
go through ``stateright_tpu.ops.fingerprint`` and
``stateright_tpu_torch.ops.fingerprint``; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops import fingerprint as jfp
from stateright_tpu_torch.interop import packed_states_from_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import fingerprint as tfp

U32 = 0xFFFFFFFF


def reachable_states(model):
    """Every reachable host state, in BFS order."""
    seen, order = set(), []
    frontier = list(model.init_states())
    while frontier:
        nxt = []
        for s in frontier:
            if s in seen:
                continue
            seen.add(s)
            order.append(s)
            nxt.extend(model.next_states(s))
        frontier = nxt
    return order


def stacked_packed(jmodel, states):
    """The JAX model's packed forms of ``states``, stacked as numpy u32."""
    packed = [jmodel.pack_state(s) for s in states]
    return {
        k: np.stack([np.asarray(p[k], np.uint32) for p in packed])
        for k in packed[0]
    }


def pairs(hi, lo):
    return list(zip(np.asarray(hi).astype(np.int64).tolist(),
                    np.asarray(lo).astype(np.int64).tolist()))


def test_2pc3_reachable_states_fingerprint_equal():
    jmodel = JaxTwoPhaseSys(3)
    states = reachable_states(jmodel)
    assert len(states) == 288
    packed = stacked_packed(jmodel, states)
    jhi, jlo = jax.vmap(jmodel.packed_fingerprint)(
        {k: jnp.asarray(v) for k, v in packed.items()}
    )
    thi, tlo = TwoPhaseSys(3).packed_fingerprint(packed_states_from_numpy(packed))
    assert pairs(jhi, jlo) == pairs(thi, tlo)
    assert len(set(pairs(thi, tlo))) == 288


def test_word_order_is_sorted_keys():
    """``state_words`` flattens dict leaves in sorted-key order, as
    ``jax.tree_util.tree_leaves`` does: msgs, prepared, rm[0..N-1], tm."""
    states = {
        "rm": torch.tensor([[1, 2, 3]]),
        "tm": torch.tensor([4]),
        "prepared": torch.tensor([5]),
        "msgs": torch.tensor([6]),
    }
    assert tfp.state_words(states).tolist() == [[6, 5, 1, 2, 3, 4]]


@pytest.mark.parametrize("n", [10, 64, 65, 391])
def test_random_word_vectors_both_branches(n):
    rng = np.random.default_rng(n)
    words = rng.integers(0, 1 << 32, size=(64, n), dtype=np.uint64).astype(np.uint32)
    jhi, jlo = jax.vmap(jfp.fingerprint_words)(jnp.asarray(words))
    thi, tlo = tfp.fingerprint_words(torch.from_numpy(words.astype(np.int64)))
    assert pairs(jhi, jlo) == pairs(thi, tlo)


def test_leaf_dtypes_match():
    """bool, small signed ints, int32 and float32 leaves widen or bit-cast
    exactly as the JAX package's ``_leaf_words`` does."""
    rng = np.random.default_rng(5)
    leaves = {
        "a": rng.random((8, 3)) < 0.5,
        "b": rng.integers(-128, 128, (8, 2)).astype(np.int8),
        "c": rng.integers(-(1 << 31), 1 << 31, (8, 4)).astype(np.int32),
        "d": rng.standard_normal((8, 2)).astype(np.float32),
        "e": rng.integers(0, 1 << 16, (8,)).astype(np.uint16),
    }
    jhi, jlo = jax.vmap(jfp.fingerprint_state)(
        {k: jnp.asarray(v) for k, v in leaves.items()}
    )
    thi, tlo = tfp.fingerprint_state({k: torch.from_numpy(v) for k, v in leaves.items()})
    assert pairs(jhi, jlo) == pairs(thi, tlo)


def _inverse_fmix(h: int) -> int:
    """The inverse of murmur3's fmix32 (each step is a bijection)."""
    h ^= h >> 16
    h = (h * 0x7ED1B41D) & U32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * 0xA5CB9243) & U32
    return h ^ (h >> 16)


@pytest.mark.parametrize(
    "target,expected",
    [((0, 0), (0, 1)), ((U32, U32), (U32, U32 - 1)), ((7, 9), (7, 9))],
)
def test_finalize_sentinel_nudges(target, expected):
    n = 3
    pre_hi = _inverse_fmix(target[0]) ^ (n * 4)
    pre_lo = _inverse_fmix(target[1]) ^ (n * 4 + 1)
    assert int(jfp.avalanche32(jnp.uint32(_inverse_fmix(target[0])))) == target[0]
    jhi, jlo = jfp._finalize_pair(jnp.uint32(pre_hi), jnp.uint32(pre_lo), n)
    thi, tlo = tfp._finalize_pair(
        torch.tensor([pre_hi]), torch.tensor([pre_lo]), n
    )
    assert (int(jhi), int(jlo)) == expected
    assert (int(thi[0]), int(tlo[0])) == expected


def test_avalanche32_and_scheme():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    j = np.asarray(jfp.avalanche32(jnp.asarray(x))).astype(np.int64)
    t = tfp.avalanche32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(j, t)
    assert tfp.FP_SCHEME == jfp.FP_SCHEME
    assert tfp.fp_to_int(3, 5) == jfp.fp_to_int(3, 5)
