"""The port's comm sieve (``ops/comm_sieve.py``) against the JAX package's
``ops/comm_sieve.py``, on the CPU, and the exchange ledger's names.

On seeded keys (numpy): the receipt cache's slots and its probes, the
Bloom filter's indices, probes and bytes equal the JAX package's exactly;
the shard-batched forms equal one call a shard; for cache collisions only
the contract is shared (a hit is never false, one of the colliders is
stored), and the port stores the highest lane. ``CommsInstruments`` has
the JAX names and span arguments. Everything compared is an integer: the
tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import comm_sieve as jcs
from stateright_tpu.telemetry.instruments import CommsInstruments as JaxCommsInstruments
from stateright_tpu.telemetry.metrics import MetricsRegistry as JaxMetricsRegistry
from stateright_tpu_torch.ops import comm_sieve as pcs
from stateright_tpu_torch.telemetry import CommsInstruments
from stateright_tpu_torch.telemetry.metrics import MetricsRegistry


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64))
    rng.shuffle(keys)
    return keys


def _jax(keys):
    return (jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _port(keys):
    return (torch.from_numpy((keys >> np.uint64(32)).astype(np.int64)),
            torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64)))


@pytest.mark.parametrize("slots_log2", [2, 8, 16])
def test_cache_slots_equal_jax(slots_log2):
    keys = _keys(slots_log2, 4096)
    want = np.asarray(jcs._cache_slot(*_jax(keys), 1 << slots_log2))
    got = pcs._cache_slot(*_port(keys), 1 << slots_log2).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("bits", [64, 1 << 10, 1 << 20])
def test_bloom_indices_equal_jax(bits):
    keys = _keys(bits, 2048)
    want = np.asarray(jcs._bloom_indices(*_jax(keys), bits))
    got = pcs._bloom_indices(*_port(keys), bits).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", range(3))
def test_bloom_bytes_and_probes_equal_jax(seed):
    keys = _keys(100 + seed, 6000)
    members, strangers = keys[:3000], keys[3000:]
    mask = np.random.default_rng(seed).random(3000) < 0.7
    bits = jcs.bloom_bits_for(3000)
    assert pcs.bloom_bits_for(3000) == bits
    jb = jcs.bloom_insert(jcs.bloom_new(bits), *_jax(members), jnp.asarray(mask))
    pb = pcs.bloom_insert(pcs.bloom_new(bits), *_port(members), torch.from_numpy(mask))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    for k in (members, strangers):
        np.testing.assert_array_equal(pcs.bloom_probe(pb, *_port(k)).numpy(),
                                      np.asarray(jcs.bloom_probe(jb, *_jax(k))))
    # No false negative: every inserted key probes present.
    assert pcs.bloom_probe(pb, *_port(members[mask])).all()


def test_cache_probes_equal_jax_without_collisions():
    slots_log2 = 12
    keys = _keys(7, 3000)
    slot = pcs._cache_slot(*_port(keys), 1 << slots_log2).numpy()
    _, first = np.unique(slot, return_index=True)
    stored = keys[np.sort(first)]  # one key a slot: no write collides
    mask = np.random.default_rng(8).random(len(stored)) < 0.5
    jc = jcs.cache_insert(jcs.cache_new(slots_log2), *_jax(stored), jnp.asarray(mask))
    pc = pcs.cache_insert(pcs.cache_new(slots_log2), *_port(stored), torch.from_numpy(mask))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc).astype(np.int64))
    active = np.random.default_rng(9).random(len(keys)) < 0.9
    np.testing.assert_array_equal(
        pcs.cache_probe(pc, *_port(keys), torch.from_numpy(active)).numpy(),
        np.asarray(jcs.cache_probe(jc, *_jax(keys), jnp.asarray(active))))


def test_cache_collisions_keep_the_contract():
    keys = _keys(11, 64)
    hi, lo = _port(keys)
    cache = pcs.cache_insert(pcs.cache_new(2), hi, lo, torch.ones(64, dtype=torch.bool))
    hit = pcs.cache_probe(cache, hi, lo, torch.ones(64, dtype=torch.bool))
    slot = pcs._cache_slot(hi, lo, 4)
    for s in range(4):
        lanes = torch.nonzero(slot == s).squeeze(1)
        # Exactly one collider of each slot is stored: the highest lane.
        assert hit[lanes].sum() == 1 and bool(hit[lanes[-1]])
    # A hit is never false: each row stored is a key inserted.
    stored = {(int(a), int(b)) for a, b in cache.tolist()}
    assert stored <= set(zip(hi.tolist(), lo.tolist()))
    # JAX's scatter stores one collider too, each a key it was given.
    jc = np.asarray(jcs.cache_insert(jcs.cache_new(2), *_jax(keys), jnp.ones(64, bool)))
    assert {(int(a), int(b)) for a, b in jc} <= set(zip(hi.tolist(), lo.tolist()))
    assert int(np.asarray(jcs.cache_probe(jnp.asarray(jc), *_jax(keys),
                                          jnp.ones(64, bool))).sum()) == 4


def test_inactive_lanes_and_empty_slots_never_hit():
    keys = _keys(12, 16)
    hi, lo = _port(keys)
    cache = pcs.cache_insert(pcs.cache_new(8), hi, lo, torch.ones(16, dtype=torch.bool))
    assert not pcs.cache_probe(cache, hi, lo, torch.zeros(16, dtype=torch.bool)).any()
    assert not pcs.cache_probe(pcs.cache_new(8), hi, lo, torch.ones(16, dtype=torch.bool)).any()


def test_shard_batched_forms_equal_one_call_a_shard():
    L, m = 3, 500
    keys = [_keys(20 + d, m) for d in range(L)]
    masks = [np.random.default_rng(30 + d).random(len(k)) < 0.6 for d, k in enumerate(keys)]
    width = min(len(k) for k in keys)
    keys = [k[:width] for k in keys]
    masks = [mk[:width] for mk in masks]
    hi = torch.stack([_port(k)[0] for k in keys])
    lo = torch.stack([_port(k)[1] for k in keys])
    mask = torch.from_numpy(np.stack(masks))
    cache = pcs.cache_insert(pcs.cache_new(6, shards=L), hi, lo, mask)
    bloom = pcs.bloom_insert(pcs.bloom_new(1 << 12, shards=L), hi, lo, mask)
    for d in range(L):
        one = pcs.cache_insert(pcs.cache_new(6), hi[d], lo[d], mask[d])
        assert torch.equal(cache[d], one)
        assert torch.equal(bloom[d], pcs.bloom_insert(pcs.bloom_new(1 << 12), hi[d], lo[d],
                                                      mask[d]))
        assert torch.equal(pcs.cache_probe(cache, hi, lo, mask)[d],
                           pcs.cache_probe(one, hi[d], lo[d], mask[d]))
        assert torch.equal(pcs.bloom_probe(bloom, hi, lo)[d],
                           pcs.bloom_probe(bloom[d], hi[d], lo[d]))


def test_bloom_width_must_be_a_power_of_two():
    with pytest.raises(ValueError):
        pcs.bloom_new(100)
    assert [pcs.bloom_bits_for(k) for k in (0, 1, 7, 1000, 1 << 20)] == \
        [jcs.bloom_bits_for(k) for k in (0, 1, 7, 1000, 1 << 20)]


def test_comms_instruments_names_and_args_equal_jax():
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    ci, jci = CommsInstruments("sharded_bfs", reg), JaxCommsInstruments("sharded_bfs", jreg)
    rec = dict(probes=100, killed=40, bloom_probes=60, bloom_hits=5, bloom_fps=2, lanes=96)
    assert ci.record(**rec) == jci.record(**rec)
    for c in (ci, jci):
        c.rung_dispatch(32, 3)
        c.rung_dispatch(128)
        c.evict_wire_bytes.inc(17)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["sharded_bfs.comms.rung_dispatch.32"] == 3
