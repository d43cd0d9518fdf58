"""The routing sieve of the sharded exchange: receipt cache and Bloom filter.

The torch port of the JAX package's ``ops/comm_sieve.py``. Each shard
routes its candidate keys to their owner shards every wave; most are
re-visits that the owner's table rejects. The sieve lets the sender drop
lanes it can prove are resident at their owner, before the exchange,
without changing any result bit:

1. the receipt cache, a direct-mapped table of ``2**slots_log2`` full
   (hi, lo) keys: a probe compares the whole key, so a hit proves this
   shard routed exactly that key and its owner acknowledged it;
2. the Bloom filter, a byte a bit, over the same keys: advisory only (it
   drops nothing); a routed lane's owner verdict is an exact membership
   check, so ``bloom_hit & fresh`` counts its false positives.

Slots, Bloom indices and filter bytes equal the JAX package's bit for bit
(``avalanche32`` over the same salts). Where two lanes of one insert map
to one cache slot, the highest lane is written (the last writer, as a
sequential scatter writes); the JAX scatter leaves that choice open, so
only the contract is shared there: a hit is never false, and one of the
colliders is stored. The (0, 0) pair is the empty-slot sentinel.

Every function takes keys with optional leading batch dimensions matching
the structure's (``(L, m)`` keys against ``(L, slots, 2)`` caches or
``(L, bits)`` filters: one per shard). u32 values ride in int64, as
everywhere in the port; caches are int64 ``(..., slots, 2)``.
"""

from __future__ import annotations

import torch

from .fingerprint import U32, avalanche32

__all__ = [
    "BLOOM_BITS_PER_KEY",
    "BLOOM_DESIGN_FP_RATE",
    "BLOOM_NUM_HASHES",
    "bloom_bits_for",
    "bloom_insert",
    "bloom_new",
    "bloom_probe",
    "cache_insert",
    "cache_new",
    "cache_probe",
]

# The storage tier's design point: 10 bits a key and 7 hashes, about a 1%
# false-positive rate at capacity.
BLOOM_BITS_PER_KEY = 10
BLOOM_NUM_HASHES = 7
BLOOM_DESIGN_FP_RATE = 0.01

_SALT_SLOT = 0x9E3779B9
_SALT_H1 = 0x85EBCA6B
_SALT_H2 = 0xC2B2AE35


def _fold(hi: torch.Tensor, lo: torch.Tensor, salt: int) -> torch.Tensor:
    """One avalanche over the 64-bit key folded with a salt."""
    return avalanche32(avalanche32(hi ^ salt) ^ lo)


def cache_new(slots_log2: int, device="cpu", shards=None) -> torch.Tensor:
    """An empty receipt cache, ``(2**slots_log2, 2)`` (``(shards, ...)``
    with ``shards``), all zero."""
    lead = () if shards is None else (shards,)
    return torch.zeros(lead + (1 << slots_log2, 2), dtype=torch.int64, device=device)


def _cache_slot(hi: torch.Tensor, lo: torch.Tensor, slots: int) -> torch.Tensor:
    return _fold(hi, lo, _SALT_SLOT) & (slots - 1)


def _rows(cache: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The cache rows at ``slot`` (``(..., m)``), as ``(..., m, 2)``."""
    idx = slot.unsqueeze(-1).expand(*slot.shape, 2)
    return torch.gather(cache, -2, idx)


def cache_probe(cache, hi, lo, active) -> torch.Tensor:
    """Exact membership of each (hi, lo) in the cache; inactive lanes are
    False. The (0, 0) pair never enters, so an empty slot cannot hit."""
    rows = _rows(cache, _cache_slot(hi, lo, cache.shape[-2]))
    return active & (rows[..., 0] == hi) & (rows[..., 1] == lo)


def cache_insert(cache, hi, lo, mask) -> torch.Tensor:
    """Records the masked lanes' keys, in place; colliders overwrite, the
    highest lane of one insert winning its slot. Returns the cache."""
    S = cache.shape[-2]
    slot = _cache_slot(hi, lo, S)
    m = hi.shape[-1]
    flat_cache = cache.view(-1, 2)
    batch = torch.arange(slot.numel() // max(1, m), dtype=torch.int64,
                         device=slot.device).view(*slot.shape[:-1], 1)
    gslot = (batch * S + slot).reshape(-1)
    lane = torch.arange(m, dtype=torch.int64, device=slot.device).expand_as(slot).reshape(-1)
    live = mask.reshape(-1)
    winner = torch.full((flat_cache.shape[0],), -1, dtype=torch.int64, device=slot.device)
    winner.scatter_reduce_(0, gslot, torch.where(live, lane, -1), "amax")
    write = live & (winner[gslot] == lane)
    dest = torch.where(write, gslot, flat_cache.shape[0])
    padded = torch.cat([flat_cache, flat_cache.new_zeros(1, 2)])
    padded[dest] = torch.stack([hi.reshape(-1), lo.reshape(-1)], dim=-1)
    flat_cache.copy_(padded[:-1])
    return cache


def bloom_bits_for(expected_keys: int) -> int:
    """Filter width (a power of two, in bits) for an expected population."""
    want = max(64, expected_keys * BLOOM_BITS_PER_KEY)
    bits = 64
    while bits < want:
        bits <<= 1
    return bits


def bloom_new(bits: int, device="cpu", shards=None) -> torch.Tensor:
    """An empty filter: one uint8 a bit (``(shards, bits)`` with
    ``shards``)."""
    if bits & (bits - 1):
        raise ValueError(f"bloom width must be a power of two, got {bits}")
    lead = () if shards is None else (shards,)
    return torch.zeros(lead + (bits,), dtype=torch.uint8, device=device)


def _bloom_indices(hi, lo, bits: int) -> torch.Tensor:
    """``(..., m, K)`` double-hashed probe positions ``h1 + j*h2 (mod bits)``."""
    h1 = _fold(hi, lo, _SALT_H1)
    h2 = _fold(lo, hi, _SALT_H2) | 1  # odd: a full-period stride
    j = torch.arange(BLOOM_NUM_HASHES, dtype=torch.int64, device=hi.device)
    idx = (h1.unsqueeze(-1) + j * h2.unsqueeze(-1)) & U32
    return idx & (bits - 1)


def bloom_probe(bloom, hi, lo) -> torch.Tensor:
    """True where all K probe bits are set (maybe present)."""
    idx = _bloom_indices(hi, lo, bloom.shape[-1])
    flat = idx.reshape(*idx.shape[:-2], -1)
    got = torch.gather(bloom, -1, flat).view(idx.shape)
    return (got != 0).all(dim=-1)


def bloom_insert(bloom, hi, lo, mask) -> torch.Tensor:
    """Sets the K bits of every masked lane, in place; returns the
    filter."""
    idx = _bloom_indices(hi, lo, bloom.shape[-1])
    flat = idx.reshape(*idx.shape[:-2], -1)
    # An unmasked lane adds a 0 under max: its bits stay as they are.
    ones = mask.unsqueeze(-1).expand(idx.shape).reshape(flat.shape).to(torch.uint8)
    bloom.scatter_reduce_(-1, flat, ones, "amax")
    return bloom
