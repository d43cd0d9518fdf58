"""Static Bloom filter over u64 fingerprints (numpy-only, batched probes).

The port's copy of the JAX package's ``storage/bloom.py``: the same bits
for the same keys, so the two packages' runs and checkpoints interchange.

Runs are immutable once built (`runs.FingerprintRun`), so the filter is
static too: built once from the sorted fingerprint array, never mutated.
Sizing targets <1% false positives: ~10 bits/key with k=7 hash functions
gives a theoretical FP rate of ~0.8% at the design load (the classic
``(1 - e^{-kn/m})^k`` optimum is k = m/n·ln2 ≈ 6.9). Probes and
construction are fully vectorized — the host-exit probe path handles
whole wave batches, never per-key Python loops.

Index derivation is double hashing over two independent splitmix64-style
finalizer mixes: ``idx_i = (h1 + i·h2) mod m`` with m a power of two, the
standard Kirsch–Mitzenmacher construction (asymptotically as good as k
independent hashes).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BloomFilter", "DESIGN_FP_RATE"]

# ~10 bits/key at k=7: <1% false-positive rate at design load.
BITS_PER_KEY = 10
NUM_HASHES = 7
# THE configured false-positive bound the sizing above targets (theory:
# ~0.8% at design load). The observed rate is audited against this bound
# by the `*.storage.host_probe.bloom_*` counters (tiered.py) — a two-phase
# probe whose Bloom layer drifts past it is silently wasting block
# decodes, which only an observed-vs-configured comparison can catch.
DESIGN_FP_RATE = 0.01

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_M3 = np.uint64(0xFF51AFD7ED558CCD)
_M4 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix(x: np.ndarray, m_a: np.uint64, m_b: np.uint64) -> np.ndarray:
    """splitmix64/murmur3-style avalanche (uint64 wraparound is the point)."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= m_a
    x ^= x >> np.uint64(27)
    x *= m_b
    x ^= x >> np.uint64(31)
    return x


class BloomFilter:
    """Immutable filter; ``words`` is the uint64 bit array, ``m_bits`` its
    power-of-two bit count."""

    def __init__(self, words: np.ndarray, n_keys: int):
        self.words = np.ascontiguousarray(words, dtype=np.uint64)
        self.n_keys = int(n_keys)
        self.m_bits = len(self.words) * 64

    @classmethod
    def build(cls, fps: np.ndarray) -> "BloomFilter":
        fps = np.asarray(fps, dtype=np.uint64)
        n = len(fps)
        # Power-of-two bit count >= BITS_PER_KEY per key (min one word).
        want = max(64, n * BITS_PER_KEY)
        m = 1 << (want - 1).bit_length()
        words = np.zeros(m // 64, dtype=np.uint64)
        if n:
            for idx in cls._indices(fps, m):
                np.bitwise_or.at(
                    words, idx >> np.uint64(6),
                    np.uint64(1) << (idx & np.uint64(63)),
                )
        return cls(words, n)

    @staticmethod
    def _indices(fps: np.ndarray, m_bits: int):
        mask = np.uint64(m_bits - 1)
        h1 = _mix(fps, _M1, _M2)
        # Odd step so every (h1, h2) pair walks the whole table.
        h2 = _mix(fps, _M3, _M4) | np.uint64(1)
        for i in range(NUM_HASHES):
            yield (h1 + np.uint64(i) * h2) & mask

    def contains(self, fps: np.ndarray) -> np.ndarray:
        """Membership mask (with false positives, never false negatives)."""
        fps = np.asarray(fps, dtype=np.uint64)
        out = np.ones(len(fps), dtype=bool)
        if self.n_keys == 0:
            out[:] = False
            return out
        for idx in self._indices(fps, self.m_bits):
            out &= (
                self.words[idx >> np.uint64(6)]
                >> (idx & np.uint64(63))
            ) & np.uint64(1) != 0
            if not out.any():
                break
        return out

    @property
    def nbytes(self) -> int:
        return self.words.nbytes

    # -- checkpoint round trip --------------------------------------------

    def to_state(self) -> dict:
        return {"words": self.words, "n_keys": self.n_keys}

    @classmethod
    def from_state(cls, state: dict) -> "BloomFilter":
        return cls(np.asarray(state["words"], np.uint64), state["n_keys"])
