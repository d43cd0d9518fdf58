"""Device-side 64-bit state fingerprinting over packed (tensor) states.

The torch twin of the JAX package's ``ops/fingerprint.py``
(``state_words``, ``fingerprint_words``, ``_finalize_pair``): states are
flattened to a vector of u32 words and a murmur3-style mix is folded over
the words twice with independent seeds, giving a (hi, lo) pair of u32
lanes = one 64-bit fingerprint. Both packages produce the same pair for
the same state, so visited keys, parent logs and ``FP_SCHEME`` are shared.

Every function here is batched: a packed state is a dict of tensors with
a leading lane axis, and each call fingerprints all lanes at once.

u32 arithmetic: torch on the CPU lacks shifts, adds and compares for
``torch.uint32``, and ``>>`` on ``int32`` is arithmetic. So u32 words are
carried in ``int64`` and masked with ``& 0xFFFFFFFF`` after every multiply
and shift. A product of two u32 values may pass 2**63 and wrap; its low 32
bits are still right.

The all-zero pair is reserved as the hash-set empty sentinel and
(MAX, MAX) as the invalid-lane sort sentinel; fingerprints are nudged off
both.
"""

from __future__ import annotations

import math
from typing import Any, List, Tuple

import torch

__all__ = [
    "FP_SCHEME",
    "U32",
    "avalanche32",
    "fingerprint_state",
    "fingerprint_words",
    "fp_to_int",
    "state_words",
]

U32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED_HI = 0x9747B28C
_SEED_LO = 0x3C6EF372
_CHUNKS = 16


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & U32) | (x >> (32 - r))


def _mm3_round(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    k = (k * _C1) & U32
    k = _rotl(k, 15)
    k = (k * _C2) & U32
    h = _rotl(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & U32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def avalanche32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3's fmix32 on u32 values carried in int64 (bit-identical to
    the JAX package's ``avalanche32``)."""
    return _fmix(h & U32)


def _leaf_words(leaf: torch.Tensor) -> torch.Tensor:
    """One batched leaf ``(N, ...)`` as ``(N, W)`` int64 u32 words, with the
    JAX package's per-dtype conversion: bool and small ints widen (signed
    ones wrap), int32 and float32 are bit-cast, and int64 leaves carry u32
    values."""
    x = leaf
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    elif x.dtype not in (
        torch.bool, torch.int8, torch.uint8, torch.int16, torch.uint16,
        torch.int32, torch.int64,
    ):
        raise TypeError(f"cannot fingerprint leaf dtype {x.dtype}")
    return (x.to(torch.int64) & U32).reshape(x.shape[0], math.prod(x.shape[1:]))


def _leaves(state: Any) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
    sequences in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    raise TypeError(f"packed state leaf of type {type(state).__name__}")


def state_words(states: Any) -> torch.Tensor:
    """Flattens a batch of packed states to their canonical ``(N, W)`` u32
    words (int64). The word layout follows the pytree structure, so two
    states of the same model always flatten identically."""
    leaves = _leaves(states)
    if not leaves:
        raise ValueError("packed state has no array leaves")
    return torch.cat([_leaf_words(x) for x in leaves], dim=1)


def fingerprint_words(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) u32 fingerprint pairs of ``(N, n)`` word rows.

    Rows of at most 64 words fold serially; wider rows are hashed as
    ``_CHUNKS`` independent lanes whose digests then fold through a short
    chain, exactly as the JAX package does (zero padding is safe: the word
    count is folded into the finalizer)."""
    N, n = words.shape
    dev = words.device
    hi = torch.full((N,), _SEED_HI, dtype=torch.int64, device=dev)
    lo = torch.full((N,), _SEED_LO, dtype=torch.int64, device=dev)
    if n <= 64:
        for i in range(n):
            w = words[:, i]
            hi = _mm3_round(hi, w)
            lo = _mm3_round(lo, w ^ 0xA5A5A5A5)
    else:
        L = -(-n // _CHUNKS)
        padded = torch.nn.functional.pad(words, (0, L * _CHUNKS - n))
        padded = padded.reshape(N, _CHUNKS, L)
        lane = torch.arange(_CHUNKS, dtype=torch.int64, device=dev)
        chi = (_SEED_HI ^ ((lane * 0x9E3779B9) & U32)).expand(N, _CHUNKS)
        clo = (_SEED_LO ^ ((lane * 0x85EBCA6B) & U32)).expand(N, _CHUNKS)
        for j in range(L):
            w = padded[:, :, j]
            chi = _mm3_round(chi, w)
            clo = _mm3_round(clo, w ^ 0xA5A5A5A5)
        for k in range(_CHUNKS):
            hi = _mm3_round(hi, chi[:, k])
            lo = _mm3_round(lo, clo[:, k])
    return _finalize_pair(hi, lo, n)


def _finalize_pair(hi: torch.Tensor, lo: torch.Tensor, n: int):
    """Shared fmix + sentinel nudges: (0, 0) is the hash-set empty slot,
    (MAX, MAX) the checkers' invalid-lane sort sentinel."""
    hi = _fmix(hi ^ ((n * 4) & U32))
    lo = _fmix(lo ^ ((n * 4 + 1) & U32))
    lo = torch.where((hi == 0) & (lo == 0), torch.ones_like(lo), lo)
    lo = torch.where((hi == U32) & (lo == U32), torch.full_like(lo, U32 - 1), lo)
    return hi, lo


def fingerprint_state(states: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) fingerprints of a batch of packed states, each ``(N,)``."""
    return fingerprint_words(state_words(states))


def fp_to_int(hi, lo) -> int:
    """Host-side: a (hi, lo) pair as one python int fingerprint."""
    return (int(hi) << 32) | int(lo)


# Identifies the fingerprint definition; the same string as the JAX
# package's, because the two produce the same keys.
FP_SCHEME = "linhash/comphash-v6"
