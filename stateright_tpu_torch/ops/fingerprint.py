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

import functools
import math
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = [
    "FP_SCHEME",
    "U32",
    "acc_finalize",
    "avalanche32",
    "combine_pairs",
    "component_seeds",
    "fingerprint_state",
    "fingerprint_words",
    "fp64_pairs",
    "fp_to_int",
    "hash_rows",
    "lin_consts",
    "multiset_digest",
    "multiset_row_pairs",
    "multiset_salts",
    "pairs_acc",
    "row_salts",
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


# -- the component hash ----------------------------------------------------------
#
# The second half of the scheme: a packed actor state is hashed component
# by component (each actor row, the network's multiset digest, the
# history), each pair seeded by its component's tag, and the pairs are
# combined by commutative sum/xor reductions. Every function works on the
# last axis with any leading (lane) axes, u32 values in int64.


@functools.lru_cache(maxsize=None)
def lin_consts(width: int, salt: int) -> np.ndarray:
    """Deterministic odd u32 coefficient vector (``np.uint32``) for the
    multilinear row hash: the frozen legacy ``RandomState`` stream, whose
    bits numpy keeps stable across versions, as the JAX package draws it.
    Read-only."""
    rng = np.random.RandomState((0xC0FFEE ^ salt) & 0x7FFFFFFF)
    k = rng.randint(0, 1 << 32, size=width, dtype=np.uint32) | np.uint32(1)
    k.flags.writeable = False  # cached: every caller gets this array
    return k


def row_salts(width: int) -> Tuple[int, int]:
    """The (hi, lo) ``lin_consts`` salts of ``hash_rows`` at ``width``."""
    return 0x48AC1 + 2 * width, 0x5B3D5 + 7 * width


def multiset_salts(width: int) -> Tuple[int, int]:
    """The (hi, lo) ``lin_consts`` salts of ``multiset_row_pairs``."""
    return 0x77A11 + 3 * width, 0x19D3F + 11 * width


_CONST_CACHE = {}


def _consts(width: int, salt: int, device) -> torch.Tensor:
    """``lin_consts`` as an int64 tensor on ``device``, made once per
    (width, salt, device): a CUDA Graph capture may not copy from the host,
    and the checker's warm-up wave fills this before any capture."""
    key = (width, salt, str(torch.device(device)))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(lin_consts(width, salt).astype(np.int64)).to(device)
        _CONST_CACHE[key] = t
    return t


def _lin_sum(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``Σ_j rows[..., j] * k[j]`` mod 2^32: each product masked before the
    sum (a product of two u32 values may wrap int64; its low 32 bits are
    still right)."""
    return ((rows * k) & U32).sum(dim=-1) & U32


def multiset_row_pairs(rows: torch.Tensor):
    """Per-row (hi, lo) hashes of a ``(..., E, W)`` table, as
    ``multiset_digest`` folds them: the multilinear row hash under the
    multiset salts, then fmix with the fold's seeds."""
    W = rows.shape[-1]
    khi, klo = (_consts(W, salt, rows.device) for salt in multiset_salts(W))
    return (_fmix(_lin_sum(rows, khi) ^ _SEED_HI),
            _fmix(_lin_sum(rows, klo) ^ _SEED_LO))


def multiset_digest(rows: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` order-insensitive digest (Σhi, ⊕hi, Σlo, ⊕lo) of the
    active rows (``active``: ``(..., E)`` bool) of a ``(..., E, W)``
    table."""
    hi, lo = multiset_row_pairs(rows)
    hi = torch.where(active, hi, 0)
    lo = torch.where(active, lo, 0)
    return torch.stack([
        hi.sum(dim=-1) & U32, _xor_reduce(hi), lo.sum(dim=-1) & U32, _xor_reduce(lo),
    ], dim=-1)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (torch has no xor reduction): a pairwise
    tree of elementwise XORs."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        head = x[..., :half] ^ x[..., half : 2 * half]
        x = torch.cat([head, x[..., 2 * half :]], dim=-1) if n % 2 else head
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return x[..., 0]


def component_seeds(tags):
    """Per-component (hi, lo) seed pairs from integer component tags (a
    tensor or a list of ints): the tag folds the component's position into
    its hash."""
    t = torch.as_tensor(tags, dtype=torch.int64) & U32
    hi = _fmix(_SEED_HI ^ ((t * 0x9E3779B9) & U32))
    lo = _fmix(_SEED_LO ^ ((t * 0x85EBCA6B) & U32))
    return hi, lo


def _seeds(tags: Tuple[int, ...], device):
    """``component_seeds`` of host tags as tensors on ``device``, made once
    per (tags, device) (see ``_consts``)."""
    key = (tags, str(torch.device(device)))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = tuple(x.to(device) for x in component_seeds(list(tags)))
        _CONST_CACHE[key] = t
    return t


def hash_rows(rows: torch.Tensor, tags):
    """(hi, lo) of each row of a ``(..., R, W)`` table, row ``r`` seeded by
    ``tags[r]``: ``fmix(Σ_j w_j · K_j ⊕ seed)`` under independent odd
    constants per lane — the component hash. ``tags`` is a sequence of R
    ints (their seeds are made once per device) or an ``(R,)`` tensor."""
    if isinstance(tags, torch.Tensor):
        thi, tlo = component_seeds(tags)
    else:
        thi, tlo = _seeds(tuple(int(t) for t in tags), rows.device)
    return _seeded_rows(rows, thi, tlo)


def hash_rows_of(rows: torch.Tensor, tags: torch.Tensor, n_tags: int):
    """``hash_rows`` with a tensor of tags in ``0..n_tags-1`` (any shape
    of ``rows``' leading axes), their seeds gathered from the table of all
    ``n_tags`` made once per device."""
    thi, tlo = _seeds(tuple(range(n_tags)), rows.device)
    return _seeded_rows(rows, thi[tags], tlo[tags])


def _seeded_rows(rows, thi, tlo):
    W = rows.shape[-1]
    khi, klo = (_consts(W, salt, rows.device) for salt in row_salts(W))
    return (_fmix(_lin_sum(rows, khi) ^ thi), _fmix(_lin_sum(rows, klo) ^ tlo))


def pairs_acc(his: torch.Tensor, los: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` sum/xor accumulator over ``(..., C)`` component pairs."""
    return torch.stack([
        his.sum(dim=-1) & U32, _xor_reduce(his), los.sum(dim=-1) & U32, _xor_reduce(los),
    ], dim=-1)


def acc_finalize(acc: torch.Tensor, n_components: int):
    """(hi, lo) state fingerprint from a ``(..., 4)`` component
    accumulator: both reductions feed each lane, fmix, then the shared
    finalizer with its sentinel nudges."""
    c = n_components
    hi = _fmix(acc[..., 0] ^ _rotl(acc[..., 1], 16) ^ ((c * 0x9E3779B9) & U32))
    lo = _fmix(acc[..., 2] ^ _rotl(acc[..., 3], 16) ^ ((c * 0x85EBCA6B + 1) & U32))
    return _finalize_pair(hi, lo, c)


def combine_pairs(his: torch.Tensor, los: torch.Tensor):
    """One (hi, lo) state fingerprint from ``(..., C)`` component pairs."""
    return acc_finalize(pairs_acc(his, los), his.shape[-1])


def fp64_pairs(hi, lo) -> np.ndarray:
    """Host-side: (hi, lo) u32 arrays (or tensors) as one ``np.uint64``
    array."""
    if isinstance(hi, torch.Tensor):
        hi, lo = hi.cpu().numpy(), lo.cpu().numpy()
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(lo).astype(np.uint64) & np.uint64(U32)
    )


# Identifies the fingerprint definition; the same string as the JAX
# package's, because the two produce the same keys.
FP_SCHEME = "linhash/comphash-v6"
