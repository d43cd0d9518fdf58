"""The random draws of the device walkers: JAX's threefry streams in torch.

The JAX package's walkers (``checker/tpu_simulation.py`` and
``checker/swarm.py``) draw every random number from ``jax.random`` with raw
``uint32[2]`` keys: ``fold_in(PRNGKey(seed), lane)`` seeds a lane,
``split(key, 3)`` forks it each step, ``randint`` picks a restart seed and
``categorical`` over 0 / -1e30 logits picks a valid action. This module
computes the same values bit for bit, so the port's walks are the JAX
package's walks, step for step.

Values are u32 carried in ``int64`` (as everywhere in the port); keys are
``(..., 2)`` int64 tensors ``(k0, k1)``. Every function is batched over the
leading axes, reads no host value and so runs inside a captured CUDA Graph;
the same integer code runs on the CPU and on the card.

The definitions (``jax/_src/prng.py`` with ``jax_threefry_partitionable``,
the default since JAX 0.5):

- ``threefry2x32``: Threefry-2x32 with 20 rounds, rotations (13, 15, 26, 6)
  and (17, 29, 16, 24), key schedule ``k0, k1, k0 ^ k1 ^ 0x1BD11BDA``;
- ``prng_key(seed)`` = ``(0, seed & 0xFFFFFFFF)``: JAX without 64-bit
  types (its default) takes the seed as 32 bits, so the high word is 0;
- ``fold_in(key, d)`` = ``threefry(key, (0, d))``;
- ``split(key, n)``: key ``i`` is ``threefry(key, (0, i))``;
- ``random_bits32(key, n)``: draw ``i`` is ``out0 ^ out1`` of
  ``threefry(key, (0, i))``;
- ``randint(key, n)``: JAX's two-draw reduction (``_randint``), with its
  u32 wrap of the multiplier once ``n`` passes 2^16;
- ``choose(key, valid)``: ``categorical(key, where(valid, 0, -1e30))``. JAX
  adds Gumbel noise ``-log(-log(u))`` to the logits, with ``u`` made from the
  top 23 bits of ``random_bits32``; the noise rises strictly with those bits
  (checked over all 2^23 values in ``tests/test_torch_threefry.py``), so the
  draw is the first valid action with the largest top 23 bits, and 0 when
  no action is valid.
"""

from __future__ import annotations

import torch

__all__ = [
    "choose",
    "choose_from_bits",
    "draw_step",
    "fold_in",
    "lane_keys",
    "prng_key",
    "randint",
    "random_bits32",
    "split",
    "threefry2x32",
]

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Bits of a draw that JAX's uniform keeps (float32's mantissa).
_MANTISSA_BITS = 23


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters ``(x0, x1)`` under the key
    ``(k0, k1)``; all u32 in int64, broadcast together. Returns the two
    output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    # x1 is kept to 32 bits (it is rotated); x0 only ever feeds additions
    # and the xor into x1, whose mask drops its carries, so it is masked
    # once at the end (it stays far below 2^63).
    x0 = x0 + k0
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0 & M32, x1


def _hash(key, counter):
    """``threefry(key, (0, counter))`` as a ``(..., 2)`` key tensor; ``key``
    is ``(..., 2)``, ``counter`` broadcasts against its leading axes."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(counter), counter)
    return torch.stack([y0, y1], dim=-1)


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` int64 key, as JAX makes it
    without 64-bit types (its default): ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2^32): a
    ``(..., 2)`` key per element of ``data`` (a tensor broadcast against
    the key's leading axes)."""
    return _hash(key, data)


def lane_keys(seed: int, lanes: int, device="cpu") -> torch.Tensor:
    """The walkers' per-lane streams: ``fold_in(PRNGKey(seed), lane)`` for
    each of ``lanes`` lanes, ``(lanes, 2)``."""
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    return fold_in(prng_key(seed, device), lane)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``(..., n, 2)`` keys."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return _hash(key.unsqueeze(-2), i)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: ``(..., n)`` u32 in int64."""
    y = split(key, n)
    return y[..., 0] ^ y[..., 1]


def _randint_from_bits(hi_bits, lo_bits, n: int):
    """JAX's ``_randint`` reduction of two u32 draws into [0, n)."""
    n = int(n)
    multiplier = ((((1 << 16) % n) ** 2) & M32) % n
    return ((hi_bits % n * multiplier + lo_bits % n) & M32) % n


def randint(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, n)`` for each key of ``(..., 2)``:
    ``(...)`` int64 in [0, n)."""
    k = split(key, 2)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    bits = _hash(k, zero)
    bits = bits[..., 0] ^ bits[..., 1]
    return _randint_from_bits(bits[..., 0], bits[..., 1], n)


def choose_from_bits(bits, valid):
    """The first valid action with the largest top 23 bits of its draw
    (``bits``, ``valid``: ``(..., A)``); 0 where none is valid."""
    A = valid.shape[-1]
    sh = max(1, (A - 1).bit_length())
    a = torch.arange(A, dtype=torch.int64, device=valid.device)
    # The score orders by the draw's top bits, then by the lower action id;
    # it is unique per action, so the maximum names one action.
    score = ((bits >> (32 - _MANTISSA_BITS)) << sh) | ((1 << sh) - 1 - a)
    best = torch.where(valid, score, torch.full_like(score, -1)).amax(dim=-1)
    return torch.where(best >= 0, (1 << sh) - 1 - (best & ((1 << sh) - 1)),
                       torch.zeros_like(best))


def choose(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, where(valid, 0.0, -1e30))`` for each
    key of ``(..., 2)`` and mask row of ``(..., A)``: ``(...)`` int64."""
    return choose_from_bits(random_bits32(key, valid.shape[-1]), valid)


def draw_step(key: torch.Tensor, n_seeds: int, A: int):
    """One walk step's draws for ``(L, 2)`` keys: ``key, k_init, k_act =
    split(key, 3)``, the restart seed ``randint(k_init, n_seeds)`` and the
    ``(L, A)`` action bits ``random_bits32(k_act, A)`` that
    ``choose_from_bits`` turns into ``choose(k_act, valid)`` once the mask
    is known. Three threefry passes instead of five: the randint's
    ``split(k_init, 2)`` and the action bits are one pass (both hash a key
    with counters ``(0, i)``). Returns ``(next_key, init_idx, bits)``, each
    equal to the separate calls."""
    L = key.shape[0]
    dev = key.device
    k3 = split(key, 3)
    keys = torch.cat([k3[:, 1:2].expand(L, 2, 2), k3[:, 2:3].expand(L, A, 2)], dim=1)
    counters = torch.cat([torch.arange(2, dtype=torch.int64, device=dev),
                          torch.arange(A, dtype=torch.int64, device=dev)])
    y = _hash(keys, counters)
    hb = _hash(y[:, :2], torch.zeros((), dtype=torch.int64, device=dev))
    hb = hb[..., 0] ^ hb[..., 1]
    init_idx = _randint_from_bits(hb[:, 0], hb[:, 1], n_seeds)
    bits = y[:, 2:, 0] ^ y[:, 2:, 1]
    return k3[:, 0], init_idx, bits
