"""Device-resident fingerprint set: open addressing over (hi, lo) rows.

The torch counterpart of the JAX package's ``ops/hashset.py``: a
``(capacity + MAX_PROBES, 2)`` table of (hi, lo) fingerprint pairs with
linear probing and no wraparound (probes run into a ``MAX_PROBES``-row
apron past the end). The table is stored as ``torch.int32`` holding the
u32 bit patterns, so its bytes are exactly the JAX package's uint32 table
(``interop.table_from_numpy`` / ``table_to_numpy`` carry it across).

The home slot is monotone in the key: the top ``log2(capacity)`` bits of
hi. Sorted batches therefore touch the table left to right, which is what
the tile-sweep insert (``ops/hashset_kernel.py``) relies on.

The all-zero pair is the empty sentinel (fingerprints are never (0, 0) —
see ``ops/fingerprint.py``).
"""

from __future__ import annotations

import torch

from .fingerprint import U32

__all__ = [
    "MAX_PROBES",
    "hashset_contains",
    "hashset_new",
    "i32_to_u32",
    "u32_to_i32",
]

# Probe cap per insert; keys still unplaced after this report pending and
# the checker grows the table.
MAX_PROBES = 128


def hashset_new(capacity: int, device="cpu") -> torch.Tensor:
    """An empty table. ``capacity`` must be a power of two; the allocation
    carries a ``MAX_PROBES``-row apron so probes never wrap."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return torch.zeros((capacity + MAX_PROBES, 2), dtype=torch.int32, device=device)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values carried in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> u32 values carried in int64."""
    return x.to(torch.int64) & U32


def _home(key_hi: torch.Tensor, capacity: int) -> torch.Tensor:
    """Monotone home slot of u32 ``key_hi`` (int64): the top
    ``log2(capacity)`` bits."""
    k = capacity.bit_length() - 1
    if k == 0:
        return torch.zeros_like(key_hi)
    return key_hi >> (32 - k)


def _row_keys(table: torch.Tensor) -> torch.Tensor:
    """Each table row as one int64 ``(hi << 32) | lo`` (0 for empty rows)."""
    return (i32_to_u32(table[:, 0]) << 32) | i32_to_u32(table[:, 1])


def hashset_contains(
    table: torch.Tensor, key_hi: torch.Tensor, key_lo: torch.Tensor,
    chunk: int = 1 << 14,
) -> torch.Tensor:
    """Batched membership probe (no mutation) of u32 keys carried in int64:
    a key is present iff it matches a row of its probe window before the
    window's first empty row."""
    capacity = table.shape[0] - MAX_PROBES
    rows = _row_keys(table)
    keys = (key_hi << 32) | key_lo
    home = _home(key_hi, capacity)
    probe = torch.arange(MAX_PROBES, device=table.device)
    out = torch.zeros(keys.shape[0], dtype=torch.bool, device=table.device)
    for s in range(0, keys.shape[0], chunk):
        win = rows[home[s : s + chunk, None] + probe]
        big = torch.full_like(win, MAX_PROBES)
        idx = probe.expand_as(win)
        first_empty = torch.where(win == 0, idx, big).min(dim=1).values
        first_match = torch.where(
            win == keys[s : s + chunk, None], idx, big
        ).min(dim=1).values
        out[s : s + chunk] = first_match < first_empty
    return out
