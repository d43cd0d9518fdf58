"""Carrying state across between the JAX package and the port, as numpy.

The JAX package keeps packed states as dicts of ``uint32`` arrays, keys as
``uint32`` (hi, lo) arrays and the visited set as a ``(cap + 128, 2)``
``uint32`` table. The port keeps the same values in torch: packed-state
leaves and keys as ``int64`` carrying u32 values, the table as ``int32``
holding the same bits. These functions convert between the two, so tests
(and a run moved from one package to the other) can give both the same
frontier and the same table. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.hashset import MAX_PROBES

__all__ = [
    "keys_from_numpy",
    "packed_states_from_numpy",
    "packed_states_to_numpy",
    "table_from_numpy",
    "table_to_numpy",
    "walk_carry_from_numpy",
    "walk_carry_to_numpy",
]


def packed_states_from_numpy(states: Dict[str, np.ndarray], device="cpu"):
    """A dict of ``np.uint32`` arrays (leading lane axis) -> the port's
    packed states (``int64`` tensors carrying the u32 values)."""
    return {
        k: torch.from_numpy(np.asarray(v, np.uint32).astype(np.int64)).to(device)
        for k, v in states.items()
    }


def packed_states_to_numpy(states) -> Dict[str, np.ndarray]:
    """The port's packed states -> a dict of ``np.uint32`` arrays."""
    return {k: v.cpu().numpy().astype(np.uint32) for k, v in states.items()}


def keys_from_numpy(hi: np.ndarray, lo: np.ndarray, device="cpu"):
    """``np.uint32`` (hi, lo) key arrays -> the insert's ``int32`` bit
    patterns."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32)).to(device)
        for x in (hi, lo)
    )


def table_from_numpy(table: np.ndarray, device="cpu") -> torch.Tensor:
    """A ``(cap + 128, 2)`` ``np.uint32`` table -> the port's ``int32``
    table with the same bits."""
    t = np.ascontiguousarray(table, np.uint32)
    if t.ndim != 2 or t.shape[1] != 2 or t.shape[0] <= MAX_PROBES:
        raise ValueError(f"expected a (cap + {MAX_PROBES}, 2) table, got {t.shape}")
    return torch.from_numpy(t.view(np.int32).copy()).to(device)


def table_to_numpy(table: torch.Tensor) -> np.ndarray:
    """The port's table -> a ``(cap + 128, 2)`` ``np.uint32`` array."""
    return table.cpu().contiguous().numpy().view(np.uint32).copy()


def walk_carry_from_numpy(carry, device="cpu"):
    """A walker's carry as numpy in the JAX package's dtypes (``uint32``
    state leaves, keys, ebits and trace buffers, ``int32`` depths, ``bool``
    flags), in nested dicts -> the port's tensors: integers as ``int64``
    (u32 values as they are), flags as ``bool``."""
    if isinstance(carry, dict):
        return {k: walk_carry_from_numpy(v, device) for k, v in carry.items()}
    a = np.asarray(carry)
    if a.dtype != np.bool_:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def walk_carry_to_numpy(carry):
    """The port's walker carry (nested dicts of tensors) -> numpy, integers
    as ``int64`` and flags as ``bool``: the form ``walk_carry_from_numpy``
    takes and the JAX package's carry compares with after ``astype``."""
    if isinstance(carry, dict):
        return {k: walk_carry_to_numpy(v) for k, v in carry.items()}
    return carry.cpu().numpy()
