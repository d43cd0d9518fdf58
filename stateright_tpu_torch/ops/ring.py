"""Device-resident FIFO ring of frontier rows, for the deep drain.

The torch port of the JAX package's ``ops/ring.py``. The drain keeps its
pending frontier in a fixed-capacity ring of frontier rows in device
memory: waves take up to a rung's width from the head and push their fresh
rows at the tail. Every op has a fixed shape and reads no value back to
the host, so a drain can run many of them back to back (and a CUDA Graph
can capture them):

- ``ring_push`` is a cumsum-compacted masked scatter; unmasked lanes go to
  the trash row at index ``capacity``;
- ``ring_take`` is a masked gather of ``width`` lanes from the head;
- ``ring_export`` puts the rows in FIFO order (ring growth).

``capacity`` is a power of two. Rows are dicts ``{states, hi, lo, ebits,
depth}`` with a leading lane axis; the ring's own storage has
``capacity + 1`` rows, the last being the trash row. ``head`` and
``count`` are 0-dim int64 tensors on the ring's device. u32 values ride in
int64, as everywhere in the port.
"""

from __future__ import annotations

import torch

from ..core.batch import leaves, map_leaves

__all__ = ["ring_rows", "ring_push", "ring_take", "ring_export"]

_ROW_KEYS = ("hi", "lo", "ebits", "depth")


def ring_rows(model, width: int, device="cpu"):
    """Zeroed frontier-row storage of the given width for ``model``'s
    packed states."""
    init = model.packed_init_states(device)
    z = torch.zeros((width,), dtype=torch.int64, device=device)
    return {
        "states": map_leaves(
            lambda x: torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=device),
            init,
        ),
        **{k: z.clone() for k in _ROW_KEYS},
    }


def ring_push(pool, head, count, rows, mask, capacity: int):
    """Appends ``rows``'s masked lanes at the ring tail (any mask pattern),
    in place; returns the new ``count``. ``pool`` holds ``capacity + 1``
    rows; the caller keeps ``count`` plus the masked lanes within
    ``capacity``."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask, (head + count + pos) & (capacity - 1), capacity)

    for dst, src in zip(leaves(pool["states"]), leaves(rows["states"])):
        dst[dest] = src
    for k in _ROW_KEYS:
        pool[k][dest] = rows[k]
    return count + mask.sum()


def ring_take(pool, head, count, capacity: int, width: int, go=None):
    """Takes up to ``width`` lanes from the ring head as a frontier with a
    ``mask`` of its live lanes (a prefix); returns ``(frontier, head,
    count, n)`` with ``n`` the lanes taken. ``go`` (a 0/1 int64 tensor),
    when given, scales the take: a stopped drain takes nothing."""
    lanes = torch.arange(width, dtype=torch.int64, device=head.device)
    n = torch.minimum(count, torch.full_like(count, width))
    if go is not None:
        n = n * go
    idx = (head + lanes) & (capacity - 1)
    frontier = {
        "states": map_leaves(lambda x: x[idx], pool["states"]),
        **{k: pool[k][idx] for k in _ROW_KEYS},
        "mask": lanes < n,
    }
    return frontier, (head + n) & (capacity - 1), count - n, n


def ring_export(pool, head, count, capacity: int):
    """The ring contents in FIFO order, ``capacity`` rows with the mask of
    the ``count`` valid lanes attached."""
    lanes = torch.arange(capacity, dtype=torch.int64, device=head.device)
    idx = (head + lanes) & (capacity - 1)
    return {
        "states": map_leaves(lambda x: x[idx], pool["states"]),
        **{k: pool[k][idx] for k in _ROW_KEYS},
        "mask": lanes < count,
    }

