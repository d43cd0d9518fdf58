"""Device condition-false edge log + the lasso-decision fixpoints, in torch.

The port of the JAX package's ``ops/edge_store.py``. The device checker's
parent-pointer log records TREE edges only, so it can never answer "does
the condition-false subgraph contain a cycle?", the question
``eventually`` soundness hangs on (``checker/liveness.py``). This module
is the missing edge relation and the decision procedure:

- **Edge log** (``edge_log_new`` / ``edge_log_append``): an append-only
  log of (parent_fp, child_fp) u32-pair rows plus two u32 masks,
  ``emask`` (bit *b* set: both endpoints fail eventually-property *b*'s
  condition) and ``tmask`` (bit *b* set: the PARENT row is a terminal
  state failing property *b*; terminal rows carry a (0, 0) child
  sentinel, which no fingerprint can collide with). The u32 values ride
  in int64 columns, as everywhere in the port. The append runs inside
  the staged wave, on the wave path and inside the captured drain: fixed
  shapes, no host read. The log has one spare "drop" row at index
  ``capacity``, where rows past the capacity land; the host evicts the
  log to ``storage.LivenessEdgeStore`` before a wave could overflow it.

- **Trim** (``lasso_trim``): decides "a cycle exists among these edges"
  by iterated elimination of nodes with no outgoing edge. A non-empty
  fixed point ⟺ a cycle exists: every surviving node keeps an out-edge to
  a survivor, so survivors carry infinite paths, and a finite graph with
  one has a cycle. Each round also CONTRACTS out-degree-1 chains with
  pointer doubling: ``f[v]`` = the unique successor (or ``v`` at
  branch/dead nodes), squared ``log2(N)`` times, lands every chain node on
  its chain's terminus; a dead terminus kills the whole chain in that one
  round. Rounds are thus bounded by the *branching* peel depth, and a
  pure cycle survives at once.

- **Reach** (``reach_any``): frontier propagation from the
  condition-false roots with an any-candidate early exit: the
  restriction that keeps the verdict sound (a condition-false cycle
  hiding behind a condition-TRUE articulation state is NOT a
  counterexample; see ``checker/device_liveness.py``).

Both fixpoints run on the caller's device over the CSR arrays that
``_csr`` prepares on the host, padded to power-of-two shapes as the JAX
package pads them, and read their loop flag on the host once a round.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "EDGE_COLS",
    "edge_log_append",
    "edge_log_new",
    "lasso_trim",
    "reach_any",
]

# Columns of one edge-log row (u32 values in int64).
EDGE_COLS = ("phi", "plo", "chi", "clo", "emask", "tmask")


def edge_log_new(capacity: int, device) -> dict:
    """An empty device edge log: ``capacity`` rows of the six columns and
    the drop row at index ``capacity``, plus the 0-dim device fill
    ``count``."""
    log = {c: torch.zeros(capacity + 1, dtype=torch.int64, device=device)
           for c in EDGE_COLS}
    log["count"] = torch.zeros((), dtype=torch.int64, device=device)
    return log


def edge_log_append(log: dict, rows: dict, n, capacity: int) -> dict:
    """Appends the first ``n`` rows of ``rows`` (prefix-compacted,
    same-length columns) at the log's fill point, in place, and returns
    the log. Rows past ``capacity`` land on the drop row, and ``count``
    still advances (an overflow is ``count > capacity``), as in the JAX
    package. ``n`` is an int or a 0-dim device tensor: nothing is read
    back, so the append can be captured in a CUDA Graph."""
    count = log["count"]
    lanes = torch.arange(rows["phi"].shape[0], dtype=torch.int64, device=count.device)
    dest = torch.where(lanes < n, torch.clamp(count + lanes, max=capacity), capacity)
    for c in EDGE_COLS:
        log[c][dest] = rows[c]
    count.add_(n)
    return log


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _seg_sums(active, values, starts):
    """Per-node segment reductions over src-sorted edges without a scatter:
    differences of cumsums at the CSR row pointers ``starts`` ((N + 1,)
    indices into the edge axis). Returns ``(count, sum)`` of the active
    edges' ``values`` per node (``sum`` None when ``values`` is None). The
    sums are int64 where the JAX package's wrap modulo 2^32; the value the
    trim reads, the sum where ``count == 1`` (that one edge's value, a node
    index), is exact either way."""
    zero = torch.zeros(1, dtype=torch.int64, device=active.device)
    csc = torch.cat([zero, torch.cumsum(active.to(torch.int64), 0)])
    count = csc[starts[1:]] - csc[starts[:-1]]
    if values is None:
        return count, None
    csd = torch.cat([zero, torch.cumsum(torch.where(active, values, 0), 0)])
    return count, csd[starts[1:]] - csd[starts[:-1]]


def _csr(src, dst, evalid, n_nodes):
    """Host-side CSR prep shared by the fixpoints: sort edges by src, pad
    to power-of-two shapes (padding rows inactive), build the (Np + 1,)
    row pointers. Returns numpy arrays and ``Np``."""
    E = len(src)
    order = np.argsort(src, kind="stable")
    src_s = np.asarray(src, np.int64)[order]
    dst_s = np.asarray(dst, np.int64)[order]
    ev_s = np.asarray(evalid, bool)[order]
    Ep = max(8, _pow2ceil(E))
    Np = max(8, _pow2ceil(n_nodes))
    src_p = np.zeros((Ep,), np.int64)
    dst_p = np.zeros((Ep,), np.int64)
    ev_p = np.zeros((Ep,), bool)
    src_p[:E], dst_p[:E], ev_p[:E] = src_s, dst_s, ev_s
    starts = np.zeros((Np + 1,), np.int64)
    starts[1 : n_nodes + 1] = np.searchsorted(src_s, np.arange(1, n_nodes + 1))
    starts[n_nodes + 1 :] = E
    return src_p, dst_p, ev_p, starts, Np


def _padded(mask, Np):
    out = np.zeros((Np,), bool)
    out[: len(mask)] = mask
    return out


def lasso_trim(src, dst, evalid, nvalid, device="cpu") -> Tuple[np.ndarray, int]:
    """Iterative condition-false trim (see the module docstring) on
    ``device``. Inputs are numpy arrays in any edge order. Returns
    ``(alive bool[N], rounds)``, numpy, sliced back to the caller's node
    count: the JAX package's ``lasso_trim``."""
    N = len(nvalid)
    src_p, dst_p, ev_p, starts, Np = _csr(src, dst, evalid, N)
    src_t, dst_t, ev_t, starts_t, alive = (
        torch.from_numpy(a).to(device)
        for a in (src_p, dst_p, ev_p, starts, _padded(nvalid, Np))
    )
    iota = torch.arange(Np, dtype=torch.int64, device=alive.device)
    doublings = max(1, (Np + 1).bit_length())
    rounds = 0
    go = bool(alive.any())
    while go:
        ae = ev_t & alive[src_t] & alive[dst_t]
        outdeg, usucc = _seg_sums(ae, dst_t, starts_t)
        f = torch.where(outdeg == 1, usucc, iota)
        # The JAX loop stops squaring once f[f] == f; this one always runs
        # all ``doublings`` squarings, with no host read. The result is the
        # same: once f[f] == f, every later squaring returns f again, and
        # where the JAX loop never reaches that fixpoint it runs the same
        # ``doublings`` squarings as this one.
        for _ in range(doublings):
            f = f[f]
        # A node dies iff its out-degree-1 chain ends at a node with no
        # outgoing edge; chains into a cycle never end, and survive.
        alive2 = alive & ~(outdeg[f] == 0)
        go = bool(((alive2 != alive).any() & alive2.any()).item())
        alive = alive2
        rounds += 1
    return alive[:N].cpu().numpy(), rounds


def reach_any(src, dst, evalid, roots, cand, device="cpu") -> Tuple[bool, np.ndarray]:
    """Condition-false reachability from ``roots`` on ``device``, with an
    early exit the moment any ``cand`` node is reached. Returns ``(hit,
    reach)`` (numpy), ``reach`` being the propagation fixpoint actually
    computed (exact when ``hit`` is False: the absence certificate)."""
    N = len(roots)
    # Reachability consumes INCOMING segments: the CSR is over dst.
    dst_p, src_p, ev_p, rstarts, Np = _csr(dst, src, evalid, N)
    src_t, ev_t, starts_t, reach, cand_t = (
        torch.from_numpy(a).to(device)
        for a in (src_p, ev_p, rstarts, _padded(roots, Np), _padded(cand, Np))
    )
    hit = bool((reach & cand_t).any())
    changed = True
    while changed and not hit:
        indeg, _ = _seg_sums(ev_t & reach[src_t], None, starts_t)
        reach2 = reach | (indeg > 0)
        changed, hit = torch.stack(
            [(reach2 != reach).any(), (reach2 & cand_t).any()]).tolist()
        reach = reach2
    return bool(hit), reach[:N].cpu().numpy()
