"""Sound ``eventually`` verdicts on the device: edge log + verdict + certificate.

The port of the JAX package's ``checker/device_liveness.py``. The default
device semantics reproduce the reference's documented false negatives
(``checker/liveness.py``): ``eventually`` bits merge at DAG joins and
cycles are invisible to a BFS that stores tree edges only. The host
post-pass (``complete_liveness()``) fixes that at O(condition-false
region) single-threaded cost. ``liveness="device"`` replaces it with a
three-stage procedure:

1. **Log** (in the staged wave, :func:`wave_edge_rows`): per eventually
   property, every (parent, child) transition whose BOTH endpoints fail
   the condition, plus condition-false terminal states and
   condition-false init states (roots, :func:`seed_root_mask`). Appended
   to the capacity-budgeted device log (``ops/edge_store.py``), evicted
   to the host tier (``storage/edge_log.py``) before it could overflow.

2. **Decide** (:func:`analyze_liveness`): a counterexample exists iff the
   condition-false subgraph, restricted to states reachable from a
   condition-false init through condition-false states only, contains a
   cycle (lasso shape) or a terminal state (masked-terminal shape). The
   cycle half is the iterative trim (non-empty fixed point ⟺ a cycle
   exists among the logged edges); the restriction is the
   root-reachability fixpoint, run only when candidates exist, so the
   absence verdict normally needs the trim alone. Both run on the
   checker's device. Equivalence with the host pass
   (``find_eventually_lasso``): both decide "∃ maximal condition-false
   path from a condition-false init", whose finite-space shapes are
   exactly {reachable cycle, reachable terminal}.

3. **Certify**: a concrete :class:`~..core.path.Path` is extracted from
   the LOGGED edges: a deterministic BFS from the roots to the first
   candidate (shortest condition-false prefix), extended around the
   cycle by walking surviving successors when the candidate is a trim
   survivor, then replayed through the host model
   (``Path.from_fingerprints``).

Duplicate edges (a wave run again after a table growth or a probe
overflow logs its rows again) dedup in the host store, so verdicts and
certificates are independent of retry timing and of the drain: the
distinct relation is the same either way.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.model import Expectation
from ..core.path import Path
from ..ops.edge_store import lasso_trim, reach_any

__all__ = [
    "LIVENESS_MODES",
    "analyze_liveness",
    "seed_root_mask",
    "validate_liveness_mode",
    "wave_edge_rows",
]

# The spawn-knob vocabulary.
LIVENESS_MODES = (None, "default", "device")


def validate_liveness_mode(liveness, *, symmetry: bool, expand_fps,
                           options) -> Optional[str]:
    """Normalizes and validates the ``liveness=`` spawn knob for a
    device checker; returns ``"device"`` or ``None``. Raises on
    configurations whose edge relation would be incomplete (the verdict
    would silently lose soundness — refusing is the honest move)."""
    if liveness not in LIVENESS_MODES:
        raise ValueError(
            f"liveness must be one of {LIVENESS_MODES}, got {liveness!r}"
        )
    if liveness != "device":
        return None
    if symmetry:
        raise ValueError(
            "liveness='device' is incompatible with symmetry reduction: "
            "orbit-deduped states are never re-expanded, so the logged "
            "edge relation would miss their outgoing transitions and "
            "the cycle verdict would be unsound; use the host post-pass "
            "(.complete_liveness()) under symmetry"
        )
    if expand_fps:
        raise ValueError(
            "liveness='device' is incompatible with expand_fps=True: "
            "the fingerprint-only wave never materializes candidate "
            "states, so child condition values cannot be evaluated "
            "in-wave; drop expand_fps (device liveness forces the "
            "materializing wave)"
        )
    if (
        options._target_state_count is not None
        or options._target_max_depth is not None
    ):
        raise ValueError(
            "liveness='device' requires an uncapped run: a capped "
            "exploration logs a truncated edge relation, and a verdict "
            "over it could certify absence that a deeper run refutes"
        )
    return "device"


def _bit_where(sel, b):
    return torch.where(sel, 1 << b, 0)


def wave_edge_rows(conditions, ebit: Dict[int, int], cond_vals, cand_flat, cvalid_flat,
                   terminal, hi, lo, chi, clo, A: int):
    """A staged wave's condition-false edge and terminal rows,
    prefix-compacted into (B + F)-row int64 columns carrying u32 values:
    edges first, in lane order, then terminal rows with the (0, 0) child
    sentinel, in frontier order. ``conditions`` are the model's batched
    ``packed_conditions``, ``cond_vals`` the frontier's (P, F) condition
    matrix, ``cvalid_flat`` the candidates' valid bits under the eval mask,
    ``terminal`` the frontier's terminal lanes, ``chi``/``clo`` the
    candidates' fingerprints in lane order. Returns ``(rows, n)``, ``n`` a
    0-dim tensor; nothing is read back."""
    B = cvalid_flat.shape[0]
    F = hi.shape[0]
    dev = hi.device
    prow = torch.arange(B, dtype=torch.int64, device=dev) // A
    emask = torch.zeros(B, dtype=torch.int64, device=dev)
    tmask = torch.zeros(F, dtype=torch.int64, device=dev)
    for pi, b in ebit.items():
        pfalse = ~cond_vals[pi]
        cc = conditions[pi](cand_flat).to(torch.bool)
        emask = emask | _bit_where(cvalid_flat & pfalse[prow] & ~cc, b)
        tmask = tmask | _bit_where(terminal & pfalse, b)
    sel_e, sel_t = emask != 0, tmask != 0
    n_e = sel_e.sum()
    width = B + F
    slot_e = torch.where(sel_e, torch.cumsum(sel_e, 0) - 1, width)
    slot_t = torch.where(sel_t, n_e + torch.cumsum(sel_t, 0) - 1, width)

    def column(pairs):
        out = torch.zeros(width + 1, dtype=torch.int64, device=dev)
        for slot, vals in pairs:
            out[slot] = vals
        return out[:width]

    rows = {
        "phi": column([(slot_e, hi[prow]), (slot_t, hi)]),
        "plo": column([(slot_e, lo[prow]), (slot_t, lo)]),
        "chi": column([(slot_e, chi)]),
        "clo": column([(slot_e, clo)]),
        "emask": column([(slot_e, emask)]),
        "tmask": column([(slot_t, tmask)]),
    }
    return rows, n_e + sel_t.sum()


def seed_root_mask(conditions, ebit: Dict[int, int], states, valid):
    """The per-init-lane int64 mask (u32 bits) of eventually properties
    whose condition is FALSE at that valid init state: the analysis
    roots."""
    mask = torch.zeros(valid.shape[0], dtype=torch.int64, device=valid.device)
    for pi, b in ebit.items():
        mask = mask | _bit_where(valid & ~conditions[pi](states).to(torch.bool), b)
    return mask


# -- analysis ----------------------------------------------------------------


def _certificate_fps(src_idx, dst_idx, roots_idx, cand_mask, alive,
                     nodes) -> np.ndarray:
    """Deterministic certificate extraction over the logged edges:
    BFS (sorted adjacency, sorted root seed order) from the roots to the
    first candidate; a trim-surviving candidate is extended around its
    cycle by always walking the smallest surviving successor. Returns
    the fingerprint trail (u64)."""
    from collections import deque

    N = len(nodes)
    order = np.lexsort((dst_idx, src_idx))
    s_sorted = src_idx[order]
    d_sorted = dst_idx[order]
    starts = np.searchsorted(s_sorted, np.arange(N + 1))
    pred = np.full((N,), -1, np.int64)
    seen = np.zeros((N,), bool)
    q = deque()
    for r in sorted(roots_idx):
        if not seen[r]:
            seen[r] = True
            q.append(int(r))
    found = -1
    while q:
        v = q.popleft()
        if cand_mask[v]:
            found = v
            break
        for u in d_sorted[starts[v]:starts[v + 1]]:
            u = int(u)
            if not seen[u]:
                seen[u] = True
                pred[u] = v
                q.append(u)
    if found < 0:
        raise RuntimeError("certificate extraction: no candidate reachable")
    trail = [found]
    while pred[trail[-1]] >= 0:
        trail.append(int(pred[trail[-1]]))
    trail.reverse()
    if alive[found]:
        # Lasso: extend around the cycle — each survivor keeps at least
        # one surviving successor (the trim fixed-point invariant).
        on_walk = {found}
        cur = found
        while True:
            succs = [int(u) for u in d_sorted[starts[cur]:starts[cur + 1]] if alive[u]]
            if not succs:
                raise RuntimeError("trim fixed point lost its successor")
            nxt = min(succs)
            trail.append(nxt)
            if nxt in on_walk:
                break
            on_walk.add(nxt)
            cur = nxt
    return nodes[np.asarray(trail, np.int64)]


def analyze_liveness(model, properties, ebit: Dict[int, int], store, fp_of, have,
                     instruments=None, tracer=None, device="cpu",
                     ) -> Tuple[Dict[str, Path], Dict[str, dict]]:
    """End-of-exploration device-liveness pass: one verdict per
    still-undiscovered ``eventually`` property, the trim and the reach on
    ``device``. Returns ``(paths, outcomes)`` where ``outcomes[name]``
    records the verdict (``"counterexample"`` / ``"absent"``) and the
    analysis evidence (edge/node counts, trim rounds, seconds)."""
    paths: Dict[str, Path] = {}
    outcomes: Dict[str, dict] = {}
    # One spill re-read + full-relation dedup for the whole pass: the
    # relation is property-independent; only the per-row mask bit
    # differs, and property_slice slices it from this shared view.
    all_rows = None
    for pi, prop in enumerate(properties):
        if prop.expectation != Expectation.EVENTUALLY:
            continue
        if prop.name in have:
            outcomes[prop.name] = {"verdict": "already_discovered"}
            continue
        b = ebit[pi]
        t0 = time.perf_counter()
        if all_rows is None:
            all_rows = store.edge_rows()
        src64, dst64, roots64, terms64 = store.property_slice(b, rows=all_rows)
        record = {
            "verdict": "absent",
            "edges": int(len(src64)),
            "roots": int(len(roots64)),
            "terminals": int(len(terms64)),
            "trim_rounds": 0,
            "survivors": 0,
        }
        if len(roots64) == 0:
            # Every init satisfies the condition already — every path
            # satisfies the property at step 0.
            record["seconds"] = time.perf_counter() - t0
            outcomes[prop.name] = record
            _count(instruments, record)
            continue
        nodes = np.unique(np.concatenate([roots64, terms64, src64, dst64]))
        N = len(nodes)
        src_idx = np.searchsorted(nodes, src64).astype(np.int64)
        dst_idx = np.searchsorted(nodes, dst64).astype(np.int64)
        evalid = np.ones((len(src_idx),), bool)
        nvalid = np.ones((N,), bool)
        record["nodes"] = N
        alive = np.zeros((N,), bool)
        if len(src_idx):
            alive, rounds = lasso_trim(src_idx, dst_idx, evalid, nvalid, device=device)
            record["trim_rounds"] = rounds
            record["survivors"] = int(alive.sum())
        term_mask = np.zeros((N,), bool)
        term_mask[np.searchsorted(nodes, terms64)] = True
        cand = alive | term_mask
        if cand.any():
            roots_idx = np.searchsorted(nodes, roots64)
            roots_mask = np.zeros((N,), bool)
            roots_mask[roots_idx] = True
            hit, _reach = reach_any(src_idx, dst_idx, evalid, roots_mask, cand,
                                    device=device)
            if hit:
                fps = _certificate_fps(src_idx, dst_idx, roots_idx, cand, alive, nodes)
                paths[prop.name] = Path.from_fingerprints(
                    model, [int(f) for f in fps], fp_of=fp_of
                )
                record["verdict"] = "counterexample"
                record["certificate_len"] = int(len(fps))
        record["seconds"] = time.perf_counter() - t0
        outcomes[prop.name] = record
        _count(instruments, record)
        if tracer is not None:
            tracer.instant(
                "liveness.verdict", property=prop.name, **{
                    k: v for k, v in record.items() if k != "verdict"
                }, verdict=record["verdict"],
            )
    return paths, outcomes


def _count(instruments, record) -> None:
    if instruments is None:
        return
    instruments.trim_rounds.inc(record.get("trim_rounds", 0))
    if record["verdict"] == "counterexample":
        instruments.counterexamples.inc()
    elif record["verdict"] == "absent":
        instruments.absences.inc()
    if "seconds" in record:
        instruments.analysis_seconds.set(record["seconds"])
