"""Batched trace-conformance replay over the packed model, on the card.

The port of the JAX package's ``conformance/replay.py``. Each lane replays
one uploaded action sequence through the model and reports whether the
recorded execution is a behaviour of the model:

- a step whose ``valid`` bit is False is a **divergence**: the recorded
  action's guard does not hold where the trace claims it fired (the host
  model would never have enumerated it there). The verdict is the first
  divergence index plus the offending action id, per lane.
- lanes are traces; a bucket of same-shape traces (same model config, same
  padded length T) is ONE dispatch. A step is ``packed_expand`` over the
  lanes and, per lane, the candidate and valid bit of its recorded action
  (the port's models have no ``packed_step``; ``packed_expand``'s valid
  mask equals it everywhere). On the card the whole T-step loop is one
  captured CUDA Graph per ``(namespace, T, L)``, replayed for every later
  batch of that shape; on the CPU the loop runs eagerly.

``replay_host`` is the parity oracle: the same replay as a one-lane loop in
plain Python, diffed bit for bit (divergence index AND offending action) by
the parity tests and the checker's gate. Padding is honest: action slots
past a trace's real length are -1 and never step, so a short trace in a
long bucket cannot pick up phantom divergences.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..checker.gpu import _collector_paused, resolve_device
from ..checker.gpu_simulation import zip_where
from ..core.batch import leaves, map_leaves


def _gather_inits(model, init_indices: Sequence[int]):
    """Stacks the requested rows of ``packed_init_states()`` into a
    lane-batched packed state on the host (init indices were validated at
    ingestion)."""
    idx = torch.as_tensor(list(init_indices), dtype=torch.int64)
    return map_leaves(lambda x: x[idx], model.packed_init_states())


def validate_trace(rec: dict, model) -> Optional[str]:
    """Model-aware ingestion check for one decoded trace record: action
    ids must be dense ids of this model, the init index must exist.
    Returns a refusal reason or None. (Wire decode cannot do this — it
    has no model; the checker calls it once the factory resolved.)"""
    A = model.packed_action_count()
    ls = leaves(model.packed_init_states())
    n_init = int(ls[0].shape[0]) if ls else 0
    if rec["init"] >= n_init:
        return (
            f"init index {rec['init']} out of range "
            f"(model has {n_init} initial states)"
        )
    bad = [a for a in rec["actions"] if a >= A]
    if bad:
        return (
            f"action id {bad[0]} out of range (model has {A} actions)"
        )
    return None


def replay_loop(model, state, actions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The batched replay of ``actions`` (``(L, T)`` int64, -1 = padding)
    from ``state`` (L lanes): the JAX package's ``lax.scan`` body, unrolled
    over T. Returns ``(L,)`` tensors ``diverged``, ``divergence_index``,
    ``offending_action``, ``steps``, ``fp_hi`` and ``fp_lo``. Every shape
    is static and nothing reads the host, so the loop captures in a CUDA
    Graph."""
    A = model.packed_action_count()
    L, T = actions.shape
    dev = actions.device
    rows = torch.arange(L, device=dev)
    diverged = torch.zeros(L, dtype=torch.bool, device=dev)
    div_idx = torch.full((L,), -1, dtype=torch.int64, device=dev)
    offending = torch.full((L,), -1, dtype=torch.int64, device=dev)
    steps = torch.zeros(L, dtype=torch.int64, device=dev)
    for i in range(T):
        a = actions[:, i]
        active = (a >= 0) & ~diverged
        ac = a.clamp(0, A - 1)
        cand, cvalid = model.packed_expand(state)
        valid = cvalid[rows, ac]
        advance = active & valid
        state = zip_where(advance, map_leaves(lambda c: c[rows, ac], cand), state)
        diverge_now = active & ~valid
        div_idx = torch.where(diverge_now, i, div_idx)
        offending = torch.where(diverge_now, a, offending)
        diverged = diverged | diverge_now
        steps = steps + advance.to(torch.int64)
    hi, lo = model.packed_fingerprint(state)
    return {
        "diverged": diverged,
        "divergence_index": div_idx,
        "offending_action": offending,
        "steps": steps,
        "fp_hi": hi,
        "fp_lo": lo,
    }


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


class ReplayKernel:
    """The replayer of one ``(namespace, T, L, device)`` shape:
    ``fn(inits, actions) -> dict of (L,) numpy arrays``, ``inits`` a packed
    state of L lanes and ``actions`` the ``(L, T)`` grid.

    On the CPU each call runs ``replay_loop`` eagerly. On the card the
    first call copies the batch into static input buffers, runs the loop
    once eagerly on a side stream (its first call makes the model's device
    tables and the allocator's blocks outside the capture) and captures it
    in a CUDA Graph with Python's collector paused
    (``checker/gpu.py::_collector_paused``) and
    ``capture_error_mode="thread_local"``, as the walkers' ``StepGraph``
    does; every call then replays the graph. A failed capture raises:
    nothing falls back to the eager loop on the card. A lock holds each
    call's copy-in, replay and copy-out, so two checkers sharing the shape
    never interleave on the static buffers."""

    def __init__(self, model, T: int, L: int, device: torch.device):
        self.model = model  # keeps the model's device tables alive for the graph
        self.T, self.L = int(T), int(L)
        self.device = device
        self._lock = threading.Lock()
        self._graph = None
        self._inputs = None
        self._out = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def _actions(self, actions) -> torch.Tensor:
        a = torch.as_tensor(np.asarray(actions), dtype=torch.int64)
        if tuple(a.shape) != (self.L, self.T):
            raise ValueError(
                f"action grid {tuple(a.shape)} is not ({self.L}, {self.T})"
            )
        return a

    def __call__(self, inits, actions) -> Dict[str, np.ndarray]:
        acts = self._actions(actions)
        if self.device.type != "cuda":
            with torch.inference_mode():
                state = map_leaves(lambda x: x.to(self.device), inits)
                return _host(replay_loop(self.model, state, acts.to(self.device)))
        with self._lock, torch.no_grad():
            if self._graph is None:
                self._capture(inits, acts)
            else:
                for dst, src in zip(leaves(self._inputs[0]), leaves(inits)):
                    dst.copy_(src, non_blocking=False)
                self._inputs[1].copy_(acts)
            self._graph.replay()
            self.replays += 1
            return _host(self._out)

    def _capture(self, inits, acts) -> None:
        t0 = time.perf_counter()
        state = map_leaves(lambda x: x.to(self.device).clone(), inits)
        grid = acts.to(self.device).clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            replay_loop(self.model, state, grid)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _collector_paused(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            out = replay_loop(self.model, state, grid)
        self._inputs, self._out, self._graph = (state, grid), out, graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


_KERNELS: Dict[tuple, ReplayKernel] = {}
_KERNELS_LOCK = threading.Lock()


def replay_kernel(model, namespace: str, T: int, L: int,
                  device=None) -> ReplayKernel:
    """The batch replayer for one (model config, padded length, lane
    count, device) shape, cached process-globally keyed on the zoo
    namespace (two uploads of the same config share its graph). ``device``
    is ``"cuda"`` unless ``"cpu"`` is passed."""
    dev = resolve_device(device, "replay_kernel")
    key = (namespace, int(T), int(L), str(dev))
    with _KERNELS_LOCK:
        fn = _KERNELS.get(key)
        if fn is None:
            fn = _KERNELS[key] = ReplayKernel(model, T, L, dev)
        return fn


def clear_replay_kernels() -> None:
    """Test hook: drop the process-global kernel cache."""
    with _KERNELS_LOCK:
        _KERNELS.clear()


def warm_replay(model, namespace: str, T: int, L: int, device=None):
    """Prepares the replayer for one shape by running it once on an inert
    batch (all-padding lanes): on the card that captures its graph.
    Returns the cached kernel."""
    fn = replay_kernel(model, namespace, T, L, device)
    fn(_gather_inits(model, [0] * L), np.full((L, T), -1, np.int64))
    return fn


def pad_actions(records: Sequence[dict], T: int, L: int) -> np.ndarray:
    """(L, T) int64 action grid: row per record padded with -1 (inert),
    then whole inert rows up to the fixed lane count L — short batches
    reuse the bucket's replayer instead of capturing another."""
    out = np.full((L, T), -1, np.int64)
    for i, rec in enumerate(records):
        acts = rec["actions"]
        out[i, : len(acts)] = acts
    return out


def replay_batch(
    records: Sequence[dict], model, namespace: str, T: int,
    lanes: Optional[int] = None, device=None,
) -> List[dict]:
    """Replays one shape bucket of decoded traces in one batched dispatch
    -> one verdict dict per record, in order: ``{"id", "kind": "trace",
    "conforms", "divergence_index", "offending_action", "steps",
    "fingerprint"}``. Runs on ``"cuda"`` unless ``device="cpu"``."""
    dev = resolve_device(device, "replay_batch")
    if not records:
        return []
    L = lanes or len(records)
    if len(records) > L:
        raise ValueError(
            f"{len(records)} traces exceed the {L}-lane batch"
        )
    actions = pad_actions(records, T, L)
    inits = _gather_inits(
        model, [r["init"] for r in records] + [0] * (L - len(records))
    )
    out = replay_kernel(model, namespace, T, L, dev)(inits, actions)
    verdicts = []
    for i, rec in enumerate(records):
        diverged = bool(out["diverged"][i])
        verdicts.append({
            "id": rec["id"],
            "kind": "trace",
            "conforms": not diverged,
            "divergence_index": (
                int(out["divergence_index"][i]) if diverged else None
            ),
            "offending_action": (
                int(out["offending_action"][i]) if diverged else None
            ),
            "steps": int(out["steps"][i]),
            "fingerprint": (
                int(out["fp_hi"][i]) << 32 | int(out["fp_lo"][i])
            ),
        })
    return verdicts


def replay_host(rec: dict, model) -> dict:
    """The host oracle: the same replay as a one-lane loop in plain Python
    on the CPU, stopping at the first invalid step. Device verdicts are
    gated on matching this bit for bit (index and offending action
    included)."""
    state = _gather_inits(model, [rec["init"]])

    def fp(s) -> int:
        hi, lo = model.packed_fingerprint(s)
        return int(hi[0]) << 32 | int(lo[0])

    steps = 0
    with torch.inference_mode():
        for i, a in enumerate(rec["actions"]):
            cand, valid = model.packed_expand(state)
            if not bool(valid[0, a]):
                return {
                    "id": rec["id"], "kind": "trace", "conforms": False,
                    "divergence_index": i, "offending_action": a,
                    "steps": steps, "fingerprint": fp(state),
                }
            state = map_leaves(lambda c: c[:, a], cand)
            steps += 1
        return {
            "id": rec["id"], "kind": "trace", "conforms": True,
            "divergence_index": None, "offending_action": None,
            "steps": steps, "fingerprint": fp(state),
        }
