"""GPU random-walk checker: L simulation lanes in lockstep.

The port of the JAX package's ``checker/tpu_simulation.py``. The host
``SimulationChecker`` rolls one trace at a time; here L lanes advance
together, one batched step at a time. Each step, each lane

1. restarts from a uniformly chosen seed state if its trace ended;
2. follows the host trace loop in order: the depth cap, the boundary exit
   (the trace excludes the current state), the fingerprint and the cycle
   check against the lane's own trace buffer (the trace includes the
   current state), the properties, then a uniform choice among the valid
   transitions (a terminal exit when there is none);
3. on a property's first hit anywhere in the batch, the hitting lane's
   fingerprint trace is copied into that property's discovery buffer, and
   the host replays it into a ``Path`` as the other device checkers do.

The random draws are the JAX package's threefry streams
(``ops/threefry.py``), so with the same model, seed and knobs the lanes
walk exactly the JAX package's walks: the same discoveries, counts, depth
and trace overflows. ``walk_lane_step``, ``walk_kernel_surface`` and
``capture_discoveries`` are shared with the swarm (``checker/swarm.py``).

On the card one step is captured in a CUDA Graph and replayed
``steps_per_call`` times a call; the host reads the stats once a call. On
the CPU (``device="cpu"``) the step runs uncaptured, with the same integer
code.

Like the reference, simulation returns only when every property has a
discovery or ``target_state_count`` is reached, and ``unique_state_count``
is approximated by the total count. Symmetry is host-only (use
``spawn_simulation``); traces longer than the lane buffer
(``max_trace_len``) are aborted like a depth cap and counted.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.batch import BatchableModel, leaves, map_leaves
from ..core.model import Expectation
from ..core.path import Path
from ..ops import hashset_kernel as hk
from ..ops.threefry import choose_from_bits, draw_step, lane_keys
from ..telemetry import get_tracer, metrics_registry
from .base import Checker
from .gpu import host_fingerprint, resolve_device

__all__ = [
    "GpuSimulationChecker",
    "StepGraph",
    "blank_discoveries",
    "blank_lanes",
    "capture_discoveries",
    "check_walkable",
    "copy_tree_",
    "host_copy",
    "read_discoveries",
    "walk_kernel_surface",
    "walk_lane_step",
    "zip_where",
]


def zip_where(mask: torch.Tensor, a, b):
    """``where(mask, a, b)`` leaf by leaf over two packed states of the
    same structure, ``mask`` ``(L,)`` broadcast over each leaf's trailing
    axes."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.view(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)
    if isinstance(a, dict):
        return {k: zip_where(mask, a[k], b[k]) for k in a}
    return type(a)(zip_where(mask, x, y) for x, y in zip(a, b))


def walk_lane_step(k, seeds, n_seeds, state, depth, ebits, done, thi, tlo, key, depth_cap):
    """One walk step for L lanes: the shared trace-loop core of
    ``GpuSimulationChecker`` and the swarm, batched over lanes (the JAX
    package's ``walk_lane_step``, which its callers vmap). Follows the
    host ``SimulationChecker`` loop in order: restart from the seed pool,
    the depth cap, the boundary exit, the fingerprint and own-trace cycle
    check, the properties, the uniform choice among valid transitions.

    ``k`` supplies the packed-model surface (``_model``/``_fp_fn``/
    ``_conditions``/``_ebit``/``_ebits0``/``_properties``/``_A``/``_D`` and,
    with coverage, ``_cov_layout``/``_cov_antecedents``). ``state`` is a
    packed state of L lanes; ``depth``, ``ebits`` (u32 in int64), ``done``
    are ``(L,)``; ``thi``/``tlo`` the ``(L, D)`` trace buffers; ``key`` the
    ``(L, 2)`` threefry keys; ``depth_cap`` an int64 tensor broadcast
    against ``(L,)`` (a per-lane cap lets one step serve tenants with
    different caps). Every lane draws on every step, whether or not it
    restarts. Returns the superset of per-step outputs each caller takes
    its part of."""
    model = k._model
    A, D = k._A, k._D
    L = depth.shape[0]
    dev = depth.device
    key, init_idx, bits = draw_step(key, n_seeds, A)

    # Restart ended lanes from a uniformly chosen seed state.
    restarted = done
    state = zip_where(done, map_leaves(lambda x: x[init_idx], seeds), state)
    depth = torch.where(done, torch.zeros_like(depth), depth)
    ebits = torch.where(done, torch.full_like(ebits, int(k._ebits0)), ebits)

    cap = torch.clamp(depth_cap, max=D)
    capped = depth >= cap
    # A cap hit below the user's depth target (or with no target at all)
    # is a trace-buffer truncation, not a semantic bound.
    truncated = capped & (depth_cap > D)
    in_bounds = model.packed_within_boundary(state)
    boundary_end = ~capped & ~in_bounds

    hi, lo = k._fp_fn(state)
    slots = torch.arange(D, dtype=torch.int64, device=dev)
    seen = slots < depth[:, None]
    cycle = (seen & (thi == hi[:, None]) & (tlo == lo[:, None])).any(dim=1)
    # Record the current fingerprint (the host appends before the cycle
    # break, so cycle, terminal and property traces include it).
    write = ~capped & ~boundary_end
    at = write[:, None] & (slots == depth[:, None])
    thi = torch.where(at, hi[:, None], thi)
    tlo = torch.where(at, lo[:, None], tlo)
    cycle_end = write & cycle

    eval_ok = write & ~cycle
    cond_vals = [c(state) for c in k._conditions]
    ebits_after = ebits
    for pi, b in k._ebit.items():
        ebits_after = torch.where(eval_ok & cond_vals[pi], ebits_after & ~(1 << b), ebits_after)

    # Uniform choice among valid transitions.
    cand, cvalid = model.packed_expand(state)
    cvalid = cvalid & eval_ok[:, None]
    terminal = eval_ok & ~cvalid.any(dim=1)
    choice = choose_from_bits(bits, cvalid)
    advanced = eval_ok & ~terminal
    rows = torch.arange(L, device=dev)
    state = zip_where(advanced, map_leaves(lambda c: c[rows, choice], cand), state)

    ebits_end = boundary_end | cycle_end | terminal
    done = capped | ebits_end
    # Trace length as the host's fingerprint path would have it (capped
    # and out-of-boundary exits happen before the host appends).
    path_len = torch.where(capped | boundary_end, depth, depth + 1)
    depth = torch.where(advanced, depth + 1, depth)

    cov_layout = getattr(k, "_cov_layout", None)
    per_prop, exercised = [], []
    for i, p in enumerate(k._properties):
        if p.expectation == Expectation.ALWAYS:
            hit = eval_ok & ~cond_vals[i]
        elif p.expectation == Expectation.SOMETIMES:
            hit = eval_ok & cond_vals[i]
        else:
            hit = ebits_end & (((ebits_after >> k._ebit[i]) & 1) == 1)
        per_prop.append(hit)
        if cov_layout is not None:
            if p.expectation == Expectation.ALWAYS:
                ant = k._cov_antecedents[i]
                exercised.append(eval_ok & ant(state) if ant is not None else eval_ok)
            elif p.expectation == Expectation.SOMETIMES:
                exercised.append(eval_ok & cond_vals[i])
            else:
                exercised.append(eval_ok & (((ebits_after >> k._ebit[i]) & 1) == 0))
    none = torch.zeros((L, 0), dtype=torch.bool, device=dev)
    out = {
        "state": state,
        "depth": depth,
        "ebits": ebits_after,
        "done": done,
        "thi": thi,
        "tlo": tlo,
        "key": key,
        "counted": eval_ok,
        "hits": torch.stack(per_prop, dim=1) if per_prop else none,
        "path_len": path_len,
        "capped": capped,
        "hi": hi,
        "lo": lo,
        "write": write,
        "restarted": restarted,
        "truncated": truncated,
    }
    if cov_layout is not None:
        out["cvalid"] = cvalid
        out["choice"] = choice
        out["advanced"] = advanced
        out["exercised"] = torch.stack(exercised, dim=1) if exercised else none
    return out


def walk_kernel_surface(model):
    """The packed walk contract both walkers build at init: the aligned
    condition callables, the eventually-property bit map and the
    all-pending ebits seed. Returns ``(properties, conditions, ebit,
    ebits0)``."""
    properties = model.properties()
    conditions = model.packed_conditions()
    if len(conditions) != len(properties):
        raise ValueError(
            "packed_conditions() must align 1:1 with properties(): "
            f"{len(conditions)} != {len(properties)}"
        )
    eventually = [i for i, p in enumerate(properties)
                  if p.expectation == Expectation.EVENTUALLY]
    if len(eventually) > 32:
        raise ValueError("at most 32 eventually properties supported")
    ebit: Dict[int, int] = {pi: b for b, pi in enumerate(eventually)}
    ebits0 = sum(1 << b for b in ebit.values())
    return properties, conditions, ebit, ebits0


def check_walkable(options, entry: str) -> None:
    """Refuses what the device walkers do not run: a model without the
    packed protocol, symmetry (its cycle detection is host-only) and
    visitors (a host path replay per state)."""
    model = options.model
    if not isinstance(model, BatchableModel):
        raise TypeError(
            f"{entry} requires a BatchableModel; {type(model).__name__} does not "
            "implement the packed protocol"
        )
    if options._symmetry is not None:
        raise NotImplementedError(
            "symmetry-aware cycle detection is host-only; use spawn_simulation "
            "for symmetric models"
        )
    if options._visitor is not None:
        raise NotImplementedError(
            "per-state visitors replay O(depth²) host paths; use spawn_simulation "
            "for visitor-driven runs"
        )


def blank_lanes(seeds, L: int, D: int, device):
    """``L`` lanes' walk carry with trace buffers of ``D``: every lane
    restarts on its first step. ``key`` is zero; the caller gives the
    lanes their threefry streams."""
    i64 = torch.int64
    return {
        "state": map_leaves(lambda x: torch.zeros((L,) + tuple(x.shape[1:]), dtype=x.dtype,
                                                  device=device), seeds),
        "depth": torch.zeros(L, dtype=i64, device=device),
        "ebits": torch.zeros(L, dtype=i64, device=device),
        "done": torch.ones(L, dtype=torch.bool, device=device),
        "thi": torch.zeros((L, D), dtype=i64, device=device),
        "tlo": torch.zeros((L, D), dtype=i64, device=device),
        "key": torch.zeros((L, 2), dtype=i64, device=device),
    }


def blank_discoveries(P: int, D: int, device):
    """One tenant's empty discovery buffers for ``P`` properties."""
    i64 = torch.int64
    return {
        "found": torch.zeros(P, dtype=torch.bool, device=device),
        "hi": torch.zeros((P, D), dtype=i64, device=device),
        "lo": torch.zeros((P, D), dtype=i64, device=device),
        "len": torch.zeros(P, dtype=i64, device=device),
    }


def read_discoveries(properties, disc):
    """One tenant's discovery buffers, as numpy, read back: the fingerprint
    trail of each discovered property, and the properties settled by an
    empty walk (a seed already out of boundary: no path, as the host
    simulation has it)."""
    fps: Dict[str, List[int]] = {}
    empty = set()
    hi = disc["hi"].astype(np.uint64)
    lo = disc["lo"].astype(np.uint64)
    for i, p in enumerate(properties):
        if not disc["found"][i]:
            continue
        n = int(disc["len"][i])
        if n == 0:
            empty.add(p.name)
            continue
        fps[p.name] = ((hi[i, :n] << np.uint64(32)) | lo[i, :n]).tolist()
    return fps, empty


def capture_discoveries(disc, out):
    """First-hit discovery capture shared by both walkers, over a leading
    tenant axis: ``out["hits"]`` is ``(T, L, P)``, ``out["thi"]``/``"tlo"``
    ``(T, L, D)``, ``out["path_len"]`` ``(T, L)``; ``disc`` holds
    ``found`` ``(T, P)``, ``hi``/``lo`` ``(T, P, D)`` and ``len`` ``(T, P)``.
    For each property hit anywhere in a tenant's batch this step, the
    lowest hitting lane's trace is recorded once: the first step that hits
    wins. Returns the new buffers."""
    hits = out["hits"]
    T, L, P = hits.shape
    lanes = torch.arange(L, dtype=torch.int64, device=hits.device).view(1, L, 1)
    first = torch.where(hits, lanes, torch.full_like(lanes, L)).amin(dim=1)
    any_hit = first < L
    lane = torch.where(any_hit, first, torch.zeros_like(first))
    found_now = any_hit & ~disc["found"]
    D = out["thi"].shape[2]
    idx = lane[:, :, None].expand(T, P, D)
    return {
        "found": disc["found"] | any_hit,
        "hi": torch.where(found_now[:, :, None], torch.gather(out["thi"], 1, idx), disc["hi"]),
        "lo": torch.where(found_now[:, :, None], torch.gather(out["tlo"], 1, idx), disc["lo"]),
        "len": torch.where(found_now, torch.gather(out["path_len"], 1, lane), disc["len"]),
    }


def host_copy(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of their own: ``.cpu()`` of a CPU
    tensor is the tensor itself, whose buffer the next step rewrites."""
    return x.detach().to("cpu", copy=True).numpy()


def copy_tree_(dst, src) -> None:
    """Copies every leaf of ``src`` into the same leaf of ``dst`` in place
    (the static buffers a captured step reads and writes)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            copy_tree_(dst[k], src[k])
    else:
        for x, y in zip(dst, src):
            copy_tree_(x, y)


class StepGraph:
    """Runs a walker's in-place step ``fn()`` ``n`` times. On the CPU each
    step runs uncaptured. On the card the first call runs one step eagerly
    (its first step: it sets up the libraries' workspaces before a
    capture), captures one step in a CUDA Graph and replays it for the
    rest; later calls replay it ``n`` times. A capture that fails raises:
    nothing falls back to the uncaptured loop. ``hashset_kernel.launches``
    counts every launch a replay makes (a capture launches nothing, its
    count is undone and added at each replay)."""

    def __init__(self, fn, device):
        self._fn = fn
        self._device = device
        self._graph = None
        self._per_replay = 0
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_s = 0.0

    def run(self, n: int, stop=None) -> None:
        """``n`` steps; on the CPU ``stop()`` (a host read) is asked before
        each and ends the call early when true (the caller's steps past a
        stop change nothing)."""
        if self._device.type != "cuda":
            with torch.inference_mode():
                for _ in range(n):
                    if stop is not None and stop():
                        return
                    self._fn()
                    self.eager_steps += 1
            return
        done = 0
        if self._graph is None and n > 0:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn()
            torch.cuda.current_stream().wait_stream(side)
            self.eager_steps += 1
            done = 1
            t0 = time.perf_counter()
            before = hk.launches
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._fn()
            self._per_replay = hk.launches - before
            hk.launches = before
            self._graph = graph
            self.captures += 1
            self.capture_s += time.perf_counter() - t0
        for _ in range(n - done):
            self._graph.replay()
            hk.launches += self._per_replay
        self.replays += max(0, n - done)


class GpuSimulationChecker(Checker):
    """``spawn_gpu_simulation``: ``lanes`` walks, ``steps_per_call`` steps
    between the host's reads, trace buffers of ``max_trace_len`` (default:
    the depth target, else 512), on ``device`` (``"cuda"`` unless
    ``"cpu"`` is passed). Requires a ``BatchableModel``."""

    # The host-paced step loop has no resumable payload and no packing;
    # ``spawn_swarm`` is the walker that has both.
    supports_preempt = False
    supports_packing = False
    packing_reason = "host-paced step loop (spawn_swarm is the packable walker)"

    def __init__(self, options, seed: int, lanes: int = 1024, steps_per_call: int = 64,
                 max_trace_len: Optional[int] = None, device=None):
        check_walkable(options, "spawn_gpu_simulation")
        model = options.model
        self._device = resolve_device(device, "spawn_gpu_simulation")
        self._model = model
        (self._properties, self._conditions, self._ebit,
         self._ebits0) = walk_kernel_surface(model)
        self._A = model.packed_action_count()
        self._L = int(lanes)
        self._K = int(steps_per_call)
        self._depth_cap = options._target_max_depth
        self._D = max_trace_len or (self._depth_cap or 512)
        if self._depth_cap is not None:
            self._D = min(self._D, self._depth_cap)
        self._target_state_count = options._target_state_count
        self._seed = int(seed)

        self._state_count = 0
        self._max_depth = 0
        # A lane hitting the buffer limit D below the user's depth cap (or
        # with no cap at all) was aborted: counted per call and warned
        # about at run end, so truncation is never mistaken for absence.
        self._trace_overflows = 0
        self._buffer_truncates = self._depth_cap is None or self._D < self._depth_cap
        self._discoveries_fps: Dict[str, List[int]] = {}
        self._empty_discoveries: set = set()
        self._done_event = threading.Event()
        self._error: Optional[BaseException] = None
        self._fp_fn = model.packed_fingerprint
        self._seeds = model.packed_init_states(self._device)
        self._n_seeds = int(leaves(self._seeds)[0].shape[0])
        self._carry = self._fresh_carry()
        self._graph = StepGraph(self._step, self._device)

        self._handles = [threading.Thread(target=self._run, name="gpu-sim", daemon=True)]
        self._handles[0].start()

    # -- the step --------------------------------------------------------------

    def _fresh_carry(self):
        L, D, dev = self._L, self._D, self._device
        i64 = torch.int64
        lanes = blank_lanes(self._seeds, L, D, dev)
        lanes["key"] = lane_keys(self._seed, L, dev)
        stats = {name: torch.zeros((), dtype=i64, device=dev)
                 for name in ("count", "max_depth", "overflow")}
        # One tenant: ``capture_discoveries`` takes a leading tenant axis.
        disc = {k: v[None] for k, v in blank_discoveries(len(self._properties), D, dev).items()}
        return {"lanes": lanes, "stats": stats, "disc": disc,
                "cap": torch.full((), self._D, dtype=i64, device=dev)}

    def _step(self):
        """One step of every lane, in place on the carry (capturable)."""
        c = self._carry
        ln = c["lanes"]
        out = walk_lane_step(self, self._seeds, self._n_seeds, ln["state"], ln["depth"],
                             ln["ebits"], ln["done"], ln["thi"], ln["tlo"], ln["key"], c["cap"])
        copy_tree_(ln, {k: out[k] for k in ln})
        st = c["stats"]
        st["count"].add_(out["counted"].sum())
        torch.maximum(st["max_depth"], out["path_len"].max(), out=st["max_depth"])
        st["overflow"].add_(out["capped"].sum())
        if self._properties:
            batched = {k: out[k][None] for k in ("hits", "thi", "tlo", "path_len")}
            copy_tree_(c["disc"], capture_discoveries(c["disc"], batched))

    # -- host loop ---------------------------------------------------------------

    def _run(self):
        try:
            self._explore()
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            self._error = e
        finally:
            self._done_event.set()

    def _explore(self):
        props = self._properties
        if not props:
            return
        tracer = get_tracer()
        reg = metrics_registry()
        m_calls = reg.counter("gpu_sim.step_calls")
        m_states = reg.counter("gpu_sim.states_visited")
        # Shared with checker/swarm.py: the truncation signal reads the
        # same whichever walker produced it.
        m_overflow = reg.counter("swarm.trace_overflow")
        st, disc = self._carry["stats"], self._carry["disc"]
        calls = 0
        while True:
            calls += 1
            with tracer.span("gpu_sim.steps", call=calls, lanes=self._L,
                             steps_per_call=self._K) as sp:
                self._graph.run(self._K)
                step_count, max_depth, overflow = (
                    int(x) for x in torch.stack([st["count"], st["max_depth"],
                                                 st["overflow"]]).cpu())
                sp.set(states=step_count)
            m_calls.inc()
            m_states.inc(step_count)
            self._state_count += step_count
            self._max_depth = max(self._max_depth, max_depth)
            if self._buffer_truncates and overflow:
                m_overflow.inc(overflow)
                self._trace_overflows += overflow
            # Each call counts from zero (the JAX package's int32 counters
            # would wrap if carried); the host accumulates.
            st["count"].zero_()
            st["overflow"].zero_()
            if host_copy(disc["found"][0]).any():
                # A property's buffers are written once, on its first hit.
                self._discoveries_fps, self._empty_discoveries = read_discoveries(
                    props, {k: host_copy(v[0]) for k, v in disc.items()})
            settled = set(self._discoveries_fps) | self._empty_discoveries
            if len(settled) == len(props):
                return
            if (self._target_state_count is not None
                    and self._target_state_count <= self._state_count):
                return

    # -- Checker surface -----------------------------------------------------------

    @property
    def graph_captures(self) -> int:
        return self._graph.captures

    @property
    def graph_replays(self) -> int:
        return self._graph.replays

    def model(self):
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        # Like the reference, approximated by the total count.
        return self._state_count

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        return {
            name: Path.from_fingerprints(self._model, fps,
                                         fp_of=functools.partial(host_fingerprint, self._model))
            for name, fps in list(self._discoveries_fps.items())
        }

    def _discovery_names(self) -> List[str]:
        return list(self._discoveries_fps)

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._done_event.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._error

