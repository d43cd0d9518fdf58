"""Swarm verification: device-wide random walks for state spaces no
visited set holds.

The port of the JAX package's ``checker/swarm.py``. ``GpuSimulationChecker``
(``checker/gpu_simulation.py``) walks L lanes but is host-paced: a read
every ``steps_per_call`` steps, no sample of the visited states, no
preemption. The swarm adds:

- **Waves of many steps.** A wave replays one captured CUDA Graph of a
  whole step (``walk_lane_step`` over every tenant's lanes, the sample
  insert, the discovery capture and the stop flag) ``wave_steps`` times;
  the host reads the stats once a wave. Each lane's draws are the JAX
  package's threefry streams (``fold_in(PRNGKey(seed), lane)``), so a run
  walks the JAX package's walks step for step.
- **A visited sample in a device hash table.** Every ``sample_stride``-th
  step and every restart inserts the walk's fingerprint through
  ``ops/hashset_kernel.py::hashset_insert_unsorted``, whose CUDA path is
  the hand-written insert kernel (``csrc/hashset_insert.cu``). The sample
  counts restarts into states it already holds (``swarm.restarts_deduped``)
  and gives ``unique_state_count()``: the distinct sampled fingerprints, a
  lower bound once the table saturates (``sample_saturated``). The walks
  never read the table, so results do not depend on ``sample_capacity``.
- **Determinism anywhere.** The stop (every property discovered, or
  ``target_state_count`` walk steps) is decided inside the step and
  freezes the tenant's whole carry, keys and table included, from that
  step on. The same seed gives the same discoveries, walk counts and
  sample whatever ``wave_steps`` is, across preempt and resume (the
  ``"gpu_swarm"`` payload, format version 3, carries the keys and walk
  buffers as they are), and packed or solo (tenants never interact).
- **Seeded walks.** ``seeds=`` takes a packed-state pool, for instance
  ``frontier_seeds_from_payload`` of a preempted ``spawn_gpu_bfs`` run, and
  restarts draw from it instead of the initial states: the exhaustive run
  maps what it can afford, the swarm hunts past its frontier. A seeded
  discovery replays from its seed state.

``SwarmEngine`` runs ``max_tenants`` tenant slots in one step;
``SwarmChecker`` is the solo ``Checker`` that ``spawn_swarm`` returns;
``SwarmPackedEngine`` admits, steps, drops and releases tenants (the JAX
package's packed-engine protocol).

Where the port differs by design: the sample table is the port's layout
(the key set is the JAX table's while neither saturates); ``sample_capacity``
is rounded up to one insert tile (``round_table_capacity``, reported in
``config_notes``); the counters are int64 (the step count still saturates
at 2^31 - 1, as the JAX package's int32 one does); the payload's kind is
``"gpu_swarm"`` and a JAX ``"swarm"`` payload is refused.
"""

from __future__ import annotations

import functools
import threading
import time
from hashlib import blake2b
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.batch import BatchableModel, leaves, map_leaves
from ..core.path import Path
from ..ops import hashset_kernel as hk
from ..ops.hashset import hashset_new, u32_to_i32
from ..ops.hashset_kernel import hashset_insert_unsorted, round_table_capacity
from ..ops.threefry import lane_keys
from ..telemetry import get_tracer, metrics_registry
from ..utils.faults import TenantFaultError, fault_point
from .base import Checker
from .gpu import (
    SWARM_CHECKPOINT_KIND,
    checkpoint_header,
    host_fingerprint,
    resolve_device,
    validate_checkpoint_header,
)
from .gpu_simulation import (
    StepGraph,
    blank_discoveries,
    blank_lanes,
    capture_discoveries,
    check_walkable,
    copy_tree_,
    host_copy,
    read_discoveries,
    walk_kernel_surface,
    walk_lane_step,
    zip_where,
)

__all__ = [
    "CHECKPOINT_KIND",
    "SwarmChecker",
    "SwarmEngine",
    "SwarmPackedEngine",
    "frontier_seeds_from_payload",
]

# The payload's kind; ``checkpoint_header`` stamps it format version 3.
CHECKPOINT_KIND = SWARM_CHECKPOINT_KIND
# Runtime "no cap" and "no target" values of a tenant's carry, so one step
# serves every tenant's depth cap and state target.
_NO_CAP = 2**31 - 1
_NO_TARGET = -1
_INT32_MAX = 2**31 - 1
_STAT_NAMES = ("step", "count", "max_depth", "walks", "restarts", "restart_dups",
               "overflow", "sample_unique")


def frontier_seeds_from_payload(model, payload: dict):
    """The live frontier states of a ``spawn_gpu_bfs`` checkpoint or preempt
    payload as a restart-seed pool (stacked packed states, numpy leaves):
    the hybrid handoff, where the swarm starts where enumeration stopped.
    A chunk without a mask gives all its lanes (the port's payloads hold
    live lanes only)."""
    if payload.get("kind") != "gpu_bfs":
        raise ValueError(
            f"frontier seeds need a gpu_bfs payload, got kind={payload.get('kind')!r}"
        )
    if payload.get("model") != type(model).__name__:
        raise ValueError(
            f"payload was written by model {payload.get('model')!r}, seeding walks "
            f"of {type(model).__name__!r} would mix state spaces"
        )
    parts = []
    for chunk in payload.get("chunks", ()):
        states = chunk["states"]
        n = np.asarray(_tree_leaves(states)[0]).shape[0]
        mask = np.asarray(chunk["mask"]).astype(bool) if "mask" in chunk else np.ones(n, bool)
        if mask.any():
            parts.append(_map_tree(lambda x: np.asarray(x)[mask], states))
    if not parts:
        raise ValueError(
            "payload has no live frontier lanes to seed from (the run finished; "
            "there is nothing beyond the store to hunt)"
        )
    return _zip_tree(lambda *xs: np.concatenate(xs, axis=0), parts)


def _tree_leaves(tree) -> list:
    """The array leaves of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _zip_tree(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_tree(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_tree(fn, [t[i] for t in trees]) for i in range(len(first)))
    return fn(*trees)


def _to_device(tree, device):
    """A numpy tree (or torch) as tensors on ``device``; unsigned arrays
    become int64, as the port carries u32."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        a = np.asarray(x)
        if a.dtype.kind == "u":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _map_tree(conv, tree)


def _to_host(tree):
    return _map_tree(host_copy, tree)


class _WalkKernel:
    """What a step closes over: the model, its conditions, the seed pool on
    the device and the shapes. The engine's carry and instruments live
    apart."""

    def __init__(self, model, device, *, lanes, wave_steps, max_trace_len,
                 sample_capacity, sample_stride, seeds, coverage_layout):
        if not isinstance(model, BatchableModel):
            raise TypeError(
                f"the swarm engine requires a BatchableModel; {type(model).__name__} "
                "does not implement the packed protocol"
            )
        if sample_capacity & (sample_capacity - 1):
            raise ValueError("sample_capacity must be a power of two")
        self._model = model
        self._device = device
        (self._properties, self._conditions, self._ebit,
         self._ebits0) = walk_kernel_surface(model)
        self._A = model.packed_action_count()
        self._P = len(self._properties)
        self._L = int(lanes)
        self._K = int(wave_steps)
        self._D = int(max_trace_len)
        # The insert kernel takes tile-aligned tables.
        self._cap = round_table_capacity(sample_capacity)
        self._stride = max(1, int(sample_stride))
        self._cov_layout = coverage_layout
        if coverage_layout is not None:
            try:
                ants = list(model.packed_antecedents())
            except Exception:  # noqa: BLE001 - optional hook
                ants = [None] * self._P
            self._cov_antecedents = ants
        self._fp_fn = model.packed_fingerprint

        # The restart-seed pool: the initial states, or a hybrid frontier.
        if seeds is None:
            seeds = model.packed_init_states(device)
            self._seeded = False
        else:
            self._seeded = True
        self._seeds = _to_device(seeds, device)
        self._n_seeds = int(leaves(self._seeds)[0].shape[0])
        if self._n_seeds < 1:
            raise ValueError("the restart-seed pool is empty")
        # Host copies for seeded replays, and the pool's digest: payloads
        # pin its content, since a same-shape pool of other states would
        # change every walk.
        self._seed_host = _to_host(self._seeds)
        h = blake2b(digest_size=8)
        for arr in _tree_leaves(self._seed_host):
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        self.seeds_digest = h.hexdigest()

    def blank_tenant(self):
        """A free slot's carry: every lane restarts on its first step, and
        the slot is born stopped (a wave leaves it as it is)."""
        dev = self._device
        i64 = torch.int64
        c = {
            "lanes": blank_lanes(self._seeds, self._L, self._D, dev),
            "table": hashset_new(self._cap, dev),
            "disc": blank_discoveries(self._P, self._D, dev),
            "stats": {
                **{name: torch.zeros((), dtype=i64, device=dev) for name in _STAT_NAMES},
                "sample_sat": torch.zeros((), dtype=torch.bool, device=dev),
                "stopped": torch.ones((), dtype=torch.bool, device=dev),
            },
            "depth_cap": torch.full((), _NO_CAP, dtype=i64, device=dev),
            "target": torch.full((), _NO_TARGET, dtype=i64, device=dev),
        }
        if self._cov_layout is not None:
            c["cov"] = torch.zeros(self._cov_layout.size, dtype=i64, device=dev)
        return c

    def _tenant_step(self, c):
        """One step of every tenant of the stacked carry ``c`` (every leaf
        with a leading tenant axis T), written back into ``c`` in place:
        the lanes' walk step, the sample insert, the discovery capture and
        the in-step stop. A stopped tenant's carry is left as it was, so
        waves past its stop change nothing. Reads no host value."""
        T, L = c["stats"]["stopped"].shape[0], self._L
        st = c["stats"]
        stopped = st["stopped"]
        ln = c["lanes"]

        def flat(x):
            return x.reshape((T * L,) + tuple(x.shape[2:]))

        def unflat(x):
            return x.reshape((T, L) + tuple(x.shape[1:]))

        out = walk_lane_step(
            self, self._seeds, self._n_seeds, map_leaves(flat, ln["state"]),
            flat(ln["depth"]), flat(ln["ebits"]), flat(ln["done"]), flat(ln["thi"]),
            flat(ln["tlo"]), flat(ln["key"]), c["depth_cap"].repeat_interleave(L),
        )
        out = {k: map_leaves(unflat, v) for k, v in out.items()}

        # Sample the visited multiset: every ``sample_stride``-th step and
        # every restart (restart dedup must never be strided away). A
        # stopped tenant inserts nothing, so its table stays as it was.
        sample = out["write"] & (((st["step"] % self._stride) == 0)[:, None]
                                 | out["restarted"]) & ~stopped[:, None]
        khi, klo = u32_to_i32(out["hi"]), u32_to_i32(out["lo"])
        flags = [hashset_insert_unsorted(c["table"][t], khi[t], klo[t], sample[t])[1:]
                 for t in range(T)]
        fresh, found, pending = (torch.stack(f) for f in zip(*flags))

        i64 = torch.int64
        # The step count saturates at 2^31 - 1 (the JAX package's int32
        # counter does; targets are below 2^31, so the stop never needs
        # the saturated range).
        count = torch.clamp(st["count"] + out["counted"].sum(dim=1, dtype=i64), max=_INT32_MAX)
        new_stats = {
            "step": st["step"] + 1,
            "count": count,
            "max_depth": torch.maximum(st["max_depth"], out["path_len"].amax(dim=1)),
            "walks": st["walks"] + out["done"].sum(dim=1, dtype=i64),
            "restarts": st["restarts"] + out["restarted"].sum(dim=1, dtype=i64),
            "restart_dups": st["restart_dups"]
            + (out["restarted"] & found).sum(dim=1, dtype=i64),
            "overflow": st["overflow"] + out["truncated"].sum(dim=1, dtype=i64),
            "sample_unique": st["sample_unique"] + fresh.sum(dim=1, dtype=i64),
            "sample_sat": st["sample_sat"] | pending.any(dim=1),
        }
        disc = c["disc"]
        if self._P:
            disc = capture_discoveries(disc, out)
            all_found = disc["found"].all(dim=1)
        else:
            all_found = torch.zeros_like(stopped)
        target = c["target"]
        new_stats["stopped"] = all_found | ((target >= 0) & (count >= target))

        new = {
            "lanes": {k: out[k] for k in ln},
            "disc": disc,
            "stats": new_stats,
        }
        if self._cov_layout is not None:
            new["cov"] = c["cov"] + torch.stack([
                self._cov_layout.wave_reduce(
                    eval_mask=out["counted"][t], cvalid=out["cvalid"][t],
                    fresh=out["advanced"][t], lane_action=out["choice"][t],
                    new_depth=out["depth"][t],
                    exercised=[out["exercised"][t][:, i] for i in range(self._P)])
                for t in range(T)])
        # Freeze on stop: a stopped tenant's slot passes through untouched
        # (keys included), so results do not depend on how many steps the
        # fleet runs past its stop.
        copy_tree_({k: c[k] for k in new}, zip_where(stopped, {k: c[k] for k in new}, new))


class SwarmEngine:
    """``max_tenants`` walk fleets advancing in one step on ``device``
    (``"cuda"`` unless ``"cpu"`` is passed). Tenant slots are independent
    lane blocks: admission writes a slot's carry, a wave advances every
    slot that has not stopped by ``wave_steps`` steps, and a drop reads the
    slot back out as a payload. Slots never interact (their own keys,
    sample tables and stop flags), so a tenant's results are the same solo
    or packed."""

    def __init__(self, model, *, lanes: int = 1024, wave_steps: int = 1024,
                 max_trace_len: int = 256, sample_capacity: int = 1 << 15,
                 sample_stride: int = 1, max_tenants: int = 1, seeds=None,
                 coverage_layout=None, aot_cache: Optional[str] = None, tracer=None,
                 registry=None, device=None):
        # ``aot_cache`` is the JAX package's namespace of compiled waves and
        # is accepted for its API. It caches nothing here: building a step
        # compiles nothing, and the costly part on the card, the warm-up
        # step and the graph capture, belongs to each engine's own buffers.
        del aot_cache
        self._device = resolve_device(device, "spawn_swarm")
        self._T = max(1, int(max_tenants))
        self._k = k = _WalkKernel(model, self._device, lanes=lanes, wave_steps=wave_steps,
                                  max_trace_len=max_trace_len,
                                  sample_capacity=sample_capacity,
                                  sample_stride=sample_stride, seeds=seeds,
                                  coverage_layout=coverage_layout)
        self._model = k._model
        self._properties = k._properties
        self._cov_layout = k._cov_layout
        self._fp_fn = k._fp_fn
        self._seeded = k._seeded
        self._seeds = k._seeds
        self._seed_host = k._seed_host
        self._n_seeds = k._n_seeds
        self._A, self._P = k._A, k._P
        self._L, self._K, self._D = k._L, k._K, k._D
        self._cap, self._stride = k._cap, k._stride
        self.config_notes: List[str] = []
        if self._cap != sample_capacity:
            self.config_notes.append(
                f"sample_capacity {sample_capacity} rounded up to {self._cap} (the insert "
                f"kernel's tables are whole {hk.TILE_ROWS}-row tiles)")
        self._tracer = tracer if tracer is not None else get_tracer()
        self._registry = registry if registry is not None else metrics_registry()
        self._wave_calls = 0

        reg = self._registry
        self._m_waves = reg.counter("swarm.wave_calls")
        self._m_steps = reg.counter("swarm.walk_steps")
        self._m_walks = reg.counter("swarm.walks_completed")
        self._m_restarts = reg.counter("swarm.restarts")
        self._m_restart_dups = reg.counter("swarm.restarts_deduped")
        self._m_overflow = reg.counter("swarm.trace_overflow")
        self._m_unique = reg.counter("swarm.unique_sample")
        self._g_sat = reg.gauge("swarm.sample_saturated")
        self._g_occ = reg.gauge("swarm.sample_occupancy")
        self._h_hit_depth = reg.histogram("swarm.hit_depth")

        self._carry = self._blank_carry()
        self._graph = StepGraph(lambda: self._k._tenant_step(self._carry), self._device)
        self._stats_host = self._pull_stats()
        self._disc_found_host = host_copy(self._carry["disc"]["found"])
        self.warmup_seconds: Optional[float] = None

    # -- carry ------------------------------------------------------------------

    def _blank_carry(self):
        one = self._k.blank_tenant()
        return _map_tree(lambda x: x[None].repeat((self._T,) + (1,) * x.dim()).contiguous(), one)

    def fresh_tenant_carry(self, seed: int, depth_cap=None, target=None):
        """A new tenant's carry: per-walk threefry streams
        ``fold_in(PRNGKey(seed), lane)``, independent of the slot and of the
        fleet's width (the packed-vs-solo identity)."""
        c = self._k.blank_tenant()
        c["lanes"]["key"] = lane_keys(int(seed), self._L, self._device)
        c["stats"]["stopped"].zero_()
        if depth_cap is not None:
            if not 0 < int(depth_cap) < 2**31:
                raise ValueError(
                    f"target_max_depth={depth_cap} out of the int32 range the walk "
                    "carry uses")
            c["depth_cap"].fill_(int(depth_cap))
        if target is not None:
            if not 0 < int(target) < 2**31:
                raise ValueError(
                    f"target_state_count={target} exceeds the int32 walk counter; "
                    "split the budget across resumed runs")
            c["target"].fill_(int(target))
        return c

    def write_slot(self, t: int, tenant_carry) -> None:
        """Writes a tenant's carry into slot ``t`` in place (a captured step
        keeps reading the same buffers) and updates the host mirrors."""
        copy_tree_(_map_tree(lambda x: x[t], self._carry), tenant_carry)
        stats = {k: np.array(v) for k, v in self._stats_host.items()}
        for k in stats:
            stats[k][t] = np.asarray(tenant_carry["stats"][k].cpu())
        self._stats_host = stats
        found = np.array(self._disc_found_host)
        found[t] = host_copy(tenant_carry["disc"]["found"])
        self._disc_found_host = found

    def read_slot(self, t: int):
        """Slot ``t``'s carry as numpy."""
        return _map_tree(lambda x: host_copy(x[t]), self._carry)

    def clear_slot(self, t: int) -> None:
        self.write_slot(t, self._k.blank_tenant())

    def _pull_stats(self):
        st = self._carry["stats"]
        return {k: host_copy(v) for k, v in st.items()}

    # -- waves -----------------------------------------------------------------

    @property
    def graph_captures(self) -> int:
        return self._graph.captures

    @property
    def capture_s(self) -> float:
        return self._graph.capture_s

    def run_wave(self) -> None:
        """One wave: every tenant that has not stopped advances by
        ``wave_steps`` steps; one read brings the stats back and feeds the
        engine's instruments."""
        fault_point("swarm.wave")
        self._wave_calls += 1
        prev = self._stats_host
        warm = self.warmup_seconds is None
        t0 = time.perf_counter()
        stopped = self._carry["stats"]["stopped"]
        with self._tracer.span("swarm.wave", call=self._wave_calls, tenants=self._T,
                               lanes=self._L, wave_steps=self._K) as sp:
            self._graph.run(self._K, stop=lambda: bool(stopped.all()))
            stats = self._pull_stats()
            self._disc_found_host = host_copy(self._carry["disc"]["found"])
            d_steps = int(stats["count"].sum() - prev["count"].sum())
            d_unique = int(stats["sample_unique"].sum() - prev["sample_unique"].sum())
            sp.set(states=d_steps, generated=d_steps, new_unique=d_unique,
                   live_lanes=int((~stats["stopped"]).sum()) * self._L,
                   max_depth=int(stats["max_depth"].max()))
        if warm:
            self.warmup_seconds = time.perf_counter() - t0
        self._stats_host = stats
        self._m_waves.inc()
        self._m_steps.inc(d_steps)
        self._m_unique.inc(max(0, d_unique))
        for field, counter in (("walks", self._m_walks), ("restarts", self._m_restarts),
                               ("restart_dups", self._m_restart_dups),
                               ("overflow", self._m_overflow)):
            counter.inc(max(0, int(stats[field].sum() - prev[field].sum())))
        self._g_sat.set(int(stats["sample_sat"].any()))
        self._g_occ.set(float(stats["sample_unique"].max()) / float(self._cap))

    # -- per-tenant host views -------------------------------------------------

    def tenant_stats(self, t: int) -> dict:
        """Slot ``t``'s cumulative numbers as of the last read."""
        return {k: v[t].item() for k, v in self._stats_host.items()}

    def tenant_found_names(self, t: int) -> List[str]:
        flags = self._disc_found_host[t]
        return [p.name for i, p in enumerate(self._properties) if flags[i]]

    def tenant_discoveries_fps(self, t: int):
        """Slot ``t``'s discovery traces as fingerprint lists per
        discovered property, and the properties settled by an empty walk
        (a seed already out of boundary: no path, as the host simulation
        has it)."""
        return read_discoveries(self._properties,
                                _map_tree(lambda x: host_copy(x[t]), self._carry["disc"]))

    def export_slot_payload(self, t: int, seed: int, run_state: dict):
        """Slot ``t`` as a payload: the checkpoint header (kind
        ``"gpu_swarm"``, version 3) and the ``swarm`` part with the keys and
        walk buffers as they are. Resuming it, solo or into a pack,
        continues the same walks as an uninterrupted run."""
        slot = self.read_slot(t)
        stats = {k: v.item() for k, v in slot["stats"].items()}
        return {
            **checkpoint_header(self._model, self._A, False, kind=CHECKPOINT_KIND),
            "state_count": int(stats["count"]),
            "unique_count": int(stats["sample_unique"]),
            "max_depth": int(stats["max_depth"]),
            "swarm": {
                "slot": slot,
                "seed": int(seed),
                "lanes": self._L,
                "max_trace_len": self._D,
                "sample_capacity": self._cap,
                "sample_stride": self._stride,
                "seeded": self._seeded,
                "seeds_digest": self._k.seeds_digest,
                **run_state,
            },
        }

    def restore_slot_carry(self, payload: dict):
        """Checks a swarm payload against this engine's model and shapes
        and returns the tenant carry it holds, on the engine's device."""
        try:
            validate_checkpoint_header(payload, self._model, self._A, False,
                                       kind=CHECKPOINT_KIND)
        except ValueError as e:
            if payload.get("kind", "tpu_bfs") not in ("gpu_bfs", "tpu_bfs"):
                raise
            raise ValueError(
                f"{e}; an exhaustive checkpoint carries a frontier queue, not walk "
                "buffers: seed a swarm from it with frontier_seeds_from_payload "
                "(the hybrid handoff)") from None
        sw = payload["swarm"]
        for knob, mine in (("lanes", self._L), ("max_trace_len", self._D),
                           ("sample_capacity", self._cap),
                           ("sample_stride", self._stride), ("seeded", self._seeded),
                           ("seeds_digest", self._k.seeds_digest)):
            if sw.get(knob) != mine:
                raise ValueError(
                    f"swarm payload {knob}={sw.get(knob)!r} does not match this engine "
                    f"({mine!r}); the walk sequence would diverge from the original run")
        had_cov = "cov" in sw["slot"]
        want_cov = self._cov_layout is not None
        if had_cov != want_cov:
            raise ValueError(
                f"swarm payload coverage={had_cov} does not match this engine "
                f"(coverage={want_cov}); resume with the same coverage setting the "
                "run was spawned with")
        return _map_tree(lambda x: torch.from_numpy(np.array(x)).to(self._device), sw["slot"])


class SwarmChecker(Checker):
    """The solo swarm run ``spawn_swarm`` returns: one engine slot and a
    worker thread running waves until every property has a discovery or
    ``target_state_count`` walk steps are reached (the reference's
    simulation semantics), with preempt and resume."""

    supports_preempt = True
    # Swarm runs pack: lane blocks over one step (``SwarmPackedEngine``).
    supports_packing = True
    packing_reason = None

    def __init__(self, options, seed: int, lanes: int = 1024, wave_steps: int = 1024,
                 max_trace_len: Optional[int] = None, sample_capacity: int = 1 << 15,
                 sample_stride: int = 1, seeds=None, resume_from=None,
                 coverage: bool = False, aot_cache: Optional[str] = None, device=None):
        check_walkable(options, "spawn_swarm")
        model = options.model
        self._model = model
        self._properties = model.properties()
        self._seed = int(seed)
        self._depth_cap = options._target_max_depth
        self._target = options._target_state_count
        # The trace buffer's depth: ``max_trace_len``, else the depth cap
        # (capped walks are then a semantic bound), else 512. The cap is a
        # runtime value of the carry, so one buffer shape serves every cap;
        # walks hitting the buffer below the cap are truncated and counted
        # (``swarm.trace_overflow``).
        D = max_trace_len or (self._depth_cap or 512)

        cov_layout = None
        if coverage:
            from ..telemetry.coverage import DeviceCoverage

            cov_layout = DeviceCoverage(model.packed_action_count(), len(self._properties))
        if isinstance(seeds, dict) and "chunks" in seeds:
            seeds = frontier_seeds_from_payload(model, seeds)
        self._engine = SwarmEngine(
            model, lanes=lanes, wave_steps=wave_steps, max_trace_len=D,
            sample_capacity=sample_capacity, sample_stride=sample_stride, max_tenants=1,
            seeds=seeds, coverage_layout=cov_layout, aot_cache=aot_cache,
            tracer=self._tracer, registry=self.metrics(), device=device)
        self.config_notes = list(self._engine.config_notes)
        if coverage:
            self._init_coverage("swarm", True, model.packed_action_count())
            self._cov_last = np.zeros((cov_layout.size,), np.int64)
        if resume_from is not None:
            carry = self._engine.restore_slot_carry(resume_from)
            if coverage:
                # The restored vector is cumulative over the run before the
                # preempt, which that run already recorded: count from it.
                self._cov_last = host_copy(carry["cov"]).astype(np.int64)
        else:
            carry = self._engine.fresh_tenant_carry(self._seed, depth_cap=self._depth_cap,
                                                    target=self._target)
        self._engine.write_slot(0, carry)

        self._state_count = 0
        self._max_depth = 0
        self._unique_sample = 0
        self._sample_saturated = False
        self._trace_overflows = 0
        self._discoveries_fps: Dict[str, List[int]] = {}
        self._empty_discoveries: set = set()
        self._found_names: List[str] = []
        self._preempt_event = threading.Event()
        self._done_event = threading.Event()
        self._error: Optional[BaseException] = None
        self._seed_fp_map = None
        self._handles = [threading.Thread(target=self._run, name="swarm", daemon=True)]
        self._handles[0].start()

    @property
    def warmup_seconds(self):
        return self._engine.warmup_seconds

    @property
    def engine(self) -> SwarmEngine:
        return self._engine

    # -- worker loop --------------------------------------------------------------

    def _run(self):
        try:
            self._explore()
        except BaseException as e:  # noqa: BLE001 - via worker_error
            self._error = e
        finally:
            self._finalize_coverage(set(self._discoveries_fps))
            self._done_event.set()

    def _absorb_stats(self):
        s = self._engine.tenant_stats(0)
        self._state_count = int(s["count"])
        self._max_depth = int(s["max_depth"])
        self._unique_sample = int(s["sample_unique"])
        self._sample_saturated = bool(s["sample_sat"])
        self._trace_overflows = int(s["overflow"])
        self._found_names = self._engine.tenant_found_names(0)
        if self._cov is not None:
            vec = host_copy(self._engine._carry["cov"][0]).astype(np.int64)
            delta = vec - self._cov_last
            self._cov_last = vec
            self._cov.consume_device(delta, self._engine._cov_layout, first_attempt=True,
                                     max_depth=self._max_depth)
            self._cov.emit_wave_span()
        return s

    def _explore(self):
        if not self._properties and self._target is None:
            return
        while True:
            self._engine.run_wave()
            s = self._absorb_stats()
            if self._preempt_event.is_set() and not s["stopped"]:
                self._preempt_payload = self._engine.export_slot_payload(0, self._seed, {})
                return
            if s["stopped"]:
                fps, empty = self._engine.tenant_discoveries_fps(0)
                self._discoveries_fps = fps
                self._empty_discoveries = empty
                for trail in fps.values():
                    self._engine._h_hit_depth.observe(len(trail))
                return

    # -- path reconstruction --------------------------------------------------------

    def _replay(self, fps: List[int]) -> Path:
        fp_of = functools.partial(host_fingerprint, self._model)
        if not self._engine._seeded:
            return Path.from_fingerprints(self._model, fps, fp_of=fp_of)
        # A seeded walk starts mid-space: find the seed whose fingerprint
        # opens the trail and replay the fragment from it.
        if self._seed_fp_map is None:
            hi, lo = self._engine._fp_fn(self._engine._seeds)
            fps64 = ((hi.cpu().numpy().astype(np.uint64) << np.uint64(32))
                     | lo.cpu().numpy().astype(np.uint64))
            fp_map: Dict[int, int] = {}
            for i, f in enumerate(fps64.tolist()):
                fp_map.setdefault(int(f), i)
            self._seed_fp_map = fp_map
        idx = self._seed_fp_map.get(int(fps[0]))
        if idx is None:
            raise RuntimeError(
                "seeded discovery trail does not start at any seed state (the seed "
                "pool changed between run and replay?)")
        packed = map_leaves(lambda x: x[idx].cpu(), self._engine._seeds)
        state = self._model.unpack_state(packed)
        return _path_from_state(self._model, state, fps, fp_of)

    # -- Checker surface -----------------------------------------------------------

    def model(self):
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        # The distinct sampled walk fingerprints: a lower bound once the
        # sample table saturates (``coverage_estimate()``).
        return self._unique_sample

    def coverage_estimate(self) -> dict:
        """The unique-coverage sample: distinct fingerprints seen, whether
        the table saturated (the estimate is then a lower bound), the walk
        steps, and the table's capacity."""
        return {
            "unique_sample": self._unique_sample,
            "saturated": self._sample_saturated,
            "walk_steps": self._state_count,
            "sample_capacity": self._engine._cap,
        }

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        return {name: self._replay(fps) for name, fps in list(self._discoveries_fps.items())}

    def _discovery_names(self) -> List[str]:
        return list(self._found_names)

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._done_event.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._error

    def request_preempt(self) -> None:
        self._preempt_event.set()

    def state_digest(self) -> dict:
        return {
            "backend": type(self).__name__,
            "done": self.is_done(),
            "state_count": self._state_count,
            "unique_state_count": self._unique_sample,
            "max_depth": self._max_depth,
            "discoveries": sorted(self._found_names),
            "swarm": {"lanes": self._engine._L, "wave_steps": self._engine._K,
                      "sample": self.coverage_estimate(),
                      "trace_overflows": self._trace_overflows},
        }


def _path_from_state(model, start_state, fps: List[int], fp_of) -> Path:
    """``Path.from_fingerprints`` from any start state (a seeded walk does
    not begin at an initial state)."""
    if fp_of(start_state) != fps[0]:
        raise ValueError("start state does not match the trail head")
    output = []
    last_state = start_state
    for next_fp in fps[1:]:
        found = None
        for a, s in model.next_steps(last_state):
            if fp_of(s) == next_fp:
                found = (a, s)
                break
        if found is None:
            raise RuntimeError(f"seeded walk replay diverged at fingerprint {next_fp}")
        output.append((last_state, found[0]))
        last_state = found[1]
    output.append((last_state, None))
    return Path(output)


class _TenantWalkView(Checker):
    """A packed tenant's Checker-shaped view: cumulative counts, discovery
    names, and once the tenant stops, its discovery paths."""

    supports_preempt = True
    supports_packing = True
    packing_reason = None

    def __init__(self, pack: "SwarmPackedEngine", key: str, slot: int):
        self._pack = pack
        self._key = key
        self._slot = slot
        self._model = pack._engine._model
        self._stats: dict = {}
        self._found: List[str] = []
        self._fps: Dict[str, List[int]] = {}
        self._stopped = False
        self._last: Dict[str, int] = {}
        reg = self.metrics()
        self._m = {
            "count": reg.counter("swarm.walk_steps"),
            "walks": reg.counter("swarm.walks_completed"),
            "restarts": reg.counter("swarm.restarts"),
            "restart_dups": reg.counter("swarm.restarts_deduped"),
            "overflow": reg.counter("swarm.trace_overflow"),
            "sample_unique": reg.counter("swarm.unique_sample"),
        }

    @property
    def warmup_seconds(self):
        return self._pack._engine.warmup_seconds

    def _prime(self, stats: dict, found_names: List[str]) -> None:
        """The admission baseline: a resumed slot's totals were recorded by
        the run before it, so only what comes after admission counts."""
        self._stats = stats
        self._found = found_names
        self._stopped = bool(stats.get("stopped"))
        for field in self._m:
            self._last[field] = int(stats.get(field, 0))

    def _absorb(self, stats: dict, found_names: List[str]) -> None:
        self._stats = stats
        self._found = found_names
        self._stopped = bool(stats.get("stopped"))
        for field, counter in self._m.items():
            cur = int(stats.get(field, 0))
            prev = self._last.get(field, 0)
            if cur > prev:
                counter.inc(cur - prev)
                self._last[field] = cur

    def _finish(self, fps: Dict[str, List[int]]) -> None:
        self._fps = fps
        self._stopped = True

    @property
    def _trace_overflows(self) -> int:
        return int(self._stats.get("overflow", 0))

    def model(self):
        return self._model

    def state_count(self) -> int:
        return int(self._stats.get("count", 0))

    def unique_state_count(self) -> int:
        return int(self._stats.get("sample_unique", 0))

    def coverage_estimate(self) -> dict:
        return {
            "unique_sample": self.unique_state_count(),
            "saturated": bool(self._stats.get("sample_sat", False)),
            "walk_steps": self.state_count(),
            "sample_capacity": self._pack._engine._cap,
        }

    def max_depth(self) -> int:
        return int(self._stats.get("max_depth", 0))

    def discoveries(self) -> Dict[str, Path]:
        fp_of = functools.partial(host_fingerprint, self._model)
        return {name: Path.from_fingerprints(self._model, fps, fp_of=fp_of)
                for name, fps in list(self._fps.items())}

    def _discovery_names(self) -> List[str]:
        return list(self._found)

    def handles(self) -> List[threading.Thread]:
        return []

    def is_done(self) -> bool:
        return self._stopped

    def worker_error(self) -> Optional[BaseException]:
        return None


class SwarmPackedEngine:
    """Up to ``max_tenants`` swarm runs in one step: admit / step / drop /
    release / free_slots / live_count / faulted_keys / fault_error /
    close, the JAX package's packed-engine protocol. Tenants are lane
    blocks that never interact, so each tenant's results are its solo
    run's."""

    def __init__(self, model, *, lanes: int = 1024, wave_steps: int = 1024,
                 max_trace_len: int = 256, sample_capacity: int = 1 << 15,
                 sample_stride: int = 1, max_tenants: int = 8,
                 aot_cache: Optional[str] = None, device=None):
        self._engine = SwarmEngine(
            model, lanes=lanes, wave_steps=wave_steps, max_trace_len=max_trace_len,
            sample_capacity=sample_capacity, sample_stride=sample_stride,
            max_tenants=max_tenants, aot_cache=aot_cache, device=device)
        self._slots: List[Optional[str]] = [None] * self._engine._T
        self._views: Dict[str, _TenantWalkView] = {}
        self._seeds: Dict[str, int] = {}
        self._reported: set = set()
        self._faulted: Dict[str, BaseException] = {}

    @property
    def engine(self) -> SwarmEngine:
        return self._engine

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def live_count(self) -> int:
        # A stopped tenant not yet reported still counts as live: a fault
        # of a peer in the same wave may have discarded its completion.
        return sum(1 for jid in self._slots
                   if jid is not None
                   and not (self._views[jid]._stopped and jid in self._reported))

    def faulted_keys(self):
        return list(self._faulted)

    def fault_error(self, key: str):
        return self._faulted.get(key)

    def admit(self, job_id: str, *, seed: int = 0, depth_cap=None,
              target_state_count=None, resume_from=None) -> _TenantWalkView:
        """Claims a slot: fresh walks from ``seed``, or a suspended run's
        carry (``resume_from``, a swarm payload of a solo run or of an
        earlier pack)."""
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError("no free swarm lane slots") from None
        if resume_from is not None:
            carry = self._engine.restore_slot_carry(resume_from)
            seed = int(resume_from["swarm"].get("seed", seed))
        else:
            carry = self._engine.fresh_tenant_carry(seed, depth_cap=depth_cap,
                                                    target=target_state_count)
        self._engine.write_slot(slot, carry)
        self._slots[slot] = job_id
        self._seeds[job_id] = int(seed)
        view = _TenantWalkView(self, job_id, slot)
        view._prime(self._engine.tenant_stats(slot), self._engine.tenant_found_names(slot))
        self._views[job_id] = view
        self._reported.discard(job_id)
        self._faulted.pop(job_id, None)
        return view

    def step(self) -> List[str]:
        """One wave for every live tenant; returns the tenants that
        finished in it (stopped, discoveries read). A per-tenant harvest
        fault raises ``TenantFaultError``: the caller drops only that
        tenant (its slot is whole, its payload resumes it from this wave)
        while the others keep walking."""
        self._engine.run_wave()
        done: List[str] = []
        try:
            for slot, jid in enumerate(self._slots):
                if jid is None or jid in self._faulted:
                    continue
                view = self._views[jid]
                try:
                    fault_point("swarm.tenant.verdict", tenant=jid)
                    stats = self._engine.tenant_stats(slot)
                    view._absorb(stats, self._engine.tenant_found_names(slot))
                    if stats["stopped"] and jid not in self._reported:
                        fps, _empty = self._engine.tenant_discoveries_fps(slot)
                        view._finish(fps)
                        self._reported.add(jid)
                        done.append(jid)
                except Exception as e:  # noqa: BLE001 - blast radius
                    self._faulted[jid] = e
                    raise TenantFaultError(jid, e) from e
        except BaseException:
            # The raised fault discards this wave's ``done`` list, so its
            # completions must be reportable again (the harvest is
            # idempotent: the next step reports them).
            for jid in done:
                self._reported.discard(jid)
            raise
        return done

    def drop(self, job_id: str, discard: bool = False):
        """Frees the tenant's slot; unless ``discard``, returns its payload
        (resumable solo or into a later pack)."""
        slot = self._slots.index(job_id)
        payload = None
        if not discard:
            payload = self._engine.export_slot_payload(slot, self._seeds.get(job_id, 0), {})
        self._engine.clear_slot(slot)
        self._slots[slot] = None
        self._views.pop(job_id, None)
        self._seeds.pop(job_id, None)
        self._faulted.pop(job_id, None)
        self._reported.discard(job_id)
        return payload

    def release(self, job_id: str) -> None:
        """Frees a completed tenant's slot: a discarding drop."""
        self.drop(job_id, discard=True)

    def close(self) -> None:
        """Nothing to tear down: the engine is its carry and its graph."""
