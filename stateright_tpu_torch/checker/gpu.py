"""GPU breadth-first checker: frontier waves in torch, inserts in CUDA.

The port of the JAX package's ``TpuBfsChecker`` as configured with
``hashset_impl="pallas"``, ``wave_kernel="staged"`` and
``wave_dedup="sort"``, driven wave at a time (``_explore_waves``). Each
wave takes one frontier chunk of at most ``frontier_capacity`` states and

    evaluates the property conditions (clearing ``eventually`` bits)
      -> expands the F x A action grid (``packed_expand``), drops lanes
         outside ``packed_within_boundary``, marks terminal states
      -> fingerprints the candidates (``ops/fingerprint.py``)
      -> sorts them stably by unsigned (hi, lo) and keeps the first
         occurrence of each key (the lowest lane decides the parent)
      -> inserts the wave-unique keys into the visited set through the
         CUDA tile-sweep kernel (``ops/hashset_kernel.py``)
      -> compacts the fresh lanes, in key order, into the next frontier,
         and logs (child, parent) fingerprints for path replay.

Counts, depths, verdicts and counterexample paths equal the JAX
package's. The table grows (doubling + rehash) before a wave whose
worst case would pass a load of ``_MAX_LOAD``, and a wave whose keys
overflow a probe window is consumed, the table grown, and the wave run
again, as in the reference. The rehash sorts the old table's live rows
and inserts them through the same kernel, so the table layout after a
growth is the port's own (deterministic, but not the JAX package's
scatter layout).

The device-resident deep drain of the JAX package waits for a later slice.

Semantics parity notes (mirrored from the reference): ``eventually`` bits
propagate along paths and are not part of the fingerprint;
``target_state_count``/``target_max_depth`` may overshoot by up to a wave.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.batch import BatchableModel, map_leaves
from ..core.model import Expectation
from ..core.path import Path
from ..native import make_fingerprint_store
from ..ops.fingerprint import fp_to_int
from ..ops.hashset import hashset_new, i32_to_u32, u32_to_i32
from ..ops.hashset_kernel import (
    TILE_ROWS,
    hashset_insert_sorted,
    sort_key,
    split_key,
)
from .base import Checker

_DEPTH_INF = (1 << 31) - 1
# Grow the visited set before its load factor can pass this.
_MAX_LOAD = 0.55


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def resolve_device(device) -> torch.device:
    """The checker's device: CUDA unless the caller asks for the CPU. With
    no CUDA device and no ``device="cpu"`` it raises — the run never goes
    on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "spawn_gpu_bfs runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain torch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    elif dev.type != "cpu":
        raise ValueError(f"spawn_gpu_bfs runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def _sorted_dedup(khi, klo, valid):
    """Stable sort of the (hi, lo) keys with invalid lanes sunk to the
    (MAX, MAX) sentinel; returns ``(shi, slo, sidx, unique)`` where
    ``unique`` marks each valid key's first (lowest-lane) occurrence —
    ``jax.lax.sort(num_keys=2)`` over ``(hi, lo, lane)`` in the reference."""
    key = torch.where(valid, sort_key(khi, klo), torch.full_like(khi, (1 << 63) - 1))
    skey, sidx = torch.sort(key, stable=True)
    first = torch.ones_like(valid)
    first[1:] = skey[1:] != skey[:-1]
    shi, slo = split_key(skey)
    return shi, slo, sidx, valid[sidx] & first


def _fp64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 pairs as int64 whose bits are the u64 fingerprint."""
    return (hi << 32) | lo


class GpuBfsChecker(Checker):
    """Requires the model to implement ``BatchableModel``.

    ``frontier_capacity`` caps lanes per wave (larger frontiers split into
    chunks); ``table_capacity`` is the initial visited-set size, a power
    of two and a multiple of ``TILE_ROWS`` (grows by doubling + rehash);
    ``device`` is ``"cuda"`` (the default) or ``"cpu"``."""

    def __init__(
        self,
        options,
        frontier_capacity=1 << 13,
        table_capacity=1 << 16,
        device=None,
    ):
        model = options.model
        if not isinstance(model, BatchableModel):
            raise TypeError(
                f"spawn_gpu_bfs requires a BatchableModel; {type(model).__name__} "
                "does not implement the packed protocol (see "
                "stateright_tpu_torch.core.batch)"
            )
        self._device = resolve_device(device)
        self._model = model
        self._properties = model.properties()
        self._conditions = model.packed_conditions()
        if len(self._conditions) != len(self._properties):
            raise ValueError(
                "packed_conditions() must align 1:1 with properties(): "
                f"{len(self._conditions)} != {len(self._properties)}"
            )
        eventually = [
            i
            for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY
        ]
        if len(eventually) > 32:
            raise ValueError("at most 32 eventually properties supported")
        self._ebit: Dict[int, int] = {pi: b for b, pi in enumerate(eventually)}
        self._ebits0 = sum(1 << b for b in self._ebit.values())
        self._A = model.packed_action_count()
        self._F_max = _pow2ceil(frontier_capacity)
        cap = int(table_capacity)
        if cap <= 0 or cap & (cap - 1) or cap % TILE_ROWS:
            raise ValueError(
                "table_capacity must be a power of two and a multiple of "
                f"{TILE_ROWS} (the insert kernel's tile), got {table_capacity}"
            )
        self._capacity = cap
        self._visitor = options._visitor
        self._target_state_count: Optional[int] = options._target_state_count
        self._depth_cap = options._target_max_depth or _DEPTH_INF

        self._state_count = 0
        self._unique_count = 0
        self._max_depth = 0
        self._discoveries_fp: Dict[str, int] = {}
        # (child fps, parent fps — 0 encodes "init state") per wave, as
        # u64 numpy arrays, ingested lazily into the parent-pointer store.
        self._wave_log: List = []
        self._store = make_fingerprint_store()
        self._ingested = 0
        self._ingest_lock = threading.Lock()
        self._host_fps: Dict = {}
        # Run statistics (read by chip_smoke.py and the tests).
        self.waves = 0
        self.table_growths = 0
        self._done_event = threading.Event()
        self._error: Optional[BaseException] = None
        self._handles = [
            threading.Thread(target=self._run, name="gpu-bfs", daemon=True)
        ]
        self._handles[0].start()

    # -- device work ---------------------------------------------------------

    def _dedup_insert(self, table, khi, klo, valid):
        shi, slo, sidx, unique = _sorted_dedup(khi, klo, valid)
        table, fresh, _found, pending = hashset_insert_sorted(
            table, u32_to_i32(shi), u32_to_i32(slo), unique
        )
        return table, sidx, fresh, pending

    def _wave(self, table, chunk):
        """One wave over a frontier chunk; returns ``(table, out)`` where
        ``out["stats"]`` is the host list ``[generated, n_new, overflow,
        max_depth, (hit, hi, lo) per property...]``."""
        model = self._model
        A = self._A
        states, hi, lo = chunk["states"], chunk["hi"], chunk["lo"]
        ebits, depth = chunk["ebits"], chunk["depth"]
        F = hi.shape[0]
        B = F * A
        eval_mask = depth < self._depth_cap

        # Property conditions on the frontier (the states being "popped").
        cond_vals = [c(states) for c in self._conditions]
        ebits_after = ebits
        for pi, b in self._ebit.items():
            ebits_after = torch.where(
                cond_vals[pi], ebits_after & ~(1 << b), ebits_after
            )

        cand, cvalid = model.packed_expand(states)
        cand_flat = map_leaves(lambda x: x.reshape((B,) + x.shape[2:]), cand)
        cvalid = (cvalid & eval_mask[:, None]).reshape(B)
        cvalid = cvalid & model.packed_within_boundary(cand_flat)
        generated = cvalid.sum()
        terminal = eval_mask & ~cvalid.view(F, A).any(dim=1)
        chi, clo = model.packed_fingerprint(cand_flat)

        table, sidx, fresh, pending = self._dedup_insert(table, chi, clo, cvalid)

        items = [generated, fresh.sum(), pending.sum(), depth.max()]
        lanes = torch.arange(F, device=hi.device)
        for i, p in enumerate(self._properties):
            if p.expectation == Expectation.ALWAYS:
                h = eval_mask & ~cond_vals[i]
            elif p.expectation == Expectation.SOMETIMES:
                h = eval_mask & cond_vals[i]
            else:  # EVENTUALLY: unmet bit at a terminal state
                h = terminal & (((ebits_after >> self._ebit[i]) & 1) == 1)
            # First hit lane (lane 0 when there is none; unused then).
            idx = torch.where(h, lanes, F).min().clamp(max=F - 1)
            items += [h.any(), hi[idx], lo[idx]]
        stats = torch.stack([x.to(torch.int64) for x in items]).tolist()

        # Compact the fresh lanes, in sorted-key order, into the next
        # frontier.
        src = sidx[torch.nonzero(fresh).squeeze(1)]
        parent = src // A
        new = {
            "states": map_leaves(lambda x: x[src], cand_flat),
            "hi": chi[src],
            "lo": clo[src],
            "ebits": ebits_after[parent],
            "depth": depth[parent] + 1,
        }
        log = torch.stack([_fp64(new["hi"], new["lo"]), _fp64(hi[parent], lo[parent])])
        return table, {"stats": stats, "new": new, "log": log}

    def _rehash(self, table, capacity):
        """The old table's live rows, sorted, inserted into an empty table
        of ``capacity`` rows through the same insert; returns the new table
        and the count of rows that found no slot."""
        rows_hi, rows_lo = i32_to_u32(table[:, 0]), i32_to_u32(table[:, 1])
        live = (rows_hi != 0) | (rows_lo != 0)
        key, _ = torch.sort(sort_key(rows_hi[live], rows_lo[live]))
        khi, klo = split_key(key)
        new_table, _fresh, _found, pending = hashset_insert_sorted(
            hashset_new(capacity, self._device), u32_to_i32(khi),
            u32_to_i32(klo), torch.ones_like(key, dtype=torch.bool),
        )
        return new_table, int(pending.sum())

    def _grow_table(self, table, min_capacity):
        capacity = self._capacity
        while capacity < min_capacity:
            capacity *= 2
        while True:
            new_table, leftover = self._rehash(table, capacity)
            if not leftover:
                break
            # A pathological key cluster can exhaust the probe cap during
            # rehash; the next doubling shortens probe chains.
            capacity *= 2
        self._capacity = capacity
        self.table_growths += 1
        return new_table

    # -- host exploration loop ----------------------------------------------

    def _run(self):
        try:
            table, queue = self._seed()
            self._explore_waves(table, queue)
        except BaseException as e:  # noqa: BLE001 - surfaced via worker_error
            self._error = e
        finally:
            self._done_event.set()

    def _seed(self):
        """Inserts + enqueues the initial states; returns (table, queue)."""
        model = self._model
        states = model.packed_init_states(self._device)
        valid = model.packed_within_boundary(states)
        hi, lo = model.packed_fingerprint(states)
        while True:
            table = hashset_new(self._capacity, self._device)
            table, _sidx, fresh, pending = self._dedup_insert(table, hi, lo, valid)
            if not int(pending.sum()):
                break
            self._capacity *= 2
        self._state_count = int(valid.sum())
        self._unique_count = int(fresh.sum())
        child = _fp64(hi, lo)[valid].cpu().numpy().view(np.uint64)
        self._wave_log.append((child, np.zeros_like(child)))

        # Chunks of F_max lanes over all init lanes, each keeping its valid
        # lanes (the reference masks the others out).
        F0 = hi.shape[0]
        ebits = torch.full((F0,), self._ebits0, dtype=torch.int64, device=self._device)
        depth = torch.ones(F0, dtype=torch.int64, device=self._device)
        queue = deque()
        for s in range(0, F0, self._F_max):
            keep = s + torch.nonzero(valid[s : s + self._F_max]).squeeze(1)
            queue.append({
                "states": map_leaves(lambda x: x[keep], states),
                "hi": hi[keep],
                "lo": lo[keep],
                "ebits": ebits[keep],
                "depth": depth[keep],
            })
        return table, queue

    def _explore_waves(self, table, queue):
        props = self._properties
        while queue:
            if not props:
                break
            if len(self._discoveries_fp) == len(props):
                break
            if (
                self._target_state_count is not None
                and self._target_state_count <= self._state_count
            ):
                break
            chunk = queue.popleft()
            # Worst case of a full-width chunk, as the reference sizes it.
            B = self._F_max * self._A
            if (self._unique_count + B) > _MAX_LOAD * self._capacity:
                table = self._grow_table(
                    table, _pow2ceil(int((self._unique_count + B) / _MAX_LOAD))
                )
            table = self._consume_wave(table, chunk, queue)

    def _consume_wave(self, table, chunk, queue):
        """Applies one wave host-side (counters, discoveries, log, requeue),
        growing the table and running the same chunk again while keys
        overflow their probe windows; each attempt's fresh states are kept."""
        if chunk["hi"].shape[0] == 0:
            return table
        attempt = 0
        while True:
            table, out = self._wave(table, chunk)
            self.waves += 1
            stats = out["stats"]
            if attempt == 0:
                self._apply_wave_stats(stats, chunk)
            n_new = stats[1]
            self._unique_count += n_new
            if n_new:
                child, parent = out["log"].cpu().numpy().view(np.uint64)
                self._wave_log.append((child, parent))
                new = out["new"]
                for s in range(0, n_new, self._F_max):
                    queue.append({
                        k: (
                            map_leaves(lambda x: x[s : s + self._F_max], v)
                            if k == "states"
                            else v[s : s + self._F_max]
                        )
                        for k, v in new.items()
                    })
            if not stats[2]:
                return table
            table = self._grow_table(table, self._capacity * 2)
            attempt += 1

    def _apply_wave_stats(self, stats, chunk):
        self._state_count += stats[0]
        self._max_depth = max(self._max_depth, stats[3])
        for i, p in enumerate(self._properties):
            hit, phi, plo = stats[4 + 3 * i : 7 + 3 * i]
            if hit and p.name not in self._discoveries_fp:
                self._discoveries_fp[p.name] = fp_to_int(phi, plo)
        if self._visitor is not None:
            depth = chunk["depth"].tolist()
            hi = chunk["hi"].tolist()
            lo = chunk["lo"].tolist()
            for d, h, lo_ in zip(depth, hi, lo):
                if d < self._depth_cap:
                    self._visitor.visit(
                        self._model, self._reconstruct(fp_to_int(h, lo_))
                    )

    # -- path reconstruction ------------------------------------------------

    def _host_fp(self, host_state) -> int:
        try:
            return self._host_fps[host_state]
        except (KeyError, TypeError):
            pass
        packed = map_leaves(lambda x: x[None], self._model.pack_state(host_state))
        hi, lo = self._model.packed_fingerprint(packed)
        fp = fp_to_int(hi[0], lo[0])
        try:
            self._host_fps[host_state] = fp
        except TypeError:
            pass
        return fp

    def _ingest_wave_log(self):
        # Raced by the worker (visitor reconstruction) and the user thread
        # (mid-run discoveries()); first-writer-wins keeps the BFS parent.
        with self._ingest_lock:
            while self._ingested < len(self._wave_log):
                children, parents = self._wave_log[self._ingested]
                self._store.insert_batch(children, parents)
                self._ingested += 1

    def _reconstruct(self, fp: int) -> Path:
        self._ingest_wave_log()
        chain = self._store.chain(fp)
        return Path.from_fingerprints(self._model, chain, fp_of=self._host_fp)

    # -- Checker surface -----------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    def model(self):
        return self._model

    def state_count(self) -> int:
        return max(self._state_count, self._unique_count)

    def unique_state_count(self) -> int:
        return self._unique_count

    def max_depth(self) -> int:
        return self._max_depth

    def discoveries(self) -> Dict[str, Path]:
        return {
            name: self._reconstruct(fp)
            for name, fp in list(self._discoveries_fp.items())
        }

    def handles(self) -> List[threading.Thread]:
        handles, self._handles = self._handles, []
        return handles

    def is_done(self) -> bool:
        return self._done_event.is_set()

    def worker_error(self) -> Optional[BaseException]:
        return self._error

    def table_capacity(self) -> int:
        return self._capacity
