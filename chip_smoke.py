"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --stage-ab [--root DIR] [--out FILE]
    python3 chip_smoke.py --attributed-child OUT.json
    python3 chip_smoke.py --sharded-child RANK PORT OUT.json

Builds every CUDA kernel of the port from the sources in this checkout (one
``nvcc`` per source, all at once), holds each kernel against its plain torch
twin (bit for bit) at the main paths' full shapes (the fused wave also on a
masked take of the deep drain's ring), then drives both main paths: an
exhaustive check of two-phase commit with 8 resource managers (1,745,408
states) through ``TwoPhaseSys(8).checker().spawn_gpu_bfs()`` with the staged
wave (torch + the CUDA insert) and with ``wave_kernel="fused"`` (the model
stage in torch, every other stage in CUDA), each wave at a time
(``max_drain_waves=1``) and through the deep drain (the default: the
frontier in a device ring, drained by replayed CUDA Graphs with no host sync
inside a drain), and smaller runs of all four whose paths are replayed
against the CPU twin. The models and their spawn settings are the named
configurations of ``stateright_tpu_torch/configs.py``. Then the actor path:
the fused wave's component-hash keys stage (``fw_comphash_keys``) and its
whole chain held against their plain twins on a full-width wave of "paxos
check 3" (3 clients, 3 servers, 24 envelope slots) taken from the drain with
its table; an exhaustive check of paxos check 3 (1,194,428 states) through
``PaxosModelCfg(3, 3, envelope_capacity=24).into_model().checker()
.spawn_gpu_bfs(...)`` on both engines through the deep drain, its ``value
chosen`` path replayed on the host; the ordered route of
``fw_comphash_keys`` (one component per FIFO flow) and the chain held
against their plain twins on a full-width wave of "linearizable-register
check 3 ordered" (abd3o: ABD, 3 clients, 2 servers, FIFO flows) taken from
the drain; abd3o (46,516 states) on both engines through the drain; the keys
stage and the chain held against their twins on a full-width wave of raft
with 5 servers (256,000 lanes: no history, timers, drops), and the insert
kernel on that wave's keys; raft5 on a lossy network until its ``stable
leader`` counterexample, the time to it (``ttc_s``) and the unique count at
the exit, the path replayed on the host, staged with the fingerprint-only wave
(the default for actor models), fused, and staged with ``expand_fps=False``
in the same call; raft with 4 servers, lossy (24,545 states, timers,
drops); the fingerprint-only expansion against the materializing one on
full-width waves of paxos3, abd3o, raft5 and raft4 (``fps_vs_materialize``:
fingerprints, validity and ``packed_take`` to ``max_abs_err`` 0, and both
staged waves timed, with their peak device bytes); and small paxos,
single-copy, ordered ABD and raft-with-a-crash runs on the card against the
CPU twin. The actor models' staged runs take the fingerprint-only wave. Then coverage
(``spawn_gpu_bfs(coverage=True)``): the coverage epilogue, which
``fw_frontier`` and ``fw_compact`` add with no kernel of their own, and the
whole chain with coverage on held against their plain twins on
full-width takes of 2pc-8 and of ``skv4x4`` (the fixed sharded KV,
``ShardedKv(4, 4, 3, guarded=True)``); 2pc-8 through the drain with coverage
on both engines, equal reports, against the coverage-off runs; ``skv4x4``
exhaustively (16,777,216 states) on both engines with coverage; and small
coverage runs on the card against the CPU twin. On every timed wave
(2pc-8, paxos3, abd3o, raft5, and 2pc-8 and skv4x4 with coverage) the
fused sort (``fw_sort``) is held to a stable ``torch.sort`` of the wave's
keys, the dedup (``fw_dedup``) to ``dedup_plain`` on the chain's own
sorted keys (``active`` and the tile ``starts``), the compaction
(``fw_compact``) to ``compact_plain`` and the stats vector it
writes to the plain wave's ``_stats``, the leaf gather (``fw_gather``) to
``x[src]`` over the chain's own compaction, the frontier (``fw_frontier``)
to ``frontier_plain`` and, on the fold route's waves, the keys stage
(``fw_keys``, reading the candidate leaves in place) to ``keys_plain`` over
``fingerprint_state``; the dedup also on two sparse waves of skv4x4's width
into its 2^25-row table (at most 64 keyed lanes: ``{"dedup_sparse_wave":
...}`` lines); last, one ``torch.profiler`` session gives each wave's
chain, captured in a CUDA Graph and replayed, its device time by stage
(each coverage wave beside its coverage-off twin: the epilogue's in-graph
time and proof that it adds no device operation), and one
``{"stage_record": ...}`` line a wave gives the chain's per-stage times
(event marks and in-graph device time), the keyed lanes and fresh rows,
the stages' times and bounds, ``torch.sort``'s, ``torch.searchsorted``'s,
``torch.nonzero``'s and the summed per-leaf ``index_select``'s times.
Then symmetry reduction (``.symmetry()``, the staged engine and its insert
kernel): a 2pc-9 drain take's canonical keys through the insert kernel
against its plain twin; 2pc-9 (2,232 orbits) through the captured drain;
2pc-5 (314) wave at a time and drained, the counter models, raft with 3
servers on a lossy duplicating network (464) and a drain stopped at every
wave by "orbit fallback" exits (a refine hook that says nothing), each
against the CPU twin; raft5 to its ``stable leader`` counterexample beside
the unreduced run; and the key stage's device ms a wave on the widest
drain take of each path (eager and in a CUDA Graph).
Then the host engines (``host_engines_and_lasso``): 2pc-5 through
``spawn_bfs().threads(4)``, ``spawn_dfs()`` (and with the reference's
symmetry heuristic, 665), ``spawn_on_demand()`` and the default
``spawn_gpu_bfs()`` (8,832 each); 2pc-8 through ``spawn_gpu_bfs()`` with no
``wave_kernel``, which resolves to the fused engine (1,745,408, its launches
counted as the other paths'); and ``complete_liveness()`` on the card for a
cycler and for raft-3 lossy "stable leader", each path equal to the CPU
twin's with the condition false along it.
Then checkpoints, preemption and the out-of-core visited set
(``checkpoint_resume_tiering``): 2pc-8 through the default engine with a
checkpoint every 8 chunks (one file copied aside mid-run), preempted after
its third drain and resumed from the payload and from the copied file
(bit-identical to the checkpointed run, golden report included), at the
smallest admissible ``hbm_budget_mib`` (evictions, the handoff to the wave
path, the host probe) and again with a 2 MiB host budget and a spill
directory; abd3o staged with the fingerprint-only wave, preempted half way
and resumed; and the insert kernel rebuilding the preempted run's table
from its payload against its plain twin, timed; the budgeted 2pc-8 run is
attributed (``attribution=True``) and its ledger printed
(``{"budget_2pc8_ledger": ...}``: the host probe's share, an evict window
an eviction).
Then attribution and the per-stage breakdown
(``attribution_and_breakdown``): 2pc-8 through the default engine with an
attribution engine built with ``profile_dir`` beside the same run
unattributed, in a child process (``--attributed-child``: its
``torch.profiler`` window is then its process's first), held to the same
states, digests, waves, drains, rungs, exits and graph captures, with a
ledger within tolerance, a ``compile`` window a graph captured, a device
split from the profile and probe-length counts over every key; and
``measure_wave_breakdown`` of 2pc-8 and paxos3 on the fused engine
(``{"wave_breakdown": ...}`` lines), each roofline attainment at most
1.05. The kernels' bounds are the must-move counts of
``stateright_tpu_torch/checker/breakdown.py``.
Then the device random walks (``simulation_and_swarm``), each run against
its CPU twin: the JAX bench's swarm leg at its full widths through
``spawn_swarm`` (the named ``SWARM_CONFIGS``: the deep sharded KV to its
"no total tear" violation, whose path is replayed on the host to a state
with every key torn; raft-3 check-live to a "stable leader" cycle; the
2pc-3 witness hunt, polled and preempted once both witnesses land), the
insert kernel against its plain twin on one sample step of the deep run,
the guarded sharded KV to 2^20 walk steps (walk steps a second, a wave's
device ms under CUDA events, capture seconds, peak device bytes, the torch
operations of one step and the threefry draws' share; its first wave
against the CPU twin's, and a preempt after that wave resumed
bit-identically), ``spawn_gpu_simulation`` on 2pc-3 (200,000 walk steps
against the twin, then 1,000,000), and two ``SwarmPackedEngine`` tenants
each equal to its solo run; one ``{"swarm_run": ...}`` line a run, and the
insert kernel's launches of each run in the kernels line.
Then device liveness (``device_liveness``): ``spawn_gpu_bfs(liveness=
"device")`` on the staged engine, the edge log appended inside the captured
drain and the trim and reach on the card, each run against its CPU twin
(counts, drains and exits, the logged relation, the verdict records, the
certificates by fingerprint): raft-3 check-live (``LIVENESS_CONFIGS``, the
JAX bench's liveness leg) to its "stable leader" counterexample; the
``LevelDag`` absence certificate (73,727 states), its analysis re-run warm
and the host post-pass (``find_eventually_lasso``) timed on the same
region; the same DAG at W = 2^20 (2,097,151 states), held to its analytic
figures; raft4 staged with the knob and without it (24,545 both); the
absence run preempted after its first drain and resumed from its version 3
payload. One ``{"liveness_run": ...}`` line a run, and the insert kernel's
launches of each run in the kernels line.
Then tenant packing (``tenant_packing``): ``TenantPackedEngine`` on the
card, every salted claim through the insert kernel: 8 tenants of 2pc-5 (the
JAX service bench's packed leg) each equal to its CPU twin, beside a solo
2pc-5; 4 tenants of 2pc-8 at the ``2pc8`` configuration's widths, one
joining after 20 waves and one dropped at half its count and resumed in
``spawn_gpu_bfs``, each at 1,745,408 with a solo card run's depth and
discovery names; 2 tenants of 2pc-5 at twice the smallest admissible budget
in both pipeline modes; 3 tenants of the ``LevelDag`` absence model with
``liveness="device"``; and the insert kernel against its plain twin on a
full-width 2pc-8 pack wave. One ``{"pack_run": ...}`` line a pack, and a
``{"tenant_packing": ...}`` summary after the kernels line.
Then fingerprint sharding (``sharded``): ``spawn_sharded_gpu_bfs`` with n
shards in this process on the card, every owner insert through the insert
kernel, each run against its CPU twin in counts, depth, discoveries, paths
and lanes shipped: the JAX bench's multichip leg (2pc-5 at 1, 2, 4 and 8
shards, sieve off and on); 2pc-8 at 8 shards of 1,024 lanes through the
drain (1,745,408); the insert kernel against its plain twin on one owner's
received batch of that run; a one-rank NCCL ``bootstrap_mesh`` run of 2pc-5
with 8 shards against the one-process mesh; and a two-rank NCCL run where
the machine has two cards (``--sharded-child``), else a
``{"sharded_nccl_two_ranks": "not run: 1 CUDA device"}`` line. Then the
rest of sharding (``_sharded_rest``): 2pc-8 on 8 shards of 512 lanes with
the sieve, wave at a time, unbounded and at the smallest ``hbm_budget_mib``
the checker admits (a 2^18-row table a shard: it evicts) with a host budget
that spills, the insert kernel against its plain twin on the first owner
batch after an eviction; the budgeted run again with
``async_pipeline=True``; the budgeted run's payload after its last eviction
resumed on 4 shards of 1,024 lanes, the insert kernel against its twin on
the rebuild's last batch;
2pc-8 on 8 shards of 1,024 lanes with ``coverage=True`` (its report against
the solo ``spawn_gpu_bfs(coverage=True)`` report) and with
``attribution=True``; ``level_dag_2p20`` with ``liveness="device"`` on 8
shards against the solo run; and the JAX package's slow sharded counts
(raft-3 with a crash 2,252, 2pc-7 orbits 920, raft-5 lossless 7,977). One
``{"sharded_run": ...}`` line a run, and ``{"sharded": ...}``,
``{"sharded_tiers": ...}``, ``{"sharded_telemetry": ...}`` and
``{"sharded_liveness": ...}`` lines after the kernels line.
Then the conformance plane and the insert micro-bench (``conformance``), at
the JAX bench's conformance leg, each result against the CPU twin: the
seed corpus (``examples/conformance_corpus.jsonl``) through
``ConformanceChecker(parity=True, batch_lanes=32)`` on the card, its
``conformance_report()`` equal to the twin's; increment_lock traces
(T = 16) replayed through one captured CUDA Graph a shape at 1, 64 and
1,024 lanes, cold then warm (traces/s, capture seconds); register histories
(C=2, O=2, linearizability) audited at the same batches (histories/s);
0, 10 and 50% divergent lanes at 1,024 (exact counts, ``divergence_flatness``);
and ``ops/bench_hashset.run`` at its defaults (2^20 rows, 2^15 lanes, 16
rounds) and at the main path's shape (2^22 rows, 344,064 lanes, 6 rounds),
the insert kernel equal to its plain twin, its launches in the kernels
line. One ``{"conformance": ...}`` line after the kernels line.
Then the check service (``service``), every job on the card: 4 x 2pc-5
packed, each tenant equal to a direct ``spawn_gpu_bfs`` run, the salted
insert of a full-width pack wave against its plain twin; a solo 2pc-8 job
preempted for a higher-priority job and resumed to the direct run's golden
report; the budgeted 2pc-8 pair (the smallest admissible budget),
synchronous and ``async_pipeline=True``, with equal counts, evictions and
reports, their walls and ``host_probe_s``, the fused chain on the first
wave after an eviction against its plain twin; 2pc-8 resubmitted on a
``service_dir``, completing from its seed in verify-only mode; a
``device.wave`` fault in a drained job, retried to the direct run's report;
a conformance job against the CPU twin and a swarm pair against direct
runs; ``torch.cuda.memory_allocated()`` after every service closed, within
1 MiB of the phase's start. ``{"service_run": ...}`` lines, and a
``{"service": ...}`` line after the kernels line.
Prints phase lines, the card's name and power limit, the fused wave's
stage times, the drains' walls, waves, no-op and warm-up waves, exits,
graph captures and replays and rungs, peak device memory, one
``{"kernels": [...]}`` line, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, without that line,
when any phase fails, when no CUDA device is present, or when the port's
package is not beside it. Imports nothing of JAX or of the JAX package.

``--stage-ab`` runs none of that: it times the keys stage, the frontier, the
dedup and the compaction alone, the dedup on the sparse waves, and every
chain stage inside a CUDA Graph, on the timed waves (the coverage waves also
with coverage off), with the package of ``--root`` (default: beside this
script); see
``stage_ab``. Run it for two checkouts in one call on the card, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
KERNEL_SOURCES = ("hashset_insert", "fused_wave")
FAILED = []


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name):
    """Runs a phase, recording a failure instead of stopping the script."""

    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"== phase {name}")
            try:
                out = fn(*a, **kw)
            except Exception:  # noqa: BLE001 - every phase must report
                FAILED.append(name)
                log(f"!! phase {name} FAILED")
                traceback.print_exc(file=sys.stdout)
                return None
            log(f"== phase {name} ok ({time.perf_counter() - t0:.2f} s)")
            return out

        return run

    return wrap


# -- 1. card and kernel builds --------------------------------------------


@phase("card")
def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(out[0])
    return out[0]


@phase("build")
def build_kernels():
    from stateright_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES, verbose=True)
    log(f"built {', '.join(n + '.cu' for n in KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        _build.load(name)


# -- 2. each kernel against its plain twin --------------------------------


def _sorted_batch(rng, n, active_frac, dup_frac=0.0, span=None, old=None, old_frac=0.0):
    """A sorted insert batch as the wave builds it: valid lanes carry keys
    (some repeated in the batch, some already in the table), invalid lanes
    the (MAX, MAX) sentinel, sorted by (hi, lo)."""
    import numpy as np

    hi = rng.integers(0, span or (1 << 32), size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    if old is not None and old_frac:
        k = int(n * old_frac)
        pick = rng.integers(0, old[0].shape[0], size=k)
        hi[:k], lo[:k] = old[0][pick], old[1][pick]
    if dup_frac:
        k = max(1, int(n * dup_frac))
        src = rng.integers(0, n, size=k)
        dst = rng.integers(0, n, size=k)
        hi[dst], lo[dst] = hi[src], lo[src]
    valid = rng.random(n) < active_frac
    hi = np.where(valid, hi, 0xFFFFFFFF).astype(np.uint32)
    lo = np.where(valid, lo, 0xFFFFFFFF).astype(np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], valid[order]


def _bd():
    """The port's must-move byte counts and breakdown
    (``stateright_tpu_torch/checker/breakdown.py``), which this script's
    bounds read, imported when a phase first needs them."""
    from stateright_tpu_torch.checker import breakdown

    return breakdown


def _sweep_pass_ms(run, reset=None, reps=5):
    """Median device ms of each pass of the tile sweep (extent, speculate,
    repair, commit) over ``reps`` calls of ``run()``, from ``torch.profiler``'s
    kernel records; None where the profiler recorded no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if reset is not None:
                reset()
            run()
        torch.cuda.synchronize()
    out = {}
    for p in ("extent", "speculate", "repair", "commit"):
        ds = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA and f"sweep_{p}_kernel" in e.name]
        out[p] = statistics.median(ds) if ds else None
    return out


def _compare_insert(table_np, hi, lo, active, timing=False, passes=True):
    """Runs the CUDA kernel and the plain twin on the same inputs; returns
    a dict: max_abs_err, the kernel's median ms and (with ``passes``) its
    passes' ms (with ``timing``), plain ms, touched tiles, the tiles the
    repair redid and the tiles it had to redo, the table after and the
    fresh flags. ``passes=False`` runs no ``torch.profiler``."""
    import numpy as np
    import torch

    from stateright_tpu_torch.interop import keys_from_numpy, table_from_numpy, table_to_numpy
    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.testing import tiles_to_redo

    khi, klo = keys_from_numpy(hi, lo)
    act = torch.from_numpy(np.ascontiguousarray(active))
    t0 = time.perf_counter()
    pt, pf, pfo, pp = hk.hashset_insert_sorted(table_from_numpy(table_np), khi, klo, act)
    plain_ms = (time.perf_counter() - t0) * 1e3

    dev = torch.device("cuda")
    orig = table_from_numpy(table_np, dev)
    ct = orig.clone()
    dhi, dlo, dact = khi.to(dev), klo.to(dev), act.to(dev)
    ct, cf, cfo, cp = hk.hashset_insert_sorted(ct, dhi, dlo, dact)
    torch.cuda.synchronize()
    err = int((ct.cpu().to(torch.int64) - pt.to(torch.int64)).abs().max())
    for p, c in ((pf, cf), (pfo, cfo), (pp, cp)):
        err = max(err, int((p.to(torch.int64) - c.cpu().to(torch.int64)).abs().max()))

    cap = table_np.shape[0] - 128
    starts = hk.tile_starts(khi, cap)
    act_c = torch.cat([torch.zeros(1, dtype=torch.int64), act.to(torch.int64).cumsum(0)])
    touched = int(((act_c[starts[1:]] - act_c[starts[:-1]]) > 0).sum())
    after = table_to_numpy(pt)
    # The launch alone, for its scratch: how many tiles the repair redid.
    dstarts = starts.to(dev)
    flags = [torch.empty_like(dact) for _ in range(3)]
    work = orig.clone()
    redone = hk.tiles_redone(hk._launch(work, dhi, dlo, dact, dstarts, *flags))
    res = {"err": err, "plain_ms": plain_ms, "touched": touched, "redone": redone,
           "to_redo": tiles_to_redo(table_np, after, hi, lo, active), "after": after,
           "fresh": pf.numpy(), "ms": None, "pass_ms": None}
    if timing:
        # Only the kernel's launch lies between the events: the tile bounds
        # and the flags are made once, before.
        times = []
        for _ in range(21):
            work.copy_(orig)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hk._launch(work, dhi, dlo, dact, dstarts, *flags)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        res["ms"] = statistics.median(times)
    if timing and passes:
        res["pass_ms"] = _sweep_pass_ms(
            lambda: hk._launch(work, dhi, dlo, dact, dstarts, *flags),
            reset=lambda: work.copy_(orig),
        )
    return res


@phase("kernel_vs_plain")
def kernel_vs_plain():
    import numpy as np

    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.testing import SWEEP_CASES, sweep_case

    tile = hk.TILE_ROWS
    rng = np.random.default_rng(2026)
    worst = 0

    def empty(cap):
        return np.zeros((cap + 128, 2), np.uint32)

    def check(label, table, hi, lo, active, timing=False):
        nonlocal worst
        r = _compare_insert(table, hi, lo, active, timing)
        worst = max(worst, r["err"])
        log(f"  {label}: B={hi.shape[0]} active={int(active.sum())} tiles={r['touched']} "
            f"redone={r['redone']} (to redo {r['to_redo']}) max_abs_err={r['err']} "
            f"plain={r['plain_ms']:.1f} ms")
        if r["err"]:
            raise AssertionError(f"{label}: kernel and plain twin disagree")
        if r["redone"] != r["to_redo"]:
            raise AssertionError(f"{label}: the repair redid {r['redone']} tiles, "
                                 f"not the {r['to_redo']} whose predecessor spilled")
        return r

    # Edge cases of the CPU tests.
    for seed in range(3):
        hi, lo, act = _sorted_batch(rng, 1024, 0.9)
        t = check(f"random seed {seed}", empty(2 * tile), hi, lo, act)["after"]
        hi2, lo2, act2 = _sorted_batch(rng, 1024, 0.9, old=(hi[act], lo[act]), old_frac=0.3)
        check(f"random seed {seed} second", t, hi2, lo2, act2)
    shift = 32 - ((2 * tile).bit_length() - 1)
    lo = np.arange(1, 65, dtype=np.uint32)
    t = check("cross-tile cluster", empty(2 * tile),
              np.full(64, (tile - 1) << shift, np.uint32), lo, np.ones(64, bool))["after"]
    check("cross-tile next tile", t, np.full(64, tile << shift, np.uint32), lo, np.ones(64, bool))
    n = 144
    check("probe overflow", empty(2 * tile), np.zeros(n, np.uint32),
          np.arange(1, n + 1, dtype=np.uint32), np.ones(n, bool))
    hi, lo, act = _sorted_batch(rng, 3500, 1.0, dup_frac=0.2, span=1 << 31)
    check("dense overflow + duplicates", empty(2 * tile), hi, lo, act)
    hi, lo, act = _sorted_batch(rng, 512, 1.0, dup_frac=0.25)
    t = check("in-batch duplicates", empty(2 * tile), hi, lo, act)["after"]
    check("second insert found", t, hi, lo, act)
    # The hard cases of the sweep's ordered repair.
    for name in SWEEP_CASES:
        check(f"repair case {name}", *sweep_case(name))

    # The main path's full shape: a 2^22-row table pre-filled to a load of
    # about 0.4, then one 8,192 x 42 = 344,064-lane wave batch.
    cap = 1 << 22
    hi, lo, act = _sorted_batch(rng, int(0.4 * cap), 1.0)
    table = check("prefill 0.4 of 2^22", empty(cap), hi, lo, act)["after"]
    B = 8192 * 42
    hi2, lo2, valid = _sorted_batch(
        rng, B, 0.3, dup_frac=0.1, old=(hi, lo), old_frac=0.3
    )
    first = np.ones(B, bool)
    first[1:] = (hi2[1:] != hi2[:-1]) | (lo2[1:] != lo2[:-1])
    active = valid & first
    r = check("full wave", table, hi2, lo2, active, timing=True)
    moved = _bd().insert_must_move(r["after"], hi2, lo2, active, r["fresh"])
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    windows = (r["touched"] + r["redone"]) * (tile + 128) * 8
    log(f"  full wave: B={B} active={int(active.sum())} fresh={int(r['fresh'].sum())} "
        f"tiles touched={r['touched']} redone={r['redone']} kernel median={r['ms']:.4f} ms "
        f"passes {_fmt_passes(r['pass_ms'])} plain={r['plain_ms']:.1f} ms "
        f"bound={bound_ms:.5f} ms ({moved} B must move; the kernel's windows move "
        f"{windows} B)")
    return {
        "max_abs_err": worst, "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": bound_ms,
    }


def _fmt_passes(pass_ms):
    return " ".join(f"{k}={'not measured' if v is None else f'{v:.4f} ms'}"
                    for k, v in pass_ms.items())


def _capture_2pc8_wave():
    """A full-width 2pc-8 frontier chunk (F = 8,192) and the visited table
    that a staged run holds when that chunk comes up on a 2^22-row table,
    with the run's wave spec; the run stops after that wave."""
    import torch

    from stateright_tpu_torch.checker import gpu
    from stateright_tpu_torch.core.batch import map_leaves

    cfg = _config("2pc8")
    F = cfg.spawn["frontier_capacity"]
    got = {}
    consume = gpu.GpuBfsChecker._consume_wave

    def spy(self, table, chunk, queue):
        if not got and table.shape[0] - 128 == 1 << 22 and chunk["hi"].shape[0] == F:
            got.update(table=table.clone(), chunk=map_leaves(torch.clone, chunk),
                       spec=self._spec, depth_cap=self._depth_cap,
                       unique=self._unique_count)
            self._target_state_count = 0  # stop after this wave
        return consume(self, table, chunk, queue)

    gpu.GpuBfsChecker._consume_wave = spy
    try:
        cfg.make().checker().spawn_gpu_bfs(
            wave_kernel="staged", **dict(cfg.spawn, max_drain_waves=1)).join()
    finally:
        gpu.GpuBfsChecker._consume_wave = consume
    if not got:
        raise AssertionError("no full-width 2pc-8 wave on a 2^22-row table")
    return got


def _capture_2pc8_ring_take():
    """A masked 2pc-8 frontier of the deep drain (F = 8,192) and the table
    it runs on: the fused drain's ring and table are copied at the start
    of the first drain whose ring holds a full-width take, and the take's
    mask keeps the first 6,143 lanes, so the 2,049 off lanes hold
    pending, would-be-fresh states of the ring."""
    import torch

    from stateright_tpu_torch.checker import gpu
    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.ops.ring import ring_take

    cfg = _config("2pc8")
    F = cfg.spawn["frontier_capacity"]
    got = {}
    deep_drain = gpu.GpuBfsChecker._deep_drain

    def spy(self, table, width, budget):
        d = self._drain
        if not got and width == F and int(d["scalars"][gpu._COUNT]) >= F:
            got.update(table=table.clone(), capacity=d["capacity"],
                       pool=map_leaves(torch.clone, d["pool"]),
                       head=d["scalars"][gpu._HEAD].clone(),
                       spec=self._spec, depth_cap=self._depth_cap,
                       unique=self._unique_count)
        return deep_drain(self, table, width, budget)

    gpu.GpuBfsChecker._deep_drain = spy
    try:
        cfg.make().checker().spawn_gpu_bfs(wave_kernel="fused", **cfg.spawn).join()
    finally:
        gpu.GpuBfsChecker._deep_drain = deep_drain
    if not got:
        raise AssertionError("no 2pc-8 drain started with a full-width take")
    live = torch.full((), F - F // 4 - 1, dtype=torch.int64, device="cuda")
    got["frontier"] = ring_take(got["pool"], got["head"], live, got["capacity"], F)[0]
    return got


def _compare_fused(spec, table, frontier, depth_cap, mask=None):
    """One wave through the fused kernels and the plain twin on the same
    inputs; returns (max_abs_err, the twin's output, the twin's host ms, its
    table and the sweeps' record)."""
    import torch

    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.ops import fused_wave as fw

    cols = [frontier[k] for k in ("hi", "lo", "ebits", "depth")]
    cpu = lambda x: x.cpu()  # noqa: E731
    t0 = time.perf_counter()
    pt, pout = fw.fused_wave_plain(spec, table.cpu(), map_leaves(cpu, frontier["states"]),
                                   *(c.cpu() for c in cols), depth_cap,
                                   mask=None if mask is None else mask.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    sweeps = []
    with _spy_sweeps(sweeps):
        ct, cout = fw.fused_wave(spec, table.clone(), frontier["states"], *cols, depth_cap,
                                 mask=mask)
    torch.cuda.synchronize()
    n = int(pout["stats"][1])
    pairs = [(pt, ct), (pout["stats"], cout["stats"])]
    pairs += [(pout[k][:n], cout[k][:n]) for k in ("parent_hi", "parent_lo")]
    pairs += [(pout["new"][k][:n], cout["new"][k][:n]) for k in ("hi", "lo", "ebits", "depth")]
    pairs += [(v[:n], cout["new"]["states"][k][:n]) for k, v in pout["new"]["states"].items()]
    if "cov" in pout:
        pairs.append((pout["cov"], cout["cov"]))
    return _max_abs_err(pairs), pout, plain_ms, pt, sweeps


def _max_abs_err(pairs):
    """The largest |plain - kernel| over pairs of integer tensors, after
    checking that their shapes agree."""
    import torch

    err = 0
    for p, c in pairs:
        assert tuple(p.shape) == tuple(c.shape), (p.shape, c.shape)
        if p.numel():
            err = max(err, int((p.to(torch.int64) - c.cpu().to(torch.int64)).abs().max()))
    return err


def _time_on_card(fn, reps=11, reset=None):
    """Median device ms of ``fn`` over ``reps`` runs with CUDA events, each
    run queued behind a sleep so the host's launch overhead stays out of
    the interval; ``reset`` runs before each (outside the events).
    ``fn(mark)`` calls ``mark(name)`` between stages; returns the median
    total and the median of each stage."""
    import torch

    totals, stages = [], {}
    for _ in range(reps):
        if reset is not None:
            reset()
        events = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

        torch.cuda._sleep(40_000_000)
        mark("start")
        fn(mark)
        mark(None)
        events[-1][1].synchronize()
        totals.append(events[0][1].elapsed_time(events[-1][1]))
        for (name, a), (_n, b) in zip(events[1:-1], events[2:]):
            if name is not None:
                stages.setdefault(name, []).append(a.elapsed_time(b))
    return statistics.median(totals), {k: statistics.median(v) for k, v in stages.items()}


def _time_dedup(key, idx, capacity, cvalid, A, depth, depth_cap, mask, chain=()):
    """``fw_dedup`` on these sorted keys against ``dedup_plain`` (both on
    the card): max_abs_err over ``active`` and ``starts`` (and over the
    chain's own, ``chain``, when given), and each timed
    alone with CUDA events beside ``torch.searchsorted`` of the tiles'
    first rows over the homes (the one PyTorch call that computes the
    starts; ``library_ms``) and the ``skey[1:] != skey[:-1]`` pass (the
    uniq mask's own pass, for context), with the stage's bound."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops.hashset_kernel import TILE_ROWS

    args = (key, idx, capacity, cvalid, A, depth, depth_cap, mask)
    got, want = fw.dedup_stage(*args), fw.dedup_plain(*args)
    torch.cuda.synchronize()
    err = _max_abs_err([(w.cpu(), g) for w, g in zip(want + want, got + tuple(chain))])
    B, n_tiles = key.shape[0], capacity // TILE_ROWS
    homes = ((key >> 32) & 0xFFFFFFFF) >> (32 - (capacity.bit_length() - 1))
    bounds = torch.arange(n_tiles + 1, dtype=torch.int64, device=key.device) * TILE_ROWS
    ms, _ = _time_on_card(lambda mark: fw.dedup_stage(*args))
    plain_ms, _ = _time_on_card(lambda mark: fw.dedup_plain(*args))
    searchsorted_ms, _ = _time_on_card(lambda mark: torch.searchsorted(homes, bounds))
    neighbours_ms, _ = _time_on_card(lambda mark: key[1:] != key[:-1])
    moved = _bd().dedup_must_move(B, n_tiles)
    return {"dedup_ms": ms, "dedup_plain_ms": plain_ms, "torch_searchsorted_ms": searchsorted_ms,
            "dedup_neighbours_ms": neighbours_ms, "dedup_bound_bytes": moved,
            "dedup_bound_ms": moved / HBM_BYTES_PER_S * 1e3, "dedup_max_abs_err": err,
            "dedup_tiles": n_tiles, "dedup_active": int(want[0].sum())}


# Each timed wave's inputs (on the host) and its stage record, for
# stage_device_profile.
STAGE_WAVES = []


def _stage_wave(label, spec, table0, hi, lo, ebits, depth, depth_cap, cond, cvalid, kin,
                cand, mask=None, ant=None, stage_ms=None, chain_ms=None):
    """``fw_sort``, ``fw_dedup``, ``fw_compact`` and ``fw_gather`` on one
    wave's own inputs, held to their plain twins and timed beside their
    bounds and their library calls: the sort on the keys stage's output
    against a stable ``torch.sort`` (``library_ms``) and ``sort_plain``; the
    dedup on the chain's own sorted keys against ``dedup_plain`` (the
    chain's own ``active`` and ``starts`` too), beside ``torch.searchsorted``
    (``_time_dedup``); the compaction on the chain's own sorted keys and outcome bytes against
    ``compact_plain`` (``torch.nonzero`` of the fresh flags timed for
    context: it finds the slots alone); the gather on the chain's own
    compaction (``src``, ``n_new``) against ``gather_plain`` (``x[src]``)
    and the summed per-leaf ``index_select`` over ``src[:n_new]``
    (``library_ms``). The sort is also timed, beside ``torch.sort``, on
    random keys of the wave's shape (B lanes, the same count of keyed
    lanes at random places, the rest ``~0``). Keeps the wave's inputs on
    the host and returns its ``stage_record``, which
    ``stage_device_profile`` completes and logs."""
    import numpy as np
    import torch

    from stateright_tpu_torch.core.batch import leaves, map_leaves
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.ops.fingerprint import fingerprint_state

    MIN = -(1 << 63)
    work, taps = table0.clone(), {}
    _t, chain_out = fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond, cvalid,
                                    kin, cand, mask=mask, ant=ant, taps=taps)
    # The stats vector fw_compact wrote, against the plain
    # wave's _stats over the chain's own sweep outcome.
    eval_mask, _eb, valid, terminal = fw._frontier_plain(spec, cond, cvalid, ebits, depth,
                                                         depth_cap, mask)
    want_stats = fw._stats(spec, cond, eval_mask, terminal, taps["ebits_after"], hi, lo, depth,
                           valid.sum(), (taps["flag"] & 1) != 0, (taps["flag"] & 4) != 0, mask)
    stats_err = _max_abs_err([(want_stats.cpu(), chain_out["stats"])])
    stats_plain_ms, _ = _time_on_card(lambda mark: fw._stats(
        spec, cond, eval_mask, terminal, taps["ebits_after"], hi, lo, depth, valid.sum(),
        (taps["flag"] & 1) != 0, (taps["flag"] & 4) != 0, mask))
    # The stats' bound: the counters read, each hit's (hi, lo) read, the
    # vector written.
    P = len(spec.conditions)
    stats_bytes = _bd().stats_must_move(P)
    if stats_err:
        raise AssertionError(f"{label}: fw_compact's stats vector and _stats disagree: "
                             f"{chain_out['stats'].tolist()} != {want_stats.tolist()}")
    key0, idx0 = fw.route_keys_stage(spec, kin, cand, cvalid, depth, depth_cap, None, mask)
    B = key0.shape[0]
    n_live = int((key0 != -1).sum())
    key, idx = key0.clone(), idx0.clone()
    fw.sort_stage(key, idx)
    skey, perm = torch.sort(key0 ^ MIN, stable=True)
    sort_err = _max_abs_err([((skey ^ MIN).cpu(), key), (idx0[perm].cpu(), idx)])
    reset = lambda: (key.copy_(key0), idx.copy_(idx0))  # noqa: E731
    sort_ms, _ = _time_on_card(lambda mark: fw.sort_stage(key, idx), reset=reset)
    sort_plain_ms, _ = _time_on_card(lambda mark: fw.sort_plain(key, idx), reset=reset)
    signed = key0 ^ MIN
    torch_sort_ms, _ = _time_on_card(lambda mark: torch.sort(signed, stable=True))

    rng = np.random.default_rng(B)
    rkeys = rng.integers(0, 1 << 64, size=B, dtype=np.uint64)
    rkeys[rng.permutation(B)[n_live:]] = np.uint64(2**64 - 1)
    rkey0 = torch.from_numpy(rkeys.view(np.int64).copy()).cuda()
    iota = torch.arange(B, dtype=torch.int32, device="cuda")
    key, idx = rkey0.clone(), iota.clone()
    fw.sort_stage(key, idx)
    skey, perm = torch.sort(rkey0 ^ MIN, stable=True)
    sort_err = max(sort_err, _max_abs_err([((skey ^ MIN).cpu(), key), (iota[perm].cpu(), idx)]))
    reset = lambda: (key.copy_(rkey0), idx.copy_(iota))  # noqa: E731
    sort_random_ms, _ = _time_on_card(lambda mark: fw.sort_stage(key, idx), reset=reset)
    rsigned = rkey0 ^ MIN
    torch_sort_random_ms, _ = _time_on_card(lambda mark: torch.sort(rsigned, stable=True))

    A = spec.action_count
    capacity = hk._check_capacity(table0)
    dedup = _time_dedup(taps["key"], taps["idx"], capacity, cvalid, A, depth, depth_cap, mask,
                        chain=(taps["active"], taps["starts"]))
    log(f"  fw_dedup ({label}): B={B} tiles={dedup['dedup_tiles']} active="
        f"{dedup['dedup_active']} {dedup['dedup_ms']:.4f} ms vs torch.searchsorted "
        f"{dedup['torch_searchsorted_ms']:.4f} ms (neighbour pass "
        f"{dedup['dedup_neighbours_ms']:.4f} ms), plain {dedup['dedup_plain_ms']:.4f} ms, bound "
        f"{dedup['dedup_bound_ms']:.5f} ms; max_abs_err={dedup['dedup_max_abs_err']}")
    if dedup["dedup_max_abs_err"]:
        raise AssertionError(f"fw_dedup and its plain twin disagree on {label}")

    src, acc = taps["src"], taps["acc"]
    n_new = int(acc[1])
    # The sweep's bound: the sorted keys (8 B), active bytes and tile
    # starts read, the distinct table rows its probes read, and the outcome
    # bytes and claimed rows written.
    from stateright_tpu_torch.interop import table_to_numpy

    act_keys = taps["key"][taps["active"]].cpu().numpy().view(np.uint64)
    probed = _bd().probed_rows(table_to_numpy(work), act_keys)
    sweep_bytes = _bd().sweep_must_move(B, taps["starts"].shape[0] - 1, probed, n_new)
    cargs = (taps["flag"], taps["key"], taps["idx"], A, taps["ebits_after"], depth, hi, lo)
    cacc = torch.zeros_like(acc)
    got_c = fw.compact_stage(*cargs, cacc)
    want_c, want_n = fw.compact_plain(*cargs)
    torch.cuda.synchronize()
    compact_err = _max_abs_err([(want_n.view(1).cpu(), cacc[1:2]), (want_n.view(1).cpu(), acc[1:2])]
                               + [(want_c[k][:n_new].cpu(), got_c[k][:n_new]) for k in want_c])
    compact_ms, _ = _time_on_card(lambda mark: fw.compact_stage(*cargs, cacc))
    compact_plain_ms, _ = _time_on_card(lambda mark: fw.compact_plain(*cargs))
    fresh = (taps["flag"] & 1) != 0
    nonzero_ms, _ = _time_on_card(lambda mark: torch.nonzero(fresh))
    compact_bytes = _bd().compact_must_move(B, n_new)
    flat = leaves(cand)
    got, want = fw.gather_stage(src, acc, cand), fw.gather_plain(src, acc, cand)
    torch.cuda.synchronize()
    gather_err = _max_abs_err([(w[:n_new].cpu(), g[:n_new]) for w, g in
                               zip(leaves(want), leaves(got))])
    rbs = [x[0].numel() * x.element_size() for x in flat]
    row_bytes = sum(rbs)
    group = fw._group([rb // fw._unit(rb, x.data_ptr()) for rb, x in zip(rbs, flat)])
    gather_ms, _ = _time_on_card(lambda mark: fw.gather_stage(src, acc, cand))
    gather_plain_ms, _ = _time_on_card(lambda mark: fw.gather_plain(src, acc, cand))
    sel = src[:n_new]
    index_select_ms, _ = _time_on_card(lambda mark: [x.index_select(0, sel) for x in flat])

    # The frontier stage alone against frontier_plain (on the card), and,
    # on the fold route, the keys stage reading the leaves in place against
    # keys_plain over fingerprint_state.
    F, P = depth.shape[0], len(spec.conditions)
    facc, pacc = (torch.zeros(4 + P, dtype=torch.int64, device="cuda") for _ in range(2))
    fargs = (spec, cond, cvalid, ebits, depth, depth_cap)
    feb = fw.frontier_stage(*fargs, facc, mask)
    peb = fw.frontier_plain(*fargs, pacc, mask)
    torch.cuda.synchronize()
    frontier_err = _max_abs_err([(peb.cpu(), feb), (pacc.cpu(), facc)])
    frontier_ms, _ = _time_on_card(lambda mark: fw.frontier_stage(*fargs, facc, mask))
    frontier_plain_ms, _ = _time_on_card(lambda mark: fw.frontier_plain(*fargs, pacc, mask))
    frontier_bytes = _bd().frontier_must_move(spec, F, mask is not None)
    keys = {}
    if spec.keys_route == "fold":
        kargs = (cvalid, depth, depth_cap, A)
        kacc = torch.zeros(4 + P, dtype=torch.int64, device="cuda")
        kkey, kidx = fw.keys_stage(kin, *kargs, kacc, mask)
        pkey, pidx = fw.keys_plain(*fingerprint_state(cand), *kargs, mask)
        torch.cuda.synchronize()
        n_keyed = (pkey != -1).sum().view(1).cpu()
        keys_err = _max_abs_err([((pkey >> 32).cpu(), kkey >> 32),
                                 ((pkey & 0xFFFFFFFF).cpu(), kkey & 0xFFFFFFFF),
                                 (pidx.cpu(), kidx), (n_keyed, kacc[0:1])])
        W = sum(math.prod(x.shape[1:]) for x in kin)
        keys_ms, _ = _time_on_card(lambda mark: fw.keys_stage(kin, *kargs, None, mask))
        keys_plain_ms, _ = _time_on_card(
            lambda mark: fw.keys_plain(*fingerprint_state(cand), *kargs, mask))
        n_valid = int(n_keyed)
        keys_bytes = _bd().keys_must_move(B, W, F, mask is not None, n_valid)
        keys = {"keys_ms": keys_ms, "keys_plain_ms": keys_plain_ms, "keys_words": W,
                "keys_valid_lanes": n_valid, "keys_bound_bytes": keys_bytes,
                "keys_bound_ms": keys_bytes / HBM_BYTES_PER_S * 1e3,
                "keys_max_abs_err": keys_err}
        log(f"  fw_keys ({label}, fold from the leaves): {keys_ms:.4f} ms, bound "
            f"{keys['keys_bound_ms']:.5f} ms ({keys_bytes} B, W={W}, {n_valid} valid lanes); "
            f"plain {keys_plain_ms:.4f} ms; max_abs_err={keys_err}")
    log(f"  fw_frontier ({label}): {frontier_ms:.4f} ms, bound "
        f"{frontier_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms ({frontier_bytes} B); plain "
        f"{frontier_plain_ms:.4f} ms; max_abs_err={frontier_err}")
    if frontier_err or keys.get("keys_max_abs_err"):
        raise AssertionError(f"fw_frontier or fw_keys and its plain twin disagree on {label}")

    # The sort reads each lane's key (8 B) and idx (4 B) once and writes
    # both once, whatever its passes move.
    sort_bytes = _bd().sort_must_move(B)
    gather_bytes = _bd().gather_must_move(n_new, row_bytes)
    rec = {
        "wave": label, "B": B, "n_live": n_live, "n_new": n_new,
        "fused_wave_stage_ms": stage_ms, "kernel_chain_ms": chain_ms,
        "sort_ms": sort_ms, "sort_plain_ms": sort_plain_ms, "torch_sort_ms": torch_sort_ms,
        "sort_bound_bytes": sort_bytes, "sort_bound_ms": sort_bytes / HBM_BYTES_PER_S * 1e3,
        "sort_max_abs_err": sort_err,
        "sort_random_ms": sort_random_ms, "torch_sort_random_ms": torch_sort_random_ms,
        "gather_ms": gather_ms, "gather_group": group,
        "gather_plain_ms": gather_plain_ms, "index_select_sum_ms": index_select_ms,
        "gather_row_bytes": row_bytes, "gather_leaves": len(flat),
        "gather_bound_bytes": gather_bytes,
        "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
        "gather_max_abs_err": gather_err,
        "compact_ms": compact_ms, "compact_plain_ms": compact_plain_ms,
        "torch_nonzero_ms": nonzero_ms, "compact_bound_bytes": compact_bytes,
        "compact_bound_ms": compact_bytes / HBM_BYTES_PER_S * 1e3,
        "compact_max_abs_err": compact_err, "stats_max_abs_err": stats_err,
        "stats_plain_ms": stats_plain_ms, "stats_bound_bytes": stats_bytes,
        "stats_bound_ms": stats_bytes / HBM_BYTES_PER_S * 1e3,
        "sweep_probed_rows": probed, "sweep_bound_bytes": sweep_bytes,
        "sweep_bound_ms": sweep_bytes / HBM_BYTES_PER_S * 1e3,
        "frontier_ms": frontier_ms, "frontier_plain_ms": frontier_plain_ms,
        "frontier_bound_bytes": frontier_bytes,
        "frontier_bound_ms": frontier_bytes / HBM_BYTES_PER_S * 1e3,
        "frontier_max_abs_err": frontier_err,
        **dedup,
        **keys,
    }
    log(f"  fw_sort ({label}): n={B} keyed={n_live} {sort_ms:.4f} ms vs torch.sort "
        f"{torch_sort_ms:.4f} ms (random keys {sort_random_ms:.4f} vs "
        f"{torch_sort_random_ms:.4f} ms), bound {rec['sort_bound_ms']:.5f} ms; "
        f"fw_compact: n_new={n_new} {compact_ms:.4f} ms vs torch.nonzero {nonzero_ms:.4f} ms, "
        f"bound {rec['compact_bound_ms']:.5f} ms; "
        f"fw_gather: {gather_ms:.4f} ms (group {group}) vs "
        f"index_select {index_select_ms:.4f} ms, bound {rec['gather_bound_ms']:.5f} ms; "
        f"max_abs_err sort={sort_err} compact={compact_err} gather={gather_err}")
    if sort_err or gather_err or compact_err:
        raise AssertionError(f"fw_sort, fw_compact or fw_gather and its plain twin disagree "
                             f"on {label}")
    host = lambda x: None if x is None else x.cpu()  # noqa: E731
    STAGE_WAVES.append({
        "rec": rec, "spec": spec, "depth_cap": depth_cap,
        "table": table0.cpu(), "cand": map_leaves(host, cand),
        **{k: host(v) for k, v in dict(hi=hi, lo=lo, ebits=ebits, depth=depth, cond=cond,
                                        cvalid=cvalid, mask=mask, ant=ant).items()},
    })
    return rec


@contextlib.contextmanager
def _spy_sweeps(record):
    """Records ``(key, active, starts, scratch)`` of every fused sweep
    stage run inside the block."""
    from stateright_tpu_torch.ops import fused_wave as fw

    sweep_stage = fw.sweep_stage

    def spy(table, key, active, starts, acc):
        flag, scratch = sweep_stage(table, key, active, starts, acc)
        record.append((key, active, starts, scratch))
        return flag, scratch

    fw.sweep_stage = spy
    try:
        yield
    finally:
        fw.sweep_stage = sweep_stage


def _fused_sweep_case(spec, chunk, depth_cap, kind):
    """The first 256 states of ``chunk`` through the fused kernels and the
    plain twin, over a 2^14-row ``testing.sweep_table`` of ``kind`` built
    around their keys; returns (max_abs_err, tiles redone, tiles to redo)."""
    import numpy as np

    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.interop import table_from_numpy, table_to_numpy
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.ops.fingerprint import fingerprint_words, state_words
    from stateright_tpu_torch.testing import sweep_table, tiles_to_redo

    F = 256
    states = map_leaves(lambda x: x[:F].contiguous(), chunk["states"])
    cols = [chunk[k][:F].contiguous() for k in ("hi", "lo", "ebits", "depth")]
    _cond, cvalid, cand = fw.model_stage(spec, states, F)
    valid = (cvalid.view(F, -1) & (cols[3] < depth_cap)[:, None]).reshape(-1).cpu().numpy()
    khi, klo = fingerprint_words(state_words(cand).cpu())
    key = np.sort(np.where(valid, ((khi << 32) | klo).numpy().astype(np.uint64),
                           np.uint64(2**64 - 1)))
    active = (key != np.uint64(2**64 - 1)) & np.concatenate([[True], key[1:] != key[:-1]])
    hi = (key >> np.uint64(32)).astype(np.uint32)
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    table = sweep_table(1 << 14, hi[active], lo[active], kind)
    frontier = dict(zip(("hi", "lo", "ebits", "depth"), cols), states=states)
    err, _pout, _ms, pt, sweeps = _compare_fused(spec, table_from_numpy(table, "cuda"),
                                                 frontier, depth_cap)
    to_redo = tiles_to_redo(table, table_to_numpy(pt), hi, lo, active)
    return err, hk.tiles_redone(sweeps[0][3]), to_redo


@phase("fused_wave_vs_plain")
def fused_vs_plain():
    import numpy as np
    import torch

    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.ops.fingerprint import fingerprint_words, state_words

    got = _capture_2pc8_wave()
    spec, table0, chunk, depth_cap = got["spec"], got["table"], got["chunk"], got["depth_cap"]
    states = chunk["states"]
    hi, lo, ebits, depth = (chunk[k] for k in ("hi", "lo", "ebits", "depth"))
    F, A, P = hi.shape[0], spec.action_count, len(spec.conditions)
    B = F * A

    err, pout, plain_ms, pt, sweeps = _compare_fused(spec, table0, chunk, depth_cap)
    _key, sweep_active, sweep_starts, scratch = sweeps[0]
    act_c = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                       sweep_active.to(torch.int64).cumsum(0)])
    touched = int(((act_c[sweep_starts[1:]] - act_c[sweep_starts[:-1]]) > 0).sum())
    redone = hk.tiles_redone(scratch)
    stats = pout["stats"].tolist()
    n = stats[1]
    log(f"  2pc-8 wave: F={F} B={B} table rows={table0.shape[0]} unique before={got['unique']} "
        f"generated={stats[0]} n_new={n} overflow={stats[2]} tiles touched={touched} "
        f"redone={redone} max_abs_err={err} plain={plain_ms:.1f} ms (host CPU)")
    if err:
        raise AssertionError("fused kernels and the plain twin disagree")

    # A masked take of the deep drain at the same width: its off lanes
    # hold pending states that no stage may read.
    take = _capture_2pc8_ring_take()
    mask = take["frontier"]["mask"]
    m_err, m_out, m_plain_ms, _pt, _sw = _compare_fused(
        take["spec"], take["table"], take["frontier"], take["depth_cap"], mask=mask)
    m_stats = m_out["stats"].tolist()
    log(f"  2pc-8 drain take: F={F} live lanes={int(mask.sum())} table rows="
        f"{take['table'].shape[0]} ring rows={take['capacity']} unique before={take['unique']} "
        f"generated={m_stats[0]} n_new={m_stats[1]} overflow={m_stats[2]} "
        f"max_abs_err={m_err} plain={m_plain_ms:.1f} ms (host CPU)")
    if m_err:
        raise AssertionError("masked fused kernels and the plain twin disagree")
    err = max(err, m_err)

    # The hard cases of the sweep's repair: the wave's first 256 states
    # over 2^14-row tables built around their own keys.
    for kind in ("empty_after_home", "load_0_9"):
        e, sub_redone, to_redo = _fused_sweep_case(spec, chunk, depth_cap, kind)
        log(f"  2pc-8 sub-wave over a {kind} table: redone={sub_redone} "
            f"(to redo {to_redo}) max_abs_err={e}")
        if e or sub_redone != to_redo:
            raise AssertionError(f"fused sweep case {kind}: kernels and plain twin disagree")

    # The stages alone at this shape: the model stage (torch) with what
    # the keys stage reads, then the kernel chain with an event between
    # stages.
    cond, cvalid, cand_flat = fw.model_stage(spec, states, F)
    kin = fw.keys_input(spec, cand_flat)
    words = state_words(cand_flat)
    model_ms, _ = _time_on_card(
        lambda mark: fw.keys_input(spec, fw.model_stage(spec, states, F)[2]))
    work = table0.clone()
    chain_ms, stage_ms = _time_on_card(
        lambda mark: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond,
                                     cvalid, kin, cand_flat, mark=mark),
        reset=lambda: work.copy_(table0),
    )
    pass_ms = _sweep_pass_ms(
        lambda: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond,
                                cvalid, kin, cand_flat),
        reset=lambda: work.copy_(table0),
    )

    # The fingerprint stage against fingerprint_words, on the wave's own
    # width and on the chunked branch (65 and 391 words).
    rng = np.random.default_rng(2026)
    for width in (words.shape[1], 65, 391):
        w = torch.from_numpy(rng.integers(0, 1 << 32, size=(8192, width), dtype=np.uint64)
                             .astype(np.int64))
        key, _ = fw.keys_stage(w.cuda(), torch.ones(8192, dtype=torch.bool, device="cuda"))
        fh, fl = fingerprint_words(w)
        e = _max_abs_err([(fh, (key >> 32) & 0xFFFFFFFF), (fl, key & 0xFFFFFFFF)])
        log(f"  fingerprint stage, {width}-word rows: max_abs_err={e}")
        err = max(err, e)

    # The sort against a stable torch.sort on keys with many duplicates
    # (each timed wave's own keys are held to it in _stage_wave).
    dup = torch.from_numpy((rng.integers(0, 1000, size=B).astype(np.uint64)
                            * np.uint64(0x9E3779B97F4A7C15)).view(np.int64))
    k, i = dup.cuda(), torch.arange(B, dtype=torch.int32, device="cuda")
    fw.sort_stage(k, i)
    skey, sidx = torch.sort(dup ^ (-(1 << 63)), stable=True)
    e = _max_abs_err([(skey ^ (-(1 << 63)), k), (sidx, i)])
    log(f"  sort, 1,000 distinct keys: n={B} max_abs_err={e}")
    err = max(err, e)
    if err:
        raise AssertionError("a fused stage and its plain counterpart disagree")

    # Bytes the wave must move: the u32 words, valid bits, the four u32
    # frontier arrays and the conditions read; the distinct table rows its
    # probes read; the claimed rows, the fresh candidates' leaves (read and
    # written), the six u32 per-lane outputs and the int64 stats written.
    # u32 values count 4 B, though the port carries them in int64.
    valid = (cvalid.view(F, A) & (depth < depth_cap)[:, None]).reshape(B).cpu().numpy()
    fh, fl = fingerprint_words(words.cpu())
    fps = (fh.numpy().astype(np.uint64) << np.uint64(32)) | fl.numpy().astype(np.uint64)
    probed = _bd().probed_rows(table_to_numpy(pt), np.unique(fps[valid]))
    leaf_row_bytes = sum(x[0].numel() * x.element_size() for x in pout["new"]["states"].values())
    moved = _bd().fused_wave_must_move(words.numel(), B, F, P, probed, n, leaf_row_bytes)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"fused_wave_stage_ms": stage_ms, "kernel_chain_ms": chain_ms,
                    "sweep_pass_ms": pass_ms, "sweep_tiles_touched": touched,
                    "sweep_tiles_redone": redone,
                    "model_stage_torch_ms": model_ms,
                    "must_move_bytes": moved, "probed_rows": probed}))
    log(f"  fused wave kernels: median {chain_ms:.4f} ms (sweep {stage_ms['sweep']:.4f} ms: "
        f"{_fmt_passes(pass_ms)}; tiles touched={touched} redone={redone}; "
        f"sort {stage_ms['sort']:.4f} ms); "
        f"model stage (torch) {model_ms:.3f} ms; bound {bound_ms:.5f} ms ({moved} B)")
    rec = _stage_wave("2pc8", spec, table0, hi, lo, ebits, depth, depth_cap, cond, cvalid,
                      kin, cand_flat, stage_ms=stage_ms, chain_ms=chain_ms)
    return {"max_abs_err": err, "ms": chain_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "waves": {"2pc8": rec}}


def _sparse_waves(seed=2026):
    """Sorted waves of skv4x4's width into its table (``configs.py``: F =
    8,192 lanes of 24 actions, 2^25 rows, 16,384 tiles) with at most 64
    keyed lanes, as a drain's last waves have: ``(label, dedup_stage's
    arguments)`` of 64 lanes over all tiles (about 256 tiles between two
    keys) and of 40 lanes in one tile (runs of thousands of tiles before
    and after it), the rest sentinels, made with numpy from ``seed`` on the
    card."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops.hashset_kernel import TILE_ROWS

    cfg = _config("skv4x4")
    F, capacity = cfg.spawn["frontier_capacity"], cfg.spawn["table_capacity"]
    A = cfg.make().packed_action_count()
    B, shift = F * A, 32 - (capacity.bit_length() - 1)
    rng = np.random.default_rng(seed)
    out = []
    for label, n_keyed, tile in (("sparse_64_lanes", 64, None), ("sparse_one_tile", 40, 7000)):
        lanes = rng.choice(B, size=n_keyed, replace=False)
        home = (rng.integers(0, capacity, size=n_keyed) if tile is None
                else tile * TILE_ROWS + rng.integers(0, TILE_ROWS, size=n_keyed))
        hi = (home << shift) | rng.integers(0, 1 << shift, size=n_keyed)
        keys = np.full(B, -1, np.int64)
        keys[lanes] = ((hi.astype(np.uint64) << np.uint64(32))
                       | rng.integers(0, 1 << 32, size=n_keyed, dtype=np.uint64)).view(np.int64)
        cvalid = np.zeros(B, bool)
        cvalid[lanes] = True
        key = torch.from_numpy(keys).cuda()
        idx = torch.arange(B, dtype=torch.int32, device="cuda")
        fw.sort_stage(key, idx)
        depth = torch.zeros(F, dtype=torch.int64, device="cuda")
        out.append((label, (key, idx, capacity, torch.from_numpy(cvalid).cuda(), A, depth, 1,
                            None)))
    return out


@phase("dedup_sparse_vs_plain")
def dedup_sparse_vs_plain():
    """``fw_dedup`` on the sparse waves of ``_sparse_waves`` against
    ``dedup_plain``, timed beside ``torch.searchsorted`` and the bound."""
    out = {}
    for label, args in _sparse_waves():
        rec = _time_dedup(*args)
        log(f"  fw_dedup ({label}): B={args[0].shape[0]} tiles={rec['dedup_tiles']} active="
            f"{rec['dedup_active']} {rec['dedup_ms']:.4f} ms vs torch.searchsorted "
            f"{rec['torch_searchsorted_ms']:.4f} ms, plain {rec['dedup_plain_ms']:.4f} ms, "
            f"bound {rec['dedup_bound_ms']:.5f} ms; max_abs_err={rec['dedup_max_abs_err']}")
        if rec["dedup_max_abs_err"] or not 0 < rec["dedup_active"] <= 64:
            raise AssertionError(f"fw_dedup and its plain twin disagree on {label}: {rec}")
        log(json.dumps({"dedup_sparse_wave": dict(rec, wave=label)}))
        out[label] = rec
    return out


# -- 3. the main paths ----------------------------------------------------------


def _check_sort_gather_launches(n):
    """Every fused wave runs the frontier, one keys stage (the fold's
    ``fw_keys`` or ``fw_comphash_keys``), the sort, the dedup and the
    compaction once and gathers its leaves at least once; the staged engine
    launches none of these kernels."""
    assert n["fw_frontier"] == n["fw_sort"] == n["fw_dedup"] == n["fw_compact"] \
        == n["fused_wave"], n
    assert n["fw_keys"] + n.get("fw_comphash_keys", 0) == n["fused_wave"], n
    assert n["fw_gather"] >= n["fused_wave"], n
    assert (n["fw_gather"] > 0) == (n["fused_wave"] > 0), n


_LAUNCH_NAMES = ("hashset_insert_sorted", "fused_wave", "fw_frontier", "fw_keys", "fw_sort",
                 "fw_dedup", "fw_compact", "fw_gather")


def _zero_launches():
    """Sets every kernel count to 0 (just before a run is driven)."""
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    hk.launches = fw.launches = fw.sort_launches = fw.compact_launches = 0
    fw.gather_launches = fw.frontier_launches = fw.keys_launches = fw.dedup_launches = 0
    fw.comphash_launches = 0


def _read_launches():
    """Each kernel's launches since ``_zero_launches``, by name."""
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    return dict(zip(_LAUNCH_NAMES, (hk.launches, fw.launches, fw.frontier_launches,
                                    fw.keys_launches, fw.sort_launches, fw.dedup_launches,
                                    fw.compact_launches, fw.gather_launches)))


def _drive_2pc8(wave_kernel, **spawn):
    """Drives 2pc-8 through ``spawn_gpu_bfs`` with every kernel count set
    to 0 just before and read just after."""
    import torch

    cfg = _config("2pc8")
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    checker = cfg.make().checker().spawn_gpu_bfs(
        **dict(cfg.spawn, wave_kernel=wave_kernel, **spawn)).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _check_sort_gather_launches(launches)
    unique = checker.unique_state_count()
    mode = "drain" if checker.drains else "wave at a time"
    engine = checker._wave_kernel if wave_kernel else f"default: {checker._wave_kernel}"
    log(f"  2pc-8 ({engine}, {mode}): unique={unique} states={checker.state_count()} "
        f"depth={checker.max_depth()} waves={checker.waves} "
        f"table_growths={checker.table_growths} "
        f"table_capacity={checker.table_capacity()} wall={wall:.3f} s "
        f"unique_states_per_s={unique / wall:.0f} launches={launches} "
        f"peak_device_bytes={torch.cuda.max_memory_allocated()}")
    if checker.drains:
        log(f"  2pc-8 ({engine}, drain): wall={wall:.3f} s waves={checker.waves} "
            f"noop_waves={checker.noop_waves} warmup_waves={checker.warmup_waves} "
            f"drains={checker.drains} exits={dict(checker.drain_exits)} "
            f"graph_captures={checker.graph_captures} "
            f"graph_replays={checker.graph_replays} rungs={dict(checker.rungs)}")
    assert checker.device.type == "cuda"
    assert unique == cfg.unique, unique
    checker.assert_properties()
    return {"launches": launches, "wall_s": wall, "waves": checker.waves,
            "engine": checker._wave_kernel, "config_notes": list(checker.config_notes),
            "state_count": checker.state_count(), "max_depth": checker.max_depth(),
            "drains": checker.drains, "noop_waves": checker.noop_waves,
            "warmup_waves": checker.warmup_waves,
            "exits": dict(checker.drain_exits), "graph_captures": checker.graph_captures,
            "graph_replays": checker.graph_replays, "rungs": dict(checker.rungs)}


@phase("main_path_2pc8")
def main_path():
    run = _drive_2pc8("staged", max_drain_waves=1)
    n = run["launches"]
    assert n["hashset_insert_sorted"] >= run["waves"] > 0 and n["fused_wave"] == 0, n
    return run


@phase("main_path_2pc8_fused")
def main_path_fused(staged):
    run = _drive_2pc8("fused", max_drain_waves=1)
    n = run["launches"]
    for k in ("state_count", "max_depth", "waves"):
        assert run[k] == staged[k], (k, run[k], staged[k])
    # The insert kernel still seeds the table and rehashes it on growth.
    assert n["fused_wave"] >= run["waves"] > 0 and n["hashset_insert_sorted"] >= 1, n
    return run


@phase("main_path_2pc8_drain")
def main_path_drain(wave_runs):
    """Both engines through the deep drain, at the reference's 2pc-8 scale
    settings; their launches are the kernels line's. A replayed graph
    launches the kernels of all its waves, so they count the live waves,
    the no-op waves after each exit and the warm-up wave before each pair
    of captures, besides the seeding and rehash inserts and the overflow
    retries."""
    runs = {}
    for wave_kernel, wave_run in zip(("staged", "fused"), wave_runs):
        run = _drive_2pc8(wave_kernel)
        for k in ("state_count", "max_depth"):
            assert run[k] == wave_run[k], (wave_kernel, k, run[k], wave_run[k])
        n = run["launches"]
        assert run["drains"] > 0 and run["graph_replays"] > 0, run
        name = "hashset_insert_sorted" if wave_kernel == "staged" else "fused_wave"
        waves = {k: run[k] for k in ("waves", "noop_waves", "warmup_waves")}
        other = n[name] - sum(waves.values())
        assert run["waves"] > 0 and other >= 0, (n, waves)
        if wave_kernel == "staged":
            assert n["fused_wave"] == 0, n
        else:
            assert n["hashset_insert_sorted"] >= 1, n
        log(f"  2pc-8 ({wave_kernel}): {name} launches={n[name]}: live waves={waves['waves']} "
            f"no-op waves={waves['noop_waves']} warm-up waves={waves['warmup_waves']} "
            f"other={other} (seeding, rehashes, overflow retries)")
        log(f"  2pc-8 ({wave_kernel}): drain wall {run['wall_s']:.3f} s against "
            f"{wave_run['wall_s']:.3f} s wave at a time")
        runs[wave_kernel] = run
    return runs


@phase("replay_2pc3_2pc5")
def replay_small():
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    modes = {
        "wave at a time": dict(frontier_capacity=1024, table_capacity=1 << 14,
                               max_drain_waves=1),
        "drain": dict(frontier_capacity=1024, table_capacity=1 << 14),
        # Ring growth and many short drains, on narrow rungs.
        "tiny drain": dict(frontier_capacity=32, table_capacity=2048, drain_log_factor=1,
                           pool_factor=1, max_drain_waves=3),
    }
    for wave_kernel in ("staged", "fused"):
        for (n, expected), (mode, options) in (
            (c, m) for c in ((3, 288), (5, 8832)) for m in modes.items()
        ):
            model = TwoPhaseSys(n)
            spawn = dict(options, wave_kernel=wave_kernel)
            gpu = model.checker().spawn_gpu_bfs(**spawn).join()
            cpu = model.checker().spawn_gpu_bfs(**spawn, device="cpu").join()
            assert gpu.worker_error() is None, gpu.worker_error()
            assert gpu.unique_state_count() == cpu.unique_state_count() == expected
            assert gpu.state_count() == cpu.state_count()
            assert gpu.max_depth() == cpu.max_depth()
            assert gpu.waves == cpu.waves and gpu.drains == cpu.drains
            assert gpu.drain_exits == cpu.drain_exits and gpu.rungs == cpu.rungs
            assert (gpu.graph_replays > 0) == (gpu.drains > 0)
            gd, cd = gpu.discoveries(), cpu.discoveries()
            assert set(gd) == set(cd) == {"abort agreement", "commit agreement"}
            for name in gd:
                assert gd[name].encode() == cd[name].encode(), name
            gpu.assert_properties()
            gpu.assert_discovery(
                "abort agreement",
                [("TmAbort",)] + [("RmRcvAbortMsg", i) for i in range(n)],
            )
            if n == 3:
                host = model.checker().spawn_bfs().join()
                assert host.unique_state_count() == 288
                assert host.state_count() == gpu.state_count()
            log(f"  2pc-{n} ({wave_kernel}, {mode}): unique={gpu.unique_state_count()} "
                f"states={gpu.state_count()} depth={gpu.max_depth()} waves={gpu.waves} "
                f"drains={gpu.drains} noop_waves={gpu.noop_waves} "
                f"graph_captures={gpu.graph_captures} abort path "
                f"{gd['abort agreement'].into_actions()} (cuda == cpu twin)")


# -- 4. the actor path -------------------------------------------------------------

# The JAX package's CPU runs stopped raft5 at its stable-leader discovery
# with 524,064 unique states (BENCH_r04.json, BENCH_r05.json).
RAFT5_JAX_CPU_UNIQUE_AT_EXIT = 524_064


def _config(name):
    from stateright_tpu_torch.configs import CONFIGS

    return CONFIGS[name]


class _Stop(Exception):
    """Ends a run once its wave was captured."""


def _capture_take(name, min_unique, min_live):
    """A full-width frontier of the fused deep drain of the configuration
    ``name`` (F lanes; the live ones masked in) and the table it runs on:
    the ring and table are copied at the start of the first drain at the
    widest rung once ``min_unique`` states are visited whose ring holds at
    least ``min_live`` states, and the run stops there."""
    import torch

    from stateright_tpu_torch.checker import gpu
    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.ops.ring import ring_take

    cfg = _config(name)
    F = cfg.spawn["frontier_capacity"]
    got = {}
    deep_drain = gpu.GpuBfsChecker._deep_drain

    def spy(self, table, width, budget):
        d = self._drain
        count = int(d["scalars"][gpu._COUNT])
        if not got and width == F and self._unique_count >= min_unique and count >= min_live:
            got.update(table=table.clone(), capacity=d["capacity"],
                       pool=map_leaves(torch.clone, d["pool"]),
                       head=d["scalars"][gpu._HEAD].clone(), live=min(count, F),
                       spec=self._spec, depth_cap=self._depth_cap,
                       unique=self._unique_count)
            raise _Stop()
        return deep_drain(self, table, width, budget)

    gpu.GpuBfsChecker._deep_drain = spy
    try:
        checker = cfg.make().checker().spawn_gpu_bfs(wave_kernel="fused", **cfg.spawn)
        for h in checker.handles():
            h.join()
    finally:
        gpu.GpuBfsChecker._deep_drain = deep_drain
    if not got or not isinstance(checker.worker_error(), _Stop):
        raise AssertionError(f"no drain started with a full-width take "
                             f"({checker.worker_error()!r})")
    live = torch.full((), got["live"], dtype=torch.int64, device="cuda")
    got["frontier"] = ring_take(got["pool"], got["head"], live, got["capacity"], F)[0]
    return got


def _comphash_wave(label, got):
    """``fw_comphash_keys`` and the whole fused chain against their plain
    twins on a wave taken from the drain with its table; their median times
    and the keys stage's bound."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw

    spec, table0, front, depth_cap = got["spec"], got["table"], got["frontier"], got["depth_cap"]
    assert spec.keys_route == "comphash", spec.keys_route
    states, mask = front["states"], front["mask"]
    hi, lo, ebits, depth = (front[k] for k in ("hi", "lo", "ebits", "depth"))
    F, A = hi.shape[0], spec.action_count
    B = F * A

    # The whole chain against fused_wave_plain (the host CPU).
    chain_err, pout, plain_ms, _pt, _sweeps = _compare_fused(spec, table0, front, depth_cap,
                                                             mask=mask)
    stats = pout["stats"].tolist()
    log(f"  {label} wave: F={F} live={got['live']} B={B} table rows={table0.shape[0]} "
        f"ring rows={got['capacity']} unique before={got['unique']} generated={stats[0]} "
        f"n_new={stats[1]} overflow={stats[2]} max_abs_err={chain_err} "
        f"plain={plain_ms:.1f} ms (host CPU)")
    if chain_err:
        raise AssertionError(f"fused kernels and the plain twin disagree on a {label} wave")

    # The keys stage alone, on the card: the kernel against the model's
    # torch packed_fingerprint and the fw_keys masking.
    cond, cvalid, cand = fw.model_stage(spec, states, F)
    key, idx = fw.comphash_keys_stage(spec.comphash, cand, cvalid, depth, depth_cap, A,
                                      None, mask)
    chi, clo = spec.fingerprint(cand)
    pkey, pidx = fw.keys_plain(chi, clo, cvalid, depth, depth_cap, A, mask)
    torch.cuda.synchronize()
    err = _max_abs_err([(pkey.cpu(), key), (pidx.cpu(), idx)])
    n_valid = int((pkey != -1).sum())
    log(f"  fw_comphash_keys ({label}): B={B} valid lanes={n_valid} max_abs_err={err}")
    if err:
        raise AssertionError("fw_comphash_keys and its plain twin disagree")
    if not n_valid:
        raise AssertionError(f"the {label} wave has no valid lane")

    ms, _ = _time_on_card(lambda mark: fw.comphash_keys_stage(
        spec.comphash, cand, cvalid, depth, depth_cap, A, None, mask))
    twin_ms, _ = _time_on_card(lambda mark: fw.keys_plain(
        *spec.fingerprint(cand), cvalid, depth, depth_cap, A, mask))
    model_ms, _ = _time_on_card(lambda mark: fw.model_stage(spec, states, F))
    work = table0.clone()
    chain_ms, stage_ms = _time_on_card(
        lambda mark: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond,
                                     cvalid, None, cand, mark=mark, mask=mask),
        reset=lambda: work.copy_(table0),
    )
    moved = _bd().comphash_must_move(spec, cand, pkey != -1, F)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(json.dumps({f"{label}_wave": {
        "comphash_keys_ms": ms, "comphash_plain_on_card_ms": twin_ms,
        "kernel_chain_ms": chain_ms, "fused_wave_stage_ms": stage_ms,
        "model_stage_torch_ms": model_ms, "comphash_must_move_bytes": moved,
        "comphash_bound_ms": bound_ms, "valid_lanes": n_valid, "B": B,
        "chain_plain_host_ms": plain_ms,
    }}))
    log(f"  fw_comphash_keys ({label}): median {ms:.4f} ms, plain twin on the card "
        f"{twin_ms:.4f} ms, bound {bound_ms:.5f} ms ({moved} B); chain {chain_ms:.4f} ms; "
        f"model stage (torch) {model_ms:.3f} ms")
    rec = _stage_wave(label, spec, table0, hi, lo, ebits, depth, depth_cap, cond, cvalid,
                            None, cand, mask=mask, stage_ms=stage_ms, chain_ms=chain_ms)
    _keep_fps_wave(label, got)
    return {"max_abs_err": max(err, chain_err), "keys_err": err, "chain_err": chain_err,
            "ms": ms, "plain_ms": twin_ms, "bound_ms": bound_ms, "waves": {label: rec}}


def _insert_on_wave(label, got):
    """``hashset_insert_sorted`` against its plain twin on the keys of a
    wave taken from the drain, as the staged engine hands them over (the
    model's fingerprints of the valid lanes, sorted, the first copy of each
    key active), into the table the drain holds; its median time and its
    bound."""
    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.ops import fused_wave as fw

    spec, front, depth_cap = got["spec"], got["frontier"], got["depth_cap"]
    F = front["hi"].shape[0]
    cond, cvalid, cand = fw.model_stage(spec, front["states"], F)
    cvalid = fw._frontier_plain(spec, cond, cvalid, front["ebits"], front["depth"], depth_cap,
                                front["mask"])[2]
    shi, slo, _sidx, unique = fw.sorted_dedup(*spec.fingerprint(cand), cvalid)
    hi, lo = (x.cpu().numpy().astype("uint32") for x in (shi, slo))
    active = unique.cpu().numpy()
    r = _compare_insert(table_to_numpy(got["table"]), hi, lo, active, timing=True)
    moved = _bd().insert_must_move(r["after"], hi, lo, active, r["fresh"])
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  hashset_insert_sorted ({label} wave keys): B={hi.shape[0]} active={int(active.sum())} "
        f"fresh={int(r['fresh'].sum())} tiles={r['touched']} redone={r['redone']} "
        f"(to redo {r['to_redo']}) max_abs_err={r['err']} median {r['ms']:.4f} ms "
        f"passes {_fmt_passes(r['pass_ms'])} plain={r['plain_ms']:.1f} ms (host CPU) "
        f"bound={bound_ms:.5f} ms ({moved} B)")
    if r["err"]:
        raise AssertionError(f"hashset_insert_sorted and its plain twin disagree on the "
                             f"{label} wave's keys")
    if r["redone"] != r["to_redo"]:
        raise AssertionError(f"{label}: the repair redid {r['redone']} tiles, not "
                             f"{r['to_redo']}")
    if not active.any():
        raise AssertionError(f"the {label} wave has no active key")
    return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms}


@phase("comphash_vs_plain")
def comphash_vs_plain():
    """The unordered route on a full-width paxos3 wave."""
    got = _capture_take("paxos3", 300_000, _config("paxos3").spawn["frontier_capacity"])
    return _comphash_wave("paxos3", got)


@phase("comphash_ordered_vs_plain")
def comphash_ordered_vs_plain():
    """The ordered route (one component per FIFO flow) on a full-width
    abd3o wave."""
    got = _capture_take("abd3o", 10_000, _config("abd3o").spawn["frontier_capacity"] // 2)
    assert got["spec"].comphash["layout"]["ordered"]
    return _comphash_wave("abd3o", got)


@phase("comphash_raft5_vs_plain")
def comphash_raft5_vs_plain():
    """The unordered route at raft's layout (no history component, one
    timer word a server, 60 envelope slots; the drop and timeout classes
    in the model stage) and the chain on a full-width raft5 wave
    (B = 256,000 lanes), and the insert kernel on that wave's keys."""
    got = _capture_take("raft5_ttc", 10_000, _config("raft5_ttc").spawn["frontier_capacity"])
    lay = got["spec"].comphash["layout"]
    assert not lay["ordered"] and lay["H"] == 0, lay
    res = _comphash_wave("raft5", got)
    res["insert"] = _insert_on_wave("raft5", got)
    return res


# The frontiers and tables of the actor waves taken from the drains (on the
# host), for fps_vs_materialize.
FPS_WAVES = {}


def _keep_fps_wave(label, got):
    from stateright_tpu_torch.core.batch import map_leaves

    host = lambda x: None if x is None else x.cpu()  # noqa: E731
    FPS_WAVES[label] = {"spec": got["spec"], "depth_cap": got["depth_cap"],
                        "table": got["table"].cpu(),
                        "frontier": map_leaves(host, got["frontier"])}


def _peak_bytes(fn):
    """The device bytes ``fn`` allocates at its peak above what was held
    before it."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _graph_ms(fn, reset):
    """Median device ms of a replay of ``fn`` captured in a CUDA Graph,
    ``reset`` before each replay (outside the timing)."""
    import torch

    reset()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms, _ = _time_on_card(lambda mark: graph.replay(), reset=reset)
    del graph
    return ms


def _fps_wave(label, w):
    """The fingerprint-only expansion against the materializing one on a
    wave taken from a drain (its live lanes masked in): ``packed_expand_fps``
    against ``packed_fingerprint`` of the ``model_stage`` candidates and
    their validity, and ``packed_take`` of every valid lane against its
    candidate, each to ``max_abs_err`` 0; the staged wave both ways on
    copies of the table (``torch_wave_fps`` and the take of its fresh
    lanes against ``torch_wave``: the same stats, table and fresh rows).
    Times (CUDA events): the materializing model stage, with and without
    the candidates' torch fingerprints; ``packed_expand_fps``; the take of
    the wave's fresh lanes and of the drain's take width; each staged wave,
    called and replayed from a CUDA Graph as the drain runs it; and the
    peak device bytes of each staged wave."""
    import dataclasses

    import torch

    from stateright_tpu_torch.checker.gpu import take_width
    from stateright_tpu_torch.core.batch import leaves, map_leaves
    from stateright_tpu_torch.ops import fused_wave as fw

    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    spec, depth_cap = w["spec"], w["depth_cap"]
    front, table0 = map_leaves(dev, w["frontier"]), w["table"].cuda()
    model = spec.expand.__self__
    fps = dataclasses.replace(spec, expand_fps=model.packed_expand_fps, take=model.packed_take)
    states, mask = front["states"], front["mask"]
    hi, lo, ebits, depth = (front[k] for k in ("hi", "lo", "ebits", "depth"))
    F, A = hi.shape[0], spec.action_count
    B, S = F * A, take_width(F, A)

    cond, cvalid, cand = fw.model_stage(spec, states, F)
    chi, clo = spec.fingerprint(cand)
    fhi, flo, fvalid = model.packed_expand_fps(states)
    fhi, flo, fvalid = fhi.reshape(B), flo.reshape(B), fvalid.reshape(B)
    valid_err = int((fvalid != cvalid).sum())
    fp_err = _max_abs_err([(chi[cvalid].cpu(), fhi[cvalid]), (clo[cvalid].cpu(), flo[cvalid])])
    lanes = cvalid.nonzero().squeeze(1)
    taken = fw.take_children(fps, states, lanes)
    take_err = _max_abs_err([(cand[k][lanes].cpu(), taken[k]) for k in cand])

    work_f, work_m = table0.clone(), table0.clone()
    _t, out = fw.torch_wave_fps(fps, work_f, states, hi, lo, ebits, depth, depth_cap, mask)
    _t, mout = fw.torch_wave(spec, work_m, states, hi, lo, ebits, depth, depth_cap, mask)
    n_new = int(out["stats"][1])
    src = out["new"]["src"][:n_new]
    fresh_rows = fw.take_children(fps, states, src)
    wave_err = _max_abs_err(
        [(mout["stats"].cpu(), out["stats"]), (work_m.cpu(), work_f)]
        + [(mout["new"][k][:n_new].cpu(), out["new"][k][:n_new])
           for k in ("hi", "lo", "ebits", "depth")]
        + [(x[:n_new].cpu(), y) for x, y in zip(leaves(mout["new"]["states"]),
                                                leaves(fresh_rows))])
    err = max(valid_err, fp_err, take_err, wave_err)
    log(f"  fps_vs_materialize ({label}): F={F} B={B} valid lanes={lanes.numel()} "
        f"n_new={n_new} take width={S} max_abs_err={err} (validity {valid_err}, "
        f"fingerprints {fp_err}, take {take_err}, wave {wave_err})")
    if err:
        raise AssertionError(f"{label}: the fps expansion and the materializing one disagree")
    if not lanes.numel() or not n_new:
        raise AssertionError(f"{label}: the wave has no valid or no fresh lane")

    reset = lambda: work_f.copy_(table0)  # noqa: E731
    model_ms, _ = _time_on_card(lambda mark: fw.model_stage(spec, states, F))
    materialize_ms, _ = _time_on_card(
        lambda mark: spec.fingerprint(fw.model_stage(spec, states, F)[2]))
    fps_ms, _ = _time_on_card(lambda mark: model.packed_expand_fps(states))
    take_ms, _ = _time_on_card(lambda mark: fw.take_children(fps, states, src))
    take_width_ms, _ = _time_on_card(
        lambda mark: fw.take_children(fps, states, out["new"]["src"][:S]))
    staged_ms, _ = _time_on_card(lambda mark: fw.torch_wave(
        spec, work_f, states, hi, lo, ebits, depth, depth_cap, mask), reps=5, reset=reset)
    def fps_wave_and_take():
        _t, fout = fw.torch_wave_fps(fps, work_f, states, hi, lo, ebits, depth, depth_cap,
                                     mask)
        return fw.take_children(fps, states, fout["new"]["src"][:S])

    staged_fps_ms, _ = _time_on_card(lambda mark: fps_wave_and_take(), reps=5, reset=reset)
    # Each staged wave as the drain runs it, captured in a CUDA Graph and
    # replayed: device time with no host launches.
    staged_graph_ms = _graph_ms(lambda: fw.torch_wave(
        spec, work_f, states, hi, lo, ebits, depth, depth_cap, mask), reset)
    fps_graph_ms = _graph_ms(fps_wave_and_take, reset)
    fps_only_graph_ms = _graph_ms(lambda: fw.torch_wave_fps(
        fps, work_f, states, hi, lo, ebits, depth, depth_cap, mask), reset)
    reset()
    staged_peak = _peak_bytes(lambda: fw.torch_wave(
        spec, work_f, states, hi, lo, ebits, depth, depth_cap, mask))
    reset()
    fps_peak = _peak_bytes(fps_wave_and_take)
    rec = {"wave": label, "F": F, "B": B, "valid_lanes": lanes.numel(), "n_new": n_new,
           "take_width": S, "max_abs_err": err,
           "model_stage_torch_ms": model_ms, "materialize_fingerprint_ms": materialize_ms,
           "expand_fps_ms": fps_ms, "take_fresh_ms": take_ms, "take_width_ms": take_width_ms,
           "staged_wave_ms": staged_ms, "staged_fps_wave_and_take_ms": staged_fps_ms,
           "staged_wave_graph_ms": staged_graph_ms, "fps_wave_graph_ms": fps_only_graph_ms,
           "fps_wave_and_take_graph_ms": fps_graph_ms,
           "staged_wave_peak_bytes": staged_peak, "staged_fps_wave_peak_bytes": fps_peak}
    log(json.dumps({"fps_vs_materialize": rec}))
    log(f"  {label}: model stage {model_ms:.3f} ms (+ fingerprints {materialize_ms:.3f}) vs "
        f"packed_expand_fps {fps_ms:.3f} ms; take of {n_new} fresh {take_ms:.3f} ms, of {S} "
        f"{take_width_ms:.3f} ms; staged wave {staged_ms:.3f} ms vs fps wave + take "
        f"{staged_fps_ms:.3f} ms (in a graph {staged_graph_ms:.3f} vs {fps_graph_ms:.3f} ms, "
        f"the fps wave alone {fps_only_graph_ms:.3f}); peak {staged_peak} vs {fps_peak} B")
    return rec


@phase("fps_vs_materialize")
def fps_vs_materialize():
    """The fingerprint-only expansion on a full-width wave of paxos3, abd3o
    and raft5 taken from the fused drains (kept by the comphash phases) and
    of raft4, against the materializing expansion: ``_fps_wave``."""
    got = _capture_take("raft4", 4_000, _config("raft4").spawn["frontier_capacity"])
    _keep_fps_wave("raft4", got)
    del got
    res = {}
    for label in ("paxos3", "abd3o", "raft5", "raft4"):
        res[label] = _fps_wave(label, FPS_WAVES.pop(label))
    return res


def _drive(name, wave_kernel, expand_fps=None):
    """Drives the configuration ``name`` through ``spawn_gpu_bfs`` and the
    deep drain (``expand_fps`` as given: None is the default, the
    fingerprint-only wave on a staged actor run), every kernel count set to
    0 just before and read just after; returns the model, the checker and
    the run's numbers (``wall_s`` from spawn to the end of ``join()``, the
    kernels already built; ``use_fps``; the drains' exits, ``take full``
    among them; the children the host made, ``host_take_rows``, and the
    device's take width a rung)."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    # Tensors of an earlier phase held only by reference cycles (a stopped
    # run's exception traceback holds its checker's frames) are freed now,
    # so that the peak below is this run's own.
    cfg = _config(name)
    model = cfg.make()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.launches = fw.launches = fw.comphash_launches = 0
    fw.sort_launches = fw.compact_launches = fw.gather_launches = 0
    fw.frontier_launches = fw.keys_launches = fw.dedup_launches = 0
    t0 = time.perf_counter()
    checker = model.checker().spawn_gpu_bfs(wave_kernel=wave_kernel, expand_fps=expand_fps,
                                            **cfg.spawn).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"hashset_insert_sorted": hk.launches, "fused_wave": fw.launches,
                "fw_frontier": fw.frontier_launches, "fw_keys": fw.keys_launches,
                "fw_comphash_keys": fw.comphash_launches, "fw_sort": fw.sort_launches,
                "fw_dedup": fw.dedup_launches, "fw_compact": fw.compact_launches,
                "fw_gather": fw.gather_launches}
    _check_sort_gather_launches(launches)
    peak = torch.cuda.max_memory_allocated()
    unique = checker.unique_state_count()
    from stateright_tpu_torch.checker.gpu import take_width

    takes = ({w: take_width(w, model.packed_action_count()) for w in checker.rungs}
             if checker._use_fps else {})
    label = f"{wave_kernel}, fps" if checker._use_fps else wave_kernel
    log(f"  {name} ({label}, drain): unique={unique} states={checker.state_count()} "
        f"depth={checker.max_depth()} wall={wall:.3f} s unique_states_per_s={unique / wall:.0f} "
        f"waves={checker.waves} noop_waves={checker.noop_waves} "
        f"warmup_waves={checker.warmup_waves} drains={checker.drains} "
        f"exits={dict(checker.drain_exits)} rungs={dict(checker.rungs)} "
        f"graph_captures={checker.graph_captures} graph_replays={checker.graph_replays} "
        f"capture_s={checker.capture_s:.3f} "
        f"table_growths={checker.table_growths} table_capacity={checker.table_capacity()} "
        f"launches={launches} peak_device_bytes={peak} keys_route={checker.keys_route} "
        f"use_fps={checker._use_fps} take_width={takes} max_fresh={checker.max_fresh} "
        f"take_full_exits={checker.drain_exits.get('take full', 0)} "
        f"host_takes={checker.host_takes} host_take_rows={checker.host_take_rows}")
    assert checker.device.type == "cuda" and checker.drains > 0
    assert checker.worker_error() is None, checker.worker_error()
    assert checker.keys_route == "comphash", checker.keys_route
    if cfg.unique is not None:
        assert unique == cfg.unique, unique
    assert checker._use_fps is (wave_kernel == "staged" and expand_fps is not False), (
        checker._use_fps)
    n = launches
    if wave_kernel == "staged":
        assert n["hashset_insert_sorted"] >= checker.waves > 0, n
        assert n["fused_wave"] == 0 and n["fw_comphash_keys"] == 0, n
    else:
        assert n["fw_comphash_keys"] >= checker.waves > 0, n
        assert n["fused_wave"] == n["fw_comphash_keys"], n
        assert n["hashset_insert_sorted"] >= 1, n  # the seed
    run = {"launches": launches, "wall_s": wall, "waves": checker.waves,
           "noop_waves": checker.noop_waves, "drains": checker.drains,
           "graph_captures": checker.graph_captures, "capture_s": checker.capture_s,
           "exits": dict(checker.drain_exits), "unique": unique,
           "state_count": checker.state_count(), "max_depth": checker.max_depth(),
           "peak_device_bytes": peak, "use_fps": checker._use_fps,
           "take_width": takes, "max_fresh": checker.max_fresh,
           "take_full_exits": checker.drain_exits.get("take full", 0),
           "host_takes": checker.host_takes, "host_take_rows": checker.host_take_rows}
    return model, checker, run


def _replay_value_chosen(label, model, checker, wave_kernel):
    """Replays the ``value chosen`` path on the host: its last state holds
    a chosen value and a linearizable history."""
    t1 = time.perf_counter()
    path = checker.discoveries()["value chosen"]
    actions = path.into_actions()
    last = path.last_state()
    cond = next(p for p in model.properties() if p.name == "value chosen").condition
    assert cond(model, last), "the value chosen path does not end in a chosen value"
    assert last.history.serialized_history() is not None
    log(f"  {label} ({wave_kernel}): value chosen path of {len(actions)} actions replayed on "
        f"the host in {time.perf_counter() - t1:.2f} s: {path.encode()}")
    return path.encode()


def _stuck_without_leader(model, path):
    """Replays raft's ``stable leader`` counterexample on the host: its last
    state has no live leader and no action leads to a state within the
    boundary. Returns the path's action count."""
    from stateright_tpu_torch.models.raft import LEADER

    actions = path.into_actions()
    s = path.last_state()
    assert not any(a.role == LEADER and not c for a, c in zip(s.actor_states, s.crashed)), s
    enabled = []
    model.actions(s, enabled)
    for a in enabled:
        n = model.next_state(s, a)
        assert n is None or not model.within_boundary(n), a
    return len(actions)


@phase("main_path_paxos3_drain")
def main_path_paxos3():
    runs = {}
    for wave_kernel in ("staged", "fused"):
        model, checker, run = _drive("paxos3", wave_kernel)
        checker.assert_properties()
        run["path"] = _replay_value_chosen("paxos3", model, checker, wave_kernel)
        runs[wave_kernel] = run
    for k in ("state_count", "max_depth"):
        assert runs["staged"][k] == runs["fused"][k], (k, runs)
    return runs


@phase("main_path_abd3o_drain")
def main_path_abd3o():
    """linearizable-register check 3 ordered on both engines through the
    drain: exactly 46,516 states, ``linearizable`` holds, ``value chosen``
    replays on the host."""
    runs = {}
    for wave_kernel in ("staged", "fused"):
        model, checker, run = _drive("abd3o", wave_kernel)
        checker.assert_properties()
        run["path"] = _replay_value_chosen("abd3o", model, checker, wave_kernel)
        runs[wave_kernel] = run
    for k in ("state_count", "max_depth"):
        assert runs["staged"][k] == runs["fused"][k], (k, runs)
    return runs


@phase("main_path_raft5_ttc")
def main_path_raft5_ttc():
    """Raft with 5 servers on a lossy network, only ``stable leader``
    kept: the time from spawn to its discovery (``ttc_s``), the unique
    count at the exit, and the counterexample replayed on the host; staged
    with the fingerprint-only wave (the default), fused, and staged with
    ``expand_fps=False`` (the materializing wave), in this one call."""
    runs = {}
    for key, wave_kernel, fps in (("staged", "staged", None), ("fused", "fused", None),
                                  ("staged_materialize", "staged", False)):
        model, checker, run = _drive("raft5_ttc", wave_kernel, expand_fps=fps)
        assert set(checker.discoveries()) == {"stable leader"}, checker.discoveries()
        path = checker.discoveries()["stable leader"]
        steps = _stuck_without_leader(model, path)
        run["ttc_s"] = run["wall_s"]
        log(f"  raft5 ({key}): ttc_s={run['ttc_s']:.3f} unique at exit={run['unique']} "
            f"(the JAX package's CPU runs: {RAFT5_JAX_CPU_UNIQUE_AT_EXIT}) drains={run['drains']} "
            f"exits={run['exits']} waves={run['waves']} noop_waves={run['noop_waves']} "
            f"peak_device_bytes={run['peak_device_bytes']}; stable leader path of {steps} "
            f"actions replayed on the host: no live leader, nothing enabled within the "
            f"boundary")
        runs[key] = run
    log(json.dumps({"raft5_ttc_within_call": {
        k: {f: r[f] for f in ("ttc_s", "unique", "waves", "drains", "exits", "use_fps",
                              "peak_device_bytes", "host_take_rows", "graph_captures",
                              "capture_s")}
        for k, r in runs.items()}}))
    return runs


@phase("main_path_raft4_lossy")
def main_path_raft4():
    """Raft with 4 servers on a lossy network, every property: the full
    space, exactly 24,545 states."""
    runs = {}
    for wave_kernel in ("staged", "fused"):
        model, checker, run = _drive("raft4", wave_kernel)
        found = checker.discoveries()
        assert set(found) == {"leader elected", "stable leader"}, set(found)
        _stuck_without_leader(model, found["stable leader"])
        runs[wave_kernel] = run
    for k in ("state_count", "max_depth"):
        assert runs["staged"][k] == runs["fused"][k], (k, runs)
    return runs


# (model, its arguments, unique states or None where the run stops at
# its discoveries, the discoveries).
LIN = {"value chosen"}
ACTOR_CASES = {
    "paxos 2c/2s": ("paxos", dict(client_count=2, server_count=2), 111, LIN),
    "paxos 1c/3s": ("paxos", dict(client_count=1, server_count=3), 265, LIN),
    "single-copy 2c/1s": ("single_copy", dict(client_count=2, server_count=1), 93, LIN),
    "single-copy 2c/2s": ("single_copy", dict(client_count=2, server_count=2), None,
                          LIN | {"linearizable"}),
    "single-copy 2c/1s, duplicating network": (
        "single_copy", dict(client_count=2, server_count=1, envelope_capacity=24,
                            network="duplicating"), None, LIN | {"linearizable"}),
    "ABD 2c/2s, ordered network": (
        "abd", dict(client_count=2, server_count=2, network="ordered"), 620, LIN),
    "raft3, lossy, one crash": (
        "raft", dict(server_count=3, max_term=1, lossy=True, max_crashes=1), 2252,
        {"leader elected", "stable leader"}),
}


@phase("replay_actor_small")
def replay_actor_small():
    from stateright_tpu_torch.actor.network import Network
    from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    from stateright_tpu_torch.models.raft import RaftModelCfg
    from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg

    cfgs = {"paxos": PaxosModelCfg, "single_copy": SingleCopyModelCfg, "abd": AbdModelCfg,
            "raft": RaftModelCfg}
    networks = {"duplicating": Network.new_unordered_duplicating, "ordered": Network.new_ordered}
    modes = {"wave at a time": dict(max_drain_waves=1), "drain": {}}

    def make(kind, args):
        args = dict(args)
        if "network" in args:
            args["network"] = networks[args["network"]]()
        return cfgs[kind](**args).into_model()

    for label, (kind, args, expected, found) in ACTOR_CASES.items():
        for wave_kernel in ("staged", "fused"):
            for mode, options in modes.items():
                spawn = dict(options, frontier_capacity=64, table_capacity=1 << 12,
                             wave_kernel=wave_kernel)
                gpu = make(kind, args).checker().spawn_gpu_bfs(**spawn).join()
                cpu = make(kind, args).checker().spawn_gpu_bfs(**spawn, device="cpu").join()
                assert gpu.keys_route == "comphash"
                assert gpu.unique_state_count() == cpu.unique_state_count()
                if expected is not None:
                    assert gpu.unique_state_count() == expected
                assert gpu.state_count() == cpu.state_count()
                assert gpu.max_depth() == cpu.max_depth()
                assert gpu.waves == cpu.waves and gpu.drains == cpu.drains
                gd, cd = gpu.discoveries(), cpu.discoveries()
                assert set(gd) == set(cd)
                for name in gd:
                    assert gd[name].encode() == cd[name].encode(), name
                assert set(gd) == found, (set(gd), found)
                log(f"  {label} ({wave_kernel}, {mode}): unique={gpu.unique_state_count()} "
                    f"states={gpu.state_count()} depth={gpu.max_depth()} waves={gpu.waves} "
                    f"drains={gpu.drains} discoveries={sorted(gd)} (cuda == cpu twin)")


# -- 5. coverage --------------------------------------------------------------------


def _with_coverage(spec, model):
    """``spec`` with coverage on, as ``spawn_gpu_bfs(coverage=True)`` builds
    it: the coverage vector's layout and the model's antecedents."""
    import dataclasses

    from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

    P = len(spec.conditions)
    return dataclasses.replace(spec, cov_layout=DeviceCoverage(spec.action_count, P),
                               cov_antecedents=tuple(model.packed_antecedents()))


def _coverage_wave(label, got, model):
    """The fused chain with coverage on against its plain twin on a
    full-width wave taken from the fused drain with its table: the chain
    against ``fused_wave_plain`` on the host; on the card, the chain's own
    coverage vector (added by ``fw_frontier`` and ``fw_compact``) against
    ``coverage_plain`` on the chain's own scratch, and each kernel's half
    alone against ``coverage_frontier_plain`` and ``coverage_fresh_plain``.
    Times: the frontier and the compaction alone with coverage on and off
    (CUDA events), ``coverage_plain`` on the card, and the chain; the
    epilogue's in-graph time (on minus off) comes from
    ``stage_device_profile``, which gets the wave's coverage-off twin."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw

    spec = _with_coverage(got["spec"], model)
    table0, front, depth_cap = got["table"], got["frontier"], got["depth_cap"]
    states, mask = front["states"], front["mask"]
    hi, lo, ebits, depth = (front[k] for k in ("hi", "lo", "ebits", "depth"))
    F, A, P = hi.shape[0], spec.action_count, len(spec.conditions)
    B = F * A

    chain_err, pout, plain_ms, _pt, _sweeps = _compare_fused(spec, table0, front, depth_cap,
                                                             mask=mask)
    stats, cov = pout["stats"].tolist(), pout["cov"].tolist()
    log(f"  {label} wave with coverage: F={F} live={got['live']} B={B} table rows="
        f"{table0.shape[0]} unique before={got['unique']} generated={stats[0]} "
        f"n_new={stats[1]} overflow={stats[2]} evaluated={cov[0]} terminal={cov[1]} "
        f"max_abs_err={chain_err} plain={plain_ms:.1f} ms (host CPU)")
    if chain_err:
        raise AssertionError(f"the chain with coverage and its plain twin disagree on {label}")
    if not stats[1] or cov[0] != got["live"]:
        raise AssertionError(f"the {label} wave is not a live full-width wave: {stats} {cov[:2]}")

    # The chain on a copy of the table, tapping its scratch and its vector;
    # coverage_plain on those inputs, and each half alone.
    cond, cvalid, cand = fw.model_stage(spec, states, F)
    ant = fw.antecedent_stage(spec, states, F)
    kin = fw.keys_input(spec, cand)
    work, taps = table0.clone(), {}
    _t, cout = fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond, cvalid, kin,
                               cand, mask=mask, ant=ant, taps=taps)
    eb_after, flag, idx = taps["ebits_after"], taps["flag"], taps["idx"]
    args = (spec, cvalid, depth, depth_cap, mask, cond, ant, eb_after, flag, idx)
    pvec = fw.coverage_plain(*args)
    fargs = (spec, cond, cvalid, ebits, depth, depth_cap)
    facc = torch.zeros(4 + P + spec.cov_layout.size, dtype=torch.int64, device="cuda")
    fw.frontier_stage(*fargs, facc, mask, ant)
    front_want = fw.coverage_frontier_plain(spec, cvalid, depth, depth_cap, mask, cond, ant,
                                            eb_after)
    cargs = (flag, taps["key"], idx, A, eb_after, depth, hi, lo)
    cacc, cvec = taps["acc"].clone(), torch.zeros_like(pvec)
    fw.compact_stage(*cargs, cacc, cvec)
    fresh_want = fw.coverage_fresh_plain(spec, depth, flag, idx)
    torch.cuda.synchronize()
    err = _max_abs_err([(pvec.cpu(), taps["cov"]), (pout["cov"], taps["cov"]),
                        (pout["cov"], cout["cov"]), (front_want.cpu(), facc[4 + P:]),
                        (fresh_want.cpu(), cvec)])
    n_new = sum(pvec[spec.cov_layout.s_fresh].tolist())
    log(f"  coverage epilogue ({label}): size={spec.cov_layout.size} max_abs_err={err} "
        f"fresh={n_new} (the chain's vector, fw_frontier's half, fw_compact's half)")
    if err:
        raise AssertionError(f"the coverage epilogue and its plain twin disagree on {label}")
    twin_ms, _ = _time_on_card(lambda mark: fw.coverage_plain(*args))
    ant_ms, _ = _time_on_card(lambda mark: fw.antecedent_stage(spec, states, F))
    alone = {
        "frontier_cov_ms": _time_on_card(lambda mark: fw.frontier_stage(*fargs, facc, mask,
                                                                        ant))[0],
        "frontier_nocov_ms": _time_on_card(lambda mark: fw.frontier_stage(*fargs, facc,
                                                                          mask))[0],
        "compact_cov_ms": _time_on_card(lambda mark: fw.compact_stage(*cargs, cacc, cvec))[0],
        "compact_nocov_ms": _time_on_card(lambda mark: fw.compact_stage(*cargs, cacc))[0],
    }
    chain_ms, stage_ms = _time_on_card(
        lambda mark: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond, cvalid,
                                     kin, cand, mark=mark, mask=mask, ant=ant),
        reset=lambda: work.copy_(table0),
    )
    moved = _bd().coverage_must_move(spec, F, cov[0], stats[0], n_new, mask is not None)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(json.dumps({f"{label}_coverage_wave": {
        "coverage_plain_on_card_ms": twin_ms, **alone,
        "antecedent_stage_torch_ms": ant_ms, "kernel_chain_ms": chain_ms,
        "fused_wave_stage_ms": stage_ms, "coverage_must_move_bytes": moved,
        "coverage_bound_ms": bound_ms, "B": B, "evaluated": cov[0], "n_new": n_new,
        "chain_plain_host_ms": plain_ms,
    }}))
    log(f"  coverage epilogue ({label}): alone, fw_frontier {alone['frontier_cov_ms']:.4f} ms "
        f"(off {alone['frontier_nocov_ms']:.4f}), fw_compact {alone['compact_cov_ms']:.4f} ms "
        f"(off {alone['compact_nocov_ms']:.4f}); plain twin on the card {twin_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({moved} B); chain with coverage {chain_ms:.4f} ms; "
        f"antecedents (torch) {ant_ms:.4f} ms")
    rec = _stage_wave(f"{label}_coverage", spec, table0, hi, lo, ebits, depth, depth_cap,
                      cond, cvalid, kin, cand, mask=mask, ant=ant, stage_ms=stage_ms,
                      chain_ms=chain_ms)
    rec.update(coverage_alone_ms=alone, coverage_plain_ms=twin_ms, coverage_bound_ms=bound_ms,
               coverage_max_abs_err=err)
    # The same wave with coverage off, profiled beside it.
    STAGE_WAVES.append(dict(STAGE_WAVES[-1], rec={"wave": f"{label}_coverage_off"},
                            spec=got["spec"], ant=None))
    return {"max_abs_err": max(err, chain_err), "plain_ms": twin_ms, "bound_ms": bound_ms,
            "chain_ms": chain_ms, "waves": {f"{label}_coverage": rec}}


@phase("coverage_vs_plain")
def coverage_vs_plain():
    """The chain with its coverage epilogue on full-width takes of 2pc-8
    and of skv4x4."""
    out = {}
    for name, min_unique in (("2pc8", 200_000), ("skv4x4", 2_000_000)):
        cfg = _config(name)
        got = _capture_take(name, min_unique, cfg.spawn["frontier_capacity"])
        out[name] = _coverage_wave(name, got, cfg.make())
    return out


def _drive_coverage(name, wave_kernel, coverage=True):
    """Drives the configuration ``name`` through ``spawn_gpu_bfs`` and the
    deep drain with ``coverage``, every kernel count set to 0 just before
    and read just after; returns the checker and the run's numbers."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    cfg = _config(name)
    model = cfg.make()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.launches = fw.launches = fw.comphash_launches = fw.coverage_launches = 0
    fw.sort_launches = fw.compact_launches = fw.gather_launches = 0
    fw.frontier_launches = fw.keys_launches = fw.dedup_launches = 0
    fw.coverage_fresh_launches = 0
    t0 = time.perf_counter()
    checker = model.checker().spawn_gpu_bfs(wave_kernel=wave_kernel, coverage=coverage,
                                            **cfg.spawn).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"hashset_insert_sorted": hk.launches, "fused_wave": fw.launches,
                "fw_frontier": fw.frontier_launches, "fw_keys": fw.keys_launches,
                "fw_comphash_keys": fw.comphash_launches,
                "coverage_epilogue": fw.coverage_launches,
                "coverage_epilogue_fresh": fw.coverage_fresh_launches,
                "fw_sort": fw.sort_launches, "fw_dedup": fw.dedup_launches,
                "fw_compact": fw.compact_launches, "fw_gather": fw.gather_launches}
    _check_sort_gather_launches(launches)
    peak = torch.cuda.max_memory_allocated()
    unique = checker.unique_state_count()
    log(f"  {name} ({wave_kernel}, drain, coverage={coverage}): unique={unique} "
        f"states={checker.state_count()} depth={checker.max_depth()} wall={wall:.3f} s "
        f"unique_states_per_s={unique / wall:.0f} waves={checker.waves} "
        f"noop_waves={checker.noop_waves} warmup_waves={checker.warmup_waves} "
        f"drains={checker.drains} exits={dict(checker.drain_exits)} rungs={dict(checker.rungs)} "
        f"graph_captures={checker.graph_captures} graph_replays={checker.graph_replays} "
        f"table_growths={checker.table_growths} table_capacity={checker.table_capacity()} "
        f"launches={launches} peak_device_bytes={peak}")
    assert checker.device.type == "cuda" and checker.drains > 0
    assert checker.worker_error() is None, checker.worker_error()
    assert unique == cfg.unique, unique
    n = launches
    # The coverage epilogue rides in fw_frontier (frontier half) and
    # fw_compact (fresh half), one launch of each a wave with coverage on.
    if wave_kernel == "staged":
        assert n["fused_wave"] == n["coverage_epilogue"] == 0, n
    elif coverage:
        assert n["coverage_epilogue"] == n["coverage_epilogue_fresh"] == n["fused_wave"] \
            >= checker.waves > 0, n
    else:
        assert n["coverage_epilogue"] == n["coverage_epilogue_fresh"] == 0, n
        assert n["fused_wave"] >= checker.waves > 0, n
    run = {"launches": launches, "wall_s": wall, "waves": checker.waves,
           "noop_waves": checker.noop_waves, "drains": checker.drains,
           "graph_captures": checker.graph_captures, "capture_s": checker.capture_s,
           "exits": dict(checker.drain_exits), "unique": unique,
           "state_count": checker.state_count(), "max_depth": checker.max_depth(),
           "discoveries": {k: v.encode() for k, v in checker.discoveries().items()},
           "peak_device_bytes": peak, "report": checker.coverage_report()}
    if coverage:
        rep = run["report"]
        assert sum(rep["shape"]["depth_hist"]) == rep["unique"] == unique, rep["shape"]
        assert rep["generated"] == checker.state_count() - 1, rep["generated"]
        assert not rep["vacuous"], rep["vacuity"]
        assert rep["actions"]["fired"] == rep["actions"]["total"], rep["actions"]
    return checker, run


def _log_report(name, rep):
    props = {k: {f: v[f] for f in ("exercised", "discovered") if f in v}
             for k, v in rep["properties"].items()}
    log(f"  {name} coverage: evaluated={rep['evaluated']} generated={rep['generated']} "
        f"unique={rep['unique']} terminal={rep['terminal_states']} revisits={rep['revisits']} "
        f"depth_bins={len(rep['shape']['depth_hist'])} succ_hist_log2="
        f"{rep['shape']['succ_hist_log2']} properties={props} vacuous={rep['vacuous']}")


@phase("main_path_2pc8_coverage")
def main_path_2pc8_coverage(drains):
    """Both engines through the drain with coverage on: equal reports,
    and the counts, depth, discoveries and fused launches of the
    coverage-off runs of ``main_path_2pc8_drain``."""
    runs = {}
    for wave_kernel in ("staged", "fused"):
        checker, run = _drive_coverage("2pc8", wave_kernel)
        off = drains[wave_kernel]
        for k in ("state_count", "max_depth"):
            assert run[k] == off[k], (wave_kernel, k, run[k], off[k])
        checker.assert_properties()
        rep = run["report"]
        assert rep["actions"]["table"]["TmCommit"]["fired"] > 0, rep["actions"]["table"]
        runs[wave_kernel] = run
    assert runs["staged"]["report"] == runs["fused"]["report"]
    assert runs["staged"]["discoveries"] == runs["fused"]["discoveries"]
    n_on, n_off = runs["fused"]["launches"], drains["fused"]["launches"]
    log(f"  2pc-8 fused launches: coverage on {n_on['fused_wave']} (the coverage epilogue in "
        f"fw_frontier {n_on['coverage_epilogue']}, in fw_compact "
        f"{n_on['coverage_epilogue_fresh']}), coverage off {n_off['fused_wave']}")
    assert n_on["fused_wave"] == n_off["fused_wave"], (n_on, n_off)
    _log_report("2pc-8", runs["fused"]["report"])
    for wave_kernel in ("staged", "fused"):
        log(f"  2pc-8 ({wave_kernel}): drain wall coverage on {runs[wave_kernel]['wall_s']:.3f} s, "
            f"off {drains[wave_kernel]['wall_s']:.3f} s")
    return runs


@phase("main_path_skv4x4_coverage")
def main_path_skv4x4_coverage():
    """The fixed sharded KV at 4 shards and 4 keys, exhaustively, on both
    engines with coverage on: 16,777,216 states; its ``always`` properties
    hold and were exercised, its ``sometimes`` properties are discovered."""
    runs = {}
    for wave_kernel in ("staged", "fused"):
        checker, run = _drive_coverage("skv4x4", wave_kernel)
        checker.assert_properties()
        rep = run["report"]
        for name in ("no torn writes", "no total tear"):
            entry = rep["properties"][name]
            assert entry["discovered"] is False and entry["has_antecedent"], (name, entry)
            assert 0 < entry["exercised"] < rep["evaluated"], (name, entry)
        for name in ("fully migrated", "saturated writes"):
            assert rep["properties"][name]["discovered"] is True, (name, rep["properties"])
        runs[wave_kernel] = run
    for k in ("state_count", "max_depth", "report", "discoveries"):
        assert runs["staged"][k] == runs["fused"][k], k
    _log_report("skv4x4", runs["fused"]["report"])
    return runs


# (model, spawn settings) of the small coverage runs on the card.
COVERAGE_CASES = {
    "2pc-5": (lambda: _two_phase(5), dict(frontier_capacity=1024, table_capacity=1 << 14)),
    "ShardedKv(2, 2, 1) guarded": (lambda: _sharded_kv(2, 2, 1, True),
                                   dict(frontier_capacity=16, table_capacity=2048)),
    "ShardedKv(2, 2, 1)": (lambda: _sharded_kv(2, 2, 1, False),
                           dict(frontier_capacity=16, table_capacity=2048)),
    "single-copy 2c/1s": (lambda: _single_copy(2, 1),
                          dict(frontier_capacity=64, table_capacity=1 << 12)),
}


def _two_phase(n):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(n)


def _sharded_kv(s, k, v, guarded):
    from stateright_tpu_torch.models.sharded_kv import ShardedKv

    return ShardedKv(s, k, v, guarded=guarded)


def _single_copy(c, n):
    from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg

    return SingleCopyModelCfg(c, n).into_model()


@phase("replay_coverage_small")
def replay_coverage_small():
    modes = {"wave at a time": dict(max_drain_waves=1), "drain": {}}
    for label, (make, spawn) in COVERAGE_CASES.items():
        for wave_kernel in ("staged", "fused"):
            for mode, options in modes.items():
                opts = dict(spawn, wave_kernel=wave_kernel, coverage=True, **options)
                gpu = make().checker().spawn_gpu_bfs(**opts).join()
                cpu = make().checker().spawn_gpu_bfs(**opts, device="cpu").join()
                assert gpu.worker_error() is None, gpu.worker_error()
                assert gpu.unique_state_count() == cpu.unique_state_count()
                assert gpu.state_count() == cpu.state_count()
                assert gpu.coverage_report() == cpu.coverage_report(), label
                gd, cd = gpu.discoveries(), cpu.discoveries()
                assert {k: v.encode() for k, v in gd.items()} == {
                    k: v.encode() for k, v in cd.items()}
                rep = gpu.coverage_report()
                log(f"  {label} ({wave_kernel}, {mode}): unique={gpu.unique_state_count()} "
                    f"evaluated={rep['evaluated']} generated={rep['generated']} "
                    f"vacuous={rep['vacuous']} (cuda == cpu twin)")


# -- 6. symmetry reduction ----------------------------------------------------------


def _sym_counts_zero():
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    hk.launches = fw.launches = 0


def _sym_launches():
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    return {"hashset_insert_sorted": hk.launches, "fused_wave": fw.launches}


def _drive_symmetry(label, make, spawn, device="cuda"):
    """``make().checker().symmetry().spawn_gpu_bfs(**spawn)`` on ``device``
    with every kernel count set to 0 just before and read just after;
    returns the checker and the run's numbers (the wall from spawn to the
    end of ``join()``, the drains' exits, the "orbit fallback" exits and
    the lanes keyed on the orbit minimum, captures and their host seconds,
    the insert's launches, peak device bytes)."""
    import torch

    model = make()
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _sym_counts_zero()
    t0 = time.perf_counter()
    checker = model.checker().symmetry().spawn_gpu_bfs(device=device, **spawn).join()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _sym_launches()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    assert checker.worker_error() is None, checker.worker_error()
    sym = checker._sym
    run = {"wall_s": wall, "unique": checker.unique_state_count(),
           "state_count": checker.state_count(), "max_depth": checker.max_depth(),
           "waves": checker.waves, "drains": checker.drains,
           "exits": dict(checker.drain_exits),
           "fallback_exits": checker.drain_exits.get("orbit fallback", 0),
           "fallback_lanes": sym.fallback_lanes, "graph_captures": checker.graph_captures,
           "capture_s": checker.capture_s, "noop_waves": checker.noop_waves,
           "launches": launches, "peak_device_bytes": peak, "route": sym.route}
    if device == "cuda":
        assert checker.device.type == "cuda" and not checker._use_fps
        # The staged engine: every live wave inserts through the kernel.
        assert launches["fused_wave"] == 0, launches
        assert launches["hashset_insert_sorted"] >= checker.waves > 0, launches
        log(f"  {label} (staged, symmetry, {'drain' if checker.drains else 'wave at a time'}): "
            f"unique={run['unique']} states={run['state_count']} depth={run['max_depth']} "
            f"wall={wall:.3f} s waves={checker.waves} noop_waves={checker.noop_waves} "
            f"drains={checker.drains} exits={run['exits']} "
            f"fallback_exits={run['fallback_exits']} fallback_lanes={run['fallback_lanes']} "
            f"graph_captures={checker.graph_captures} capture_s={checker.capture_s:.3f} "
            f"table_capacity={checker.table_capacity()} launches={launches} "
            f"peak_device_bytes={peak} key_route={sym.route}")
    return model, checker, run


def _same_as_cpu(label, card, make, spawn):
    """The CPU twin of a card run: the same counts, depth, drains, exits and
    paths."""
    _model, cpu, _run = _drive_symmetry(label, make, spawn, device="cpu")
    assert card.unique_state_count() == cpu.unique_state_count()
    assert card.state_count() == cpu.state_count()
    assert card.max_depth() == cpu.max_depth()
    assert card.drains == cpu.drains and card.drain_exits == cpu.drain_exits
    gd, cd = card.discoveries(), cpu.discoveries()
    assert set(gd) == set(cd), (set(gd), set(cd))
    for name in gd:
        assert gd[name].encode() == cd[name].encode(), name
    return cpu


def _spy_widest_take(make, spawn):
    """Runs ``make()`` with ``.symmetry()`` through the drain and keeps the
    take at the start of the drain whose ring held the most states (the
    drain's frontier at its rung width, the live lanes masked in), with a
    copy of the table the drain ran on, the checker's wave spec and its
    symmetry keys."""
    import torch

    from stateright_tpu_torch.checker import gpu
    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.ops.ring import ring_take

    got = {}
    deep_drain = gpu.GpuBfsChecker._deep_drain

    def spy(self, table, width, budget):
        d = self._drain
        count = d["scalars"][gpu._COUNT]
        if int(count) > got.get("live", 0):
            frontier = ring_take(d["pool"], d["scalars"][gpu._HEAD], count, d["capacity"],
                                 width)[0]
            got.update(live=min(int(count), width), width=width, table=table.clone(),
                       frontier={k: map_leaves(torch.clone, v) for k, v in frontier.items()},
                       spec=self._spec, sym=self._sym, depth_cap=self._depth_cap)
        return deep_drain(self, table, width, budget)

    gpu.GpuBfsChecker._deep_drain = spy
    try:
        checker = make().checker().symmetry().spawn_gpu_bfs(**spawn).join()
    finally:
        gpu.GpuBfsChecker._deep_drain = deep_drain
    assert checker.worker_error() is None, checker.worker_error()
    assert got, "no drain ran"
    return got


def _key_stage_ms(label, got):
    """The key stage (``SymmetryKeys.wave_keys``, capturable: no host read)
    on a drain's take, eager under CUDA events and replayed in a CUDA
    Graph, as the drain runs it: its device ms a wave."""
    from stateright_tpu_torch.ops import fused_wave as fw

    spec, front, sym = got["spec"], got["frontier"], got["sym"]
    F = front["hi"].shape[0]
    cond, cvalid, cand = fw.model_stage(spec, front["states"], F)
    cvalid = fw._frontier_plain(spec, cond, cvalid, front["ebits"], front["depth"],
                                got["depth_cap"], front["mask"])[2]

    def keys():
        return sym.wave_keys(cand, cvalid, exact=False)

    keys()  # constants to the device, before the capture
    eager, _ = _time_on_card(lambda mark: keys())
    graph = _graph_ms(keys, reset=lambda: None)
    out = {"width": F, "lanes": F * spec.action_count, "live": got["live"],
           "valid": int(cvalid.sum()), "eager_ms": eager, "graph_ms": graph}
    log(f"  {label}: key stage ({sym.route}) on a drain take of {F} lanes ({got['live']} live, "
        f"B={out['lanes']}, {out['valid']} valid): {eager:.4f} ms eager, {graph:.4f} ms "
        f"in a CUDA Graph a wave")
    return out


@phase("symmetry_insert_vs_plain")
def symmetry_insert_vs_plain():
    """2pc-9 with ``.symmetry()``: the widest take of its drain, keyed on the
    card (the exact keys: the refined ones, and the orbit minimum on a lane
    whose check fails), sorted and deduplicated as the staged wave hands
    them over, then through ``hashset_insert_sorted`` on the card and its
    plain twin into the table that drain held: the table, fresh, found and
    pending bit-identical. Also the key stage's device ms a wave."""
    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import fused_wave as fw

    got = _spy_widest_take(lambda: TwoPhaseSys(9), SYM_2PC9_SPAWN)
    timing = _key_stage_ms("2pc-9", got)
    spec, front, sym = got["spec"], got["frontier"], got["sym"]
    F = front["hi"].shape[0]
    cond, cvalid, cand = fw.model_stage(spec, front["states"], F)
    cvalid = fw._frontier_plain(spec, cond, cvalid, front["ebits"], front["depth"],
                                got["depth_cap"], front["mask"])[2]
    khi, klo, _ = sym.wave_keys(cand, cvalid)
    shi, slo, _sidx, unique = fw.sorted_dedup(khi, klo, cvalid)
    hi, lo = (x.cpu().numpy().astype("uint32") for x in (shi, slo))
    active = unique.cpu().numpy()
    r = _compare_insert(table_to_numpy(got["table"]), hi, lo, active, timing=True)
    moved = _bd().insert_must_move(r["after"], hi, lo, active, r["fresh"])
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  hashset_insert_sorted (2pc-9 canonical keys): B={hi.shape[0]} "
        f"active={int(active.sum())} fresh={int(r['fresh'].sum())} tiles={r['touched']} "
        f"redone={r['redone']} (to redo {r['to_redo']}) max_abs_err={r['err']} median "
        f"{r['ms']:.4f} ms plain={r['plain_ms']:.1f} ms (host CPU) bound={bound_ms:.5f} ms "
        f"({moved} B)")
    if r["err"]:
        raise AssertionError("hashset_insert_sorted and its plain twin disagree on the "
                             "2pc-9 canonical keys")
    if r["redone"] != r["to_redo"]:
        raise AssertionError(f"the repair redid {r['redone']} tiles, not {r['to_redo']}")
    if not active.any() or not r["fresh"].any():
        raise AssertionError("the 2pc-9 take has no fresh canonical key")
    return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "key_stage": timing}


# 2pc-9 under symmetry at the JAX package's test settings
# (tests/test_device_symmetry.py::test_2pc9_device_orbit_count).
SYM_2PC9_SPAWN = dict(frontier_capacity=1 << 13, table_capacity=1 << 21, drain_log_factor=48)
TWO_PC_9_ORBITS = 2232


@phase("symmetry_2pc9_drain")
def symmetry_2pc9_drain(insert):
    """2pc-9 (10,340,352 states) with ``.symmetry()`` through the captured
    drain: 2,232 orbits, every property holding."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    _model, checker, run = _drive_symmetry("2pc-9", lambda: TwoPhaseSys(9), SYM_2PC9_SPAWN)
    assert run["unique"] == TWO_PC_9_ORBITS, run["unique"]
    assert checker.drains > 0 and checker.graph_replays > 0
    checker.assert_properties()
    run["key_stage"] = insert["key_stage"]
    log(json.dumps({"symmetry_2pc9": {k: run[k] for k in (
        "unique", "state_count", "max_depth", "wall_s", "waves", "drains", "exits",
        "fallback_exits", "fallback_lanes", "graph_captures", "capture_s", "launches",
        "peak_device_bytes", "key_stage")}}))
    return run


@phase("symmetry_2pc5_waves")
def symmetry_2pc5_waves():
    """2pc-5 with ``.symmetry()``, wave at a time and drained: 314 orbits each
    with both agreement discoveries, equal to the CPU twin's counts and
    paths; the paths replay to their agreement states."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    runs = {}
    for mode, options in (("wave", dict(max_drain_waves=1)), ("drain", {})):
        spawn = dict(frontier_capacity=256, table_capacity=1 << 14, **options)
        _model, checker, run = _drive_symmetry(f"2pc-5 {mode}", lambda: TwoPhaseSys(5), spawn)
        assert run["unique"] == 314, run["unique"]
        found = checker.discoveries()
        assert set(found) == {"abort agreement", "commit agreement"}, set(found)
        for name, want in (("abort agreement", "Aborted"), ("commit agreement", "Committed")):
            assert all(s == want for s in found[name].last_state().rm_state), name
        _same_as_cpu(f"2pc-5 {mode}", checker, lambda: TwoPhaseSys(5), spawn)
        runs[mode] = run
    assert runs["wave"]["state_count"] == runs["drain"]["state_count"]
    runs["drain"]["key_stage"] = _key_stage_ms(
        "2pc-5", _spy_widest_take(lambda: TwoPhaseSys(5), spawn))
    return runs


@phase("symmetry_increment")
def symmetry_increment():
    """The counter models on the card: ``IncrementLock(3)`` with
    ``.symmetry()`` (13 orbits, both properties holding) and ``Increment(3)``
    with ``.symmetry()`` (the lost update found, its path replaying), each
    against the CPU twin; and both without symmetry on the fused engine's
    fold route and the staged engine (``Increment(3)`` has 84 states with a
    property that always holds, ``IncrementLock(2)`` 17)."""
    from stateright_tpu_torch import Property
    from stateright_tpu_torch.models import Increment, IncrementLock

    spawn = dict(frontier_capacity=32, table_capacity=1 << 11)
    _m, lock, run = _drive_symmetry("IncrementLock(3)", lambda: IncrementLock(3), spawn)
    assert run["unique"] == 13, run["unique"]
    lock.assert_properties()
    _same_as_cpu("IncrementLock(3)", lock, lambda: IncrementLock(3), spawn)
    _key_stage_ms("IncrementLock(3)", _spy_widest_take(lambda: IncrementLock(3), spawn))
    _m, inc, run = _drive_symmetry("Increment(3)", lambda: Increment(3), spawn)
    path = inc.assert_any_discovery("fin")
    last = path.last_state()
    assert sum(1 for _t, pc in last.s if pc == 3) != last.i, last
    _same_as_cpu("Increment(3)", inc, lambda: Increment(3), spawn)
    log(f"  Increment(3): fin violated by a path of {len(path.into_actions())} actions, "
        f"replayed on the host: {path.encode()}")

    import torch

    class Full(Increment):
        def properties(self):
            return [Property.always("true", lambda _m, _s: True)]

        def packed_conditions(self):
            return [lambda st: torch.ones(st["i"].shape[0], dtype=torch.bool,
                                          device=st["i"].device)]

    for make, unique in ((lambda: Full(3), 84), (lambda: IncrementLock(2), 17)):
        for wave_kernel in ("staged", "fused"):
            c = make().checker().spawn_gpu_bfs(wave_kernel=wave_kernel, **spawn).join()
            assert c.worker_error() is None, c.worker_error()
            assert c.unique_state_count() == unique, (wave_kernel, c.unique_state_count())
            if wave_kernel == "fused":
                assert c.keys_route == "fold", c.keys_route
            log(f"  {type(make()).__name__} ({wave_kernel}): unique={c.unique_state_count()} "
                f"states={c.state_count()} depth={c.max_depth()} keys_route={c.keys_route}")
    sym = _drive_symmetry("Increment(2), full", lambda: Full(2), spawn)[2]
    assert sym["unique"] == 8, sym["unique"]
    return run


@phase("symmetry_raft3_dup")
def symmetry_raft3_dup():
    """Raft, 3 servers, ``max_term=1``, lossy, unordered duplicating network,
    with ``.symmetry()``: 464 orbits, ``leader elected`` and ``stable
    leader`` found, wave at a time and drained, equal to the CPU twin."""
    from stateright_tpu_torch.actor.network import Network
    from stateright_tpu_torch.models.raft import RaftModelCfg

    def make():
        return RaftModelCfg(server_count=3, max_term=1, lossy=True,
                            network=Network.new_unordered_duplicating()).into_model()

    runs = {}
    for mode, options in (("wave", dict(max_drain_waves=1)), ("drain", {})):
        spawn = dict(frontier_capacity=256, table_capacity=1 << 12, **options)
        model, checker, run = _drive_symmetry(f"raft3 dup {mode}", make, spawn)
        assert run["unique"] == 464, run["unique"]
        found = checker.discoveries()
        assert set(found) == {"leader elected", "stable leader"}, set(found)
        _stuck_without_leader(model, found["stable leader"])
        _same_as_cpu(f"raft3 dup {mode}", checker, make, spawn)
        runs[mode] = run
    runs["drain"]["key_stage"] = _key_stage_ms("raft3 dup", _spy_widest_take(make, spawn))
    return runs


@phase("symmetry_raft5_ttc")
def symmetry_raft5_ttc(unreduced):
    """The ``raft5_ttc`` configuration (5 servers, lossy, only ``stable
    leader``; B = 256,000 lanes) with ``.symmetry()`` on the staged engine:
    ``stable leader`` found and its path replayed on the host; ``ttc_s``,
    the unique count at the exit and the fallback exits beside the
    unreduced staged run of this call; and the key stage's device ms a
    wave on the widest take of a drain."""
    cfg = _config("raft5_ttc")
    model, checker, run = _drive_symmetry("raft5_ttc", cfg.make, cfg.spawn)
    found = checker.discoveries()
    assert set(found) == {"stable leader"}, set(found)
    steps = _stuck_without_leader(model, found["stable leader"])
    run["ttc_s"] = run["wall_s"]
    run["key_stage"] = _key_stage_ms("raft5", _spy_widest_take(cfg.make, cfg.spawn))
    base = {k: unreduced[k] for k in ("ttc_s", "unique", "drains", "exits",
                                       "peak_device_bytes", "capture_s")}
    log(f"  raft5 (staged, symmetry): ttc_s={run['ttc_s']:.3f} unique at exit={run['unique']} "
        f"fallback_exits={run['fallback_exits']} fallback_lanes={run['fallback_lanes']}; "
        f"stable leader path of {steps} actions replayed on the host; the unreduced staged "
        f"run of this call: ttc_s={base['ttc_s']:.3f} unique at exit={base['unique']}")
    log(json.dumps({"raft5_symmetry_within_call": {
        "symmetry": {k: run[k] for k in ("ttc_s", "unique", "waves", "drains", "exits",
                                          "fallback_exits", "fallback_lanes",
                                          "graph_captures", "capture_s",
                                          "peak_device_bytes", "launches", "key_stage")},
        "unreduced_staged": base}}))
    return run


@phase("symmetry_drain_vs_cpu")
def symmetry_drain_vs_cpu():
    """2pc-5 with a refine hook that says nothing: every wave with an
    unverified lane stops its captured drain ("orbit fallback") and the host
    runs it with the orbit minimum; counts, depths, exits and paths equal
    the CPU twin's, 314 orbits."""
    import torch

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    class WeakRefine2pc(TwoPhaseSys):
        def packed_refine_colors(self, states, colors):
            return torch.zeros_like(colors)

    spawn = dict(frontier_capacity=64, table_capacity=1 << 14)
    _model, checker, run = _drive_symmetry("2pc-5 weak refine", lambda: WeakRefine2pc(5), spawn)
    assert run["unique"] == 314, run["unique"]
    assert run["fallback_exits"] > 0 and checker.graph_replays > 0, run
    assert checker._sym.fallback_waves == run["fallback_exits"]
    _same_as_cpu("2pc-5 weak refine", checker, lambda: WeakRefine2pc(5), spawn)
    run["key_stage"] = _key_stage_ms("2pc-5 weak refine",
                                     _spy_widest_take(lambda: WeakRefine2pc(5), spawn))
    return run


# The fused chain's kernels by stage (csrc/fused_wave.cu), matched in this
# order; a memset belongs to the stage of the kernel after it. The device
# operations before the chain's first kernel are ``keys_input``'s (an
# earlier checkout's fold route built its words matrix there with torch
# kernels). The coverage epilogue has no kernel of its own: a device
# operation of no stage (the former coverage_kernel among them) raises.
# -- 7. the host engines, the default engine and the lasso pass -------------


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _raft3_stable_leader():
    from stateright_tpu_torch.models.raft import RaftModelCfg

    return (RaftModelCfg(server_count=3, max_term=1, lossy=True).into_model()
            .retain_properties("stable leader"))


@phase("host_engines_and_lasso")
def host_engines_and_lasso(drains):
    """The host engines (the JAX package's, copied) and the GPU checker's
    default engine on 2pc-5 (8,832 each; DFS with the reference's symmetry
    heuristic 665); 2pc-8 through ``spawn_gpu_bfs()`` with no
    ``wave_kernel``, which must resolve to the fused engine and count
    1,745,408 with every kernel count set to 0 just before it and read just
    after; and ``complete_liveness()`` on the card for the cycler and for
    raft-3 lossy "stable leader", each path equal to the CPU twin's with the
    condition false along it."""
    import torch

    from stateright_tpu_torch.core.fingerprint import fingerprint
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.testing import Cycler

    def joined(checker, timeout=300):
        handles = checker.handles()
        for h in handles:
            h.join(timeout)
        assert not any(h.is_alive() for h in handles), "host engine still running"
        assert checker.worker_error() is None, checker.worker_error()
        return checker

    def on_demand():
        c = TwoPhaseSys(5).checker().spawn_on_demand()
        c.run_to_completion()
        return joined(c)

    runs = {
        "bfs_threads4": lambda: joined(TwoPhaseSys(5).checker().threads(4).spawn_bfs()),
        "dfs": lambda: joined(TwoPhaseSys(5).checker().spawn_dfs()),
        "on_demand": on_demand,
        "gpu_default": lambda: TwoPhaseSys(5).checker().spawn_gpu_bfs().join(),
        "dfs_symmetry": lambda: joined(TwoPhaseSys(5).checker().symmetry().spawn_dfs()),
    }
    out = {}
    for name, run in runs.items():
        checker, wall = _timed(run)
        want = 665 if name == "dfs_symmetry" else 8832
        assert checker.unique_state_count() == want, (name, checker.unique_state_count())
        checker.assert_properties()
        out[name] = {"unique": checker.unique_state_count(),
                     "states": checker.state_count(), "wall_s": wall}
        if name == "gpu_default":
            assert checker.device.type == "cuda" and checker._wave_kernel == "fused"
            out[name]["engine"] = checker._wave_kernel
        log(f"  2pc-5 {name}: {out[name]}")

    default_2pc8 = _drive_2pc8(None)
    assert default_2pc8["engine"] == "fused", default_2pc8["engine"]
    assert default_2pc8["config_notes"][0].startswith("wave_kernel resolved to 'fused'")
    n = default_2pc8["launches"]
    assert n["fused_wave"] >= default_2pc8["waves"] > 0 and n["hashset_insert_sorted"] >= 1, n
    for k in ("state_count", "max_depth", "waves"):
        assert default_2pc8[k] == drains["fused"][k], (k, default_2pc8[k], drains["fused"][k])
    out["gpu_default_2pc8"] = {k: default_2pc8[k] for k in (
        "engine", "wall_s", "waves", "state_count", "drains", "launches")}

    lassos = {}
    for name, make, prop, spawn in (
        ("cycler", Cycler, "three", dict(frontier_capacity=16, table_capacity=2048)),
        ("raft3_lossy", _raft3_stable_leader, "stable leader",
         dict(frontier_capacity=256, table_capacity=1 << 12)),
    ):
        card, wall = _timed(
            lambda: make().checker().complete_liveness().spawn_gpu_bfs(**spawn).join())
        torch.cuda.synchronize()
        cpu = make().checker().complete_liveness().spawn_gpu_bfs(device="cpu", **spawn).join()
        assert card.device.type == "cuda" and card._wave_kernel == "fused"
        path, cpu_path = card.discoveries()[prop], cpu.discoveries()[prop]
        states = path.into_states()
        fps = [fingerprint(s) for s in states]
        assert fps == [fingerprint(s) for s in cpu_path.into_states()], name
        model, p = card.model(), card.model().property(prop)
        assert not any(p.condition(model, s) for s in states), name
        assert card.liveness_report() == cpu.liveness_report() == {"mode": "host_pass"}
        assert card.unique_state_count() == cpu.unique_state_count()
        lassos[name] = {"unique": card.unique_state_count(), "path_len": len(states),
                        "lasso": states[-1] in states[:-1], "wall_s": wall}
        log(f"  complete_liveness {name}: {lassos[name]}")
    assert lassos["cycler"]["lasso"]
    out["complete_liveness"] = lassos
    log(json.dumps({"host_engines_and_lasso": out}))
    return out


def _tiering_checkers():
    """Subclasses of the GPU checker that stop a run deterministically from
    its worker (after its ``after``-th drain) or copy its checkpoint file
    aside after the ``copy_after``-th write."""
    import shutil

    from stateright_tpu_torch.checker.gpu import GpuBfsChecker

    class PreemptAfterDrain(GpuBfsChecker):
        def __init__(self, *a, after, **kw):
            self._after = after
            super().__init__(*a, **kw)

        def _deep_drain(self, *a):
            out = super()._deep_drain(*a)
            if self.drains == self._after:
                self.request_preempt()
            return out

    class CopyAside(GpuBfsChecker):
        def __init__(self, *a, copy_after, copy_to, **kw):
            self._copy = (copy_after, copy_to)
            super().__init__(*a, **kw)

        def save_checkpoint(self, path, queue, drain=None):
            super().save_checkpoint(path, queue, drain)
            if self.checkpoints_written == self._copy[0]:
                shutil.copyfile(path, self._copy[1])

    return PreemptAfterDrain, CopyAside


def _golden(checker):
    import io
    import re

    from stateright_tpu_torch import WriteReporter

    out = io.StringIO()
    checker.report(WriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


def _golden_text(text):
    import re

    return re.sub(r"sec=\d+", "sec=_", text)


def _same_run(label, got, want, golden=True):
    """Holds a resumed or budgeted run to the reference run: counts, depth,
    discovery fingerprints and (``golden``) the report lines."""
    assert got.worker_error() is None, (label, got.worker_error())
    for k in ("unique_state_count", "state_count", "max_depth"):
        assert getattr(got, k)() == getattr(want, k)(), (label, k, getattr(got, k)(),
                                                         getattr(want, k)())
    assert got._discoveries_fp == want._discoveries_fp, label
    if golden:
        assert _golden(got) == _golden(want), label


def _joined(checker):
    for h in checker.handles():
        h.join()
    assert checker.worker_error() is None, checker.worker_error()
    return checker


def _ledger_line(ledger):
    """A ledger's totals and shares on one line."""
    return {k: ledger[k] for k in ("waves", "drains", "wall_s", "phases_s", "phase_share",
                                   "phase_windows", "gap_s", "gap_share", "overrun_s",
                                   "within_tolerance", "utilization", "overlap_headroom",
                                   "device_split", "outside_wave_s") if k in ledger}


def _check_budget_ledger(checker):
    """The budgeted run's ledger: phases within tolerance of the wall, an
    evict window for each eviction, and a host-probe total that agrees with
    ``host_probe_s`` (the two time the same work: within 5% and 1 ms)."""
    ledger = checker.attribution_report()
    log(json.dumps({"budget_2pc8_ledger": _ledger_line(ledger)}))
    assert ledger["within_tolerance"], ledger
    assert ledger["phase_windows"].get("evict", 0) == checker.evictions, ledger
    probe = ledger["phases_s"].get("host_probe", 0.0)
    assert abs(probe - checker.host_probe_s) <= 0.05 * checker.host_probe_s + 1e-3, (
        probe, checker.host_probe_s)
    assert sum(ledger["probe_length_counts"]) == checker._l0_count


# checkpoint_resume_tiering's settings: a checkpoint every 8 chunks (a
# drain runs at most 8 waves), whose 3rd file is copied aside; the preempt
# after the 3rd drain; a 2 MiB host budget, which spills the runs (L2).
TIERING_EVERY, TIERING_COPY_AFTER, TIERING_PREEMPT_AFTER = 8, 3, 3
TIERING_HOST_BUDGET_MIB = 2.0


def checkpoint_resume_runs(tmp, make, spawn, unique, fps_make, fps_spawn, fps_unique):
    """The checkpoint, preempt, resume and tiering runs of one
    configuration (``make``, ``spawn``) through the default engine on the
    card, each with every kernel count set to 0 just before it and read
    just after (a run's ``launches``): the uncheckpointed reference; a run
    checkpointed every ``TIERING_EVERY`` chunks whose
    ``TIERING_COPY_AFTER``-th file is copied aside; the same run preempted
    after its ``TIERING_PREEMPT_AFTER``-th drain and resumed from the
    payload, and resumed from the copied file; the run at
    ``min_admissible_hbm_budget_mib``, and again with
    ``TIERING_HOST_BUDGET_MIB`` and a spill directory; and a staged
    fingerprint-only run of ``fps_make`` preempted half way and resumed.
    Returns a dict of the runs' records and the preempt payload."""
    import pickle

    import torch

    from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib

    PreemptAfterDrain, CopyAside = _tiering_checkers()
    spawn = dict(spawn, device="cuda")
    out, launches = {}, {}

    def run(name, fn):
        _zero_launches()
        t0 = time.perf_counter()
        checker = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = n = _read_launches()
        assert checker.worker_error() is None, (name, checker.worker_error())
        assert checker.device.type == "cuda", (name, checker.device)
        # Every wave went through the engine's kernels, and the insert
        # kernel seeded, rehashed or rebuilt the table.
        if checker._wave_kernel == "fused":
            _check_sort_gather_launches(n)
            assert n["fused_wave"] >= checker.waves > 0, (name, n)
        else:
            assert n["fused_wave"] == 0 and n["hashset_insert_sorted"] >= checker.waves > 0
        assert n["hashset_insert_sorted"] >= 1, (name, n)
        rec = {"wall_s": wall, "unique": checker.unique_state_count(),
               "states": checker.state_count(), "depth": checker.max_depth(),
               "engine": checker._wave_kernel, "waves": checker.waves,
               "drains": checker.drains, "noop_waves": checker.noop_waves,
               "checkpoints_written": checker.checkpoints_written,
               "checkpoint_s": checker.checkpoint_s, "checkpoint_bytes": checker.checkpoint_bytes,
               "evictions": checker.evictions, "storage_fps": checker.storage_fps,
               "host_probe_s": checker.host_probe_s, "stale_lanes": checker.stale_lanes,
               "handoff_wave": checker.handoff_wave,
               "restore_inserts": checker.restore_inserts, "launches": launches[name]}
        if checker._tier is not None:
            st = checker._tier.instruments.bench_stats()
            rec.update(l1_runs=len(checker._tier.l1), l2_runs=len(checker._tier.l2),
                       spills=st["spills"], merges=st["merges"],
                       probe_hits_l2=st["probe_hits_l2"])
        if checker.handoff_wave is not None:
            rec["waves_after_handoff"] = checker.waves - checker.handoff_wave
        ledger = checker.attribution_report()
        if ledger is not None:
            rec["attribution"] = ledger
        out[name] = rec
        log(f"  {name}: {rec}")
        return checker

    ref = run("reference", lambda: make().checker().spawn_gpu_bfs(**spawn).join())
    assert ref.unique_state_count() == unique, ref.unique_state_count()

    # (a) checkpointed; one file is kept aside.
    ckpt, aside = os.path.join(tmp, "run.ckpt"), os.path.join(tmp, "aside.ckpt")
    ck_spawn = dict(spawn, checkpoint_path=ckpt, checkpoint_every_chunks=TIERING_EVERY)
    ckd = run("checkpointed", lambda: _joined(CopyAside(
        make().checker(), copy_after=TIERING_COPY_AFTER, copy_to=aside, **ck_spawn)))
    assert ckd.unique_state_count() == unique
    assert ckd.checkpoints_written >= TIERING_COPY_AFTER and os.path.exists(aside)
    _same_run("checkpointed", ckd, ref, golden=False)

    # (b) preempted, resumed from the payload and from the checkpoint
    # copied aside: bit-identical to (a).
    first = run("preempted", lambda: _joined(PreemptAfterDrain(
        make().checker(), after=TIERING_PREEMPT_AFTER, **ck_spawn)))
    assert first.preempted and first.drains == TIERING_PREEMPT_AFTER
    payload = first.preempt_payload()
    assert payload["version"] == 2 and payload["kind"] == "gpu_bfs"
    resumed = run("resumed_payload", lambda: make().checker().spawn_gpu_bfs(
        resume_from=payload, **ck_spawn).join())
    _same_run("resumed_payload", resumed, ckd)
    with open(aside, "rb") as f:
        assert pickle.load(f)["unique_count"] < unique
    from_file = run("resumed_file", lambda: make().checker().spawn_gpu_bfs(
        resume_from=aside, **dict(ck_spawn, checkpoint_path=os.path.join(tmp, "r2.ckpt")))
        .join())
    _same_run("resumed_file", from_file, ckd)

    # (c) at the smallest admissible budget, then with a host budget that
    # spills the runs to disk.
    # The budgeted run is attributed: its ledger splits the wall into the
    # wave kernel, the host probe, the evictions and the gap.
    budget = min_admissible_hbm_budget_mib(make(), spawn["frontier_capacity"])
    out["budget_mib"] = budget
    bounded = run("budget", lambda: make().checker().spawn_gpu_bfs(
        hbm_budget_mib=budget, attribution=True, **spawn).join())
    _same_run("budget", bounded, ref, golden=False)
    assert bounded.evictions >= 2 and bounded.handoff_wave is not None
    _check_budget_ledger(bounded)
    spilled = run("budget_spill", lambda: make().checker().spawn_gpu_bfs(
        hbm_budget_mib=budget, host_budget_mib=TIERING_HOST_BUDGET_MIB,
        spill_dir=os.path.join(tmp, "spill"), **spawn).join())
    _same_run("budget_spill", spilled, bounded)
    assert spilled.evictions >= 2 and out["budget_spill"]["spills"] >= 1

    # (e) the fingerprint-only wave, staged, preempted half way.
    fps_spawn = dict(fps_spawn, device="cuda", wave_kernel="staged", expand_fps=True)
    whole = run("fps_reference", lambda: fps_make().checker().spawn_gpu_bfs(
        **fps_spawn).join())
    assert whole._use_fps and whole.unique_state_count() == fps_unique
    half = max(1, whole.drains // 2)
    stop = run("fps_preempted", lambda: _joined(PreemptAfterDrain(
        fps_make().checker(), after=half, **fps_spawn)))
    assert stop.preempted
    back = run("fps_resumed", lambda: fps_make().checker().spawn_gpu_bfs(
        resume_from=stop.preempt_payload(), **fps_spawn).join())
    _same_run("fps_resumed", back, whole)
    out["launches"] = launches
    return out, payload


@phase("checkpoint_resume_tiering")
def checkpoint_resume_tiering():
    """2pc-8 (1,745,408) through the default (fused) engine: checkpointed
    every 8 chunks, preempted after its third drain and resumed from the
    payload and from a checkpoint file copied aside mid-run (bit-identical
    to the checkpointed run, golden report included), and at the smallest
    admissible ``hbm_budget_mib`` (a 2^20-row table cap: evictions, the
    handoff to the wave path, the host probe), again with a 2 MiB host
    budget and a spill directory (L2); abd3o (46,516) staged with the
    fingerprint-only wave, preempted half way and resumed; then the insert
    kernel rebuilding the preempted 2pc-8 run's table from its payload (as
    the restore does) against its plain twin, bit for bit, timed."""
    import tempfile

    import numpy as np

    from stateright_tpu_torch.checker.gpu import sorted_key_halves

    cfg, abd = _config("2pc8"), _config("abd3o")
    with tempfile.TemporaryDirectory() as tmp:
        runs, payload = checkpoint_resume_runs(
            tmp, cfg.make, cfg.spawn, cfg.unique, fps_make=abd.make, fps_spawn=abd.spawn,
            fps_unique=abd.unique)
    # (d) the restore's insert: the payload's keys, sorted, into an empty
    # table of the restored capacity.
    khi, klo = sorted_key_halves(payload["children"], "cpu")
    hi, lo = khi.numpy().view(np.uint32), klo.numpy().view(np.uint32)
    cap = max(cfg.spawn["table_capacity"], payload["capacity"])
    empty = np.zeros((cap + 128, 2), np.uint32)
    active = np.ones(hi.shape[0], bool)
    res = _compare_insert(empty, hi, lo, active, timing=True)
    assert res["err"] == 0 and res["after"].any(), res["err"]
    bound_ms = _bd().insert_must_move(res["after"], hi, lo, active, res["fresh"]) \
        / HBM_BYTES_PER_S * 1e3
    runs["restore_insert"] = {"keys": int(hi.shape[0]), "capacity": cap,
                              "max_abs_err": res["err"], "ms": res["ms"],
                              "plain_ms": res["plain_ms"], "bound_ms": bound_ms,
                              "bound_by": "bytes", "library_ms": None}
    log(json.dumps({"checkpoint_resume_tiering": {
        k: ({kk: vv for kk, vv in v.items() if kk != "launches"} if isinstance(v, dict) else v)
        for k, v in runs.items()}}))
    return runs


# -- 8. attribution and the per-stage breakdown ------------------------------


def _run_record(checker, wall, launches):
    return {"unique": checker.unique_state_count(), "states": checker.state_count(),
            "depth": checker.max_depth(), "digest": checker.state_digest(), "wall_s": wall,
            "launches": launches, "waves": checker.waves, "drains": checker.drains,
            "rungs": {str(k): v for k, v in checker.rungs.items()},
            "exits": dict(checker.drain_exits), "graph_captures": checker.graph_captures,
            "noop_waves": checker.noop_waves, "resident_keys": checker._l0_count}


def attributed_runs(config="2pc8", device="cuda"):
    """The configuration's run through the default engine without
    attribution, then with an engine built with ``profile_dir`` in a
    temporary directory (``torch.profiler`` over its first two windows), each
    with every kernel count set to 0 just before and read just after.
    Returns both runs' records, the second with its ledger."""
    import tempfile

    import torch

    from stateright_tpu_torch.telemetry import WaveAttribution

    cfg = _config(config)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("unattributed", "attributed"):
            attr = (WaveAttribution("gpu_bfs", profile_dir=tmp, profile_waves=2)
                    if name == "attributed" else False)
            _zero_launches()
            t0 = time.perf_counter()
            checker = cfg.make().checker().spawn_gpu_bfs(
                **dict(cfg.spawn, device=device, attribution=attr)).join()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert checker.worker_error() is None, (name, checker.worker_error())
            out[name] = _run_record(checker, wall, _read_launches())
            if attr:
                out[name]["ledger"] = checker.attribution_report()
    return out


def _attributed_child(path):
    """``attributed_runs()`` in a process of its own (its profiler session
    is the process's first), written to ``path`` as JSON."""
    runs = attributed_runs()
    with open(path, "w") as f:
        json.dump(runs, f)
    return 0


@phase("attribution_and_breakdown")
def attribution_and_breakdown():
    """2pc-8 through the default (fused) engine attributed, beside the same
    run unattributed, in a process of its own so that its ``torch.profiler``
    window is the process's first: the same 1,745,408 states and state
    digests, waves, drains, rungs, exits and graph captures; the ledger
    within tolerance, a ``compile`` window for each graph captured, a
    device split parsed from the profile, and probe-length counts that sum
    to the resident keys. Then ``measure_wave_breakdown`` of 2pc-8 and
    paxos3 on the fused engine at their configurations' widths, each
    roofline attainment at most 1.05. (The budgeted 2pc-8 run of
    ``checkpoint_resume_tiering`` is attributed too; its ledger is printed
    there.)"""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "runs.json")
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--attributed-child", path],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if child.returncode:
            raise AssertionError(f"the attributed runs' process failed ({child.returncode}):\n"
                                 f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
        with open(path) as f:
            runs = json.load(f)
    off, on = runs["unattributed"], runs["attributed"]
    ledger = on.pop("ledger")
    unique = _config("2pc8").unique
    log(json.dumps({"attributed_2pc8": {"unattributed": off, "attributed": on}}))
    log(json.dumps({"attributed_2pc8_ledger": _ledger_line(ledger)}))
    assert off["unique"] == on["unique"] == unique, (off["unique"], on["unique"])
    assert off["digest"] == on["digest"], (off["digest"], on["digest"])
    for k in ("states", "depth", "waves", "drains", "rungs", "exits", "graph_captures"):
        assert off[k] == on[k], (k, off[k], on[k])
    assert ledger["within_tolerance"], ledger
    assert ledger["drains"] == on["drains"], (ledger["drains"], on["drains"])
    assert ledger["phase_windows"].get("compile", 0) == on["graph_captures"] > 0, (
        ledger["phase_windows"], on["graph_captures"])
    assert ledger["device_split"] is not None, "the profiler window recorded no device interval"
    assert sum(ledger["probe_length_counts"]) == on["resident_keys"] == unique

    from stateright_tpu_torch.checker.breakdown import measure_wave_breakdown

    breakdown = {}
    for name in ("2pc8", "paxos3"):
        cfg = _config(name)
        t0 = time.perf_counter()
        rec = measure_wave_breakdown(
            cfg.make(), frontier_capacity=cfg.spawn["frontier_capacity"],
            table_capacity=cfg.spawn["table_capacity"], wave_kernel="fused")
        rec["seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        log(json.dumps({"wave_breakdown": {"config": name, **rec}}))
        assert rec["hbm_roofline_attainment"] is not None, rec["device_kind"]
        assert rec["hbm_roofline_attainment"] <= 1.05, rec["hbm_roofline_attainment"]
        breakdown[name] = rec
    return {"runs": runs, "ledger": ledger, "breakdown": breakdown}


# -- 9. device random walks: simulation and swarm ------------------------------

# The JAX bench's deep sharded-KV swarm figures (BENCH_r15.json, an older JAX
# on a CPU), printed beside the port's for comparison only; JAX 0.9.0 on a
# CPU walks the port's walks (tests/test_torch_swarm_parity.py).
BENCH_R15_DEEP_KV = {"walk_steps": 22_528, "unique_sample": 2_049, "trail": 22}
SWARM_THROUGHPUT_STEPS = 1_048_576


@contextlib.contextmanager
def _one_cpu_thread():
    """The CPU twins' steps are many small operations, which the intra-op
    thread pool only slows down."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _walk_result(ck):
    """What a swarm run's determinism covers (the JAX tests'
    ``_fingerprint_result``) and the engine's stats."""
    return (ck.state_count(), ck.unique_state_count(), ck.max_depth(),
            dict(ck._discoveries_fps), ck.coverage_estimate()["saturated"],
            ck.engine.tenant_stats(0))


def _swarm_line(name, ck, wall, launches, device):
    eng = ck.engine
    rec = {"name": name, "device": device, "walk_steps": ck.state_count(),
           "unique_sample": ck.unique_state_count(),
           "saturated": ck.coverage_estimate()["saturated"], "max_depth": ck.max_depth(),
           "trails": {k: len(v) for k, v in eng.tenant_discoveries_fps(0)[0].items()},
           "waves": eng._wave_calls, "wall_s": wall, "warmup_s": ck.warmup_seconds,
           "graph_captures": eng.graph_captures, "capture_s": eng.capture_s,
           "insert_launches": launches}
    log(json.dumps({"swarm_run": rec}))
    return rec


def _swarm(name, builder, device, poll=None, preempt_after_first=False, **spawn):
    """One swarm run on ``device``: its checker, wall and insert launches.
    ``poll(ck)`` true preempts the run (polled every 20 ms); with
    ``preempt_after_first`` the run stops at its first wave boundary."""
    import torch

    from stateright_tpu_torch.ops import hashset_kernel as hk

    _zero_launches()
    ctx = _one_cpu_thread() if device == "cpu" else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        ck = builder.spawn_swarm(device=device, **spawn)
        if preempt_after_first:
            ck.request_preempt()
        while poll is not None and not ck.is_done():
            if poll(ck):
                ck.request_preempt()
                break
            time.sleep(0.02)
        ck.join()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = hk.launches if device == "cuda" else 0
    assert device == "cpu" or launches > 0, name
    _swarm_line(name, ck, wall, launches, device)
    return ck, wall, launches


def _same_slot(a, b, where=""):
    import numpy as np

    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_slot(a[k], b[k], f"{where}.{k}")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), where


def _ops_in_a_step(model, **spawn):
    """The torch operations dispatched in one step of the swarm (the work
    one captured step replays), and the threefry draws' share of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from stateright_tpu_torch.checker.swarm import SwarmEngine
    from stateright_tpu_torch.ops import threefry

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    eng = SwarmEngine(model, device="cuda", **spawn)
    eng.write_slot(0, eng.fresh_tenant_carry(1, target=1 << 30))
    with Count():
        eng._k._tenant_step(eng._carry)
    step_ops = Count.n
    Count.n = 0
    with Count():
        threefry.draw_step(eng._carry["lanes"]["key"][0], eng._n_seeds, eng._A)
    return {"ops_a_step": step_ops, "threefry_ops": Count.n}


def _insert_on_swarm_step(ck):
    """``hashset_insert_sorted`` against its plain twin on one sample step
    of a swarm run, as ``hashset_insert_unsorted`` hands it over: the
    fingerprints of the run's 1,024 lanes, sorted, the first copy of each
    key active, into the run's sample table; its median time and bound."""
    import numpy as np
    import torch

    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.ops.hashset_kernel import sort_key, split_key

    eng = ck.engine
    hi, lo = eng._model.packed_fingerprint(map_leaves(lambda x: x[0],
                                                      eng._carry["lanes"]["state"]))
    skey, _ = torch.sort(sort_key(hi, lo), stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    shi, slo = split_key(skey)
    hi, lo = (x.cpu().numpy().astype(np.uint32) for x in (shi, slo))
    active = first.cpu().numpy()
    r = _compare_insert(table_to_numpy(eng._carry["table"][0]), hi, lo, active, timing=True)
    moved = _bd().insert_must_move(r["after"], hi, lo, active, r["fresh"])
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  hashset_insert_sorted (swarm sample step): B={hi.shape[0]} "
        f"active={int(active.sum())} fresh={int(r['fresh'].sum())} max_abs_err={r['err']} "
        f"median {r['ms']:.4f} ms plain={r['plain_ms']:.1f} ms (host CPU) "
        f"bound={bound_ms:.6f} ms ({moved} B)")
    if r["err"]:
        raise AssertionError("hashset_insert_sorted and its plain twin disagree on the "
                             "swarm's sample step")
    return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms}


@phase("simulation_and_swarm")
def simulation_and_swarm():
    """The device walkers on the card, each run against its CPU twin: the
    JAX bench's swarm leg (deep sharded KV, raft-3 check-live, the 2pc-3
    witness hunt) at its full widths, a throughput run of the guarded
    sharded KV to 2^20 walk steps with a preempt and resume, the
    simulation checker, and two packed tenants. Returns the insert
    kernel's launches by path and the throughput record."""
    import torch

    from stateright_tpu_torch.checker.swarm import SwarmPackedEngine
    from stateright_tpu_torch.configs import SWARM_CONFIGS
    from stateright_tpu_torch.models.sharded_kv import ShardedKv
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import hashset_kernel as hk

    launches, out = {}, {}

    # 1. The deep sharded KV: "no total tear" at depth >= 16.
    cfg = SWARM_CONFIGS["skv483_deep"]
    card, wall, launches["swarm_skv483_deep"] = _swarm(
        "skv483_deep", cfg.builder(), "cuda", **cfg.spawn)
    cpu, _, _ = _swarm("skv483_deep", cfg.builder(), "cpu", **cfg.spawn)
    assert _walk_result(card) == _walk_result(cpu)
    path = card.discoveries()["no total tear"]
    assert all(path.last_state().torn), path.last_state()
    out["insert"] = _insert_on_swarm_step(card)
    log(json.dumps({"swarm_deep_kv": {
        "walk_steps": card.state_count(), "unique_sample": card.unique_state_count(),
        "trail": len(card._discoveries_fps["no total tear"]), "ttfv_s": wall,
        "jax_bench_r15_for_comparison": BENCH_R15_DEEP_KV}}))

    # 2. Raft-3 check-live: a leaderless cycle for "stable leader".
    cfg = SWARM_CONFIGS["raft3_live"]
    card, _, launches["swarm_raft3_live"] = _swarm("raft3_live", cfg.builder(), "cuda",
                                                   **cfg.spawn)
    cpu, _, _ = _swarm("raft3_live", cfg.builder(), "cpu", **cfg.spawn)
    assert _walk_result(card) == _walk_result(cpu)
    assert "stable leader" in card.discoveries()

    # 3. The 2pc-3 witness hunt, polled until both witnesses land.
    cfg = SWARM_CONFIGS["2pc3_witness"]
    both = {"abort agreement", "commit agreement"}
    trails = {}
    for device in ("cuda", "cpu"):
        ck, _, n = _swarm("2pc3_witness", cfg.builder(), device,
                          poll=lambda c: both <= set(c._discovery_names()), **cfg.spawn)
        trails[device] = ck.engine.tenant_discoveries_fps(0)[0]
        if device == "cuda":
            launches["swarm_2pc3_witness"] = n
    assert set(trails["cuda"]) == both and trails["cuda"] == trails["cpu"]

    # 4. Throughput: the guarded sharded KV (the property holds, so walks
    # run to the target), with a preempt after the first wave and a resume.
    def guarded():
        return ShardedKv(4, 8, 3, guarded=True, retain=("no total tear",)).checker() \
            .target_state_count(SWARM_THROUGHPUT_STEPS)

    spawn = dict(SWARM_CONFIGS["skv483_deep"].spawn)
    peak = {}

    def whole():
        peak["ck"] = _swarm("skv483_guarded_throughput", guarded(), "cuda", **spawn)

    peak["bytes"] = _peak_bytes(whole)
    full, wall, launches["swarm_throughput"] = peak["ck"]
    first = {}
    for device in ("cuda", "cpu"):
        ck, _, n = _swarm("skv483_guarded_first_wave", guarded(), device,
                          preempt_after_first=True, **spawn)
        assert ck.preempted
        first[device] = ck.preempt_payload()
        if device == "cuda":
            launches["swarm_throughput_first_wave"] = n
    _same_slot(first["cuda"]["swarm"]["slot"], first["cpu"]["swarm"]["slot"], "first wave")
    resumed, _, launches["swarm_throughput_resumed"] = _swarm(
        "skv483_guarded_resumed", guarded(), "cuda", resume_from=first["cuda"], **spawn)
    assert _walk_result(resumed) == _walk_result(full)
    _same_slot(resumed.engine.read_slot(0), full.engine.read_slot(0), "resumed")
    # A wave's device time: the replays of a captured step, CUDA events.
    from stateright_tpu_torch.checker.swarm import SwarmEngine

    eng = SwarmEngine(guarded().model, device="cuda", **{
        k: v for k, v in spawn.items() if k != "seed"})
    eng.write_slot(0, eng.fresh_tenant_carry(spawn["seed"], target=1 << 30))
    eng.run_wave()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    wave_ms = []
    for _ in range(3):
        ev[0].record()
        eng._graph.run(eng._K)
        ev[1].record()
        torch.cuda.synchronize()
        wave_ms.append(ev[0].elapsed_time(ev[1]))
    hk.launches = 0
    ops = _ops_in_a_step(guarded().model, **{k: v for k, v in spawn.items() if k != "seed"})
    out["throughput"] = {
        "walk_steps": full.state_count(), "walk_steps_per_s": full.state_count() / wall,
        "waves": full.engine._wave_calls, "wall_s": wall, "warmup_s": full.warmup_seconds,
        "capture_s": full.engine.capture_s, "wave_device_ms": wave_ms,
        "step_device_ms": [m / eng._K for m in wave_ms], "peak_device_bytes": peak["bytes"],
        **ops}
    log(json.dumps({"swarm_throughput": out["throughput"]}))

    # 5. The simulation checker: equal to the CPU twin, then timed.
    def sim(target, device):
        _zero_launches()
        ctx = _one_cpu_thread() if device == "cpu" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            ck = (TwoPhaseSys(3).checker().target_state_count(target)
                  .spawn_gpu_simulation(seed=7, lanes=1024, steps_per_call=64,
                                        device=device).join())
            wall = time.perf_counter() - t0
        rec = {"name": f"gpu_simulation_2pc3_{target}", "device": device,
               "walk_steps": ck.state_count(), "max_depth": ck.max_depth(),
               "trails": {k: len(v) for k, v in ck._discoveries_fps.items()},
               "trace_overflows": ck._trace_overflows, "wall_s": wall,
               "graph_captures": ck.graph_captures, "graph_replays": ck.graph_replays,
               "insert_launches": hk.launches}
        log(json.dumps({"swarm_run": rec}))
        return ck, rec

    card, _ = sim(200_000, "cuda")
    cpu, _ = sim(200_000, "cpu")
    assert ((card.state_count(), card.max_depth(), card._trace_overflows,
             card._discoveries_fps) == (cpu.state_count(), cpu.max_depth(),
                                        cpu._trace_overflows, cpu._discoveries_fps))
    _card, out["simulation"] = sim(1_000_000, "cuda")

    # 6. Two packed tenants, each equal to its solo card run.
    knobs = dict(lanes=1024, wave_steps=64, max_trace_len=64, sample_capacity=1 << 15,
                 sample_stride=4)
    _zero_launches()
    pack = SwarmPackedEngine(TwoPhaseSys(3), max_tenants=2, device="cuda", **knobs)
    views = {seed: pack.admit(f"t{seed}", seed=seed, target_state_count=200_000)
             for seed in (11, 12)}
    done = set()
    t0 = time.perf_counter()
    while len(done) < 2:
        done |= set(pack.step())
    torch.cuda.synchronize()
    launches["swarm_packed_2pc3"] = hk.launches
    log(json.dumps({"swarm_run": {"name": "packed_2pc3", "device": "cuda",
                                  "tenants": 2, "waves": pack.engine._wave_calls,
                                  "wall_s": time.perf_counter() - t0,
                                  "insert_launches": hk.launches}}))
    for seed, view in views.items():
        solo, _, launches[f"swarm_solo_2pc3_seed{seed}"] = _swarm(
            f"solo_2pc3_seed{seed}", TwoPhaseSys(3).checker().target_state_count(200_000),
            "cuda", seed=seed, **knobs)
        assert (view.state_count(), view.unique_state_count(), view.max_depth(),
                view._fps) == (solo.state_count(), solo.unique_state_count(),
                               solo.max_depth(), solo._discoveries_fps), seed
    out["launches"] = launches
    return out


# -- 10. device liveness -------------------------------------------------------------

# ``level_dag_2p20`` follows from its definition (``configs.LevelDag``, W =
# 2^20, L = 20): levels 0..20 of min(2^k, W) states; levels 0..19 fail the
# condition; each state of levels 0..18 has 2 condition-false children.
LEVEL_DAG_2P20 = {"states": 2_097_151, "nodes": 1_048_575, "edges": 1_048_574,
                  "verdict": "absent", "survivors": 0}


def _liveness_record(name, checker, wall, launches, peak):
    """One ``{"liveness_run": ...}`` record: counts, waves, drains and exits,
    the edge store and each verdict's record, the wall and peak bytes."""
    rep = checker.liveness_report()
    return {"name": name, "device": checker.device.type, "unique": checker.unique_state_count(),
            "states": checker.state_count(), "depth": checker.max_depth(),
            "engine": checker._wave_kernel, "waves": checker.waves, "drains": checker.drains,
            "exits": dict(checker.drain_exits), "noop_waves": checker.noop_waves,
            "graph_replays": checker.graph_replays, "edge_store": rep.get("edge_store"),
            "outcomes": rep.get("outcomes"), "discoveries": sorted(checker.discoveries()),
            "wall_s": wall, "peak_device_bytes": peak, "insert_launches": launches}


def _same_liveness(label, card, cpu):
    """A card run held to its CPU twin: counts, drains and exits, the edge
    store's statistics and relation, each outcome record (its seconds
    aside) and each certificate, state for state by fingerprint."""
    import numpy as np

    from stateright_tpu_torch.core.fingerprint import fingerprint

    assert card.worker_error() is None and cpu.worker_error() is None, label
    for k in ("unique_state_count", "state_count", "max_depth"):
        assert getattr(card, k)() == getattr(cpu, k)(), (label, k)
    assert (card.drains, card.drain_exits) == (cpu.drains, cpu.drain_exits), label
    assert card._live_store.stats() == cpu._live_store.stats(), label
    np.testing.assert_array_equal(card._live_store.edge_rows(), cpu._live_store.edge_rows())

    def records(ck):
        return {k: {f: v for f, v in r.items() if f != "seconds"}
                for k, r in ck.liveness_report()["outcomes"].items()}

    assert records(card) == records(cpu), label
    got = {k: [fingerprint(s) for s in p.into_states()] for k, p in card.discoveries().items()}
    want = {k: [fingerprint(s) for s in p.into_states()] for k, p in cpu.discoveries().items()}
    assert got == want, label


def _analysis_split(checker):
    """Where an absence analysis' seconds go, its steps timed apart on the
    checker's store: the deduped relation (``edge_rows``), the property's
    slice and the node index on the host (``np.unique``,
    ``np.searchsorted``), and the trim on the card."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.edge_store import lasso_trim

    store, t = checker._live_store, {}
    t0 = time.perf_counter()
    rows = store.edge_rows()
    t["edge_rows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    src64, dst64, roots64, terms64 = store.property_slice(0, rows=rows)
    nodes = np.unique(np.concatenate([roots64, terms64, src64, dst64]))
    src, dst = np.searchsorted(nodes, src64), np.searchsorted(nodes, dst64)
    t["slice_and_index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    alive, rounds = lasso_trim(src, dst, np.ones(len(src), bool), np.ones(len(nodes), bool),
                               device=checker.device)
    torch.cuda.synchronize()
    t["trim_s"] = time.perf_counter() - t0
    t.update(trim_rounds=rounds, survivors=int(alive.sum()))
    return t


@phase("device_liveness")
def device_liveness():
    """``liveness="device"`` on the card (the staged engine, its insert
    kernel, the edge log appended inside the captured drain, the trim and
    reach on the card), each run against its CPU twin in this call, but
    ``level_dag_2p20``, held to ``LEVEL_DAG_2P20``: raft-3 check-live;
    the ``LevelDag`` absence certificate with the analysis re-run warm and
    the host post-pass timed on the same region; ``level_dag_2p20``; raft4
    staged with the knob and without it; and the absence run preempted after
    its first drain and resumed from its version 3 payload."""
    import torch

    from stateright_tpu_torch.checker.device_liveness import analyze_liveness
    from stateright_tpu_torch.checker.liveness import find_eventually_lasso
    from stateright_tpu_torch.configs import CONFIGS, LIVENESS_CONFIGS

    out, launches = {}, {}

    def run(name, spawn_fn):
        # Tensors of earlier runs held only by reference cycles are freed
        # now, so that the peak below is this run's own.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        checker = spawn_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = _read_launches()
        assert checker.worker_error() is None, (name, checker.worker_error())
        assert checker.device.type == "cuda" and checker._wave_kernel == "staged", name
        assert n["fused_wave"] == 0 and n["hashset_insert_sorted"] >= checker.waves > 0, (name, n)
        launches[name] = n["hashset_insert_sorted"]
        out[name] = rec = _liveness_record(name, checker, wall, launches[name],
                                           torch.cuda.max_memory_allocated())
        log(json.dumps({"liveness_run": rec}, default=str))
        return checker

    def cpu_twin(cfg):
        return cfg.make().checker().spawn_gpu_bfs(device="cpu", **cfg.spawn).join()

    # raft-3 check-live.
    cfg = LIVENESS_CONFIGS["raft3_check_live"]
    raft3 = run(cfg.name, lambda: cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join())
    assert "stable leader" in raft3.discoveries()
    _same_liveness(cfg.name, raft3, cpu_twin(cfg))

    # The absence certificate: the analysis again, warm, on the same store,
    # and the host post-pass over the same condition-false region.
    cfg = LIVENESS_CONFIGS["level_dag_absence"]
    dag = run(cfg.name, lambda: cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join())
    assert dag.unique_state_count() == cfg.unique
    assert dag._live_outcomes["done"]["verdict"] == "absent"
    _same_liveness(cfg.name, dag, cpu_twin(cfg))
    t0 = time.perf_counter()
    _paths, warm = analyze_liveness(dag.model(), dag.model().properties(), dag._ebit,
                                    dag._live_store, dag._host_fp, set(), device=dag.device)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert warm["done"]["verdict"] == "absent"
    model = cfg.make()
    t0 = time.perf_counter()
    assert find_eventually_lasso(model, model.properties()[0]) is None
    host_s = time.perf_counter() - t0
    out["absence"] = {"analysis_cold_s": dag._live_outcomes["done"]["seconds"],
                      "analysis_warm_s": warm_s, "host_pass_s": host_s,
                      "host_over_warm": host_s / warm_s}
    log(json.dumps({"liveness_absence": out["absence"]}))

    # The same DAG at W = 2^20, held to its analytic figures.
    cfg = LIVENESS_CONFIGS["level_dag_2p20"]
    big = run(cfg.name, lambda: cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join())
    rec = big._live_outcomes["done"]
    got = {"states": big.unique_state_count(), "nodes": rec["nodes"], "edges": rec["edges"],
           "verdict": rec["verdict"], "survivors": rec["survivors"]}
    assert got == LEVEL_DAG_2P20, got
    out["analysis_split_2p20"] = split = _analysis_split(big)
    log(json.dumps({"liveness_analysis_split": {"name": cfg.name, **split}}))

    # raft4, staged, with the knob and without it: the knob adds only the
    # device verdicts.
    cfg = CONFIGS["raft4"]
    spawn = dict(cfg.spawn, wave_kernel="staged", expand_fps=False)
    live4 = run("raft4_live", lambda: cfg.make().checker().spawn_gpu_bfs(
        liveness="device", **spawn).join())
    plain4 = run("raft4_plain", lambda: cfg.make().checker().spawn_gpu_bfs(**spawn).join())
    assert live4.unique_state_count() == plain4.unique_state_count() == cfg.unique
    assert (live4.state_count(), live4.max_depth(), live4.waves) == (
        plain4.state_count(), plain4.max_depth(), plain4.waves)
    assert plain4._discoveries_fp == live4._discoveries_fp
    added = set(live4.discoveries()) - set(plain4.discoveries())
    assert all(live4._live_outcomes[k]["verdict"] == "counterexample" for k in added), added

    # The absence run preempted after its first drain and resumed from its
    # version 3 payload.
    cfg = LIVENESS_CONFIGS["level_dag_absence"]
    PreemptAfterDrain, _copy_aside = _tiering_checkers()
    cut = run("level_dag_absence_preempted", lambda: _joined(PreemptAfterDrain(
        cfg.make().checker(), after=1, device="cuda", **cfg.spawn)))
    payload = cut.preempt_payload()
    assert cut.preempted and payload["version"] == 3 and "liveness" in payload
    resumed = run("level_dag_absence_resumed", lambda: cfg.make().checker().spawn_gpu_bfs(
        resume_from=payload, **cfg.spawn).join())
    assert resumed.unique_state_count() == cfg.unique
    assert resumed._live_outcomes["done"]["verdict"] == "absent"
    assert resumed._live_store.stats()["edges_logged"] >= dag._live_store.stats()["edges_logged"]
    import numpy as np

    np.testing.assert_array_equal(resumed._live_store.edge_rows(), dag._live_store.edge_rows())
    out["launches"] = launches
    return out


# -- tenant packing ---------------------------------------------------------------

UNIQUE_2PC5, UNIQUE_2PC8 = 8_832, 1_745_408


def _pack_drive(eng, views=None, before_step=None, max_steps=100_000):
    """Steps a pack until no tenant is live, calling ``before_step(eng)``
    before each step, releasing the finished; returns ``views``."""
    steps = 0
    while True:
        if before_step is not None:
            before_step(eng)
        if not eng.live_count():
            break
        for key in eng.step():
            eng.release(key)
        steps += 1
        assert steps < max_steps, "packed engine did not converge"
    eng.close()
    return views


def _pack_record(name, eng, views, wall, launches, peak, gc_pauses):
    """One ``{"pack_run": ...}`` record: each tenant's unique count, the
    waves and lanes (occupancy = live / dispatched), the table, the wall and
    the aggregate unique states a second, the host seconds of the waves'
    parts (assembly and upload, the wave to its stats read, the fresh
    prefix's copy, the verdicts, the table's growths) and what else the
    wall holds, the collector's pauses (seconds and collections by
    generation), the insert launches and the peak bytes."""
    unique = {k: v.unique_state_count() for k, v in views.items()}
    rec = {"name": name, "device": eng.device.type, "tenants": len(views), "unique": unique,
           "waves": eng.waves, "lanes_live": eng.lanes_live,
           "lanes_dispatched": eng.lanes_dispatched,
           "occupancy": eng.lanes_live / max(1, eng.lanes_dispatched),
           "table_capacity": eng._capacity, "table_growths": eng.table_growths,
           "evictions": eng.evictions, "wall_s": wall,
           "unique_per_s": sum(unique.values()) / wall, "assemble_s": eng.assemble_s,
           "wave_s": eng.wave_s, "copy_s": eng.copy_s, "verdict_s": eng.verdict_s,
           "grow_s": eng.grow_s,
           "other_s": wall - eng.assemble_s - eng.wave_s - eng.copy_s - eng.verdict_s
           - eng.grow_s, "gc_s": gc_pauses["s"], "gc_collections": gc_pauses["n"],
           "insert_launches": launches, "peak_device_bytes": peak}
    log(json.dumps({"pack_run": rec}))
    return rec


def _same_pack_tenant(label, got, want, golden=True):
    """A card tenant held to its CPU twin: counts, depth, discovery names
    and (``golden``) the report, paths included."""
    for k in ("unique_state_count", "state_count", "max_depth"):
        assert getattr(got, k)() == getattr(want, k)(), (label, k, getattr(got, k)(),
                                                         getattr(want, k)())
    assert sorted(got.discoveries()) == sorted(want.discoveries()), label
    if golden:
        assert _golden(got) == _golden(want), label


# The full-width 2pc-8 pack wave whose insert is held to its plain twin:
# late enough that the shared table is well filled.
PACK_INSERT_WAVE = 64


def _capture_pack_insert(pt, width, nth=PACK_INSERT_WAVE):
    """Wraps the pack's salted insert to keep the inputs of one full-width
    wave (the ``nth``): the table before it, the keys, the salts and the
    valid lanes."""
    real, seen = pt.hashset_insert_salted, {"n": 0}

    def spy(table, hi, lo, salt_hi, salt_lo, active):
        if hi.shape[0] == width and "table" not in seen:
            seen["n"] += 1
            if seen["n"] == nth:
                seen.update(table=table.clone(), args=[x.clone() for x in (
                    hi, lo, salt_hi, salt_lo, active)])
        return real(table, hi, lo, salt_hi, salt_lo, active)

    pt.hashset_insert_salted = spy
    return real, seen


def _insert_on_pack_wave(seen, label="2pc-8 pack wave"):
    """``hashset_insert_sorted`` against its plain twin on one full-width
    2pc-8 pack wave, as ``hashset_insert_salted`` hands it over: the four
    tenants' salted keys, sorted, the first copy of each key active, into
    the pack's shared table; its median time and bound."""
    import torch

    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.ops.fingerprint import salt_keys
    from stateright_tpu_torch.ops.hashset_kernel import sort_key, split_key

    hi, lo, shi, slo, active = seen["args"]
    khi, klo = salt_keys(hi, lo, shi, slo)
    key = torch.where(active, sort_key(khi, klo), torch.full_like(khi, (1 << 63) - 1))
    skey, order = torch.sort(key, stable=True)
    sact = active[order]
    first = torch.ones_like(sact)
    first[1:] = (skey[1:] != skey[:-1]) | (sact[1:] != sact[:-1])
    shi_, slo_ = split_key(skey)
    hi_np, lo_np = (x.cpu().numpy().astype("uint32") for x in (shi_, slo_))
    act_np = (sact & first).cpu().numpy()
    r = _compare_insert(table_to_numpy(seen["table"]), hi_np, lo_np, act_np, timing=True)
    moved = _bd().insert_must_move(r["after"], hi_np, lo_np, act_np, r["fresh"])
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  hashset_insert_sorted ({label}): B={hi_np.shape[0]} "
        f"active={int(act_np.sum())} fresh={int(r['fresh'].sum())} max_abs_err={r['err']} "
        f"median {r['ms']:.4f} ms plain={r['plain_ms']:.1f} ms (host CPU) "
        f"bound={bound_ms:.6f} ms ({moved} B)")
    if r["err"]:
        raise AssertionError("hashset_insert_sorted and its plain twin disagree on the "
                             "pack wave")
    return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms}


@phase("tenant_packing")
def tenant_packing():
    """Tenant packing on the card (``TenantPackedEngine``: one shared wave
    and one shared table, every salted claim through the insert kernel),
    each pack against its CPU twin or its solo card runs: 8 x 2pc-5 (the
    JAX service bench's packed leg, bench.py:900-933) beside a solo 2pc-5;
    4 x 2pc-8 at the 2pc8 configuration's widths, one tenant joining after
    20 waves and one dropped at half its count and resumed in
    ``spawn_gpu_bfs``, held to a solo card run; 2 x 2pc-5 at twice the
    smallest admissible budget, both pipeline modes; 3 x the LevelDag
    absence model with ``liveness="device"``. One ``{"pack_run": ...}``
    line a run; the insert kernel on a full-width 2pc-8 pack wave against
    its plain twin."""
    import torch

    from stateright_tpu_torch.checker import TenantPackedEngine
    from stateright_tpu_torch.checker import packed_tenancy as pt
    from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
    from stateright_tpu_torch.configs import CONFIGS, LIVENESS_CONFIGS
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.telemetry import metrics_registry

    out, launches = {"runs": {}}, {}

    def run(name, make_engine, script):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        pauses = {"s": 0.0, "n": [0, 0, 0], "t0": None}

        def on_gc(event, info):
            if event == "start":
                pauses["t0"] = time.perf_counter()
            elif pauses["t0"] is not None:
                pauses["s"] += time.perf_counter() - pauses["t0"]
                pauses["n"][info["generation"]] += 1

        gc.callbacks.append(on_gc)
        try:
            t0 = time.perf_counter()
            eng = make_engine()
            views = script(eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(on_gc)
        n = _read_launches()
        assert eng.device.type == "cuda", name
        assert n["fused_wave"] == 0 and n["hashset_insert_sorted"] >= eng.waves > 0, (name, n)
        launches[name] = n["hashset_insert_sorted"]
        out["runs"][name] = _pack_record(name, eng, views, wall, launches[name],
                                         torch.cuda.max_memory_allocated(), pauses)
        return eng, views

    def admit_all(prefix, n):
        def script(eng):
            views = {f"t{i}": eng.admit(f"t{i}", f"tpk-{prefix}-{eng.device.type}-{i}")
                     for i in range(n)}
            return _pack_drive(eng, views)
        return script

    def cpu_twin(make_engine, script):
        eng = make_engine()
        return eng, script(eng)

    # 8 x 2pc-5: the JAX service bench's packed leg, nothing cut.
    kw = dict(frontier_capacity=1 << 10, table_capacity=1 << 15, max_tenants=8)
    card, views = run("pack_2pc5x8", lambda: TenantPackedEngine(TwoPhaseSys(5), **kw),
                      admit_all("2pc5x8", 8))
    _, twins = cpu_twin(lambda: TenantPackedEngine(TwoPhaseSys(5), device="cpu", **kw),
                        admit_all("2pc5x8", 8))
    for key, view in views.items():
        assert view.unique_state_count() == UNIQUE_2PC5, key
        _same_pack_tenant(f"pack_2pc5x8 {key}", view, twins[key])
    _zero_launches()
    solo, solo_wall = _timed(lambda: TwoPhaseSys(5).checker().spawn_gpu_bfs(
        frontier_capacity=1 << 10, table_capacity=1 << 15).join())
    torch.cuda.synchronize()
    launches["pack_2pc5_solo"] = _read_launches()
    assert solo.unique_state_count() == UNIQUE_2PC5
    rec = out["runs"]["pack_2pc5x8"]
    out["2pc5x8"] = {"pack_unique_per_s": rec["unique_per_s"], "pack_wall_s": rec["wall_s"],
                     "solo_wall_s": solo_wall,
                     "solo_unique_per_s": UNIQUE_2PC5 / solo_wall,
                     "solo_engine": solo._wave_kernel, "waves": rec["waves"],
                     "occupancy": rec["occupancy"], "insert_launches": rec["insert_launches"]}
    log(json.dumps({"pack_2pc5x8": out["2pc5x8"]}))

    # 4 x 2pc-8 at the 2pc8 configuration's widths: "d" joins after 20
    # waves, "b" is dropped at half its count and resumed solo.
    cfg = CONFIGS["2pc8"]
    kw = dict(frontier_capacity=cfg.spawn["frontier_capacity"],
              table_capacity=cfg.spawn["table_capacity"], max_tenants=4)
    dropped = {}

    def script_2pc8(eng):
        views = {k: eng.admit(k, f"tpk-2pc8x4-{k}") for k in ("a", "b", "c")}

        def before_step(eng):
            if "d" not in views and eng.waves >= 20:
                views["d"] = eng.admit("d", "tpk-2pc8x4-d")
            if "payload" not in dropped and views["b"].unique_state_count() >= UNIQUE_2PC8 // 2:
                dropped["unique"] = views["b"].unique_state_count()
                t0 = time.perf_counter()
                dropped["payload"] = eng.drop("b")
                dropped["drop_s"] = time.perf_counter() - t0

        return _pack_drive(eng, views, before_step)

    real, seen = _capture_pack_insert(
        pt, kw["frontier_capacity"] * cfg.make().packed_action_count())
    try:
        eng, views = run("pack_2pc8x4", lambda: TenantPackedEngine(cfg.make(), **kw),
                         script_2pc8)
    finally:
        pt.hashset_insert_salted = real
    assert "table" in seen and "payload" in dropped
    _zero_launches()
    resumed, resumed_wall = _timed(lambda: cfg.make().checker().spawn_gpu_bfs(
        resume_from=dropped["payload"], **cfg.spawn).join())
    torch.cuda.synchronize()
    launches["pack_2pc8_resumed"] = _read_launches()
    _zero_launches()
    solo, solo_wall = _timed(lambda: cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join())
    torch.cuda.synchronize()
    launches["pack_2pc8_solo"] = _read_launches()
    finished = {k: v for k, v in views.items() if k != "b"}
    assert sorted(finished) == ["a", "c", "d"]
    for key, ck in {**finished, "b_resumed": resumed}.items():
        assert ck.unique_state_count() == UNIQUE_2PC8, key
        assert (ck.state_count(), ck.max_depth()) == (solo.state_count(), solo.max_depth()), key
        assert sorted(ck.discoveries()) == sorted(solo.discoveries()), key
        for path in ck.discoveries().values():
            assert path.into_states(), key  # replayed on the model
    assert views["b"].preempted and dropped["payload"]["kind"] == "gpu_bfs"
    rec = out["runs"]["pack_2pc8x4"]
    out["2pc8x4"] = {"wall_s": rec["wall_s"], "unique_per_s": rec["unique_per_s"],
                     "waves": rec["waves"], "occupancy": rec["occupancy"],
                     "assemble_s": rec["assemble_s"], "wave_s": rec["wave_s"],
                     "copy_s": rec["copy_s"], "verdict_s": rec["verdict_s"],
                     "grow_s": rec["grow_s"], "other_s": rec["other_s"], "gc_s": rec["gc_s"],
                     "gc_collections": rec["gc_collections"], "drop_s": dropped["drop_s"],
                     "table_capacity": rec["table_capacity"],
                     "peak_device_bytes": rec["peak_device_bytes"],
                     "dropped_at_unique": dropped["unique"], "resumed_wall_s": resumed_wall,
                     "solo_wall_s": solo_wall, "solo_unique_per_s": UNIQUE_2PC8 / solo_wall,
                     "insert_launches": rec["insert_launches"]}
    log(json.dumps({"pack_2pc8x4": out["2pc8x4"]}))
    out["insert"] = _insert_on_pack_wave(seen)
    del seen

    # 2 x 2pc-5 at twice the smallest admissible budget, both pipeline modes.
    for mode in (False, True):
        name = f"pack_budget_2pc5x2_{'async' if mode else 'sync'}"
        kw = dict(frontier_capacity=64, table_capacity=1 << 15, max_tenants=2,
                  hbm_budget_mib=2 * min_admissible_hbm_budget_mib(TwoPhaseSys(5), 64),
                  async_pipeline=mode)
        card, views = run(name, lambda: TenantPackedEngine(TwoPhaseSys(5), **kw),
                          admit_all(name, 2))
        _, twins = cpu_twin(lambda: TenantPackedEngine(TwoPhaseSys(5), device="cpu", **kw),
                            admit_all(name, 2))
        assert card.evictions > 0, name
        for key, view in views.items():
            assert view.unique_state_count() == UNIQUE_2PC5, (name, key)
            _same_pack_tenant(f"{name} {key}", view, twins[key])
            stale = metrics_registry(view.run_id).snapshot().get("pack.tenant.storage_stale", 0)
            assert stale > 0, (name, key)

    # 3 x the LevelDag absence model with device liveness.
    cfg = LIVENESS_CONFIGS["level_dag_absence"]
    kw = dict(frontier_capacity=cfg.spawn["frontier_capacity"],
              table_capacity=cfg.spawn["table_capacity"], max_tenants=4, liveness="device")
    card, views = run("pack_liveness_level_dag", lambda: TenantPackedEngine(cfg.make(), **kw),
                      admit_all("live", 3))
    _, twins = cpu_twin(lambda: TenantPackedEngine(cfg.make(), device="cpu", **kw),
                        admit_all("live", 3))
    _zero_launches()
    solo = cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join()
    launches["pack_liveness_solo"] = _read_launches()

    def records(ck):
        return {k: {f: v for f, v in r.items() if f != "seconds"}
                for k, r in ck.liveness_report()["outcomes"].items()}

    def relation(ck):
        return {k: v for k, v in ck._live_store.stats().items()
                if k not in ("evictions", "chunks")}

    import numpy as np

    for key, view in views.items():
        assert view.unique_state_count() == cfg.unique, key
        assert records(view) == records(solo) == records(twins[key]), key
        assert records(view)["done"]["verdict"] == "absent", key
        assert relation(view) == relation(solo) == relation(twins[key]), key
        np.testing.assert_array_equal(view._live_store.edge_rows(), solo._live_store.edge_rows())
        _same_pack_tenant(f"pack_liveness {key}", view, twins[key])
    out["launches"] = launches
    return out


STAGE_KERNELS = (
    ("frontier_kernel", "frontier"), ("comphash_keys_kernel", "keys"),
    ("keys_pairs_kernel", "keys"), ("keys_kernel", "keys"),
    ("sort_partition_kernel", "sort"), ("sort_pass_kernel", "sort"),
    ("dedup_kernel", "dedup"), ("sweep_", "sweep"), ("compact_kernel", "compact"),
    ("gather_kernel", "gather"),
)
# Kernels of earlier checkouts, which stage_ab (--stage-ab) also profiles:
# the compaction's before its one-pass design, the coverage stage's (a
# memset and coverage_kernel) before it moved into the frontier and the
# compaction, and the stats stage's before it moved into the compaction.
EARLIER_STAGE_KERNELS = STAGE_KERNELS + (
    ("fresh_count_kernel", "compact"), ("scan_one_block_kernel", "compact"),
    ("coverage_kernel", "coverage"), ("stats_kernel", "stats"),
)
PROFILE_GAP_S = 0.5  # host sleep between profiled blocks; splits the device timeline


def _stages_of(names, kernels=STAGE_KERNELS):
    """The stage of each device operation of ``keys_input`` and one chain,
    by kernel name (``kernels``): the operations before the chain's first
    kernel are ``keys_input``'s, and any later one of no chain stage
    raises."""
    kinds = [None if n.startswith("Memset") else
             next((st for part, st in kernels if part in n), None) for n in names]
    first = next((i for i, st in enumerate(kinds) if st is not None), None)
    if first is None:
        raise AssertionError(f"no kernel of the chain: {names}")
    stages, nxt = [None] * len(names), None
    for i in range(len(names) - 1, -1, -1):
        if names[i].startswith("Memset"):
            if nxt is None:
                raise AssertionError(f"a memset with no kernel after it: {names}")
            stages[i] = nxt
            continue
        nxt = kinds[i]
        if nxt is None:
            if i > first:
                raise AssertionError(f"a device operation of no chain stage: {names[i]} in {names}")
            nxt = "keys_input"
        stages[i] = nxt
    return stages


def _device_blocks(prof):
    """The profiled device operations (memcpys left out) in start order,
    as ``(name, us)`` lists split where the device idled for more than half
    of ``PROFILE_GAP_S``."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy")),
                 key=lambda e: e.time_range.start)
    blocks, last = [], None
    for e in evs:
        if last is None or e.time_range.start - last > PROFILE_GAP_S * 0.5e6:
            blocks.append([])
        blocks[-1].append((e.name, e.time_range.end - e.time_range.start))
        last = e.time_range.end
    return blocks


def _profile_chains(waves, sort_keys=None, reps=5, kernels=STAGE_KERNELS):
    """One ``torch.profiler`` session over ``reps`` sorts of ``sort_keys``
    (``(key0, idx0)``, each sort from the unsorted keys; or none) and then
    each wave's ``keys_input`` and kernel chain captured in a CUDA Graph
    (all captured first) and replayed ``reps`` times, each over a fresh copy
    of its table. A wave is a dict of the chain's inputs on the card
    (``spec``, ``table0``, ``hi``, ``lo``, ``ebits``, ``depth``,
    ``depth_cap``, ``cond``, ``cvalid``, ``cand``, ``mask``, ``ant``).
    Returns the sort's ``(name, us)`` operations of one sort, and for each
    wave its stages' device ms and device operations a replay (every
    operation mapped to a stage of ``kernels`` by ``_stages_of``; the
    replays must agree) and the ``(name, us, stage)`` of each operation of
    the frontier, keys, dedup, compaction, coverage (an earlier checkout's)
    and stats stages and of ``keys_input``, averaged over the replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stateright_tpu_torch.ops import fused_wave as fw

    graphs = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if sort_keys is not None:
            key, idx = (x.clone() for x in sort_keys)
            for _ in range(reps):
                key.copy_(sort_keys[0])
                idx.copy_(sort_keys[1])
                fw.sort_stage(key, idx)
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
        for w in waves:
            work = w["table0"].clone()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                kin = fw.keys_input(w["spec"], w["cand"])
                fw.kernel_chain(w["spec"], work, w["hi"], w["lo"], w["ebits"], w["depth"],
                                w["depth_cap"], w["cond"], w["cvalid"], kin, w["cand"],
                                mask=w["mask"], ant=w["ant"])
            graphs.append((graph, work))
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
        for w, (graph, work) in zip(waves, graphs):
            for _ in range(reps):
                work.copy_(w["table0"])
                graph.replay()
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
    blocks = _device_blocks(prof)
    n_sort = 1 if sort_keys is not None else 0
    if len(blocks) < n_sort + len(waves):
        raise AssertionError(f"the profile holds {len(blocks)} blocks of device operations, "
                             f"fewer than {n_sort + len(waves)}: {[len(b) for b in blocks]}")
    sort_ops = []
    if sort_keys is not None:
        if len(blocks[0]) % reps:
            raise AssertionError(f"{len(blocks[0])} sort operations over {reps} sorts")
        per = len(blocks[0]) // reps
        sort_ops = [(name, sum(us for _n, us in blocks[0][i::per]) / reps)
                    for i, (name, _us) in enumerate(blocks[0][:per])]
    out = []
    for w, block in zip(waves, blocks[len(blocks) - len(waves):]):
        # A memset's name says where its memory lies ("Device", "Unknown"),
        # and not always alike in every replay.
        block = [("Memset" if n.startswith("Memset") else n.split("(")[0], us)
                 for n, us in block]
        k = len(block) // reps
        names = [n for n, _us in block[:k]]
        if len(block) % reps or any([n for n, _us in block[r * k:(r + 1) * k]] != names
                                    for r in range(reps)):
            raise AssertionError(f"the replays of a chain differ: {len(block)} operations over "
                                 f"{reps} replays: {[n for n, _us in block]}")
        stages = _stages_of(names, kernels)
        stage_us, stage_ops = {}, {}
        for (_name, us), st in zip(block, stages * reps):
            stage_us[st] = stage_us.get(st, 0.0) + us / reps
            stage_ops[st] = stage_ops.get(st, 0) + 1
        op_us = [(names[i][:48], sum(block[r * k + i][1] for r in range(reps)) / reps, st)
                 for i, st in enumerate(stages)
                 if st in ("keys_input", "frontier", "keys", "dedup", "compact", "coverage",
                           "stats")]
        out.append(({st: us / 1e3 for st, us in stage_us.items()},
                    {st: n // reps for st, n in stage_ops.items()}, op_us))
    del graphs
    return sort_ops, out


def _waves_on_card(stage_waves):
    """The chain inputs of each kept wave, back on the card."""
    from stateright_tpu_torch.core.batch import map_leaves

    dev = lambda x: None if x is None else x.cuda()  # noqa: E731
    out = []
    for w in stage_waves:
        cols = {k: dev(w[k]) for k in ("hi", "lo", "ebits", "depth", "cond", "cvalid", "mask",
                                       "ant")}
        out.append(dict(w, table0=w["table"].cuda(), cand=map_leaves(dev, w["cand"]), **cols))
    return out


# -- sharding -------------------------------------------------------------------

# The JAX bench's multichip leg (bench.py:2693-2740): 2pc-5 at these shard
# counts, frontier_per_device=max(8, 512 // n), 2^14-row shard tables.
SHARD_COUNTS = (1, 2, 4, 8)
# The full-width sharded path: 2pc-8 at 8 shards of 1,024 lanes (the 2pc8
# configuration's 8,192) and its 2^20-row table split over the shards.
SHARDED_2PC8 = dict(frontier_per_device=1024, table_capacity_per_device=1 << 17)
# The owner insert of this wave (counting every insert call of the run,
# shard by shard) is held against its plain twin.
SHARDED_INSERT_CALL = 800


def _sharded_run(label, make, mesh, spawn=None, **kw):
    """One ``spawn_sharded_gpu_bfs`` run (``spawn(builder, **kw)`` instead,
    where given) with every kernel count set to 0 just before and read just
    after; returns its record."""
    import torch

    from stateright_tpu_torch.parallel.sharded import run_summary

    gc.collect()
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    spawn = spawn or (lambda b, **k: b.spawn_sharded_gpu_bfs(**k))
    checker = _joined(spawn(make().checker(), mesh=mesh, run_id=f"shd-{label}", **kw))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    assert checker.device.type == mesh.device.type, label
    assert launches["fused_wave"] == 0, (label, launches)
    if cuda:
        # Every owner insert goes through the kernel: one launch a shard a
        # wave, the seed's and every growth's rehash besides.
        assert launches["hashset_insert_sorted"] >= checker.waves * mesh.local > 0, (
            label, launches, checker.waves)
    summary = run_summary(checker)
    rec = {"label": label, "shards": mesh.n, "processes": mesh.world,
           "device": mesh.device.type, "unique": summary["unique"],
           "states": summary["states"], "depth": summary["depth"],
           "discoveries": sorted(summary["discoveries"]), "waves": checker.waves,
           "drains": checker.drains, "table_growths": checker.table_growths,
           "table_capacity_per_shard": checker.table_capacity_per_shard(),
           "lanes_shipped": summary["lanes_shipped"], "rungs": summary["rungs"],
           "wall_s": wall, "warmup_s": checker.warmup_seconds,
           "unique_per_s": summary["unique"] / wall,
           "insert_launches": launches["hashset_insert_sorted"],
           "evictions": checker.evictions, "stale_lanes": checker.stale_lanes,
           "host_probe_s": checker.host_probe_s,
           "peak_device_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    for path in checker.discoveries().values():
        assert path.into_states(), label  # replayed on the model
    return checker, summary, rec


def _capture_sharded_insert(mod, call):
    """Wraps the sharded module's insert to keep the inputs of its
    ``call``-th launch: one owner's table before it and its received
    batch, sorted, the first copy of each key active."""
    real, seen = mod.hashset_insert_sorted, {"n": 0}

    def spy(table, hi, lo, active):
        seen["n"] += 1
        if seen["n"] == call:
            seen.update(table=table.clone(), args=[x.clone() for x in (hi, lo, active)])
        return real(table, hi, lo, active)

    mod.hashset_insert_sorted = spy
    return real, seen


def _insert_on_owner_batch(seen, label="sharded 2pc-8 owner batch"):
    """``hashset_insert_sorted`` against its plain twin on one owner's
    received batch of a sharded run (``label``); its median time and
    bound."""
    import numpy as np

    from stateright_tpu_torch.interop import table_to_numpy

    hi, lo, active = (x.cpu().numpy() for x in seen["args"])
    hi_np, lo_np = hi.view(np.uint32), lo.view(np.uint32)
    r = _compare_insert(table_to_numpy(seen["table"]), hi_np, lo_np, active, timing=True)
    moved = _bd().insert_must_move(r["after"], hi_np, lo_np, active, r["fresh"])
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  hashset_insert_sorted ({label}): B={hi_np.shape[0]} "
        f"active={int(active.sum())} fresh={int(r['fresh'].sum())} max_abs_err={r['err']} "
        f"median {r['ms']:.4f} ms plain={r['plain_ms']:.1f} ms (host CPU) "
        f"bound={bound_ms:.6f} ms ({moved} B)")
    if r["err"]:
        raise AssertionError(f"hashset_insert_sorted and its plain twin disagree on the "
                             f"{label}")
    return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "B": int(hi_np.shape[0]), "active": int(active.sum())}


def _same_sharded(label, got, want):
    """Two sharded runs of one configuration agree in counts, depth,
    discoveries, paths and the exchange's lanes and rungs."""
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got.get(k) != want[k]}
        raise AssertionError(f"{label}: the runs disagree: {diff}")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_child(rank, port, out_path):
    """``--sharded-child``: one rank of the two-rank NCCL leg, 4 shards on
    ``cuda:<rank>``; writes its run summary to ``out_path``."""
    import torch
    import torch.distributed as dist

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.parallel import bootstrap_mesh
    from stateright_tpu_torch.parallel.sharded import run_summary

    mesh = bootstrap_mesh(4, device=f"cuda:{rank}", init_method=f"tcp://localhost:{port}",
                          world_size=2, rank=rank, timeout_s=120)
    n = mesh.n
    checker = TwoPhaseSys(5).checker().spawn_sharded_gpu_bfs(
        mesh=mesh, frontier_per_device=max(8, 512 // n), table_capacity_per_device=1 << 14,
        run_id=f"shd-nccl2-{rank}").join()
    with open(out_path, "w") as f:
        json.dump(run_summary(checker), f)
    dist.destroy_process_group()
    torch.cuda.synchronize()
    return 0


# The rest of sharding (per-shard tiers, coverage, attribution, device
# liveness, the async pipeline). The tiers' runs: 2pc-8 at 8 shards of 512
# lanes, the sieve on, wave at a time, at the smallest hbm_budget_mib the
# checker admits (a 2^18-row table a shard: about 131,000 keys at load 0.5
# of the about 218,000 a shard owns, so every budgeted run evicts), with a
# 1 MiB host budget (1/8 MiB a shard) that spills, and again with the
# async pipeline; its payload after the last eviction resumed on 4 shards
# of 1,024 lanes (the same lanes a wave and device memory in all).
SHARDED_TIERS = dict(frontier_per_device=512, table_capacity_per_device=1 << 18, sieve=True)
SHARDED_HOST_BUDGET_MIB = 1.0
SHARDED_ELASTIC_SHARDS = 4


def _sharded_slow_counts():
    """The JAX package's sharded parity checks marked slow there, at their
    knobs on 8 shards: (label, model, spawn, settings, count)."""
    from stateright_tpu_torch.models.raft import RaftModelCfg
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return [
        # test_packed_ordered_crash.py:66
        ("raft3_crash", lambda: RaftModelCfg(server_count=3, max_term=1, lossy=True,
                                             max_crashes=1).into_model(),
         None, dict(frontier_per_device=64, table_capacity_per_device=1 << 10), 2_252),
        # test_device_symmetry.py:332
        ("2pc7_orbits", lambda: TwoPhaseSys(7),
         lambda b, **k: b.symmetry().spawn_sharded_gpu_bfs(**k),
         dict(frontier_per_device=1 << 10, table_capacity_per_device=1 << 17), 920),
        # test_raft5.py:26
        ("raft5_lossless", lambda: RaftModelCfg(server_count=5, max_term=1,
                                                lossy=False).into_model(),
         None, dict(frontier_per_device=128, table_capacity_per_device=1 << 11), 7_977),
    ]


def _capture_insert_when(mod, armed, last=False):
    """Wraps the sharded module's insert to keep the inputs (the table
    before the launch and its batch) of the first launch for which
    ``armed()`` holds, or with ``last`` of the last one."""
    real, seen = mod.hashset_insert_sorted, {"n": 0}

    def spy(table, hi, lo, active):
        seen["n"] += 1
        if armed() and (last or "table" not in seen):
            seen.update(table=table.clone(), args=[x.clone() for x in (hi, lo, active)])
        return real(table, hi, lo, active)

    mod.hashset_insert_sorted = spy
    return real, seen


def _results(summary):
    """What a budgeted run shares with the unbounded one whatever the sieve
    flushed: counts, depth, discoveries and their paths."""
    return {k: summary[k] for k in ("unique", "states", "depth", "discoveries", "paths")}


def _same_coverage(label, sharded_rep, solo_rep):
    """A sharded coverage report held to the solo run's on every field that
    does not depend on which lane of a wave claims a key first: the
    per-action fresh counts (and ``never_new``, made of them) and a drain's
    near-miss depths aside."""
    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out

    a, b = flat(sharded_rep), flat(solo_rep)
    skip = ("prefix", "actions.never_new")
    diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
            if k not in skip and not k.endswith(".fresh") and not k.endswith(".near_miss_depth")
            and a.get(k) != b.get(k)}
    if diff:
        raise AssertionError(f"{label}: the coverage reports disagree: {diff}")


def _sharded_rest(out, launches, keep, big):
    """The tiers, the async pipeline, coverage, attribution, device
    liveness and the slow parity counts on ``spawn_sharded_gpu_bfs``; each
    run against its twin. ``big`` is the full-width 2pc-8 run of the
    phase (coverage's and attribution's bare twin)."""
    import tempfile

    import numpy as np
    import torch

    from stateright_tpu_torch.configs import CONFIGS, LIVENESS_CONFIGS
    from stateright_tpu_torch.core.fingerprint import fingerprint
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.parallel import default_mesh
    from stateright_tpu_torch.parallel import sharded as shmod

    tiers, telemetry = {}, {}

    def run(label, make, n=8, spawn=None, **kw):
        checker, summary, rec = _sharded_run(label, make, default_mesh(n), spawn=spawn, **kw)
        keep(checker, summary, rec)
        launches[f"sharded_{label}"] = rec["insert_launches"]
        return checker, summary, rec

    two8 = lambda: TwoPhaseSys(8)  # noqa: E731
    budget = shmod.min_hbm_budget_mib(SHARDED_TIERS["frontier_per_device"],
                                      two8().packed_action_count())
    tiers["hbm_budget_mib"] = budget
    _, unbounded, unb_rec = run("2pc8_tiers_unbounded", two8, max_drain_waves=1, **SHARDED_TIERS)
    assert unbounded["unique"] == UNIQUE_2PC8, unb_rec

    # The budget with a host budget that spills; the insert kept on the
    # first owner batch after an eviction; a checkpoint payload taken at the
    # second wave boundary after each eviction (the pool is then the whole
    # pending frontier, and the tables hold one wave's keys, which the
    # rebuild inserts), the last one kept for the elastic resume.
    holder, payloads = [], {"evictions": 0, "armed": None, "s": 0.0}

    class PayloadAfterEvict(shmod.ShardedGpuBfsChecker):
        def _pool_take(self, width):
            if self.evictions != payloads["evictions"]:
                if payloads["armed"] is None:
                    payloads["armed"] = self.waves
                elif self.waves > payloads["armed"]:
                    t0 = time.perf_counter()
                    payloads.update(evictions=self.evictions, armed=None,
                                    last=self.checkpoint_payload(list(self._pool)),
                                    unique=self.unique_state_count())
                    payloads["s"] += time.perf_counter() - t0
            return super()._pool_take(width)

    real, seen = _capture_insert_when(shmod, lambda: bool(holder) and holder[0].evictions > 0)
    try:
        with tempfile.TemporaryDirectory() as spill:
            ck, budgeted, rec = run(
                "2pc8_budget_spill", two8, hbm_budget_mib=budget,
                host_budget_mib=SHARDED_HOST_BUDGET_MIB, spill_dir=spill,
                spawn=lambda b, **k: holder.append(PayloadAfterEvict(b, **k)) or holder[0],
                **SHARDED_TIERS)
            spills = ck.metrics().snapshot().get("sharded_bfs.storage.spills", 0)
            assert spills >= 1 and any(f.startswith("s0_") for f in os.listdir(spill)), spills
    finally:
        shmod.hashset_insert_sorted = real
    assert rec["evictions"] >= 1 and rec["stale_lanes"] > 0, rec
    assert _results(budgeted) == _results(unbounded), "the budgeted run differs from the unbounded"
    # The payloads are taken inside the timed run: the budget's own wall is
    # the run's less their seconds.
    tiers["budget_spill"] = {"spills": spills, "payload_s": payloads["s"],
                             "wall_less_payload_s": rec["wall_s"] - payloads["s"],
                             "storage": ck.state_digest()["storage"],
                             **{k: rec[k] for k in ("evictions", "stale_lanes", "host_probe_s",
                                                    "wall_s", "waves", "lanes_shipped",
                                                    "unique_per_s")}}
    tiers["unbounded"] = {k: unb_rec[k] for k in ("wall_s", "waves", "lanes_shipped",
                                                   "table_growths", "unique_per_s")}
    assert "table" in seen, seen["n"]
    out["evicted_insert"] = _insert_on_owner_batch(
        seen, "sharded 2pc-8 owner batch after an eviction")
    del seen, holder

    # The async pipeline: the budgeted run's twin.
    ck, pipelined, rec = run("2pc8_budget_async", two8, hbm_budget_mib=budget,
                             async_pipeline=True, **SHARDED_TIERS)
    _same_sharded("2pc8 budget async", pipelined, budgeted)
    tiers["async"] = {k: rec[k] for k in ("wall_s", "evictions", "stale_lanes", "host_probe_s")}

    # The payload after the last eviction resumed on 4 shards: the insert
    # kept on the last launch of the restore's rebuild.
    payload = payloads.pop("last")
    assert payload["n_shards"] == 8 and len(payload["storage"]) == 8
    state = {"on": False}

    class Restoring(shmod.ShardedGpuBfsChecker):
        def _restore(self, source):
            state["on"] = True
            try:
                return super()._restore(source)
            finally:
                state["on"] = False

    # The same lanes a wave and the same device memory in all, over half
    # the shards: each shard twice as wide, at its smallest budget.
    grow = 8 // SHARDED_ELASTIC_SHARDS
    elastic_kw = dict(SHARDED_TIERS,
                      frontier_per_device=SHARDED_TIERS["frontier_per_device"] * grow,
                      table_capacity_per_device=SHARDED_TIERS["table_capacity_per_device"] * grow)
    elastic_kw["hbm_budget_mib"] = shmod.min_hbm_budget_mib(
        elastic_kw["frontier_per_device"], two8().packed_action_count())
    real, seen = _capture_insert_when(shmod, lambda: state["on"], last=True)
    try:
        ck, elastic, rec = run(f"2pc8_budget_elastic{SHARDED_ELASTIC_SHARDS}", two8,
                               n=SHARDED_ELASTIC_SHARDS, resume_from=payload,
                               spawn=lambda b, **k: Restoring(b, **k), **elastic_kw)
    finally:
        shmod.hashset_insert_sorted = real
    assert {k: elastic[k] for k in ("unique", "discoveries")} == {
        k: unbounded[k] for k in ("unique", "discoveries")}, "the elastic resume differs"
    tiers["elastic"] = {"from_shards": 8, "to_shards": SHARDED_ELASTIC_SHARDS,
                        "hbm_budget_mib": elastic_kw["hbm_budget_mib"],
                        "frontier_per_device": elastic_kw["frontier_per_device"],
                        "resumed_at_unique": payloads["unique"],
                        "restore_inserts": ck.restore_inserts, "wall_s": rec["wall_s"],
                        "evictions": rec["evictions"], "stale_lanes": rec["stale_lanes"],
                        "host_probe_s": rec["host_probe_s"]}
    out["restore_inserts"] = ck.restore_inserts
    assert "table" in seen, seen["n"]
    out["restore_insert"] = _insert_on_owner_batch(
        seen, "sharded 2pc-8 elastic restore's rebuild batch")
    del seen, payload

    # Coverage and attribution through the drain, each against the bare
    # full-width run; coverage also against the solo run's report.
    ck, covered, rec = run("2pc8_n8_coverage", two8, coverage=True, **SHARDED_2PC8)
    _same_sharded("2pc8 coverage", covered, big["summary"])
    cfg = CONFIGS["2pc8"]
    solo = cfg.make().checker().spawn_gpu_bfs(coverage=True, **cfg.spawn).join()
    _same_coverage("2pc8 coverage", ck.coverage_report(), solo.coverage_report())
    telemetry["coverage"] = {"wall_s": rec["wall_s"], "bare_wall_s": big["rec"]["wall_s"],
                             "unique": ck.coverage_report()["unique"],
                             "vacuous": ck.coverage_report()["vacuous"]}
    del solo
    ck, attributed, rec = run("2pc8_n8_attributed", two8, attribution=True, **SHARDED_2PC8)
    _same_sharded("2pc8 attribution", attributed, big["summary"])
    ledger = ck.attribution_report()
    assert ledger["within_tolerance"] and ledger["phases_s"].get("device", 0) > 0, ledger
    assert sum(ledger["probe_length_counts"]) == UNIQUE_2PC8, ledger["probe_length_counts"]
    telemetry["attribution"] = {"wall_s": rec["wall_s"], "bare_wall_s": big["rec"]["wall_s"],
                                **_ledger_line(ledger)}

    # Device liveness at W = 2^20 on 8 shards, against the solo run.
    cfg = LIVENESS_CONFIGS["level_dag_2p20"]
    spawn = dict(frontier_per_device=cfg.spawn["frontier_capacity"] // 8,
                 table_capacity_per_device=cfg.spawn["table_capacity"] // 8, liveness="device")
    ck, _, rec = run("level_dag_2p20_live", cfg.make, **spawn)
    t0 = time.perf_counter()
    solo = cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join()
    solo_wall = time.perf_counter() - t0

    def records(c):
        return {k: {f: v for f, v in r.items() if f != "seconds"}
                for k, r in c.liveness_report()["outcomes"].items()}

    assert ck.unique_state_count() == LEVEL_DAG_2P20["states"], rec
    assert records(ck) == records(solo), (records(ck), records(solo))
    np.testing.assert_array_equal(ck._live_store.edge_rows(), solo._live_store.edge_rows())
    assert ({k: [fingerprint(s) for s in p.into_states()] for k, p in ck.discoveries().items()}
            == {k: [fingerprint(s) for s in p.into_states()]
                for k, p in solo.discoveries().items()})
    done = ck.liveness_report()["outcomes"]["done"]
    liveness = {"waves": ck.waves, "edge_store": ck._live_store.stats(),
                "verdict": done["verdict"], "analysis_s": done["seconds"],
                "wall_s": rec["wall_s"], "solo_wall_s": solo_wall,
                "solo_analysis_s": solo.liveness_report()["outcomes"]["done"]["seconds"]}
    del ck, solo

    # The JAX package's slow sharded parity counts.
    slow = {}
    for label, make, spawn_fn, kw, count in _sharded_slow_counts():
        _, summary, rec = run(label, make, spawn=spawn_fn, **kw)
        assert summary["unique"] == count, (label, summary["unique"], count)
        slow[label] = {"unique": summary["unique"], "wall_s": rec["wall_s"]}
    telemetry["slow_counts"] = slow
    out["tiers"], out["telemetry"], out["liveness"] = tiers, telemetry, liveness


@phase("sharded")
def sharded():
    """Fingerprint-sharded BFS on the card (``spawn_sharded_gpu_bfs``: n
    shards in this process on the one card, every owner insert through the
    insert kernel), each run against its CPU twin: the JAX bench's
    multichip leg, 2pc-5 at 1, 2, 4 and 8 shards with the sieve off and on;
    2pc-8 at 8 shards of 1,024 lanes through the drain; the insert kernel
    against its plain twin on one owner's received batch of that run; a
    one-rank NCCL ``bootstrap_mesh`` run of 2pc-5 with 8 shards against the
    one-process mesh; with two cards, a two-rank NCCL run; then the tiers,
    the async pipeline, coverage, attribution, device liveness and the
    slow counts (``_sharded_rest``). One ``{"sharded_run": ...}`` line a
    run."""
    import torch
    import torch.distributed as dist

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.parallel import bootstrap_mesh, default_mesh
    from stateright_tpu_torch.parallel import sharded as shmod

    out, launches = {"runs": {}}, {}

    def keep(checker, summary, rec):
        out["runs"][rec["label"]] = rec
        log(json.dumps({"sharded_run": rec}))
        return summary

    # The multichip leg: 2pc-5, each shard count, sieve off and on.
    leg = {}
    for n in SHARD_COUNTS:
        for sieve in (False, True):
            label = f"2pc5_n{n}_{'sieve' if sieve else 'plain'}"
            kw = dict(frontier_per_device=max(8, 512 // n), table_capacity_per_device=1 << 14,
                      sieve=sieve)
            card = keep(*_sharded_run(label, lambda: TwoPhaseSys(5), default_mesh(n), **kw))
            launches[f"sharded_{label}"] = out["runs"][label]["insert_launches"]
            _, cpu, _ = _sharded_run(f"{label}_cpu", lambda: TwoPhaseSys(5),
                                     default_mesh(n, device="cpu"), **kw)
            assert card["unique"] == UNIQUE_2PC5, label
            _same_sharded(label, card, cpu)
            leg[label] = card
        plain, sieved = leg[f"2pc5_n{n}_plain"], leg[f"2pc5_n{n}_sieve"]
        _same_sharded(f"2pc5_n{n} sieve", {**sieved, "lanes_shipped": 0, "rungs": 0},
                      {**plain, "lanes_shipped": 0, "rungs": 0})
        if n > 1:
            assert sieved["lanes_shipped"] < plain["lanes_shipped"], n

    # The full-width path: 2pc-8 at 8 shards through the drain, one owner
    # insert kept for the kernel-vs-twin check.
    real, seen = _capture_sharded_insert(shmod, SHARDED_INSERT_CALL)
    try:
        _, big, rec = _sharded_run("2pc8_n8", lambda: TwoPhaseSys(8), default_mesh(8),
                                   **SHARDED_2PC8)
    finally:
        shmod.hashset_insert_sorted = real
    keep(None, big, rec)
    assert big["unique"] == UNIQUE_2PC8 and rec["drains"] > 0, rec
    launches["sharded_2pc8_n8"] = rec["insert_launches"]
    assert "table" in seen, seen["n"]
    out["insert"] = _insert_on_owner_batch(seen)
    del seen

    # The per-shard tiers, the async pipeline, coverage, attribution,
    # device liveness and the slow parity counts.
    _sharded_rest(out, launches, keep, {"summary": big, "rec": rec})

    # One rank of NCCL: the collectives' path, against the one-process mesh.
    _zero_launches()
    mesh = bootstrap_mesh(8, device="cuda", init_method=f"tcp://localhost:{_free_port()}",
                          world_size=1, rank=0, timeout_s=120)
    try:
        assert mesh.distributed and mesh.n == 8 and mesh.world == 1
        kw = dict(frontier_per_device=max(8, 512 // 8), table_capacity_per_device=1 << 14)
        nccl = keep(*_sharded_run("2pc5_nccl_one_rank", lambda: TwoPhaseSys(5), mesh, **kw))
        launches["sharded_2pc5_nccl_one_rank"] = out["runs"]["2pc5_nccl_one_rank"][
            "insert_launches"]
        _same_sharded("2pc5 one-rank NCCL", nccl, leg["2pc5_n8_plain"])
        out["nccl_backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()

    if torch.cuda.device_count() < 2:
        log(json.dumps({"sharded_nccl_two_ranks": "not run: 1 CUDA device"}))
        out["nccl_two_ranks"] = "not run: 1 CUDA device"
    else:
        import tempfile

        port = _free_port()
        got = []
        with tempfile.TemporaryDirectory() as tmp:
            paths = [os.path.join(tmp, f"sharded_rank{r}.json") for r in range(2)]
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--sharded-child", str(r), str(port), paths[r]])
                     for r in range(2)]
            try:
                for p in procs:
                    assert p.wait(timeout=300) == 0, "a rank of the two-rank NCCL leg failed"
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for path in paths:
                with open(path) as f:
                    got.append(json.load(f))
        want = json.loads(json.dumps(leg["2pc5_n8_plain"]))
        for r, summary in enumerate(got):
            _same_sharded(f"2pc5 two-rank NCCL rank {r}", summary, want)
        out["nccl_two_ranks"] = "passed"
        log(json.dumps({"sharded_nccl_two_ranks": "passed"}))
    out["launches"] = launches
    return out


# -- the conformance plane and the insert micro-bench ---------------------------

CONFORMANCE_BATCHES = (1, 64, 1024)
CONFORMANCE_TRACE_STEPS = 16
# The insert micro-bench's two shapes: its defaults (2^20 rows, 2^15-lane
# batches) and the main path's (2^22 rows, one 2pc-8 wave's 344,064 lanes),
# each filled to about half its rows (16 and 6 rounds).
BENCH_SHAPES = {"bench_hashset_2p20": (20, 1 << 15), "bench_hashset_2p22": (22, 8192 * 42)}


def _same_verdicts(label, card, cpu):
    if card != cpu:
        bad = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
        raise AssertionError(f"{label}: card verdict {card[bad]!r} != CPU twin {cpu[bad]!r}")


def _timed_twice(fn, more=5):
    """``fn()`` cold, then warm (the JAX bench leg's two calls), then
    ``more`` warm calls for their spread: (warm result, warm s, cold s,
    the more calls' median s)."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(more):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return out, warm, cold, statistics.median(times)


# -- 14. the check service ----------------------------------------------------


class _StepClock:
    """The service's clock for the phase: the monotonic clock plus an
    offset the phase steps, to end a slice's quantum at a chosen point."""

    def __init__(self):
        self._offset = 0.0

    def __call__(self):
        return time.monotonic() + self._offset

    def advance(self, dt):
        self._offset += dt


def _fused_held(label, spec, table, chunk, depth_cap):
    """The fused chain against its plain twin on one captured wave (its
    insert, the tile sweep, included), timed with CUDA events; the bound is
    the bytes the wave must move (``breakdown.fused_wave_must_move``) over
    the card's memory rate."""
    import numpy as np

    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops.fingerprint import fingerprint_words, state_words

    err, pout, plain_ms, pt, _sweeps = _compare_fused(spec, table, chunk, depth_cap)
    hi, lo, ebits, depth = (chunk[k] for k in ("hi", "lo", "ebits", "depth"))
    F, A, P = hi.shape[0], spec.action_count, len(spec.conditions)
    B = F * A
    cond, cvalid, cand_flat = fw.model_stage(spec, chunk["states"], F)
    kin = fw.keys_input(spec, cand_flat)
    work = table.clone()
    ms, _stages = _time_on_card(
        lambda mark: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond, cvalid,
                                     kin, cand_flat, mark=mark),
        reset=lambda: work.copy_(table))
    words = state_words(cand_flat)
    valid = (cvalid.view(F, A) & (depth < depth_cap)[:, None]).reshape(B).cpu().numpy()
    fh, fl = fingerprint_words(words.cpu())
    fps = (fh.numpy().astype(np.uint64) << np.uint64(32)) | fl.numpy().astype(np.uint64)
    probed = _bd().probed_rows(table_to_numpy(pt), np.unique(fps[valid]))
    n = int(pout["stats"][1])
    row_bytes = sum(x[0].numel() * x.element_size() for x in pout["new"]["states"].values())
    moved = _bd().fused_wave_must_move(words.numel(), B, F, P, probed, n, row_bytes)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  fused wave ({label}): F={F} table rows={table.shape[0]} n_new={n} "
        f"max_abs_err={err} median {ms:.4f} ms plain={plain_ms:.1f} ms (host CPU) "
        f"bound={bound_ms:.6f} ms ({moved} B)")
    if err:
        raise AssertionError(f"{label}: the fused chain and its plain twin disagree")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def _capture_after_eviction(cls):
    """Wraps the checker class so the first wave it runs after its first
    eviction keeps its inputs (the emptied table and the chunk); returns
    ``(restore, seen)``."""
    from stateright_tpu_torch.core.batch import map_leaves

    evict, wave, seen = cls._evict_l0, cls._device_wave, {}

    def evict_spy(self, table, defer=False):
        out = evict(self, table, defer=defer)
        seen.setdefault("evicted", True)
        return out

    def wave_spy(self, table, chunk):
        if seen.get("evicted") and "table" not in seen:
            seen.update(table=table.clone(), spec=self._spec, depth_cap=self._depth_cap,
                        chunk={k: (map_leaves(lambda x: x.clone(), v) if k == "states"
                                   else v.clone()) for k, v in chunk.items()})
        return wave(self, table, chunk)

    cls._evict_l0, cls._device_wave = evict_spy, wave_spy

    def restore():
        cls._evict_l0, cls._device_wave = evict, wave

    return restore, seen


@phase("service")
def service():
    """The check service (``CheckService``) on the card, every job on
    ``cuda``: 4 x 2pc-5 packed (each tenant against a direct
    ``spawn_gpu_bfs`` run; the salted insert of one full-width pack wave
    against its plain twin); a solo 2pc-8 job (the 2pc8 configuration's
    widths, drains of at most 8 waves) preempted for a higher-priority job
    and resumed, its golden report equal to the direct run's; the budgeted
    2pc-8 pair (the smallest admissible budget) synchronous and with
    ``async_pipeline=True``: equal counts, evictions and reports, both
    walls and ``host_probe_s``, the fused chain on the first wave after an
    eviction against its plain twin; 2pc-8 on a ``service_dir`` resubmitted
    to a new service, which completes in verify-only mode from the seed;
    a ``device.wave`` fault in a drained 2pc-5 job, retried to the direct
    run's report; a conformance job on the seed corpus against the CPU
    twin; a swarm pair against direct card runs. Then
    ``torch.cuda.memory_allocated()`` after every service closed against
    its value at the phase's start (the conformance replay cache, a
    process-wide cache, cleared first and its size reported). Every run's
    kernel launches counted from 0. One ``{"service": ...}`` line after the
    kernels line."""
    import tempfile

    import torch

    from stateright_tpu_torch.checker import packed_tenancy as pt
    from stateright_tpu_torch.checker.gpu import GpuBfsChecker, min_admissible_hbm_budget_mib
    from stateright_tpu_torch.conformance import ConformanceChecker, decode_lines
    from stateright_tpu_torch.conformance.replay import _KERNELS, clear_replay_kernels
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.service import CheckService, default_zoo
    from stateright_tpu_torch.utils.faults import FaultSpec, inject

    out, launches, checkers = {"runs": {}}, {}, {}
    cfg = _config("2pc8")
    clock = _StepClock()
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()

    def keep_checkers(svc):
        """The service's verdict hook, wrapped to keep each job's checker
        (its run statistics) until the phase reads them."""
        finalize = svc._finalize

        def spy(job, checker):
            checkers[job.job_id] = checker
            return finalize(job, checker)

        svc._finalize = spy

    def job_run(name, svc, submit, **extra):
        _zero_launches()
        t0 = time.perf_counter()
        h = submit()
        r = h.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = n = _read_launches()
        st = h.status()
        ck = checkers.get(h.job_id)
        rec = {"wall_s": wall, "active_s": st["latency"]["active_s"],
               "queued_s": st["latency"]["queued_s"], "ttfv_s": st["latency"]["ttfv_s"],
               "unique": r["unique"], "states": r["states"], "depth": r["max_depth"],
               "packed": st["packed"], "preempts": st["preempts"], "retries": st["retries"],
               "warm_start": st["warm_start"], "launches": n}
        if ck is not None and hasattr(ck, "waves"):
            rec.update(engine=ck._wave_kernel, waves=ck.waves, drains=ck.drains,
                       evictions=ck.evictions, host_probe_s=ck.host_probe_s,
                       stale_lanes=ck.stale_lanes, handoff_wave=ck.handoff_wave,
                       graph_captures=ck.graph_captures, capture_s=ck.capture_s)
            assert ck.device.type == "cuda", (name, ck.device)
            if ck.waves:
                # Every wave went through the fused kernels, and the insert
                # kernel seeded or rebuilt the table.
                assert n["fused_wave"] >= ck.waves, (name, n, ck.waves)
                assert n["hashset_insert_sorted"] >= 1, (name, n)
        rec.update(extra)
        out["runs"][name] = rec
        log(json.dumps({"service_run": dict(name=name, **{k: v for k, v in rec.items()
                                                         if k != "launches"})}))
        return h, r, rec

    spawn = dict(cfg.spawn)
    direct_2pc8 = cfg.make().checker().spawn_gpu_bfs(max_drain_waves=8, **spawn).join()
    assert direct_2pc8.unique_state_count() == cfg.unique

    # (a) 4 x 2pc-5, packed; the salted insert on one full-width wave.
    svc = CheckService(quantum_s=60.0, clock=clock)
    keep_checkers(svc)
    F = svc.default_spawn["frontier_capacity"]
    real, seen = _capture_pack_insert(pt, F * TwoPhaseSys(5).packed_action_count(), nth=4)
    try:
        _zero_launches()
        t0 = time.perf_counter()
        hs = [svc.submit(model_name="2pc", model_args={"rm_count": 5}) for _ in range(4)]
        rs = [h.result(timeout=300) for h in hs]
        torch.cuda.synchronize()
        launches["pack_2pc5x4"] = _read_launches()
        pack_wall = time.perf_counter() - t0
    finally:
        pt.hashset_insert_salted = real
    direct = TwoPhaseSys(5).checker().spawn_gpu_bfs(**svc.default_spawn).join()
    for h, r in zip(hs, rs):
        assert h.status()["packed"], h.status()
        assert (r["unique"], r["states"], r["max_depth"]) == (
            direct.unique_state_count(), direct.state_count(), direct.max_depth()), r
        assert sorted(r["discoveries"]) == sorted(direct.discoveries())
    assert launches["pack_2pc5x4"]["hashset_insert_sorted"] > 0
    out["runs"]["pack_2pc5x4"] = {"wall_s": pack_wall, "tenants": 4,
                                  "unique": [r["unique"] for r in rs]}
    out["insert"] = _insert_on_pack_wave(seen, "2pc-5 service pack wave")
    del seen

    # (b) a solo 2pc-8 job preempted for a higher-priority one, resumed.
    def preempted():
        h = svc.submit(model_name="2pc", model_args={"rm_count": 8}, spawn=dict(spawn))
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            ck = svc._active_checker
            if isinstance(ck, GpuBfsChecker) and ck.drains >= 2:
                break
            time.sleep(0.001)
        # A higher-priority arrival, then the running slice's quantum over.
        hi = svc.submit(model_name="2pc", model_args={"rm_count": 5}, priority=5,
                        spawn={"max_drain_waves": 4})
        clock.advance(120.0)
        assert hi.result(timeout=300)["unique"] == 8832
        return h

    h, r, _rec = job_run("solo_2pc8_preempted", svc, preempted)
    assert h.status()["preempts"] >= 1, h.status()
    assert _golden_text(r["report"]) == _golden(direct_2pc8), "preempted 2pc-8 report"
    svc.close()

    # (c) the budgeted 2pc-8 pair, synchronous and async.
    budget = min_admissible_hbm_budget_mib(cfg.make(), spawn["frontier_capacity"])
    out["budget_mib"] = budget
    svc = CheckService(quantum_s=600.0)
    keep_checkers(svc)
    pair = {}
    for mode, extra in (("sync", {}), ("async", {"async_pipeline": True})):
        restore, seen = _capture_after_eviction(GpuBfsChecker) if mode == "async" else (
            lambda: None, None)
        try:
            h, r, rec = job_run(f"budget_2pc8_{mode}", svc, lambda extra=extra: svc.submit(
                model_name="2pc", model_args={"rm_count": 8}, hbm_budget_mib=budget,
                spawn=dict(spawn, **extra)))
        finally:
            restore()
        pair[mode] = (r, checkers[h.job_id])
        if seen is not None:
            out["evicted_wave"] = _fused_held("2pc-8 after an eviction", seen["spec"],
                                              seen["table"], seen["chunk"], seen["depth_cap"])
            del seen
    (rs_, cs), (ra, ca) = pair["sync"], pair["async"]
    assert ra["unique"] == rs_["unique"] == cfg.unique
    assert (ra["states"], ra["max_depth"], ca.evictions) == (
        rs_["states"], rs_["max_depth"], cs.evictions), (ra, rs_)
    assert cs.evictions >= 2
    assert _golden_text(ra["report"]) == _golden_text(rs_["report"])
    out["budget_pair"] = {m: {"wall_s": out["runs"][f"budget_2pc8_{m}"]["wall_s"],
                              "host_probe_s": c.host_probe_s, "evictions": c.evictions,
                              "stale_lanes": c.stale_lanes}
                          for m, (_r, c) in pair.items()}
    log(json.dumps({"service_budget_pair": out["budget_pair"]}))
    svc.close()
    del pair, cs, ca

    # (d) a seed on a service_dir, resubmitted to a new service.
    with tempfile.TemporaryDirectory() as tmp:
        walls = {}
        for attempt in ("cold", "seeded"):
            svc = CheckService(quantum_s=600.0, service_dir=tmp)
            keep_checkers(svc)
            try:
                h, r, rec = job_run(f"seed_2pc8_{attempt}", svc, lambda: svc.submit(
                    model_name="2pc", model_args={"rm_count": 8}, spawn=dict(spawn)))
            finally:
                svc.close()
            walls[attempt] = rec["wall_s"]
            assert r["unique"] == cfg.unique
            assert bool(h.status()["warm_start"]) == (attempt == "seeded"), h.status()
        assert rec["waves"] == 0, rec
        out["seed"] = dict(walls, seeded_from=h.status()["seeded_from"])
        log(json.dumps({"service_seed": out["seed"]}))

    # (e) a device.wave fault in a drained job, retried.
    svc = CheckService(quantum_s=600.0, packing=False)
    keep_checkers(svc)
    fault_spawn = {"max_drain_waves": 4}
    with inject(FaultSpec("device.wave", at=1)) as inj:
        h, r, rec = job_run("fault_2pc5", svc, lambda: svc.submit(
            model_name="2pc", model_args={"rm_count": 5}, spawn=dict(fault_spawn)))
    assert inj.triggered() == 1 and h.status()["retries"] == 1, h.status()
    assert h.status()["faults"][0]["class"] == "device_wave"
    want = TwoPhaseSys(5).checker().spawn_gpu_bfs(**dict(svc.default_spawn, **fault_spawn)).join()
    assert _golden_text(r["report"]) == _golden(want), "retried 2pc-5 report"

    # (f) a conformance job, and a swarm pair.
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "conformance_corpus.jsonl")
    with open(path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    h, r, _rec = job_run("conformance_seed", svc, lambda: svc.submit(conformance=lines))
    records, _ = decode_lines(lines)
    twin = ConformanceChecker(records, default_zoo(), device="cpu").join()
    _same_verdicts("service conformance", r["conformance"]["records"],
                   twin.conformance_report()["records"])
    svc.close()
    svc = CheckService(quantum_s=600.0)
    _zero_launches()
    t0 = time.perf_counter()
    hs = [svc.submit(model_name="2pc", model_args={"rm_count": 3}, mode="swarm", seed=s,
                     options={"target_state_count": 10_000}) for s in (21, 22)]
    rs = [h.result(timeout=300) for h in hs]
    torch.cuda.synchronize()
    launches["swarm_2pc3x2"] = _read_launches()
    out["runs"]["swarm_2pc3x2"] = {"wall_s": time.perf_counter() - t0,
                                   "states": [r["states"] for r in rs]}
    for s, r in zip((21, 22), rs):
        ck = TwoPhaseSys(3).checker().target_state_count(10_000).spawn_swarm(
            seed=s, **svc.default_swarm_spawn).join()
        assert (r["states"], r["unique"]) == (ck.state_count(), ck.unique_state_count()), r
    assert any(h.status()["packed"] for h in hs)
    svc.close()

    # (g) memory: every job's table, ring, log and graphs released.
    replay_graphs = len(_KERNELS)
    checkers.clear()
    del direct, direct_2pc8, want, twin, ck, h, hs
    gc.collect()
    torch.cuda.synchronize()
    before_clear = torch.cuda.memory_allocated()
    clear_replay_kernels()
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    bound = 1 << 20
    out["memory"] = {"start_bytes": mem0, "end_bytes": mem1, "bound_bytes": bound,
                     "replay_cache_bytes": before_clear - mem1,
                     "replay_graphs": replay_graphs}
    log(json.dumps({"service_memory": out["memory"]}))
    assert mem1 <= mem0 + bound, out["memory"]
    out["launches"] = launches
    return out


@phase("conformance")
def conformance():
    """The conformance plane on the card at the JAX bench's conformance leg
    (``bench.py:1483-1653``), each result against the CPU twin: the seed
    corpus through ``ConformanceChecker(parity=True, batch_lanes=32)``;
    replay of increment_lock (T = 16, a pool of 32 seeded walks from
    ``random.Random(20)``) at 1, 64 and 1,024 lanes, cold (the graph's
    capture) then warm; audits of register C=2, O=2 linearizability
    histories at the same batches; the divergence sweep (0, 10 and 50% of
    1,024 lanes divergent, counted exactly). Then the insert micro-bench
    (``ops/bench_hashset.run``) at its defaults and at the main path's
    shape, the kernel against its plain twin."""
    import random

    from stateright_tpu_torch.conformance import (
        ConformanceChecker,
        audit_batch,
        bucket_key,
        decode_lines,
        mutate_trace,
        random_history,
        random_walk_trace,
        replay_batch,
        replay_kernel,
    )
    from stateright_tpu_torch.ops import bench_hashset
    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.service import aot_namespace, default_zoo

    out = {"replay": {}, "audit": {}, "divergence_sweep": {}, "bench": {}}

    # The seed corpus, card and CPU twin, the host parity gate on.
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "conformance_corpus.jsonl")
    with open(path, encoding="utf-8") as f:
        records, refusals = decode_lines([ln for ln in f if ln.strip()])
    assert not refusals and len(records) == 36
    reports = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        ck = ConformanceChecker(records, default_zoo(), parity=True, batch_lanes=32,
                                device=dev).join()
        reports[dev] = (ck.conformance_report(), time.perf_counter() - t0)
    card, cpu = (dict(reports[d][0]) for d in ("cuda", "cpu"))
    traces_per_s = card.pop("traces_per_s")
    cpu.pop("traces_per_s")
    if card != cpu:
        raise AssertionError("seed corpus: the card's conformance_report() != the CPU twin's")
    out["seed_corpus"] = {k: card[k] for k in ("traces", "histories", "refusals",
                                               "divergences", "violations")}
    out["seed_corpus"].update(traces_per_s=traces_per_s, wall_s=reports["cuda"][1],
                              cpu_wall_s=reports["cpu"][1])
    log(f"  seed corpus: {json.dumps(out['seed_corpus'])}")

    # Replay: the bench leg's pools, replicated with fresh ids.
    name, T = "increment_lock", CONFORMANCE_TRACE_STEPS
    model = default_zoo()[name]()
    ns = aot_namespace(name, {})
    rng = random.Random(20)
    walk_pool = [random_walk_trace(model, rng, T, rec_id=f"w{i}", model_name=name)
                 for i in range(32)]
    divergent_pool = [m for m in (mutate_trace(model, rng, r) for r in walk_pool)
                      if m is not None]
    assert divergent_pool, "no mutation sites in the walk pool"

    def trace_batch(n, frac=0.0):
        n_div = int(round(n * frac))
        return [dict(src, id=f"{src['id']}-{i}") for i, src in enumerate(
            divergent_pool[i % len(divergent_pool)] if i < n_div
            else walk_pool[i % len(walk_pool)] for i in range(n))]

    for n in CONFORMANCE_BATCHES:
        recs = trace_batch(n)
        got, warm, cold, median = _timed_twice(
            lambda: replay_batch(recs, model, ns, T, lanes=n, device="cuda"))
        _same_verdicts(f"replay batch {n}", got,
                       replay_batch(recs, model, ns, T, lanes=n, device="cpu"))
        assert all(v["conforms"] for v in got)
        fn = replay_kernel(model, ns, T, n, "cuda")
        out["replay"][str(n)] = {"traces_per_s": n / warm, "warm_s": warm, "cold_s": cold,
                                 "warm_median_s": median, "capture_s": fn.capture_s,
                                 "captures": fn.captures}
        log(f"  replay batch={n}: {n / warm:,.0f} traces/s (warm {warm * 1e3:.3f} ms, "
            f"median of 5 more {median * 1e3:.3f} ms, cold {cold:.3f} s, "
            f"capture {fn.capture_s:.3f} s)")
    out["replay_batch_amortization"] = (out["replay"]["1024"]["traces_per_s"]
                                        / out["replay"]["1"]["traces_per_s"])

    # Audit: one bucket, register C=2, O=2 linearizability.
    hist_pool = [random_history(rng, spec="register", semantics="linearizability",
                                threads=2, ops_per_thread=2, mode=("clean", "random")[i % 2],
                                rec_id=f"h{i}") for i in range(64)]
    key0 = bucket_key(hist_pool[0])
    hist_pool = [h for h in hist_pool if bucket_key(h) == key0]
    for n in CONFORMANCE_BATCHES:
        recs = [dict(hist_pool[i % len(hist_pool)], id=f"h{i}-{n}") for i in range(n)]
        got, warm, cold, median = _timed_twice(lambda: audit_batch(recs, device="cuda"))
        _same_verdicts(f"audit batch {n}", got, audit_batch(recs, device="cpu"))
        assert all("refused" not in v for v in got)
        out["audit"][str(n)] = {"histories_per_s": n / warm, "warm_s": warm, "cold_s": cold,
                                "warm_median_s": median}
        log(f"  audit batch={n}: {n / warm:,.0f} histories/s (warm {warm * 1e3:.3f} ms, "
            f"median of 5 more {median * 1e3:.3f} ms, cold {cold:.3f} s)")

    # The divergence sweep at the widest batch: the graph is branchless, so
    # throughput should not move with the divergent share.
    n = CONFORMANCE_BATCHES[-1]
    for frac in (0.0, 0.1, 0.5):
        recs = trace_batch(n, frac)
        t0 = time.perf_counter()
        got = replay_batch(recs, model, ns, T, lanes=n, device="cuda")
        warm = time.perf_counter() - t0
        _same_verdicts(f"divergence {frac}", got,
                       replay_batch(recs, model, ns, T, lanes=n, device="cpu"))
        n_div = sum(1 for v in got if not v["conforms"])
        if n_div != int(round(n * frac)):
            raise AssertionError(f"divergence {frac}: {n_div} divergent lanes")
        out["divergence_sweep"][f"{int(frac * 100)}pct"] = {"traces_per_s": n / warm,
                                                            "divergent_lanes": n_div}
    rates = [v["traces_per_s"] for v in out["divergence_sweep"].values()]
    out["divergence_flatness"] = min(rates) / max(rates)
    log(f"  divergence sweep: {json.dumps(out['divergence_sweep'])} "
        f"flatness {out['divergence_flatness']:.3f}")

    # The insert micro-bench, its launches counted from 0 over each run.
    for label, (log2_cap, batch) in BENCH_SHAPES.items():
        hk.launches = 0
        res = bench_hashset.run(log2_cap, batch, device="cuda", must_move=True)
        launches = hk.launches
        if not res["equal"] or launches != res["launches"]:
            raise AssertionError(f"{label}: kernel and plain twin disagree ({res})")
        rounds = res["rounds"]
        out["bench"][label] = {
            "cap_log2": log2_cap, "batch": batch, "rounds": rounds, "launches": launches,
            "max_abs_err": res["max_abs_err"],
            "kernel_lanes_per_s": res["kernel"]["lanes_per_s"],
            "plain_lanes_per_s": res["plain"]["lanes_per_s"],
            "fresh": res["kernel"]["fresh"], "pending": res["kernel"]["pending"],
            # A round's mean: one insert of one batch.
            "ms": res["kernel"]["seconds"] * 1e3 / rounds,
            "plain_ms": res["plain"]["seconds"] * 1e3 / rounds,
            "bound_ms": res["must_move_bytes"] / rounds / HBM_BYTES_PER_S * 1e3,
        }
        out["bench"][label]["last_round"] = _bench_last_round(log2_cap, batch)
        log(f"  {label}: {json.dumps(out['bench'][label])}")
    return out


def _bench_last_round(log2_cap, batch):
    """The micro-bench's last round alone: its table before it (the plain
    twin over the earlier rounds), then ``_compare_insert``: the kernel's
    launch under CUDA events (median of 21, no wrapper), err against the
    twin, the tiles touched and those the repair redid."""
    import numpy as np
    import torch

    from stateright_tpu_torch.interop import table_to_numpy
    from stateright_tpu_torch.ops import bench_hashset
    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.ops.hashset import hashset_new

    data = bench_hashset.batches(log2_cap, batch)
    table = hashset_new(1 << log2_cap)
    ones = torch.ones(batch, dtype=torch.bool)
    for hi, lo in data[:-1]:
        table, *_ = hk.hashset_insert_sorted_plain(table, *bench_hashset._keys(hi, lo, "cpu"),
                                                   ones)
    hi, lo = data[-1]
    r = _compare_insert(table_to_numpy(table), hi, lo, np.ones(batch, bool), timing=True,
                        passes=False)
    if r["err"] or r["redone"] != r["to_redo"]:
        raise AssertionError(f"the bench's last round: err {r['err']}, the repair redid "
                             f"{r['redone']} tiles of {r['to_redo']} to redo")
    return {"kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "max_abs_err": r["err"],
            "tiles_touched": r["touched"], "tiles_redone": r["redone"],
            "tiles_to_redo": r["to_redo"]}


@phase("stage_device_profile")
def stage_device_profile(reps=5):
    """``_profile_chains`` over every timed wave, in this process's only
    ``torch.profiler`` session (a later session in one process dropped
    device records): ``fw_sort``'s device operations on the 2pc-8 wave's
    keys, and each wave's chain replayed in a CUDA Graph, each coverage
    wave beside its coverage-off twin. Completes each wave's
    ``stage_record`` with ``fused_wave_stage_device_ms`` (each stage's
    device ms a wave inside the graph: no host gaps, unlike the event marks
    of ``fused_wave_stage_ms``), ``fused_wave_stage_device_ops``,
    ``fused_wave_op_device_us`` (each device operation of ``keys_input``,
    the frontier, keys, dedup, compaction and stats stages),
    ``fused_wave_device_ms``, ``compact_device_ops`` and
    ``frontier_device_ops``, and on a coverage wave the twin's stages and
    ``coverage_epilogue_device_ms``, the frontier's and the compaction's
    in-graph ms with coverage on less with it off; logs it. Raises unless
    the compaction and the frontier ran their stated device operations,
    the dedup one, a fold wave's ``keys_input`` none, and a coverage wave
    no stage and no device operation more than its coverage-off twin."""
    from stateright_tpu_torch.ops import fused_wave as fw

    waves = _waves_on_card(STAGE_WAVES)
    first = waves[0]
    assert first["rec"]["wave"] == "2pc8", first["rec"]["wave"]
    key0, idx0 = fw.route_keys_stage(first["spec"], fw.keys_input(first["spec"], first["cand"]),
                                     first["cand"], first["cvalid"], first["depth"],
                                     first["depth_cap"], None, first["mask"])
    sort_ops, stages = _profile_chains(waves, (key0, idx0), reps)
    if len(sort_ops) != fw.sort_device_ops:
        raise AssertionError(f"fw_sort queued {len(sort_ops)} device operations, not "
                             f"{fw.sort_device_ops}")
    sort_us = {}
    for name, us in sort_ops:
        sort_us[name.split("(")[0]] = sort_us.get(name.split("(")[0], 0.0) + us
    first["rec"].update(sort_device_ops=len(sort_ops), sort_device_us=sort_us)
    log(f"  fw_sort device operations on the 2pc-8 wave (torch.profiler): {len(sort_ops)}, "
        f"device us a sort: {sort_us}")
    by_wave = {w["rec"]["wave"]: st for w, st in zip(waves, stages)}
    for w, (stage_ms, stage_ops, op_us) in zip(waves, stages):
        rec = w["rec"]
        if rec["wave"].endswith("_coverage_off"):
            continue
        rec["fused_wave_stage_device_ms"] = stage_ms
        rec["fused_wave_stage_device_ops"] = stage_ops
        rec["fused_wave_op_device_us"] = op_us
        rec["fused_wave_device_ms"] = sum(stage_ms.values())
        rec["compact_device_ops"] = stage_ops["compact"]
        rec["frontier_device_ops"] = stage_ops["frontier"]
        if stage_ops["compact"] != fw.compact_device_ops:
            raise AssertionError(f"{rec['wave']}: fw_compact ran {stage_ops['compact']} device "
                                 f"operations, not {fw.compact_device_ops}")
        if stage_ops["frontier"] != fw.frontier_device_ops:
            raise AssertionError(f"{rec['wave']}: fw_frontier ran {stage_ops['frontier']} device "
                                 f"operations, not {fw.frontier_device_ops}")
        if stage_ops["dedup"] != 1:
            raise AssertionError(f"{rec['wave']}: fw_dedup ran {stage_ops['dedup']} device "
                                 f"operations, not 1")
        if "keys_ms" in rec and "keys_input" in stage_ops:
            raise AssertionError(f"{rec['wave']}: the fold route's keys_input ran "
                                 f"{stage_ops['keys_input']} device operations in the graph")
        off = by_wave.get(f"{rec['wave']}_off")
        if off is not None:
            off_ms, off_ops, _off_us = off
            if "coverage" in stage_ops or sum(stage_ops.values()) != sum(off_ops.values()):
                raise AssertionError(f"{rec['wave']}: coverage on ran {stage_ops}, coverage off "
                                     f"{off_ops}")
            rec["coverage_off_stage_device_ms"] = off_ms
            rec["coverage_off_stage_device_ops"] = off_ops
            rec["coverage_epilogue_device_ms"] = (
                stage_ms["frontier"] + stage_ms["compact"] - off_ms["frontier"]
                - off_ms["compact"])
            log(f"  {rec['wave']}: coverage epilogue in the graph "
                f"{rec['coverage_epilogue_device_ms'] * 1e3:.2f} us a wave (frontier "
                f"{stage_ms['frontier'] * 1e3:.2f} us, off {off_ms['frontier'] * 1e3:.2f}; "
                f"compact {stage_ms['compact'] * 1e3:.2f} us, off "
                f"{off_ms['compact'] * 1e3:.2f}); device operations on "
                f"{sum(stage_ops.values())}, off {sum(off_ops.values())}")
        log(json.dumps({"stage_record": rec}))
        log(f"  {rec['wave']} in-graph device ms a wave (torch.profiler): " + " ".join(
            f"{st}={ms:.4f}" for st, ms in stage_ms.items())
            + f"; chain {rec['fused_wave_device_ms']:.4f} ms")


def stage_ab(root, out=None):
    """The keys stage, the frontier, the dedup and the compaction alone,
    for the package of ``root``: the timed waves of this script (a
    full-width 2pc-8 wave, full-width takes of the paxos3, abd3o and raft5
    drains, the coverage takes of 2pc-8 and skv4x4); on each, the keys
    stage and the sort as the chain runs them and the chain on a copy of the
    table for the sweep's outcome bytes, then timed alone with CUDA events
    (``_time_on_card``): the compaction (``compact_stage``), the frontier
    (``frontier_stage``), the dedup (``dedup_stage``), the keys stage
    (``comphash_keys_stage`` on actor waves; on fold waves
    ``route_keys_stage`` over ``keys_input``'s output, and the two
    together); the dedup alone on the sparse waves of ``_sparse_waves``;
    and last every wave's ``keys_input`` and chain in-graph
    (``_profile_chains``, kernels of earlier checkouts included), each
    coverage wave also with coverage off. These stages keep their Python
    signatures across the checkouts compared, so a parent and a change run
    the same code around them. Prints one ``{"stage_ab": ...}`` line a
    wave and appends them to ``out``."""
    import stateright_tpu_torch
    from stateright_tpu_torch.ops import _build
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(stateright_tpu_torch.__file__)))
    if pkg != root:
        raise AssertionError(f"stateright_tpu_torch came from {pkg}, not {root}")
    card = card_line()
    _build.build_all(KERNEL_SOURCES)
    waves = {"2pc8": _capture_2pc8_wave()}
    waves["2pc8"]["frontier"] = dict(waves["2pc8"]["chunk"], mask=None)
    for label, name, min_unique, live in (("paxos3", "paxos3", 300_000, 1),
                                          ("abd3o", "abd3o", 10_000, 2),
                                          ("raft5", "raft5_ttc", 10_000, 1)):
        waves[label] = _capture_take(name, min_unique,
                                     _config(name).spawn["frontier_capacity"] // live)
    for name, min_unique in (("2pc8", 200_000), ("skv4x4", 2_000_000)):
        cfg = _config(name)
        got = _capture_take(name, min_unique, cfg.spawn["frontier_capacity"])
        got["spec_off"] = got["spec"]
        got["spec"] = _with_coverage(got["spec"], cfg.make())
        waves[f"{name}_coverage"] = got

    recs, chains = [], []
    for label, got in waves.items():
        spec, table0, front, depth_cap = (got[k] for k in ("spec", "table", "frontier",
                                                           "depth_cap"))
        mask = front["mask"]
        hi, lo, ebits, depth = (front[k] for k in ("hi", "lo", "ebits", "depth"))
        F, A = hi.shape[0], spec.action_count
        cond, cvalid, cand = fw.model_stage(spec, front["states"], F)
        ant = (fw.antecedent_stage(spec, front["states"], F) if spec.cov_layout is not None
               else None)
        kin = fw.keys_input(spec, cand)
        key, idx = fw.route_keys_stage(spec, kin, cand, cvalid, depth, depth_cap, None, mask)
        fw.sort_stage(key, idx)
        work, taps = table0.clone(), {}
        fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond, cvalid, kin, cand,
                        mask=mask, ant=ant, taps=taps)
        acc = taps["acc"].clone()
        cargs = (taps["flag"], key, idx, A, taps["ebits_after"], depth, hi, lo)
        compact_ms, _ = _time_on_card(lambda mark: fw.compact_stage(*cargs, acc))
        facc = acc.clone()
        frontier_ms, _ = _time_on_card(lambda mark: fw.frontier_stage(
            spec, cond, cvalid, ebits, depth, depth_cap, facc, mask))
        dargs = (key, idx, hk._check_capacity(table0), cvalid, A, depth, depth_cap, mask)
        dedup_ms, _ = _time_on_card(lambda mark: fw.dedup_stage(*dargs))
        rec = {"wave": label, "root": root, "card": card, "B": F * A, "n_new": int(acc[1]),
               "compact_ms": compact_ms, "frontier_ms": frontier_ms, "dedup_ms": dedup_ms}
        if spec.keys_route == "comphash":
            rec["comphash_keys_ms"], _ = _time_on_card(lambda mark: fw.comphash_keys_stage(
                spec.comphash, cand, cvalid, depth, depth_cap, A, None, mask))
            rec["valid_lanes"] = int((key != -1).sum())
        if spec.keys_route == "fold":
            # The keys stage alone on what keys_input gave it, and the
            # whole fold keys work: keys_input and the keys stage.
            rec["fold_keys_ms"], _ = _time_on_card(lambda mark: fw.route_keys_stage(
                spec, kin, cand, cvalid, depth, depth_cap, None, mask))
            rec["fold_keys_work_ms"], _ = _time_on_card(lambda mark: fw.route_keys_stage(
                spec, fw.keys_input(spec, cand), cand, cvalid, depth, depth_cap, None, mask))
            rec["valid_lanes"] = int((key != -1).sum())
        log(json.dumps({"stage_ab_events": rec}))
        recs.append(rec)
        chains.append(dict(spec=spec, table0=table0, hi=hi, lo=lo, ebits=ebits, depth=depth,
                           depth_cap=depth_cap, cond=cond, cvalid=cvalid, cand=cand,
                           mask=mask, ant=ant))
        if ant is not None:
            recs.append({"wave": f"{label}_off", "root": root, "card": card, "B": F * A})
            chains.append(dict(chains[-1], spec=got["spec_off"], ant=None))
    sparse = [{"wave": label, "root": root, "card": card, "B": args[0].shape[0],
               "dedup_ms": _time_on_card(lambda mark: fw.dedup_stage(*args))[0]}
              for label, args in _sparse_waves()]
    _sort_ops, stages = _profile_chains(chains, kernels=EARLIER_STAGE_KERNELS)
    for rec, (stage_ms, stage_ops, op_us) in zip(recs, stages):
        rec.update(stage_device_ms=stage_ms, stage_device_ops=stage_ops, op_device_us=op_us)
    lines = [json.dumps({"stage_ab": rec}) for rec in recs + sparse]
    for line in lines:
        log(line)
    if out:
        with open(out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage-ab", action="store_true",
                    help="time the keys stage, the frontier, the dedup and the compaction alone "
                         "(see stage_ab)")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="with --stage-ab: the checkout whose package is timed")
    ap.add_argument("--out", default=None, help="with --stage-ab: JSON lines output path")
    ap.add_argument("--sharded-child", nargs=3, default=None,
                    metavar=("RANK", "PORT", "OUT"),
                    help="run one rank of the sharded phase's two-rank NCCL leg")
    ap.add_argument("--attributed-child", default=None, metavar="PATH",
                    help="run only attributed_runs() and write them to PATH (the "
                         "attribution_and_breakdown phase starts this)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.stage_ab:
        sys.path.insert(0, root)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import stateright_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if args.stage_ab:
        return stage_ab(root, args.out)
    if args.attributed_child:
        return _attributed_child(args.attributed_child)
    if args.sharded_child:
        rank, port, out = args.sharded_child
        return _sharded_child(int(rank), int(port), out)

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = card_line()
    build_kernels()
    insert = kernel_vs_plain() if not FAILED else None
    fused = fused_vs_plain() if not FAILED else None
    sparse = dedup_sparse_vs_plain() if not FAILED else None
    staged = main_path() if not FAILED else None
    fused_run = main_path_fused(staged) if not FAILED else None
    drains = main_path_drain((staged, fused_run)) if not FAILED else None
    if not FAILED:
        replay_small()
    comphash = comphash_vs_plain() if not FAILED else None
    paxos3 = main_path_paxos3() if not FAILED else None
    ordered = comphash_ordered_vs_plain() if not FAILED else None
    abd3o = main_path_abd3o() if not FAILED else None
    raft5_wave = comphash_raft5_vs_plain() if not FAILED else None
    raft5 = main_path_raft5_ttc() if not FAILED else None
    raft4 = main_path_raft4() if not FAILED else None
    fps_waves = fps_vs_materialize() if not FAILED else None
    if not FAILED:
        replay_actor_small()
    coverage = coverage_vs_plain() if not FAILED else None
    cov_2pc8 = main_path_2pc8_coverage(drains) if not FAILED else None
    cov_skv = main_path_skv4x4_coverage() if not FAILED else None
    if not FAILED:
        replay_coverage_small()
    sym_insert = symmetry_insert_vs_plain() if not FAILED else None
    sym_2pc9 = symmetry_2pc9_drain(sym_insert) if not FAILED else None
    sym_2pc5 = symmetry_2pc5_waves() if not FAILED else None
    if not FAILED:
        symmetry_increment()
    sym_raft3 = symmetry_raft3_dup() if not FAILED else None
    sym_raft5 = symmetry_raft5_ttc(raft5["staged"]) if not FAILED else None
    sym_fallback = symmetry_drain_vs_cpu() if not FAILED else None
    host = host_engines_and_lasso(drains) if not FAILED else None
    tiering = checkpoint_resume_tiering() if not FAILED else None
    attribution = attribution_and_breakdown() if not FAILED else None
    walks = simulation_and_swarm() if not FAILED else None
    liveness = device_liveness() if not FAILED else None
    packing = tenant_packing() if not FAILED else None
    shard = sharded() if not FAILED else None
    conf = conformance() if not FAILED else None
    svc = service() if not FAILED else None
    if not FAILED:
        stage_device_profile()
    if FAILED:
        log(f"FAILED phases: {FAILED}")
        return 1
    log(card)
    # Each path's launches, counted over its own run; each wave held to
    # its plain twins.
    actor_runs = {"paxos3": paxos3, "abd3o": abd3o, "raft5": raft5, "raft4": raft4}
    waves = {"paxos3": comphash, "abd3o": ordered, "raft5": raft5_wave}

    def by_path(engine, kernel, runs):
        return {name: run[engine]["launches"][kernel] for name, run in runs.items()}

    insert_launches = by_path("staged", "hashset_insert_sorted",
                              {"2pc8": drains, **actor_runs})
    # The symmetry paths run the staged engine only: every wave's canonical
    # keys go through the insert kernel.
    sym_runs = {"symmetry_2pc9": sym_2pc9, "symmetry_2pc5_wave": sym_2pc5["wave"],
                "symmetry_2pc5_drain": sym_2pc5["drain"],
                "symmetry_raft3_dup_drain": sym_raft3["drain"], "symmetry_raft5": sym_raft5,
                "symmetry_fallback_drain": sym_fallback}
    insert_launches.update({name: run["launches"]["hashset_insert_sorted"]
                            for name, run in sym_runs.items()})
    # The swarm's visited sample: one launch a tenant a step.
    insert_launches.update(walks["launches"])
    # Device liveness: the staged engine's insert, every wave.
    insert_launches.update({f"liveness_{name}": n for name, n in liveness["launches"].items()})
    # Tenant packing: every salted claim of a pack (its seeds, waves, bulk
    # admissions and table growths); the solo and resumed runs beside the
    # packs join default_runs below.
    pack_solo = {name: n for name, n in packing["launches"].items() if isinstance(n, dict)}
    insert_launches.update({name: n for name, n in packing["launches"].items()
                            if not isinstance(n, dict)})
    # Sharding: every owner insert of every shard, the seeds and the
    # growths' rehashes.
    insert_launches.update(shard["launches"])
    # The insert micro-bench: a launch a round and its warm-up batch.
    insert_launches.update({label: b["launches"] for label, b in conf["bench"].items()})
    # The check service: its pack's salted claims and its swarm pair's
    # sample inserts (its solo jobs join default_runs below).
    insert_launches.update({f"service_{name}": svc["launches"][name]["hashset_insert_sorted"]
                            for name in ("pack_2pc5x4", "swarm_2pc3x2")})
    fused_launches = by_path("fused", "fused_wave", {"2pc8": drains, **actor_runs})
    comphash_launches = by_path("fused", "fw_comphash_keys", actor_runs)
    cov_runs = {"2pc8": cov_2pc8, "skv4x4": cov_skv}
    coverage_launches = by_path("fused", "coverage_epilogue", cov_runs)
    coverage_fresh_launches = by_path("fused", "coverage_epilogue_fresh", cov_runs)
    main_runs = {"2pc8": drains, **actor_runs, "2pc8_coverage": cov_2pc8, "skv4x4": cov_skv}
    sort_launches = by_path("fused", "fw_sort", main_runs)
    dedup_launches = by_path("fused", "fw_dedup", main_runs)
    compact_launches = by_path("fused", "fw_compact", main_runs)
    gather_launches = by_path("fused", "fw_gather", main_runs)
    frontier_launches = by_path("fused", "fw_frontier", main_runs)
    keys_launches = by_path("fused", "fw_keys", main_runs)
    # 2pc-8 through the default engine (fused) in host_engines_and_lasso.
    # ... and the runs of checkpoint_resume_tiering (2pc-8 on the default
    # engine, abd3o staged).
    # ... and the attributed 2pc-8 run with its unattributed twin
    # (attribution_and_breakdown).
    default_runs = {"2pc8_default": host["gpu_default_2pc8"],
                    **{f"tiering_{name}": {"launches": n}
                       for name, n in tiering["launches"].items()},
                    **{f"attribution_{name}": run
                       for name, run in attribution["runs"].items()},
                    **{name: {"launches": n} for name, n in pack_solo.items()},
                    # The service's solo exhaustive jobs (the seeded job runs
                    # no wave and launches nothing: it verifies on the host).
                    **{f"service_{name}": {"launches": svc["launches"][name]}
                       for name in ("solo_2pc8_preempted", "budget_2pc8_sync",
                                    "budget_2pc8_async", "seed_2pc8_cold", "fault_2pc5")}}
    for kernel, counts in (("hashset_insert_sorted", insert_launches),
                           ("fused_wave", fused_launches), ("fw_sort", sort_launches),
                           ("fw_dedup", dedup_launches), ("fw_compact", compact_launches),
                           ("fw_gather", gather_launches), ("fw_frontier", frontier_launches),
                           ("fw_keys", keys_launches)):
        counts.update({name: run["launches"][kernel] for name, run in default_runs.items()})
    raft5_insert = raft5_wave["insert"]
    # Each timed wave's sort and gather records, with the launches of the
    # path the wave was taken from.
    stage_waves = {}
    for res in (fused, comphash, ordered, raft5_wave, *coverage.values()):
        stage_waves.update(res["waves"])
    wave_path = {"2pc8": "2pc8", "paxos3": "paxos3", "abd3o": "abd3o", "raft5": "raft5",
                 "2pc8_coverage": "2pc8_coverage", "skv4x4_coverage": "skv4x4"}

    def held(res, launches):
        return {"launches": launches, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"], "bound_by": "bytes",
                "library_ms": None}

    library = {"sort": "torch_sort_ms", "gather": "index_select_sum_ms", "compact": None,
               "frontier": None, "keys": None, "dedup": "torch_searchsorted_ms"}

    def stage_held(kernel, launches):
        return {wave: {"launches": launches[wave_path[wave]],
                       "max_abs_err": r[f"{kernel}_max_abs_err"], "ms": r[f"{kernel}_ms"],
                       "plain_ms": r[f"{kernel}_plain_ms"], "bound_ms": r[f"{kernel}_bound_ms"],
                       "bound_by": "bytes",
                       "library_ms": r[library[kernel]] if library[kernel] else None}
                for wave, r in stage_waves.items() if f"{kernel}_ms" in r}

    rec_2pc8, gather_paxos3 = stage_waves["2pc8"], stage_waves["paxos3"]
    rec_cov = stage_waves["2pc8_coverage"]
    fold_waves = [r for r in stage_waves.values() if "keys_ms" in r]

    log(json.dumps({"kernels": [
        {
            "name": "hashset_insert_sorted",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/hashset_insert.cu",
            "replaces": "stateright_tpu/ops/pallas_hashset.py:193",
            "launches": sum(insert_launches.values()),
            "launches_by_path": insert_launches,
            "max_abs_err": max(insert["max_abs_err"], raft5_insert["max_abs_err"],
                               sym_insert["max_abs_err"],
                               tiering["restore_insert"]["max_abs_err"],
                               walks["insert"]["max_abs_err"],
                               packing["insert"]["max_abs_err"],
                               shard["insert"]["max_abs_err"],
                               shard["evicted_insert"]["max_abs_err"],
                               shard["restore_insert"]["max_abs_err"],
                               svc["insert"]["max_abs_err"],
                               *(b["max_abs_err"] for b in conf["bench"].values())),
            # On a random 344,064-key batch into a 2^22-row table at load
            # 0.4; on the keys of a raft5 wave and on a 2pc-9 drain take's
            # canonical (symmetry) keys, below.
            "ms": insert["ms"],
            "plain_ms": insert["plain_ms"],
            "bound_ms": insert["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": {"raft5": held(raft5_insert, insert_launches["raft5"]),
                        "symmetry_2pc9": held(sym_insert, insert_launches["symmetry_2pc9"]),
                        # The restore's rebuild of a preempted 2pc-8 run's
                        # table: its launches in the resumed run.
                        "restore_2pc8": held(tiering["restore_insert"],
                                             tiering["resumed_payload"]["restore_inserts"]),
                        # One sample step of the deep sharded-KV swarm.
                        "swarm_skv483_deep": held(walks["insert"],
                                                  insert_launches["swarm_skv483_deep"]),
                        # One full-width wave of the 4 x 2pc-8 pack: four
                        # tenants' salted keys into the shared table.
                        "pack_2pc8x4": held(packing["insert"],
                                            insert_launches["pack_2pc8x4"]),
                        # One owner's received batch of the 8-shard 2pc-8
                        # run: every shard's keys for that owner, sorted.
                        "sharded_2pc8": held(shard["insert"],
                                             insert_launches["sharded_2pc8_n8"]),
                        # The first owner batch after an eviction of the
                        # budgeted 8-shard 2pc-8 run, into its emptied
                        # 2^18-row shard table.
                        "sharded_evicted_2pc8": held(shard["evicted_insert"],
                                                     insert_launches["sharded_2pc8_budget_spill"]),
                        # The last batch of the elastic restore's rebuild
                        # (8 shards to 4): its launches in the resumed run.
                        "sharded_restore_2pc8": held(shard["restore_insert"],
                                                     shard["restore_inserts"]),
                        # The insert micro-bench (ops/bench_hashset.py): a
                        # round's mean, the kernel against its twin on the
                        # host over the same batches.
                        **{label: held(b, b["launches"])
                           for label, b in conf["bench"].items()},
                        # One full-width wave of the service's 4 x 2pc-5
                        # pack: the tenants' salted keys.
                        "service_pack_2pc5x4": held(
                            svc["insert"], insert_launches["service_pack_2pc5x4"])},
        },
        {
            "name": "fused_wave",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:91",
            "launches": sum(fused_launches.values()),
            "launches_by_path": fused_launches,
            # The chain at 2pc-8; held bit for bit on the actor waves too,
            # and on the service's budgeted async 2pc-8 job's first wave
            # after an eviction (into the emptied table).
            "max_abs_err": max([fused["max_abs_err"], svc["evicted_wave"]["max_abs_err"]]
                               + [w["chain_err"] for w in waves.values()]),
            "ms": fused["ms"],
            "plain_ms": fused["plain_ms"],
            "bound_ms": fused["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": {"service_budget_2pc8_evicted": held(
                svc["evicted_wave"], fused_launches["service_budget_2pc8_async"])},
        },
        {
            "name": "fw_comphash_keys",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:180",
            "launches": sum(comphash_launches.values()),
            "launches_by_path": comphash_launches,
            "max_abs_err": max(w["max_abs_err"] for w in waves.values()),
            # The unordered route, on the paxos3 wave; each wave's own
            # numbers below (abd3o: the ordered route, one component per
            # FIFO flow; raft5: no history, drop and timeout classes).
            "ms": comphash["ms"],
            "plain_ms": comphash["plain_ms"],
            "bound_ms": comphash["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": {name: held(w, comphash_launches[name]) for name, w in waves.items()},
        },
        {
            "name": "fw_keys",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:180",
            "launches": sum(keys_launches.values()),
            "launches_by_path": keys_launches,
            "max_abs_err": max(r["keys_max_abs_err"] for r in fold_waves),
            # The default fold route from the candidate leaves, on the 2pc-8
            # wave; each fold wave's numbers below.
            "ms": rec_2pc8["keys_ms"],
            "plain_ms": rec_2pc8["keys_plain_ms"],
            "bound_ms": rec_2pc8["keys_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": stage_held("keys", keys_launches),
        },
        {
            "name": "fw_frontier",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:131",
            "launches": sum(frontier_launches.values()),
            "launches_by_path": frontier_launches,
            "device_ops_a_wave": rec_2pc8["frontier_device_ops"],
            "max_abs_err": max(r["frontier_max_abs_err"] for r in stage_waves.values()),
            # The prologue's eval mask, eventually bits and terminal lanes
            # (:131-143) and the epilogue's max depth and first hits
            # (:470-489), on the 2pc-8 wave; each timed wave's below.
            "ms": rec_2pc8["frontier_ms"],
            "plain_ms": rec_2pc8["frontier_plain_ms"],
            "bound_ms": rec_2pc8["frontier_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": stage_held("frontier", frontier_launches),
        },
        {
            "name": "coverage_epilogue",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:495",
            # No kernel of its own: fw_frontier adds the frontier half and
            # fw_compact the fresh half; a launch is a wave that ran both.
            "launches": sum(coverage_launches.values()),
            "launches_by_path": coverage_launches,
            "launches_fresh_by_path": coverage_fresh_launches,
            "max_abs_err": max(w["max_abs_err"] for w in coverage.values()),
            # On the 2pc-8 take: fw_frontier's and fw_compact's in-graph
            # ms with coverage on less with it off; the skv4x4 take's below.
            "ms": rec_cov["coverage_epilogue_device_ms"],
            "plain_ms": rec_cov["coverage_plain_ms"],
            "bound_ms": rec_cov["coverage_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": {
                name: {"launches": coverage_launches[name],
                       "max_abs_err": r["coverage_max_abs_err"],
                       "ms": r["coverage_epilogue_device_ms"],
                       "plain_ms": r["coverage_plain_ms"], "bound_ms": r["coverage_bound_ms"],
                       "bound_by": "bytes", "library_ms": None,
                       "alone_ms": r["coverage_alone_ms"]}
                for name, r in (("2pc8", rec_cov), ("skv4x4", stage_waves["skv4x4_coverage"]))},
        },
        {
            "name": "fw_dedup",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:189",
            "launches": sum(dedup_launches.values()),
            "launches_by_path": dedup_launches,
            "max_abs_err": max([r["dedup_max_abs_err"] for r in stage_waves.values()]
                               + [r["dedup_max_abs_err"] for r in sparse.values()]),
            # On the 2pc-8 wave; each timed wave's below, and the sparse
            # skv4x4-width waves (at most 64 keyed lanes, 16,384 tiles).
            # The skey[1:] != skey[:-1] pass is in each record as
            # dedup_neighbours_ms, for context.
            "ms": rec_2pc8["dedup_ms"],
            "plain_ms": rec_2pc8["dedup_plain_ms"],
            "bound_ms": rec_2pc8["dedup_bound_ms"],
            "bound_by": "bytes",
            "library_ms": rec_2pc8["torch_searchsorted_ms"],
            "by_path": stage_held("dedup", dedup_launches),
            "sparse_waves": {label: {"max_abs_err": r["dedup_max_abs_err"], "ms": r["dedup_ms"],
                                     "plain_ms": r["dedup_plain_ms"],
                                     "bound_ms": r["dedup_bound_ms"], "bound_by": "bytes",
                                     "library_ms": r["torch_searchsorted_ms"]}
                             for label, r in sparse.items()},
        },
        {
            "name": "fw_sort",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:186",
            "launches": sum(sort_launches.values()),
            "launches_by_path": sort_launches,
            "device_ops_a_sort": rec_2pc8["sort_device_ops"],
            "max_abs_err": max(r["sort_max_abs_err"] for r in stage_waves.values()),
            # On the 2pc-8 wave's keys; each timed wave's numbers below.
            "ms": rec_2pc8["sort_ms"],
            "plain_ms": rec_2pc8["sort_plain_ms"],
            "bound_ms": rec_2pc8["sort_bound_ms"],
            "bound_by": "bytes",
            "library_ms": rec_2pc8["torch_sort_ms"],
            "by_path": stage_held("sort", sort_launches),
        },
        {
            "name": "fw_compact",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:444",
            "launches": sum(compact_launches.values()),
            "launches_by_path": compact_launches,
            "device_ops_a_wave": rec_2pc8["compact_device_ops"],
            "max_abs_err": max(r["compact_max_abs_err"] for r in stage_waves.values()),
            # It writes the wave's stats vector (the Pallas
            # epilogue's :470-489, :510-514): held to _stats on every
            # timed wave; no stats kernel is left.
            "stats_max_abs_err": max(r["stats_max_abs_err"] for r in stage_waves.values()),
            "stats_plain_ms": rec_2pc8["stats_plain_ms"],
            "stats_bound_ms": rec_2pc8["stats_bound_ms"],
            # On the 2pc-8 wave; each timed wave's numbers below.
            # torch.nonzero of the fresh flags (the slots alone) is in
            # each stage_record as torch_nonzero_ms, for context.
            "ms": rec_2pc8["compact_ms"],
            "plain_ms": rec_2pc8["compact_plain_ms"],
            "bound_ms": rec_2pc8["compact_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_path": stage_held("compact", compact_launches),
        },
        {
            "name": "fw_gather",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:465",
            "launches": sum(gather_launches.values()),
            "launches_by_path": gather_launches,
            "max_abs_err": max(r["gather_max_abs_err"] for r in stage_waves.values()),
            # On the paxos3 wave (4.3 KB rows); each timed wave's numbers below.
            "ms": gather_paxos3["gather_ms"],
            "plain_ms": gather_paxos3["gather_plain_ms"],
            "bound_ms": gather_paxos3["gather_bound_ms"],
            "bound_by": "bytes",
            "library_ms": gather_paxos3["index_select_sum_ms"],
            "by_path": stage_held("gather", gather_launches),
        },
    ]}))
    # The packs' figures after the long kernels line, so the output's tail
    # keeps them.
    log(json.dumps({"tenant_packing": {
        "2pc5x8": packing["2pc5x8"], "2pc8x4": packing["2pc8x4"],
        "runs": {name: {k: r[k] for k in ("waves", "occupancy", "wall_s", "unique_per_s",
                                           "evictions", "insert_launches")}
                 for name, r in packing["runs"].items()}}}))
    log(json.dumps({"sharded": {
        "insert": shard["insert"], "nccl_backend": shard["nccl_backend"],
        "nccl_two_ranks": shard["nccl_two_ranks"],
        "runs": {name: {k: r[k] for k in ("unique", "waves", "drains", "wall_s", "unique_per_s",
                                           "lanes_shipped", "insert_launches")}
                 for name, r in shard["runs"].items()}}}))
    log(json.dumps({"sharded_tiers": shard["tiers"]}, default=str))
    log(json.dumps({"sharded_telemetry": shard["telemetry"]}, default=str))
    log(json.dumps({"sharded_liveness": shard["liveness"]}, default=str))
    log(json.dumps({"conformance": conf}))
    log(json.dumps({"service": {k: v for k, v in svc.items() if k != "launches"}},
                   default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
