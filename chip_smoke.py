"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one ``nvcc`` per source, all at once), holds each kernel against its plain
torch twin (bit for bit) at the main paths' full shapes (the fused wave
also on a masked take of the deep drain's ring), then drives both
main paths: an exhaustive check of two-phase commit with 8 resource
managers (1,745,408 states) through
``TwoPhaseSys(8).checker().spawn_gpu_bfs()`` with the staged wave (torch +
the CUDA insert) and with ``wave_kernel="fused"`` (the model stage in
torch, every other stage in CUDA), each wave at a time
(``max_drain_waves=1``) and through the deep drain (the default: the
frontier in a device ring, drained by replayed CUDA Graphs with no host
sync inside a drain), and smaller runs of all four whose paths are
replayed against the CPU twin. Then the actor path: the fused wave's
component-hash keys stage (``fw_comphash_keys``) and its whole chain held
against their plain twins on a full-width wave of "paxos check 3" (3
clients, 3 servers, 24 envelope slots) taken from the drain with its
table; an exhaustive check of paxos check 3 (1,194,428 states) through
``PaxosModelCfg(3, 3, envelope_capacity=24).into_model().checker()
.spawn_gpu_bfs(...)`` on both engines through the deep drain, its
``value chosen`` path replayed on the host; and small paxos and
single-copy register runs on the card against the CPU twin. Prints phase
lines, the card's name and power limit, the fused wave's stage times, the
drains' walls, waves, no-op and warm-up waves, exits, graph captures and
replays and rungs, peak device memory, one ``{"kernels": [...]}`` line, and
as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
any phase fails, when no CUDA device is present, or when the port's package
is not beside it. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
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


def _probed_rows(after, k):
    """The distinct table rows that the probes of the sorted, distinct u64
    keys ``k`` read in the table ``after`` the insert: a probe reads from
    its home to the row where it stops (its match, its claim, or the
    window's last row when it is pending)."""
    import numpy as np

    probes = 128
    cap = after.shape[0] - probes
    home = (k >> np.uint64(64 - (cap.bit_length() - 1))).astype(np.int64)
    rows = (after[:, 0].astype(np.uint64) << np.uint64(32)) | after[:, 1].astype(np.uint64)
    stop = np.empty_like(home)
    for s in range(0, k.shape[0], 1 << 14):
        hit = rows[home[s : s + (1 << 14), None] + np.arange(probes)] == k[s : s + (1 << 14), None]
        stop[s : s + (1 << 14)] = np.where(hit.any(1), hit.argmax(1), probes - 1)
    end = home + stop
    # Rows of [home, end] not already read by an earlier key (homes are
    # monotone, so the earlier probes end at most at the running maximum).
    reach = np.concatenate([[-1], np.maximum.accumulate(end)[:-1]])
    return int(np.clip(end - np.maximum(home, reach + 1) + 1, 0, None).sum())


def _must_move_bytes(after, hi, lo, active, fresh):
    """Bytes the insert must move on this input: the distinct table rows
    that the keys' probes read (a later copy of a key is settled by the
    first, its neighbour in the sorted batch), the claimed rows written,
    the keys (hi, lo, active) read and the three flags written."""
    import numpy as np

    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    k = keys[active]
    k = k[np.concatenate([[True], k[1:] != k[:-1]])]
    B = hi.shape[0]
    return _probed_rows(after, k) * 8 + int(fresh.sum()) * 8 + B * 9 + B * 3


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


def _compare_insert(table_np, hi, lo, active, timing=False):
    """Runs the CUDA kernel and the plain twin on the same inputs; returns
    a dict: max_abs_err, the kernel's median ms and its passes' ms (with
    ``timing``), plain ms, touched tiles, the tiles the repair redid and
    the tiles it had to redo, the table after and the fresh flags."""
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
    moved = _must_move_bytes(r["after"], hi2, lo2, active, r["fresh"])
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
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    got = {}
    consume = gpu.GpuBfsChecker._consume_wave

    def spy(self, table, chunk, queue):
        if not got and table.shape[0] - 128 == 1 << 22 and chunk["hi"].shape[0] == 8192:
            got.update(table=table.clone(), chunk=map_leaves(torch.clone, chunk),
                       spec=self._spec, depth_cap=self._depth_cap,
                       unique=self._unique_count)
            self._target_state_count = 0  # stop after this wave
        return consume(self, table, chunk, queue)

    gpu.GpuBfsChecker._consume_wave = spy
    try:
        TwoPhaseSys(8).checker().spawn_gpu_bfs(
            frontier_capacity=8192, table_capacity=1 << 20, max_drain_waves=1
        ).join()
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
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops.ring import ring_take

    F = 8192
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
        TwoPhaseSys(8).checker().spawn_gpu_bfs(
            frontier_capacity=F, table_capacity=1 << 20, wave_kernel="fused",
            drain_log_factor=48,
        ).join()
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

    # The stages alone at this shape: the model stage (torch), then the
    # kernel chain with an event between stages.
    cond, cvalid, cand_flat = fw.model_stage(spec, states, F)
    words = state_words(cand_flat)
    model_ms, _ = _time_on_card(lambda mark: state_words(fw.model_stage(spec, states, F)[2]))
    work = table0.clone()
    chain_ms, stage_ms = _time_on_card(
        lambda mark: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond,
                                     cvalid, words, cand_flat, mark=mark),
        reset=lambda: work.copy_(table0),
    )
    pass_ms = _sweep_pass_ms(
        lambda: fw.kernel_chain(spec, work, hi, lo, ebits, depth, depth_cap, cond,
                                cvalid, words, cand_flat),
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

    # The radix sort against a stable torch.sort: the wave's own keys
    # (the invalid lanes' sentinel repeated) and keys with many duplicates;
    # torch.sort of the same keys on the card is the stage's yardstick.
    key, idx = fw.keys_stage(words, cvalid, depth, depth_cap, A)
    wave_keys = key.clone()
    dup = torch.from_numpy((rng.integers(0, 1000, size=B).astype(np.uint64)
                            * np.uint64(0x9E3779B97F4A7C15)).view(np.int64))
    for label, keys in (("wave keys", wave_keys.cpu()), ("1,000 distinct keys", dup)):
        k, i = keys.cuda(), torch.arange(B, dtype=torch.int32, device="cuda")
        fw.sort_stage(k, i)
        skey, sidx = torch.sort(keys ^ (-(1 << 63)), stable=True)
        e = _max_abs_err([(skey ^ (-(1 << 63)), k), (sidx, i)])
        log(f"  radix sort, {label}: n={B} max_abs_err={e}")
        err = max(err, e)
    signed = wave_keys ^ (-(1 << 63))
    torch_sort_ms, _ = _time_on_card(lambda mark: torch.sort(signed, stable=True))
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
    probed = _probed_rows(table_to_numpy(pt), np.unique(fps[valid]))
    leaf_row_bytes = sum(x[0].numel() * x.element_size() for x in pout["new"]["states"].values())
    moved = (words.numel() * 4 + B + 4 * F * 4 + P * F + probed * 8
             + n * 8 + 2 * n * leaf_row_bytes + 6 * n * 4 + (5 + 3 * P) * 8)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"fused_wave_stage_ms": stage_ms, "kernel_chain_ms": chain_ms,
                    "sweep_pass_ms": pass_ms, "sweep_tiles_touched": touched,
                    "sweep_tiles_redone": redone,
                    "model_stage_torch_ms": model_ms, "torch_sort_ms": torch_sort_ms,
                    "must_move_bytes": moved, "probed_rows": probed}))
    log(f"  fused wave kernels: median {chain_ms:.4f} ms (sweep {stage_ms['sweep']:.4f} ms: "
        f"{_fmt_passes(pass_ms)}; tiles touched={touched} redone={redone}; "
        f"radix sort {stage_ms['sort']:.4f} ms vs torch.sort {torch_sort_ms:.4f} ms); "
        f"model stage (torch) {model_ms:.3f} ms; bound {bound_ms:.5f} ms ({moved} B)")
    return {"max_abs_err": err, "ms": chain_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


# -- 3. the main paths ----------------------------------------------------------


def _drive_2pc8(wave_kernel, **spawn):
    """Drives 2pc-8 through ``spawn_gpu_bfs`` with every kernel count set
    to 0 just before and read just after."""
    import torch

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    torch.cuda.reset_peak_memory_stats()
    hk.launches = fw.launches = 0
    t0 = time.perf_counter()
    checker = TwoPhaseSys(8).checker().spawn_gpu_bfs(
        frontier_capacity=8192, table_capacity=1 << 20, wave_kernel=wave_kernel, **spawn
    ).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"hashset_insert_sorted": hk.launches, "fused_wave": fw.launches}
    unique = checker.unique_state_count()
    mode = "drain" if checker.drains else "wave at a time"
    log(f"  2pc-8 ({wave_kernel}, {mode}): unique={unique} states={checker.state_count()} "
        f"depth={checker.max_depth()} waves={checker.waves} "
        f"table_growths={checker.table_growths} "
        f"table_capacity={checker.table_capacity()} wall={wall:.3f} s "
        f"unique_states_per_s={unique / wall:.0f} launches={launches} "
        f"peak_device_bytes={torch.cuda.max_memory_allocated()}")
    if checker.drains:
        log(f"  2pc-8 ({wave_kernel}, drain): wall={wall:.3f} s waves={checker.waves} "
            f"noop_waves={checker.noop_waves} warmup_waves={checker.warmup_waves} "
            f"drains={checker.drains} exits={dict(checker.drain_exits)} "
            f"graph_captures={checker.graph_captures} "
            f"graph_replays={checker.graph_replays} rungs={dict(checker.rungs)}")
    assert checker.device.type == "cuda"
    assert unique == 1_745_408, unique
    checker.assert_properties()
    return {"launches": launches, "wall_s": wall, "waves": checker.waves,
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
        run = _drive_2pc8(wave_kernel, drain_log_factor=48)
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

PAXOS3 = dict(frontier_capacity=2048, table_capacity=1 << 21, drain_log_factor=32)
PAXOS3_UNIQUE = 1_194_428


def _paxos3():
    from stateright_tpu_torch.models.paxos import PaxosModelCfg

    return PaxosModelCfg(3, 3, envelope_capacity=24).into_model()


class _Stop(Exception):
    """Ends a run once its wave was captured."""


def _capture_paxos3_take(min_unique=300_000):
    """A full-width paxos check 3 frontier of the fused deep drain (F =
    2,048 lanes, all live) and the table it runs on: the ring and table
    are copied at the start of the first drain whose ring holds a
    full-width take once ``min_unique`` states are visited, and the run
    stops there."""
    import torch

    from stateright_tpu_torch.checker import gpu
    from stateright_tpu_torch.core.batch import map_leaves
    from stateright_tpu_torch.ops.ring import ring_take

    F = PAXOS3["frontier_capacity"]
    got = {}
    deep_drain = gpu.GpuBfsChecker._deep_drain

    def spy(self, table, width, budget):
        d = self._drain
        if (not got and width == F and self._unique_count >= min_unique
                and int(d["scalars"][gpu._COUNT]) >= F):
            got.update(table=table.clone(), capacity=d["capacity"],
                       pool=map_leaves(torch.clone, d["pool"]),
                       head=d["scalars"][gpu._HEAD].clone(),
                       spec=self._spec, depth_cap=self._depth_cap,
                       unique=self._unique_count)
            raise _Stop()
        return deep_drain(self, table, width, budget)

    gpu.GpuBfsChecker._deep_drain = spy
    try:
        checker = _paxos3().checker().spawn_gpu_bfs(wave_kernel="fused", **PAXOS3)
        for h in checker.handles():
            h.join()
    finally:
        gpu.GpuBfsChecker._deep_drain = deep_drain
    if not got or not isinstance(checker.worker_error(), _Stop):
        raise AssertionError(f"no paxos3 drain started with a full-width take "
                             f"({checker.worker_error()!r})")
    live = torch.full((), F, dtype=torch.int64, device="cuda")
    got["frontier"] = ring_take(got["pool"], got["head"], live, got["capacity"], F)[0]
    return got


def _comphash_must_move(spec, cand, valid, F):
    """Bytes ``fw_comphash_keys`` must move on this wave, u32 values at
    4 B: every lane's valid bit and its frontier lane's depth and mask; for
    each valid lane its actor rows and timer words, its history row, every
    envelope count, and the src, dst and message words of its active
    envelopes; the key (8 B) and lane index (4 B) of every lane."""
    lay = spec.comphash["layout"]
    B = valid.shape[0]
    N, R, E, W, H = (lay[k] for k in ("N", "R", "E", "W", "H"))
    active_envs = int(((cand["net_cnt"] != 0) & valid[:, None]).sum())
    n_valid = int(valid.sum())
    words = n_valid * (N * (R + 1) + H + E) + active_envs * (2 + W)
    return B * 1 + F * (4 + 1) + words * 4 + B * 12


@phase("comphash_vs_plain")
def comphash_vs_plain():
    """``fw_comphash_keys`` and the whole fused chain against their plain
    twins on a full-width paxos3 wave taken from the drain with its table;
    their median times and bound."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw

    got = _capture_paxos3_take()
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
    log(f"  paxos3 wave: F={F} B={B} table rows={table0.shape[0]} ring rows={got['capacity']} "
        f"unique before={got['unique']} generated={stats[0]} n_new={stats[1]} "
        f"overflow={stats[2]} max_abs_err={chain_err} plain={plain_ms:.1f} ms (host CPU)")
    if chain_err:
        raise AssertionError("fused kernels and the plain twin disagree on a paxos3 wave")

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
    log(f"  fw_comphash_keys: B={B} valid lanes={n_valid} max_abs_err={err}")
    if err:
        raise AssertionError("fw_comphash_keys and its plain twin disagree")
    if not n_valid:
        raise AssertionError("the paxos3 wave has no valid lane")

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
    valid = (pkey != -1)
    moved = _comphash_must_move(spec, cand, valid, F)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"paxos3_wave": {
        "comphash_keys_ms": ms, "comphash_plain_on_card_ms": twin_ms,
        "kernel_chain_ms": chain_ms, "fused_wave_stage_ms": stage_ms,
        "model_stage_torch_ms": model_ms, "comphash_must_move_bytes": moved,
        "comphash_bound_ms": bound_ms, "valid_lanes": n_valid, "B": B,
        "chain_plain_host_ms": plain_ms,
    }}))
    log(f"  fw_comphash_keys: median {ms:.4f} ms, plain twin on the card {twin_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({moved} B); chain {chain_ms:.4f} ms; model stage "
        f"(torch) {model_ms:.3f} ms")
    return {"max_abs_err": max(err, chain_err), "ms": ms, "plain_ms": twin_ms,
            "bound_ms": bound_ms}


def _drive_paxos3(wave_kernel):
    """Drives paxos check 3 through ``spawn_gpu_bfs`` and the deep drain,
    every kernel count set to 0 just before and read just after."""
    import torch

    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    model = _paxos3()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hk.launches = fw.launches = fw.comphash_launches = 0
    t0 = time.perf_counter()
    checker = model.checker().spawn_gpu_bfs(wave_kernel=wave_kernel, **PAXOS3).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"hashset_insert_sorted": hk.launches, "fused_wave": fw.launches,
                "fw_comphash_keys": fw.comphash_launches}
    peak = torch.cuda.max_memory_allocated()
    unique = checker.unique_state_count()
    log(f"  paxos3 ({wave_kernel}, drain): unique={unique} states={checker.state_count()} "
        f"depth={checker.max_depth()} wall={wall:.3f} s unique_states_per_s={unique / wall:.0f} "
        f"waves={checker.waves} noop_waves={checker.noop_waves} "
        f"warmup_waves={checker.warmup_waves} drains={checker.drains} "
        f"exits={dict(checker.drain_exits)} rungs={dict(checker.rungs)} "
        f"graph_captures={checker.graph_captures} graph_replays={checker.graph_replays} "
        f"table_growths={checker.table_growths} table_capacity={checker.table_capacity()} "
        f"launches={launches} peak_device_bytes={peak} keys_route={checker.keys_route}")
    assert checker.device.type == "cuda" and checker.drains > 0
    assert unique == PAXOS3_UNIQUE, unique
    checker.assert_properties()
    t1 = time.perf_counter()
    path = checker.discoveries()["value chosen"]
    actions = path.into_actions()
    last = path.last_state()
    cond = next(p for p in model.properties() if p.name == "value chosen").condition
    assert cond(model, last), "the value chosen path does not end in a chosen value"
    assert last.history.serialized_history() is not None
    log(f"  paxos3 ({wave_kernel}): value chosen path of {len(actions)} actions replayed on "
        f"the host in {time.perf_counter() - t1:.2f} s: {path.encode()}")
    return {"launches": launches, "wall_s": wall, "waves": checker.waves,
            "state_count": checker.state_count(), "max_depth": checker.max_depth(),
            "path": path.encode(), "peak_device_bytes": peak}


@phase("main_path_paxos3_drain")
def main_path_paxos3():
    runs = {}
    for wave_kernel in ("staged", "fused"):
        runs[wave_kernel] = run = _drive_paxos3(wave_kernel)
        n = run["launches"]
        if wave_kernel == "staged":
            assert n["hashset_insert_sorted"] >= run["waves"] > 0, n
            assert n["fused_wave"] == 0 and n["fw_comphash_keys"] == 0, n
        else:
            assert n["fw_comphash_keys"] >= run["waves"] > 0, n
            assert n["fused_wave"] == n["fw_comphash_keys"], n
            assert n["hashset_insert_sorted"] >= 1, n  # the seed
    for k in ("state_count", "max_depth"):
        assert runs["staged"][k] == runs["fused"][k], (k, runs)
    return runs


# (model, its arguments, unique states or None where the run stops at
# its discoveries, whether it is linearizable).
ACTOR_CASES = {
    "paxos 2c/2s": ("paxos", dict(client_count=2, server_count=2), 111, True),
    "paxos 1c/3s": ("paxos", dict(client_count=1, server_count=3), 265, True),
    "single-copy 2c/1s": ("single_copy", dict(client_count=2, server_count=1), 93, True),
    "single-copy 2c/2s": ("single_copy", dict(client_count=2, server_count=2), None, False),
    "single-copy 2c/1s, duplicating network": (
        "single_copy", dict(client_count=2, server_count=1, envelope_capacity=24,
                            network="duplicating"), None, False),
}


@phase("replay_actor_small")
def replay_actor_small():
    from stateright_tpu_torch.actor.network import Network
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg

    cfgs = {"paxos": PaxosModelCfg, "single_copy": SingleCopyModelCfg}
    modes = {"wave at a time": dict(max_drain_waves=1), "drain": {}}

    def make(kind, args):
        args = dict(args)
        if args.pop("network", None) == "duplicating":
            args["network"] = Network.new_unordered_duplicating()
        return cfgs[kind](**args).into_model()

    for label, (kind, args, expected, linearizable) in ACTOR_CASES.items():
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
                want = {"value chosen"} | (set() if linearizable else {"linearizable"})
                assert set(gd) == want, (set(gd), want)
                log(f"  {label} ({wave_kernel}, {mode}): unique={gpu.unique_state_count()} "
                    f"states={gpu.state_count()} depth={gpu.max_depth()} waves={gpu.waves} "
                    f"drains={gpu.drains} discoveries={sorted(gd)} (cuda == cpu twin)")


def main() -> int:
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

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = card_line()
    build_kernels()
    insert = kernel_vs_plain() if not FAILED else None
    fused = fused_vs_plain() if not FAILED else None
    staged = main_path() if not FAILED else None
    fused_run = main_path_fused(staged) if not FAILED else None
    drains = main_path_drain((staged, fused_run)) if not FAILED else None
    if not FAILED:
        replay_small()
    comphash = comphash_vs_plain() if not FAILED else None
    paxos3 = main_path_paxos3() if not FAILED else None
    if not FAILED:
        replay_actor_small()
    if FAILED:
        log(f"FAILED phases: {FAILED}")
        return 1
    log(card)
    log(json.dumps({"kernels": [
        {
            "name": "hashset_insert_sorted",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/hashset_insert.cu",
            "replaces": "stateright_tpu/ops/pallas_hashset.py:191",
            "launches": drains["staged"]["launches"]["hashset_insert_sorted"],
            "max_abs_err": insert["max_abs_err"],
            "ms": insert["ms"],
            "plain_ms": insert["plain_ms"],
            "bound_ms": insert["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "fused_wave",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:91",
            "launches": drains["fused"]["launches"]["fused_wave"],
            "max_abs_err": fused["max_abs_err"],
            "ms": fused["ms"],
            "plain_ms": fused["plain_ms"],
            "bound_ms": fused["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "fw_comphash_keys",
            "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_wave.cu",
            "replaces": "stateright_tpu/ops/pallas_wave.py:180",
            "launches": paxos3["fused"]["launches"]["fw_comphash_keys"],
            "max_abs_err": comphash["max_abs_err"],
            "ms": comphash["ms"],
            "plain_ms": comphash["plain_ms"],
            "bound_ms": comphash["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
