"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain torch twin (bit for bit) up to the main
path's full shapes, then drives the main path: an exhaustive check of
two-phase commit with 8 resource managers (1,745,408 states) through
``TwoPhaseSys(8).checker().spawn_gpu_bfs()``, and smaller runs whose paths
are replayed. Prints phase lines, the card's name and power limit, one
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
any phase fails, when no CUDA device is present, or when the port's package
is not beside it. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
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
def build_kernel():
    from stateright_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build("hashset_insert", verbose=True)
    log(f"built hashset_insert.cu in {time.perf_counter() - t0:.2f} s")
    _build.load("hashset_insert")


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


def _must_move_bytes(after, hi, lo, active, fresh):
    """Bytes the insert must move on this input: the distinct table rows
    that the keys' probes read (a probe reads from its home to the row
    where it stops: its match, its claim, or the window's last row when it
    is pending; a later copy of a key is settled by the first, its
    neighbour in the sorted batch), the claimed rows written, the keys
    (hi, lo, active) read and the three flags written."""
    import numpy as np

    probes = 128
    cap = after.shape[0] - probes
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    k = keys[active]
    k = k[np.concatenate([[True], k[1:] != k[:-1]])]
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
    read_rows = int(np.clip(end - np.maximum(home, reach + 1) + 1, 0, None).sum())
    B = hi.shape[0]
    return read_rows * 8 + int(fresh.sum()) * 8 + B * 9 + B * 3


def _compare_insert(table_np, hi, lo, active, timing=False):
    """Runs the CUDA kernel and the plain twin on the same inputs; returns
    (max_abs_err, kernel ms, plain ms, touched tiles, table after, fresh)."""
    import numpy as np
    import torch

    from stateright_tpu_torch.interop import keys_from_numpy, table_from_numpy, table_to_numpy
    from stateright_tpu_torch.ops import hashset_kernel as hk

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
    kernel_ms = None
    if timing:
        # Only the kernel's launch lies between the events: the tile bounds
        # and the flags are made once, before.
        dstarts = starts.to(dev)
        flags = [torch.empty_like(dact) for _ in range(3)]
        times = []
        work = orig.clone()
        for _ in range(21):
            work.copy_(orig)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hk._launch(work, dhi, dlo, dact, dstarts, *flags)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        kernel_ms = statistics.median(times)
    return err, kernel_ms, plain_ms, touched, table_to_numpy(pt), pf.numpy()


@phase("kernel_vs_plain")
def kernel_vs_plain():
    import numpy as np

    from stateright_tpu_torch.ops import hashset_kernel as hk

    tile = hk.TILE_ROWS
    rng = np.random.default_rng(2026)
    worst = 0

    def empty(cap):
        return np.zeros((cap + 128, 2), np.uint32)

    def check(label, table, hi, lo, active):
        nonlocal worst
        err, _ms, plain_ms, touched, after, _fresh = _compare_insert(table, hi, lo, active)
        worst = max(worst, err)
        log(f"  {label}: B={hi.shape[0]} active={int(active.sum())} tiles={touched} "
            f"max_abs_err={err} plain={plain_ms:.1f} ms")
        if err:
            raise AssertionError(f"{label}: kernel and plain twin disagree")
        return after

    # Edge cases of the CPU tests.
    for seed in range(3):
        hi, lo, act = _sorted_batch(rng, 1024, 0.9)
        t = check(f"random seed {seed}", empty(2 * tile), hi, lo, act)
        hi2, lo2, act2 = _sorted_batch(rng, 1024, 0.9, old=(hi[act], lo[act]), old_frac=0.3)
        check(f"random seed {seed} second", t, hi2, lo2, act2)
    shift = 32 - ((2 * tile).bit_length() - 1)
    lo = np.arange(1, 65, dtype=np.uint32)
    t = check("cross-tile cluster", empty(2 * tile),
              np.full(64, (tile - 1) << shift, np.uint32), lo, np.ones(64, bool))
    check("cross-tile next tile", t, np.full(64, tile << shift, np.uint32), lo, np.ones(64, bool))
    n = 144
    check("probe overflow", empty(2 * tile), np.zeros(n, np.uint32),
          np.arange(1, n + 1, dtype=np.uint32), np.ones(n, bool))
    hi, lo, act = _sorted_batch(rng, 3500, 1.0, dup_frac=0.2, span=1 << 31)
    check("dense overflow + duplicates", empty(2 * tile), hi, lo, act)
    hi, lo, act = _sorted_batch(rng, 512, 1.0, dup_frac=0.25)
    t = check("in-batch duplicates", empty(2 * tile), hi, lo, act)
    check("second insert found", t, hi, lo, act)

    # The main path's full shape: a 2^22-row table pre-filled to a load of
    # about 0.4, then one 8,192 x 42 = 344,064-lane wave batch.
    cap = 1 << 22
    hi, lo, act = _sorted_batch(rng, int(0.4 * cap), 1.0)
    table = check("prefill 0.4 of 2^22", empty(cap), hi, lo, act)
    B = 8192 * 42
    hi2, lo2, valid = _sorted_batch(
        rng, B, 0.3, dup_frac=0.1, old=(hi, lo), old_frac=0.3
    )
    first = np.ones(B, bool)
    first[1:] = (hi2[1:] != hi2[:-1]) | (lo2[1:] != lo2[:-1])
    active = valid & first
    err, kernel_ms, plain_ms, touched, after, fresh = _compare_insert(
        table, hi2, lo2, active, timing=True
    )
    worst = max(worst, err)
    moved = _must_move_bytes(after, hi2, lo2, active, fresh)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    windows = touched * 2 * (tile + 128) * 8
    log(f"  full wave: B={B} active={int(active.sum())} fresh={int(fresh.sum())} "
        f"tiles={touched} max_abs_err={err} kernel median={kernel_ms:.3f} ms "
        f"plain={plain_ms:.1f} ms bound={bound_ms:.5f} ms ({moved} B must move; "
        f"the kernel's windows move {windows} B)")
    if err:
        raise AssertionError("full wave: kernel and plain twin disagree")
    return {
        "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
    }


# -- 3. the main path ---------------------------------------------------------


@phase("main_path_2pc8")
def main_path():
    import torch

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import hashset_kernel as hk

    hk.launches = 0
    t0 = time.perf_counter()
    checker = TwoPhaseSys(8).checker().spawn_gpu_bfs(
        frontier_capacity=8192, table_capacity=1 << 20
    ).join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hk.launches
    unique = checker.unique_state_count()
    log(f"  2pc-8: unique={unique} states={checker.state_count()} "
        f"depth={checker.max_depth()} waves={checker.waves} "
        f"table_growths={checker.table_growths} "
        f"table_capacity={checker.table_capacity()} wall={wall:.3f} s "
        f"unique_states_per_s={unique / wall:.0f} insert_launches={launches}")
    assert checker.device.type == "cuda"
    assert unique == 1_745_408, unique
    checker.assert_properties()
    assert launches >= checker.waves > 0, (launches, checker.waves)
    return {"launches": launches, "wall_s": wall, "waves": checker.waves}


@phase("replay_2pc3_2pc5")
def replay_small():
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    for n, expected in ((3, 288), (5, 8832)):
        model = TwoPhaseSys(n)
        gpu = model.checker().spawn_gpu_bfs(frontier_capacity=1024, table_capacity=1 << 14).join()
        cpu = model.checker().spawn_gpu_bfs(
            frontier_capacity=1024, table_capacity=1 << 14, device="cpu"
        ).join()
        assert gpu.unique_state_count() == cpu.unique_state_count() == expected
        assert gpu.state_count() == cpu.state_count()
        assert gpu.max_depth() == cpu.max_depth()
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
        log(f"  2pc-{n}: unique={gpu.unique_state_count()} states={gpu.state_count()} "
            f"depth={gpu.max_depth()} abort path "
            f"{gd['abort agreement'].into_actions()} (cuda == cpu twin)")


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
    build_kernel()
    insert = kernel_vs_plain() if not FAILED else None
    main = main_path() if not FAILED else None
    if not FAILED:
        replay_small()
    if FAILED:
        log(f"FAILED phases: {FAILED}")
        return 1
    log(card)
    log(json.dumps({"kernels": [{
        "name": "hashset_insert_sorted",
        "route": "cuda",
        "source": "stateright_tpu_torch/csrc/hashset_insert.cu",
        "replaces": "stateright_tpu/ops/pallas_hashset.py:193",
        "launches": main["launches"],
        "max_abs_err": insert["max_abs_err"],
        "ms": insert["ms"],
        "plain_ms": insert["plain_ms"],
        "bound_ms": insert["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
