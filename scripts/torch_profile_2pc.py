"""Where the time of one GPU BFS run of the PyTorch/CUDA port goes.

    python scripts/torch_profile_2pc.py [--rm 8] [--frontier 8192]
        [--table 1048576] [--wave-kernel staged|fused]
        [--max-drain-waves N] [--drain-log-factor N] [--trace TRACE.json]
    python scripts/torch_profile_2pc.py --paxos 3 3 24 --frontier 2048
        --table 2097152 --drain-log-factor 32 [--wave-kernel ...]

Runs ``TwoPhaseSys(rm).checker().spawn_gpu_bfs(...)`` (with ``--paxos C S
E``: ``PaxosModelCfg(C, S, envelope_capacity=E).into_model()``, "paxos
check 3" being ``3 3 24``) once to warm up
(kernel build, allocator, library handles), then once more under
``torch.profiler`` with CPU and CUDA activities. Prints the device time of
each CUDA kernel name (summed over the run), the wall time, the device
busy time (union of kernel intervals), the device idle share, the device
launches per wave, the drains (exits, no-op waves, graph captures and
replays) and one JSON summary line. ``--max-drain-waves 1`` runs wave at a
time; the default runs the deep drain with the checker's defaults. Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rm", type=int, default=8)
    ap.add_argument("--paxos", type=int, nargs=3, default=None,
                    metavar=("CLIENTS", "SERVERS", "ENVELOPES"))
    ap.add_argument("--frontier", type=int, default=8192)
    ap.add_argument("--table", type=int, default=1 << 20)
    ap.add_argument("--wave-kernel", default="staged", choices=("staged", "fused"))
    ap.add_argument("--max-drain-waves", type=int, default=100_000)
    ap.add_argument("--drain-log-factor", type=int, default=8)
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import fused_wave as fw
    from stateright_tpu_torch.ops import hashset_kernel as hk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    def make():
        if args.paxos:
            from stateright_tpu_torch.models.paxos import PaxosModelCfg

            c, s, e = args.paxos
            return PaxosModelCfg(c, s, envelope_capacity=e).into_model()
        return TwoPhaseSys(args.rm)

    def run():
        model = make()
        t0 = time.perf_counter()
        c = model.checker().spawn_gpu_bfs(
            frontier_capacity=args.frontier, table_capacity=args.table,
            wave_kernel=args.wave_kernel, max_drain_waves=args.max_drain_waves,
            drain_log_factor=args.drain_log_factor,
        ).join()
        torch.cuda.synchronize()
        return c, time.perf_counter() - t0

    warm, warm_wall = run()
    print(f"warm-up run: unique={warm.unique_state_count()} wall={warm_wall:.3f} s", flush=True)

    hk.launches = fw.launches = fw.comphash_launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        checker, wall = run()
    launches = {"hashset_insert_sorted": hk.launches, "fused_wave": fw.launches,
                "fw_comphash_keys": fw.comphash_launches}

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        by_name[e.name][0] += 1
        by_name[e.name][1] += (end - start) / 1e3
        intervals.append((start, end))
    intervals.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    span_us = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0

    total_ms = sum(v[1] for v in by_name.values())
    print(f"profiled run ({args.wave_kernel}, max_drain_waves={args.max_drain_waves}): "
          f"unique={checker.unique_state_count()} waves={checker.waves} "
          f"table_growths={checker.table_growths} wall={wall:.3f} s launches={launches} "
          f"drains={checker.drains} exits={dict(checker.drain_exits)} "
          f"noop_waves={checker.noop_waves} warmup_waves={checker.warmup_waves} "
          f"graph_captures={checker.graph_captures} "
          f"graph_replays={checker.graph_replays} rungs={dict(checker.rungs)}")
    print(f"{'device ms':>12} {'share':>7} {'count':>8}  kernel")
    for name, (count, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]:
        print(f"{ms:12.3f} {ms / total_ms:7.1%} {count:8d}  {name[:90]}")
    def kernel_ms(*parts):
        return sum(ms for name, (_c, ms) in by_name.items() if all(p in name for p in parts))

    # The tile sweep's passes run in the insert (InsertBatch) and in the
    # fused wave (WaveBatch).
    insert_ms = kernel_ms("InsertBatch")
    sweep_ms = kernel_ms("WaveBatch")
    pass_ms = {p: {"insert": kernel_ms(f"sweep_{p}_kernel", "InsertBatch"),
                   "fused": kernel_ms(f"sweep_{p}_kernel", "WaveBatch")}
               for p in ("extent", "speculate", "repair", "commit")}
    summary = {
        "card": card,
        "model": ("paxos {} clients {} servers {} envelopes".format(*args.paxos)
                  if args.paxos else f"2pc-{args.rm}"),
        "wave_kernel": args.wave_kernel,
        "max_drain_waves": args.max_drain_waves,
        "drain_log_factor": args.drain_log_factor,
        "unique": checker.unique_state_count(),
        "waves": checker.waves,
        "noop_waves": checker.noop_waves,
        "warmup_waves": checker.warmup_waves,
        "drains": checker.drains,
        "drain_exits": dict(checker.drain_exits),
        "graph_captures": checker.graph_captures,
        "graph_replays": checker.graph_replays,
        "rungs": {str(k): v for k, v in checker.rungs.items()},
        "launches": launches,
        "wall_s": wall,
        "warm_wall_s": warm_wall,
        "kernel_ms_total": total_ms,
        "insert_kernel_ms": insert_ms,
        "sweep_kernel_ms": sweep_ms,
        "sweep_pass_ms": pass_ms,
        "comphash_kernel_ms": kernel_ms("comphash_keys_kernel"),
        "device_busy_ms": busy_us / 1e3,
        "device_span_ms": span_us / 1e3,
        "device_idle_share_of_wall": 1.0 - (busy_us / 1e6) / wall,
        "kernel_launches": len(kernels),
        "kernel_launches_per_wave": len(kernels) / max(1, checker.waves),
        "kernel_launches_per_wave_incl_noop": len(kernels) / max(
            1, checker.waves + checker.noop_waves
        ),
    }
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
