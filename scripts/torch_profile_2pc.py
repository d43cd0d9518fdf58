"""Where the time of one GPU BFS run of the PyTorch/CUDA port goes.

    python scripts/torch_profile_2pc.py [--rm 8] [--frontier 8192]
        [--table 1048576] [--trace chiprun_out/profile_2pc8.json]

Runs ``TwoPhaseSys(rm).checker().spawn_gpu_bfs(...)`` once to warm up
(kernel build, allocator, library handles), then once more under
``torch.profiler`` with CPU and CUDA activities. Prints the device time of
each CUDA kernel name (summed over the run), the wall time, the device
busy time (union of kernel intervals) and the device idle share, and one
JSON summary line. Needs a CUDA device; imports nothing of JAX.
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
    ap.add_argument("--frontier", type=int, default=8192)
    ap.add_argument("--table", type=int, default=1 << 20)
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import hashset_kernel as hk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    def run():
        t0 = time.perf_counter()
        c = TwoPhaseSys(args.rm).checker().spawn_gpu_bfs(
            frontier_capacity=args.frontier, table_capacity=args.table
        ).join()
        torch.cuda.synchronize()
        return c, time.perf_counter() - t0

    warm, warm_wall = run()
    print(f"warm-up run: unique={warm.unique_state_count()} wall={warm_wall:.3f} s", flush=True)

    hk.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        checker, wall = run()
    launches = hk.launches

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
    print(f"profiled run: unique={checker.unique_state_count()} waves={checker.waves} "
          f"table_growths={checker.table_growths} wall={wall:.3f} s "
          f"insert_launches={launches}")
    print(f"{'device ms':>12} {'share':>7} {'count':>8}  kernel")
    for name, (count, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]:
        print(f"{ms:12.3f} {ms / total_ms:7.1%} {count:8d}  {name[:90]}")
    insert_ms = sum(ms for name, (_c, ms) in by_name.items() if "hashset_insert" in name)
    summary = {
        "card": card,
        "model": f"2pc-{args.rm}",
        "unique": checker.unique_state_count(),
        "waves": checker.waves,
        "insert_launches": launches,
        "wall_s": wall,
        "warm_wall_s": warm_wall,
        "kernel_ms_total": total_ms,
        "insert_kernel_ms": insert_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_span_ms": span_us / 1e3,
        "device_idle_share_of_wall": 1.0 - (busy_us / 1e6) / wall,
        "kernel_launches": len(kernels),
    }
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
