"""Peak device memory of one GPU BFS run of the PyTorch/CUDA port.

    python scripts/torch_peak_memory.py [--root DIR] [--config 2pc8]
        [--wave-kernel staged|fused]

Imports ``stateright_tpu_torch`` from ``--root`` (default: this checkout),
so that a commit unpacked with ``git archive`` can be measured beside this
one in the same call; that commit must have ``stateright_tpu_torch/
configs.py``. Runs the named configuration of that file (``2pc8``,
``paxos3``, ``abd3o``, ``raft5_ttc``, ``raft4``) through
``spawn_gpu_bfs`` with its spawn settings, once to warm up, then once with
the allocator's peak reset, and prints the card, the run's counts, its
wall, ``torch.cuda.max_memory_allocated()`` and one JSON summary line.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--config", default="2pc8")
    ap.add_argument("--wave-kernel", default="staged", choices=("staged", "fused"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch.configs import CONFIGS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    cfg = CONFIGS[args.config]
    spawn = dict(cfg.spawn, wave_kernel=args.wave_kernel)

    def run():
        t0 = time.perf_counter()
        c = cfg.make().checker().spawn_gpu_bfs(**spawn).join()
        torch.cuda.synchronize()
        return c, time.perf_counter() - t0

    run()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    checker, wall = run()
    summary = {
        "card": card,
        "root": os.path.abspath(args.root),
        "config": cfg.name,
        "wave_kernel": args.wave_kernel,
        "unique": checker.unique_state_count(),
        "waves": checker.waves,
        "wall_s": wall,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
