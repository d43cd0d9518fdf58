"""Time to build the port's CUDA kernels, one after the other and at once.

    python scripts/torch_build_time.py [--reps 2]

Builds every ``stateright_tpu_torch/csrc/*.cu`` into a fresh directory
under ``stateright_tpu_torch/_build/`` (removed afterwards), first one
``nvcc`` after the other (``_build.build`` per source), then all started
together (``_build.build_all``), ``--reps`` times each, alternating. Prints
each wall time and one JSON summary line. Needs ``nvcc``; touches no
device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    from stateright_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    root = _build.BUILD_DIR / f"timing-{os.getpid()}"
    times = {"sequential_s": [], "parallel_s": []}
    try:
        for rep in range(args.reps):
            for mode in ("sequential_s", "parallel_s"):
                _build.BUILD_DIR = root / f"{mode}-{rep}"
                t0 = time.perf_counter()
                if mode == "sequential_s":
                    for name in names:
                        _build.build(name)
                else:
                    _build.build_all(names)
                times[mode].append(time.perf_counter() - t0)
                print(f"{mode[:-2]} build of {names}: {times[mode][-1]:.3f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"sources": names, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
