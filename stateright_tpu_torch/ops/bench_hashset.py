"""Micro-bench: the visited-set insert kernel against its plain twin.
Usage::

    python -m stateright_tpu_torch.ops.bench_hashset [log2_capacity] [batch] [--json] [--device cpu]

The port of the JAX package's ``ops/bench_hashset.py``. Feeds
``hashset_insert_sorted`` on the card (the CUDA kernel
``csrc/hashset_insert.cu``) and its plain twin
``hashset_insert_sorted_plain`` on the host CPU the same sorted batches
(numpy ``default_rng(0)``, each lexsorted by ``(hi, lo)``, every lane
active) until the table is about half full, and prints lanes/s, effective
inserts/s, ``fresh`` and ``pending`` for each. It fails (exit 1) unless
both give the same counts and the same final table. Defaults: 2^20 rows,
batches of 2^15. ``--json`` prints ONE machine-readable line instead
(``"kernel"`` and ``"plain"`` in the JAX line's ``"xla"``/``"pallas"``
places). With ``--device cpu`` only the plain twin runs, and the line
says so (``"kernel": null``). Kernel launches count in
``hashset_kernel.launches`` as every other caller's do.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import hashset_kernel as hk
from .hashset import hashset_new, u32_to_i32


def batches(log2_cap: int, batch: int, seed: int = 0):
    """The bench's rounds: ``(hi, lo)`` u32 numpy pairs, each lexsorted by
    ``(hi, lo)``, enough to fill the table to about half its rows."""
    cap = 1 << log2_cap
    rounds = max(1, int(cap * 0.5) // batch)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        hi = rng.integers(0, 1 << 32, batch, np.uint64).astype(np.uint32)
        lo = rng.integers(1, 1 << 32, batch, np.uint64).astype(np.uint32)
        order = np.lexsort((lo, hi))
        out.append((hi[order], lo[order]))
    return out


def _keys(hi: np.ndarray, lo: np.ndarray, device):
    """u32 numpy keys as the insert's int32 bit patterns on ``device``."""
    return tuple(u32_to_i32(torch.from_numpy(x.astype(np.int64))).to(device) for x in (hi, lo))


def _time_rounds(insert, data, cap: int, device):
    """Inserts every round with ``insert`` into a fresh table on
    ``device``; returns the table, the summed fresh and pending counts and
    the seconds (the keys are on the device before the clock starts)."""
    B = data[0][0].shape[0]
    keys = [_keys(hi, lo, device) for hi, lo in data]
    active = torch.ones(B, dtype=torch.bool, device=device)
    table = hashset_new(cap, device)
    cuda = table.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    fresh_total = torch.zeros((), dtype=torch.int64, device=device)
    pend_total = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    for khi, klo in keys:
        table, fresh, _found, pend = insert(table, khi, klo, active)
        fresh_total += fresh.sum()
        pend_total += pend.sum()
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return table, int(fresh_total), int(pend_total), dt


def _result(lanes: int, fresh: int, pending: int, dt: float) -> dict:
    return {
        "lanes_per_s": round(lanes / dt, 1),
        "inserts_per_s": round(fresh / dt, 1),
        "fresh": fresh,
        "pending": pending,
        "seconds": dt,
    }


def run(log2_cap: int = 20, batch: int = 1 << 15, device=None,
        must_move: bool = False) -> dict:
    """The bench as a dict: ``kernel`` (None on the CPU) and ``plain``
    results, ``equal`` (kernel and twin agree on the counts and the final
    table; None when only the twin ran), ``max_abs_err`` over the final
    tables, and ``launches`` of the kernel. ``must_move`` adds
    ``must_move_bytes``: what the inserts must move over every round
    (``checker/breakdown.py::insert_must_move``), for a bound. ``device``
    is ``"cuda"`` unless ``"cpu"`` is passed."""
    from ..checker.gpu import resolve_device

    dev = resolve_device(device, "bench_hashset")
    cap = 1 << log2_cap
    data = batches(log2_cap, batch)
    rounds = len(data)
    lanes = rounds * batch
    out = {
        "device": dev.type, "compiled": dev.type == "cuda", "cap_log2": log2_cap,
        "batch": batch, "rounds": rounds, "kernel": None, "plain": None,
        "equal": None, "max_abs_err": None, "launches": 0,
    }

    plain_table, fresh, pending, dt = _time_rounds(
        hk.hashset_insert_sorted_plain, data, cap, "cpu")
    out["plain"] = _result(lanes, fresh, pending, dt)
    if must_move:
        from ..checker.breakdown import insert_must_move
        from ..interop import table_to_numpy

        table = hashset_new(cap)
        ones = np.ones(batch, bool)
        total = 0
        for hi, lo in data:
            table, f, _found, _pend = hk.hashset_insert_sorted_plain(
                table, *_keys(hi, lo, "cpu"), torch.from_numpy(ones))
            total += insert_must_move(table_to_numpy(table), hi, lo, ones, f.numpy())
        out["must_move_bytes"] = total

    if dev.type == "cuda":
        before = hk.launches
        # The first batch into a scratch table: loads the kernel's library.
        warm = hashset_new(cap, dev)
        hk.hashset_insert_sorted(warm, *_keys(*data[0], dev),
                                 torch.ones(batch, dtype=torch.bool, device=dev))
        table, fresh, pending, dt = _time_rounds(
            hk.hashset_insert_sorted, data, cap, dev)
        out["launches"] = hk.launches - before
        out["kernel"] = _result(lanes, fresh, pending, dt)
        err = int((table.cpu().to(torch.int64) - plain_table.to(torch.int64)).abs().max())
        out["max_abs_err"] = err
        out["equal"] = (err == 0 and (fresh, pending) == (out["plain"]["fresh"],
                                                           out["plain"]["pending"]))
    impls = {k: out[k] for k in ("kernel", "plain") if out[k] is not None}
    out["winner"] = max(impls, key=lambda k: impls[k]["lanes_per_s"])
    return out


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    as_json = "--json" in argv
    device = None
    args = []
    it = iter(a for a in argv if a != "--json")
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            args.append(a)
    log2_cap = int(args[0]) if len(args) > 0 else 20
    batch = int(args[1]) if len(args) > 1 else 1 << 15
    res = run(log2_cap, batch, device)
    print(f"device={res['device']} cap=2^{log2_cap} batch={batch} "
          f"rounds={res['rounds']}", file=sys.stderr)
    for name in ("kernel", "plain"):
        r = res[name]
        if r is None:
            line = f"{name}: not run (the kernel runs on a CUDA device)"
        else:
            lanes = res["rounds"] * batch
            line = (f"{name}: {lanes} lanes in {r['seconds']:.3f}s = "
                    f"{r['lanes_per_s']:,.0f} lanes/s, {r['inserts_per_s']:,.0f} "
                    f"effective inserts/s (fresh={r['fresh']} pending={r['pending']})")
        print(line, file=sys.stderr if as_json else sys.stdout)
    if as_json:
        print(json.dumps(res))
    if res["equal"] is False:
        print("bench_hashset: the kernel and its plain twin disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
