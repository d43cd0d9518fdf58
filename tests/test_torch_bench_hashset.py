"""The port's insert micro-bench (``python -m
stateright_tpu_torch.ops.bench_hashset``) on the CPU: its ``--json`` line
with ``--device cpu`` (the plain twin alone, as the line says), held to the
JAX package's TPU kernel ``pallas_hashset_insert`` (in interpret mode, as
that package's own tests run it on the CPU) on the same batches — the JAX
bench's first batches, numpy ``default_rng(0)``, each lexsorted — in
counts and in the final table, bit for bit. The kernel half runs on the
card (``tests/test_torch_conformance_cuda.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from stateright_tpu.ops.hashset import hashset_new as jax_new
from stateright_tpu.ops.pallas_hashset import pallas_hashset_insert
from stateright_tpu_torch.interop import table_to_numpy
from stateright_tpu_torch.ops import bench_hashset

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.ops.bench_hashset", *args],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=120,
    )


def _jax_bench(log2_cap, batch):
    """The JAX bench's Pallas leg on the same rounds: (table, fresh,
    pending)."""
    table = jax_new(1 << log2_cap)
    fresh = pending = 0
    for hi, lo in bench_hashset.batches(log2_cap, batch):
        ones = jnp.ones((batch,), bool)
        table, f, _found, p = pallas_hashset_insert(
            table, jnp.asarray(hi), jnp.asarray(lo), ones, interpret=True)
        fresh += int(f.sum())
        pending += int(p.sum())
    return np.asarray(table), fresh, pending


def test_cli_json_line_on_the_cpu_matches_the_pallas_insert():
    out = _cli("12", "1024", "--json", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["compiled"] is False
    assert (line["cap_log2"], line["batch"], line["rounds"]) == (12, 1024, 2)
    assert line["kernel"] is None and line["equal"] is None and line["launches"] == 0
    assert line["winner"] == "plain"
    _table, fresh, pending = _jax_bench(12, 1024)
    assert (line["plain"]["fresh"], line["plain"]["pending"]) == (fresh, pending)
    assert fresh + pending <= 2 * 1024 and line["plain"]["lanes_per_s"] > 0
    assert "kernel: not run" in out.stderr


@pytest.mark.parametrize("log2_cap,batch", [(12, 512), (13, 1024), (11, 2048)])
def test_plain_rounds_match_the_pallas_insert(log2_cap, batch):
    """``run(device="cpu")``: the twin's counts and final table equal the
    Pallas kernel's over the bench's rounds (at 2^11 rows a round of 2,048
    keys fills the table into its apron)."""
    import torch

    from stateright_tpu_torch.ops import hashset_kernel as hk
    from stateright_tpu_torch.ops.hashset import hashset_new

    res = bench_hashset.run(log2_cap, batch, device="cpu")
    table, fresh, pending = _jax_bench(log2_cap, batch)
    assert (res["plain"]["fresh"], res["plain"]["pending"]) == (fresh, pending)
    port = hashset_new(1 << log2_cap)
    for hi, lo in bench_hashset.batches(log2_cap, batch):
        khi, klo = bench_hashset._keys(hi, lo, "cpu")
        port, *_ = hk.hashset_insert_sorted_plain(port, khi, klo,
                                                   torch.ones(batch, dtype=torch.bool))
    assert np.array_equal(table_to_numpy(port), table)
    assert res["rounds"] == max(1, (1 << log2_cap) // 2 // batch)


def test_cli_defaults_and_device_resolution():
    import torch

    assert [len(b) for b in bench_hashset.batches(20, 1 << 15)[:1]] == [2]
    assert len(bench_hashset.batches(20, 1 << 15)) == 16
    assert len(bench_hashset.batches(22, 344_064)) == 6
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli("12", "1024")
    assert out.returncode != 0
    assert "bench_hashset runs on a CUDA device and none is available" in out.stderr
