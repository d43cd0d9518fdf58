"""The conformance plane and the insert micro-bench on the card, against
the port's CPU twin: trace replay (one captured CUDA Graph a shape),
history audits, the checker over the seed corpus, and
``ops/bench_hashset.run`` with the insert kernel. Tolerance is exact
equality.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs on a machine with only PyTorch; there, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conformance_cuda.py
"""

import os
import random
import threading
import time

import pytest
import torch

from stateright_tpu_torch.conformance import (
    ConformanceChecker,
    audit_batch,
    bucket_records,
    clear_replay_kernels,
    decode_lines,
    encode_record,
    mutate_trace,
    random_history,
    random_walk_trace,
    replay_batch,
    replay_kernel,
)
from stateright_tpu_torch.ops import bench_hashset
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.service import aot_namespace, default_zoo

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_CORPUS = os.path.join(REPO_DIR, "examples", "conformance_corpus.jsonl")
HISTORY_SHAPES = (
    ("register", "linearizability", 2, 2),
    ("register", "sequential", 2, 2),
    ("register", "linearizability", 3, 2),
    ("vec", "linearizability", 2, 2),
    ("vec", "sequential", 2, 2),
    ("vec", "linearizability", 3, 2),
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bundle(name, walks=12, steps=10, seed=5):
    model = default_zoo()[name]()
    rng = random.Random(seed)
    clean = [random_walk_trace(model, rng, steps, rec_id=f"{name}-{i}", model_name=name)
             for i in range(walks)]
    mutated = [m for m in (mutate_trace(model, rng, r) for r in clean) if m is not None]
    return model, clean + mutated


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["increment_lock", "2pc", "abd"])
@pytest.mark.parametrize("lanes", [1, 64])
def test_cuda_replay_matches_cpu(cuda_device, name, lanes):
    """Each batch through the captured graph equals the CPU twin's; the
    shape's graph is captured once and replayed for every later batch."""
    model, records = _bundle(name)
    T = max(len(r["actions"]) for r in records)
    ns = aot_namespace(name, {})
    clear_replay_kernels()
    for lo in range(0, len(records), lanes):
        chunk = records[lo: lo + lanes]
        got = replay_batch(chunk, model, ns, T, lanes=lanes, device=cuda_device)
        assert got == replay_batch(chunk, model, ns, T, lanes=lanes, device="cpu")
    fn = replay_kernel(model, ns, T, lanes, cuda_device)
    assert fn.captures == 1 and fn.replays == -(-len(records) // lanes)


@pytest.mark.cuda
def test_cuda_replay_graph_is_shared_by_concurrent_callers(cuda_device):
    """Two threads on one cached graph: every batch's verdicts are its
    own (the lock holds copy-in, replay and copy-out together)."""
    model, records = _bundle("increment_lock", walks=24)
    T = max(len(r["actions"]) for r in records)
    ns = aot_namespace("increment_lock", {})
    batches = [records[i: i + 8] for i in range(0, 32, 8)] * 4
    want = [replay_batch(b, model, ns, T, lanes=8, device="cpu") for b in batches]
    got = [None] * len(batches)
    errors = []

    def worker(idx):
        try:
            for i in idx:
                got[i] = replay_batch(batches[i], model, ns, T, lanes=8, device=cuda_device)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(range(k, len(batches), 2),))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and got == want
    assert replay_kernel(model, ns, T, 8, cuda_device).captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HISTORY_SHAPES,
                         ids=[f"{s}-{m[:3]}-C{c}O{o}" for s, m, c, o in HISTORY_SHAPES])
def test_cuda_audit_matches_cpu(cuda_device, shape):
    rng = random.Random(42)
    recs = [random_history(rng, spec=shape[0], semantics=shape[1], threads=shape[2],
                           ops_per_thread=shape[3], mode=("clean", "random", "invalid")[i % 3],
                           rec_id=f"h{i}") for i in range(300)]
    decoded, refusals = decode_lines([encode_record(r) for r in recs])
    assert not refusals
    for bucket in bucket_records(decoded).values():
        assert audit_batch(bucket, lanes=len(bucket) + 3, device=cuda_device) == (
            audit_batch(bucket, device="cpu"))


@pytest.mark.cuda
def test_cuda_checker_seed_corpus_matches_cpu(cuda_device):
    with open(SEED_CORPUS, encoding="utf-8") as f:
        records, refusals = decode_lines([ln for ln in f if ln.strip()])
    assert not refusals
    reports = []
    for dev in (cuda_device, "cpu"):
        ck = ConformanceChecker(records, default_zoo(), parity=True, batch_lanes=32, device=dev)
        deadline = time.monotonic() + 300
        while not ck.is_done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ck.is_done() and ck.worker_error() is None
        reports.append({k: v for k, v in ck.conformance_report().items()
                        if k != "traces_per_s"})
    assert reports[0] == reports[1]


@pytest.mark.cuda
def test_cuda_bench_hashset_kernel_equals_the_twin(cuda_device):
    before = hk.launches
    res = bench_hashset.run(16, 4096, device=cuda_device)
    assert res["equal"] is True and res["max_abs_err"] == 0
    assert res["launches"] == res["rounds"] + 1 == hk.launches - before
    assert res["kernel"]["fresh"] == res["plain"]["fresh"] > 0
