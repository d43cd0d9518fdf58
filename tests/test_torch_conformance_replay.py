"""Trace replay in the port (``conformance/replay.py`` on the CPU) against
the JAX package's ``replay_batch`` (``jax.jit(jax.vmap(lax.scan))`` on the
CPU) and the port's own host oracle ``replay_host``.

For increment_lock, 2pc and the zoo's abd: clean seeded walks and their
known-divergent twins (the port's generators, which
``tests/test_torch_conformance_corpus.py`` holds to the JAX ones). Every
verdict is compared on all five fields (conforms, divergence index,
offending action, steps, final fingerprint). Tolerance is exact equality.
"""

import random

import numpy as np
import pytest

from stateright_tpu.conformance import replay as jax_replay
from stateright_tpu.service.zoo import default_zoo as jax_default_zoo
from stateright_tpu_torch.conformance import (
    clear_replay_kernels,
    mutate_trace,
    random_walk_trace,
    replay_batch,
    replay_host,
    replay_kernel,
    validate_trace,
)
from stateright_tpu_torch.conformance.replay import pad_actions, warm_replay
from stateright_tpu_torch.service import aot_namespace, default_zoo

# (zoo name, walks, steps) of each bundle.
BUNDLES = {"increment_lock": (6, 10), "2pc": (6, 10), "abd": (4, 8)}
FIELDS = ("conforms", "divergence_index", "offending_action", "steps", "fingerprint")


def _bundle(name, walks, steps, seed=5):
    model = default_zoo()[name]()
    rng = random.Random(seed)
    clean = [random_walk_trace(model, rng, steps, rec_id=f"{name}-{i}", model_name=name)
             for i in range(walks)]
    mutated = [m for m in (mutate_trace(model, rng, r) for r in clean) if m is not None]
    return model, clean + mutated


@pytest.fixture(scope="module")
def bundles():
    """Per model: the port's model, the records, T, and the JAX verdicts
    (one ``replay_batch`` of 16 lanes)."""
    out = {}
    for name, (walks, steps) in BUNDLES.items():
        model, records = _bundle(name, walks, steps)
        T = max(len(r["actions"]) for r in records)
        want = jax_replay.replay_batch(records, jax_default_zoo()[name](),
                                       aot_namespace(name, {}), T, lanes=16)
        out[name] = (model, records, T, want)
    return out


@pytest.mark.parametrize("name", list(BUNDLES))
def test_replay_batch_matches_jax_on_all_five_fields(bundles, name):
    model, records, T, want = bundles[name]
    assert any(r["id"].endswith("-div") for r in records)
    got = replay_batch(records, model, aot_namespace(name, {}), T, lanes=16, device="cpu")
    assert got == want
    for rec, v in zip(records, got):
        assert v == replay_host(rec, model), rec["id"]
        assert set(FIELDS) < set(v)
        if rec["id"].endswith("-div"):
            assert not v["conforms"]
            assert v["divergence_index"] == rec["meta"]["divergence_index"]
            assert v["offending_action"] == rec["meta"]["offending_action"]
            assert v["steps"] == v["divergence_index"]
        else:
            assert v["conforms"] and v["divergence_index"] is None
            assert v["steps"] == len(rec["actions"])


@pytest.mark.parametrize("name", ["increment_lock", "2pc"])
def test_replay_host_matches_jax(bundles, name):
    """The port's one-lane oracle against the JAX one (``packed_step`` in
    a Python loop) on the bundle's mutated traces and two clean ones."""
    model, records, _T, _want = bundles[name]
    jax_model = jax_default_zoo()[name]()
    picked = [r for r in records if r["id"].endswith("-div")] + records[:2]
    for rec in picked:
        assert replay_host(rec, model) == jax_replay.replay_host(rec, jax_model)


@pytest.mark.parametrize("name", list(BUNDLES))
def test_trace_padding_is_inert(bundles, name):
    """A trace in a tight bucket scores as in a long, wide one: padding
    never steps, inert lanes never diverge."""
    model, records, T, want = bundles[name]
    ns = aot_namespace(name, {})
    tight = replay_batch(records, model, ns, T, lanes=len(records), device="cpu")
    padded = replay_batch(records, model, ns, T + 7, lanes=40, device="cpu")
    assert tight == padded == want


def test_divergent_lanes_are_counted_exactly(bundles):
    """A batch mixing divergent twins into clean lanes at a set fraction
    (the bench's divergence sweep): exactly that many lanes diverge."""
    model, records, T, _ = bundles["increment_lock"]
    clean = [r for r in records if not r["id"].endswith("-div")]
    div = [r for r in records if r["id"].endswith("-div")]
    ns = aot_namespace("increment_lock", {})
    for n_div in (0, 3, 16):
        recs = [dict((div if i < n_div else clean)[i % len(div if i < n_div else clean)],
                     id=f"l{i}") for i in range(32)]
        got = replay_batch(recs, model, ns, T, lanes=32, device="cpu")
        assert sum(not v["conforms"] for v in got) == n_div


def test_validate_trace_matches_jax():
    model, jax_model = default_zoo()["2pc"](), jax_default_zoo()["2pc"]()
    A = model.packed_action_count()
    for rec in ({"init": 0, "actions": [0, 1]}, {"init": 3, "actions": [0]},
                {"init": 0, "actions": [2, A, A + 5]}):
        assert validate_trace(rec, model) == jax_replay.validate_trace(rec, jax_model)
    assert validate_trace({"init": 3, "actions": [0]}, model).startswith("init index 3")


def test_replay_kernel_cache_and_grid():
    model = default_zoo()["increment_lock"]()
    ns = aot_namespace("increment_lock", {})
    clear_replay_kernels()
    fn = replay_kernel(model, ns, 8, 4, device="cpu")
    assert replay_kernel(model, ns, 8, 4, device="cpu") is fn
    assert replay_kernel(model, ns, 8, 8, device="cpu") is not fn
    assert warm_replay(model, ns, 8, 4, device="cpu") is fn
    grid = pad_actions([{"actions": [1, 2]}, {"actions": [3]}], 4, 3)
    assert grid.dtype == np.int64 and grid.tolist() == [[1, 2, -1, -1], [3, -1, -1, -1],
                                                        [-1, -1, -1, -1]]
    with pytest.raises(ValueError, match="is not"):
        fn(None, np.zeros((4, 7), np.int64))
    with pytest.raises(ValueError, match="exceed the 2-lane batch"):
        replay_batch([{"id": "a", "init": 0, "actions": [0]}] * 3, model, ns, 8, lanes=2,
                     device="cpu")
    assert replay_batch([], model, ns, 8, device="cpu") == []
    clear_replay_kernels()
    assert replay_kernel(model, ns, 8, 4, device="cpu") is not fn


def test_replay_runs_on_cuda_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = default_zoo()["2pc"]()
    rec = {"id": "t", "init": 0, "actions": [0]}
    for call in (lambda: replay_batch([rec], model, "zoo:2pc()", 1),
                 lambda: replay_kernel(model, "zoo:2pc()", 1, 1)):
        with pytest.raises(RuntimeError, match="runs on a CUDA device and none is available"):
            call()


def test_concurrent_callers_share_one_replayer(bundles):
    """More threads than cores replaying through one cached shape, with a
    short switch interval: one replayer is made, and every batch gets its
    own verdicts (the card's twin of this is in
    ``tests/test_torch_conformance_cuda.py``)."""
    import sys
    import threading

    model, records, T, _ = bundles["2pc"]
    ns = aot_namespace("2pc", {}) + "-threads"
    batches = [records[i: i + 4] for i in range(0, len(records), 4)] * 6
    want = [replay_batch(b, model, ns, T, lanes=4, device="cpu") for b in batches]
    clear_replay_kernels()
    got, errors, made = [None] * len(batches), [], []

    def worker(k):
        try:
            made.append(replay_kernel(model, ns, T, 4, device="cpu"))
            for i in range(k, len(batches), 16):
                got[i] = replay_batch(batches[i], model, ns, T, lanes=4, device="cpu")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == want
    assert len({id(fn) for fn in made}) == 1
