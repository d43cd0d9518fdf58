"""History auditing in the port (``conformance/audit.py`` on the CPU, with
the copied ``semantics/sequential_consistency.py`` and ``vec.py``) against
the JAX package's ``conformance/audit.py``.

The sweep is the JAX package's own (``tests/test_conformance.py``): at
least 500 seeded histories for each of the five history shapes, cycling
clean, random and invalid, wire-encoded, decoded and bucketed by exact
shape. On every record the port's verdict dict equals the JAX one (the
JAX side runs once per shape, ``jax.jit(jax.vmap(...))`` on the CPU) and
the port's host oracle, refusals included, and the packed vectors are
equal bit for bit. Tolerance is exact equality.
"""

import random

import numpy as np
import pytest

from stateright_tpu.conformance import audit as jax_audit
from stateright_tpu.conformance import corpus as jax_corpus
from stateright_tpu.conformance import wire as jax_wire
from stateright_tpu.semantics import SequentialConsistencyTester as JaxSC
from stateright_tpu.semantics import VecSpec as JaxVec
from stateright_tpu.semantics.register import Register as JaxRegister
from stateright_tpu_torch.conformance import (
    MAX_VEC_LANES,
    PackedVecHistory,
    audit_batch,
    audit_kernel,
    bucket_records,
    decode_lines,
    encode_record,
    host_is_consistent,
    pack_history,
    random_history,
)
from stateright_tpu_torch.conformance.audit import (
    MAX_REGISTER_DP_TRANSITIONS,
    drive_tester,
)
from stateright_tpu_torch.semantics import (
    LEN,
    POP,
    PUSH_OK,
    LenOk,
    PopOk,
    Push,
    Register,
    SequentialConsistencyTester,
    VecSpec,
)

HISTORY_SHAPES = (
    ("register", "linearizability", 2, 2),
    ("register", "sequential", 2, 2),
    ("register", "linearizability", 3, 2),
    ("vec", "linearizability", 2, 2),
    ("vec", "sequential", 2, 2),
)
SHAPE_IDS = [f"{s}-{m[:3]}-C{c}O{o}" for s, m, c, o in HISTORY_SHAPES]


def _histories(gen, seed, n, spec, semantics, threads, ops):
    rng = random.Random(seed)
    modes = ("clean", "random", "invalid")
    return [
        gen(rng, spec=spec, semantics=semantics, threads=threads,
            ops_per_thread=ops, mode=modes[i % 3],
            rec_id=f"{spec[:3]}-{semantics[:3]}-{i}")
        for i in range(n)
    ]


def _decoded(records):
    decoded, refusals = decode_lines([encode_record(r) for r in records])
    assert not refusals, refusals[:2]
    return decoded


@pytest.fixture(scope="module")
def sweep():
    """Per shape: the decoded records of the JAX sweep (seed 42, 500
    histories) and the JAX verdicts, bucket by bucket."""
    out = {}
    for shape in HISTORY_SHAPES:
        decoded = _decoded(_histories(jax_corpus.random_history, 42, 500, *shape))
        verdicts = []
        for recs in bucket_records(decoded).values():
            verdicts.append((recs, jax_audit.audit_batch(recs)))
        out[shape] = (decoded, verdicts)
    return out


# -- the copied testers and spec ----------------------------------------------


def test_random_history_matches_jax():
    """The history generator draws in the JAX order: same records for the
    same seed, every shape and mode (in-flight tails included)."""
    for i, shape in enumerate(HISTORY_SHAPES):
        for mode in ("clean", "random", "invalid"):
            a, b = random.Random(900 + i), random.Random(900 + i)
            for n in range(30):
                kw = dict(spec=shape[0], semantics=shape[1], threads=shape[2],
                          ops_per_thread=shape[3], mode=mode, rec_id=f"h{n}")
                assert random_history(a, **kw) == jax_corpus.random_history(b, **kw)


def test_vec_spec_matches_jax():
    rng = random.Random(5)
    port, ref = VecSpec(), JaxVec()
    for _ in range(400):
        roll = rng.random()
        op = Push(rng.choice("abc")) if roll < 0.45 else POP if roll < 0.85 else LEN
        assert port.invoke(op) == ref.invoke(op)
        assert port.items == ref.items
        assert port.clone() == port and port.clone() is not port
    assert hash(VecSpec(["a", "b"])) == hash(JaxVec(["a", "b"]))
    assert (PUSH_OK, PopOk(None), LenOk(2)) == (("PushOk",), ("PopOk", None), ("LenOk", 2))
    with pytest.raises(ValueError, match="unknown vec op"):
        VecSpec().invoke(("Peek",))


@pytest.mark.parametrize("shape", HISTORY_SHAPES, ids=SHAPE_IDS)
def test_sequential_consistency_tester_matches_jax(shape):
    """The SC tester, driven by the same events as the JAX one: the same
    verdict, serialization, validity latch and hash on every history."""
    spec = shape[0]
    for rec in _decoded(_histories(jax_corpus.random_history, 7, 150, *shape)):
        port = SequentialConsistencyTester(
            Register(rec["default"]) if spec == "register" else VecSpec())
        ref = JaxSC(JaxRegister(rec["default"]) if spec == "register" else JaxVec())
        drive_tester(port, rec["events"])
        jax_audit.drive_tester(ref, rec["events"])
        assert port.is_valid_history == ref.is_valid_history
        assert port.is_consistent() == ref.is_consistent(), rec["id"]
        assert port.serialized_history() == ref.serialized_history()
        assert len(port) == len(ref)
        assert hash(port) == hash(ref)


# -- the audit sweep ----------------------------------------------------------------


@pytest.mark.parametrize("shape", HISTORY_SHAPES, ids=SHAPE_IDS)
def test_audit_batch_matches_jax_and_the_host_oracle(sweep, shape):
    """>=500 seeded histories of one shape: the port's verdict dict equals
    JAX's on every record (refusals word for word), equals the host
    oracle, and the by-construction labels hold."""
    decoded, jax_verdicts = sweep[shape]
    checked = refused = 0
    for recs, want in jax_verdicts:
        got = audit_batch(recs, device="cpu")
        assert got == want
        # Padding a short batch with inert rows changes no verdict.
        assert audit_batch(recs, lanes=len(recs) + 5, device="cpu") == want
        for rec, v in zip(recs, got):
            assert host_is_consistent(rec) == jax_audit.host_is_consistent(rec)
            if v.get("refused") is not None:
                assert rec["meta"]["expect"] == "invalid" and "bound is" in v["refused"]
                refused += 1
                continue
            checked += 1
            assert v["consistent"] == host_is_consistent(rec), rec["id"]
            expect = rec["meta"]["expect"]
            if expect == "consistent":
                assert v["consistent"], rec["id"]
            elif expect == "invalid":
                assert not v["consistent"] and not v["valid_history"], rec["id"]
    assert checked + refused == len(decoded) >= 500
    assert checked >= (2 * len(decoded)) // 3


@pytest.mark.parametrize("shape", HISTORY_SHAPES, ids=SHAPE_IDS)
def test_packed_vectors_match_jax_bit_for_bit(sweep, shape):
    """``pack_history`` (the register codec through the host tester, the
    vec codec ``PackedVecHistory.pack``) gives the JAX vectors, or the JAX
    refusal, on every record of the sweep."""
    decoded, _ = sweep[shape]
    for rec in decoded:
        vec, reason = pack_history(rec)
        jvec, jreason = jax_audit.pack_history(rec)
        assert reason == jreason
        if vec is None:
            continue
        assert vec.dtype == np.uint32 and np.array_equal(vec, np.asarray(jvec))
        if rec["spec"] == "vec":
            c, o = jax_wire.history_shape(rec)
            tids = sorted({e[1] for e in rec["events"]}) or [0]
            assert np.array_equal(PackedVecHistory(c, o).pack(rec["events"], tids),
                                  jax_audit.PackedVecHistory(c, o).pack(rec["events"], tids))


def test_sequential_weaker_than_linearizability():
    """SC drops the real-time constraint: every linearizable history is
    SC-consistent, and some SC-consistent histories are not linearizable.
    Both show in a sweep, in the port and in JAX alike."""
    decoded = _decoded(_histories(jax_corpus.random_history, 9, 300,
                                  "register", "linearizability", 2, 2))
    gap = 0
    for recs in bucket_records(decoded).values():
        sc_recs = [dict(r, semantics="sequential") for r in recs]
        lin_v, sc_v = audit_batch(recs, device="cpu"), audit_batch(sc_recs, device="cpu")
        assert lin_v == jax_audit.audit_batch(recs)
        assert sc_v == jax_audit.audit_batch(sc_recs)
        for lv, sv in zip(lin_v, sc_v):
            if lv["consistent"]:
                assert sv["consistent"]
            if sv["consistent"] and not lv["consistent"]:
                gap += 1
    assert gap > 0, "sweep never exercised the lin/SC gap"


# -- refusals and bounds ------------------------------------------------------------


def _wide_history(spec, threads, ops):
    """A clean history of ``threads`` threads x ``ops`` ops each."""
    rng = random.Random(threads * 10 + ops)
    while True:
        rec = random_history(rng, spec=spec, semantics="linearizability",
                             threads=threads, ops_per_thread=ops, mode="clean",
                             inflight_prob=0.0, rec_id=f"{spec}-{threads}x{ops}")
        if jax_wire.history_shape(rec) == (threads, ops):
            return rec


@pytest.mark.parametrize("spec,threads,ops", [
    ("register", 3, 3),   # DP graph 192 > 96
    ("register", 2, 6),   # 98 > 96
    ("register", 4, 8),   # 33 ops > 31
    ("vec", 3, 3),        # 1,680 x 8 lanes > 4,096
    ("vec", 2, 7),        # 3,432 x 4 lanes > 4,096
    ("vec", 2, 6),        # 924 x 4 = 3,696 lanes: audited
    ("register", 3, 2),   # 81 transitions: audited
])
def test_refusal_bounds_match_jax(spec, threads, ops):
    """The same refusals as JAX, word for word, at and past both bounds;
    within them the same verdicts."""
    rec = _decoded([_wide_history(spec, threads, ops)])[0]
    got, want = audit_batch([rec], device="cpu"), jax_audit.audit_batch([rec])
    assert got == want
    assert MAX_VEC_LANES == jax_audit.MAX_VEC_LANES == 4096
    assert MAX_REGISTER_DP_TRANSITIONS == jax_audit.MAX_REGISTER_DP_TRANSITIONS == 96
    if "refused" not in got[0]:
        assert got[0]["consistent"] == host_is_consistent(rec) is True


def test_vec_grid_runs_in_row_chunks(monkeypatch):
    """A vec batch past the grid's element budget runs in row chunks with
    the same verdicts as one pass."""
    from stateright_tpu_torch.conformance import audit as port_audit

    decoded = _decoded(_histories(random_history, 11, 90, "vec", "linearizability", 3, 2))
    recs = max(bucket_records(decoded).values(), key=len)
    port_audit.clear_audit_kernels()
    whole = audit_batch(recs, device="cpu")
    monkeypatch.setattr(port_audit, "_VEC_CHUNK_ELEMENTS", 1)
    port_audit.clear_audit_kernels()
    try:
        assert audit_batch(recs, device="cpu") == whole == jax_audit.audit_batch(recs)
    finally:
        port_audit.clear_audit_kernels()


def test_audit_runs_on_cuda_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rec = _decoded([_wide_history("register", 2, 2)])[0]
    with pytest.raises(RuntimeError, match="audit_batch runs on a CUDA device"):
        audit_batch([rec])
    with pytest.raises(RuntimeError, match="audit_kernel runs on a CUDA device"):
        audit_kernel("register", "linearizability", 2, 2, "a")
