"""The conformance plane's host layers in the port, against the JAX package:
the wire codec (``conformance/wire.py``), the named corpus store
(``storage/corpus.py``), the registry lint (``telemetry/server.py``'s
``sanitize_metric_name`` and ``registry_hygiene_problems``), the model zoo
(``service/zoo.py``) and the ``conformance.batch`` fault site.

Tolerance is exact equality: decoded records, refusal messages word for
word, encoded lines, bucket keys, lint problem strings.
"""

import json
import os
import random

import pytest

from stateright_tpu.conformance import corpus as jax_corpus
from stateright_tpu.conformance import wire as jax_wire
from stateright_tpu.service import zoo as jax_zoo
from stateright_tpu.storage import corpus as jax_store
from stateright_tpu.telemetry import server as jax_server
from stateright_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from stateright_tpu_torch.conformance import wire
from stateright_tpu_torch.service import zoo
from stateright_tpu_torch.storage import CorpusStore, validate_corpus_name
from stateright_tpu_torch.telemetry import (
    MetricsRegistry,
    registry_hygiene_problems,
    sanitize_metric_name,
)
from stateright_tpu_torch.utils.faults import (
    FAULT_SITES,
    ConformanceBatchFault,
    FaultSpec,
    fault_point,
    inject,
)

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_CORPUS = os.path.join(REPO_DIR, "examples", "conformance_corpus.jsonl")

HISTORY_SHAPES = (
    ("register", "linearizability", 2, 2),
    ("register", "sequential", 2, 2),
    ("register", "linearizability", 3, 2),
    ("vec", "linearizability", 2, 2),
    ("vec", "sequential", 2, 2),
)


def _seed_lines():
    with open(SEED_CORPUS, encoding="utf-8") as f:
        return [ln for ln in f if ln.strip()]


def _history_records():
    """JAX-generated histories over every shape and mode (the JAX
    generator, so the port's codec sees the reference's records)."""
    out = []
    for i, (spec, semantics, c, o) in enumerate(HISTORY_SHAPES):
        rng = random.Random(300 + i)
        for n in range(40):
            out.append(jax_corpus.random_history(
                rng, spec=spec, semantics=semantics, threads=c,
                ops_per_thread=o, mode=("clean", "random", "invalid")[n % 3],
                rec_id=f"{spec[:3]}-{semantics[:3]}-{n}",
            ))
    return out


# Hostile and malformed frames: every refusal path of the decoder.
BAD_LINES = [
    "not json at all",
    '{"v": 1, "kind": "trace", "id": "torn", "model": "2pc", "act',
    "[1, 2, 3]",
    json.dumps({"kind": "trace", "id": "x"}),
    json.dumps({"v": 99, "kind": "trace", "id": "x"}),
    json.dumps({"v": 1, "kind": "banana", "id": "x"}),
    json.dumps({"v": 1, "kind": "trace", "id": "x"}),
    json.dumps({"v": 1, "kind": "trace", "id": "x", "model": "2pc",
                "model_args": [1]}),
    json.dumps({"v": 1, "kind": "trace", "id": "x", "model": "2pc",
                "init": -1, "actions": [0]}),
    json.dumps({"v": 1, "kind": "trace", "id": "x", "model": "2pc",
                "actions": []}),
    json.dumps({"v": 1, "kind": "trace", "id": "x", "model": "2pc",
                "actions": [0, -3]}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": "register",
                "semantics": "causal", "events": []}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": {"type": "map"},
                "semantics": "linearizability", "events": []}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register", "default": "ab"},
                "semantics": "linearizability", "events": []}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability"}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability",
                "events": [["banana", 0]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability",
                "events": [["invoke", 0, ["Push", "a"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability",
                "events": [["invoke", 0, ["Write", "ab"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability",
                "events": [["invoke", 0, ["Read", "a"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability",
                "events": [["invoke", 0, ["Read"]], ["return", 0, ["WriteOk"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h",
                "spec": {"type": "register"}, "semantics": "linearizability",
                "events": [["invoke", 0, ["Read"]], ["return", 0, ["ReadOk"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": {"type": "vec"},
                "semantics": "sequential",
                "events": [["invoke", 0, ["Pop"]], ["return", 0, ["PopOk"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": {"type": "vec"},
                "semantics": "sequential",
                "events": [["invoke", 0, ["Pop"]],
                           ["return", 0, ["PopOk", ["Some", "xy"]]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": {"type": "vec"},
                "semantics": "sequential",
                "events": [["invoke", 0, ["Len"]], ["return", 0, ["LenOk", -1]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": {"type": "vec"},
                "semantics": "sequential",
                "events": [["invoke", 0, ["Push", "a"]],
                           ["return", 0, ["PushOk", "a"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "h", "spec": {"type": "vec"},
                "semantics": "sequential", "events": [["return", 0, []]]}),
]

# Frames the decoder accepts although they end in a client bug: a double
# invoke or an orphan return latches and decoding stops there.
LATCHING_LINES = [
    json.dumps({"v": 1, "kind": "history", "id": "dbl", "spec": {"type": "vec"},
                "semantics": "linearizability",
                "events": [["invoke", 0, ["Push", "a"]], ["invoke", 0, ["Pop"]],
                           ["return", 0, ["PushOk"]]]}),
    json.dumps({"v": 1, "kind": "history", "id": "orph",
                "spec": {"type": "register", "default": "c"},
                "semantics": "sequential",
                "events": [["return", 1, ["Nonsense", 7]],
                           ["invoke", 1, ["Read"]]]}),
    json.dumps({"v": 1, "kind": "history", "spec": {"type": "vec"},
                "semantics": "sequential", "extra": {"ignored": True},
                "events": [["invoke", 0, ["Len"]], ["return", 0, ["LenOk", 9]]]}),
]


def test_decode_lines_matches_jax_on_the_seed_corpus():
    lines = _seed_lines()
    assert wire.decode_lines(lines) == jax_wire.decode_lines(lines)
    assert wire.WIRE_VERSION == jax_wire.WIRE_VERSION == 1


@pytest.mark.parametrize("line", BAD_LINES + LATCHING_LINES,
                         ids=[f"frame{i}" for i in range(len(BAD_LINES + LATCHING_LINES))])
def test_decode_frame_matches_jax_word_for_word(line):
    """Each hostile frame: the same record, or the same refusal (line,
    reason and id) as the JAX decoder."""
    got, want = wire.decode_lines([line]), jax_wire.decode_lines([line])
    assert got == want
    if line in BAD_LINES:
        assert got[0] == [] and len(got[1]) == 1


def test_decode_lines_strict_raises_the_jax_refusal():
    decoded, refusals = wire.decode_lines(BAD_LINES)
    assert decoded == []
    assert [r["line"] for r in refusals] == list(range(1, len(BAD_LINES) + 1))
    with pytest.raises(wire.WireRefusal) as got:
        wire.decode_lines(BAD_LINES, strict=True)
    with pytest.raises(jax_wire.WireRefusal) as want:
        jax_wire.decode_lines(BAD_LINES, strict=True)
    assert str(got.value) == str(want.value)
    assert (got.value.line, got.value.reason) == (want.value.line, want.value.reason)


def test_encode_bucket_and_shape_match_jax():
    """Every generated history and every seed-corpus record: the same wire
    line, the same decode of it, the same exact shape and bucket key, and
    the same stable bucketing."""
    records = _history_records() + jax_wire.decode_lines(_seed_lines())[0]
    lines = [wire.encode_record(r) for r in records]
    assert lines == [jax_wire.encode_record(r) for r in records]
    decoded, refusals = wire.decode_lines(lines)
    assert not refusals
    assert (decoded, refusals) == jax_wire.decode_lines(lines)
    for rec in decoded:
        assert wire.bucket_key(rec) == jax_wire.bucket_key(rec)
        if rec["kind"] == "history":
            assert wire.history_shape(rec) == jax_wire.history_shape(rec)
        # Round trip: a decoded record encodes to a line that decodes to it.
        assert wire.decode_lines([wire.encode_record(rec)])[0] == [rec]
    assert list(wire.bucket_records(decoded).items()) == list(
        jax_wire.bucket_records(decoded).items()
    )
    # A raw frame passes through encode_record as sorted JSON.
    raw = json.loads(lines[0])
    assert wire.encode_record(raw) == jax_wire.encode_record(raw)


# -- the named corpus store ---------------------------------------------------

NAMES = ["seed", "a.b-c_9", "x" * 128, "x" * 129, ".hidden", "../../etc/passwd",
         "a/b", "", "-lead", "0k", None, 7]


@pytest.mark.parametrize("name", NAMES, ids=[f"name{i}" for i in range(len(NAMES))])
def test_validate_corpus_name_matches_jax(name):
    def outcome(fn):
        try:
            return ("ok", fn(name))
        except ValueError as e:
            return ("refused", str(e))

    assert outcome(validate_corpus_name) == outcome(jax_store.validate_corpus_name)


def test_corpus_store_behaves_as_jax(tmp_path):
    lines = [ln.rstrip("\n") for ln in _seed_lines()]
    port, ref = CorpusStore(str(tmp_path / "port")), jax_store.CorpusStore(str(tmp_path / "jax"))
    for store in (port, ref):
        assert store.list() == []
        store.save("seed", lines)
        store.save("two", lines[:2] + ["\n"])
        with open(os.path.join(store.root, "notes.txt"), "w") as f:
            f.write("not a corpus")
    assert port.list() == ref.list() == ["seed", "two"]
    for name in ("seed", "two"):
        assert port.load(name) == ref.load(name)
        with open(port.path(name), "rb") as a, open(ref.path(name), "rb") as b:
            assert a.read() == b.read()
    assert port.load("seed") == lines
    for store in (port, ref):
        with pytest.raises(FileNotFoundError):
            store.load("absent")
        with pytest.raises(ValueError, match="invalid corpus name"):
            store.load("../../etc/passwd")
        with pytest.raises(ValueError, match="invalid corpus name"):
            store.save("a/b", lines)
    # Atomic writes leave no stray temporary file behind.
    assert sorted(os.listdir(port.root)) == sorted(os.listdir(ref.root))
    assert not any(n.endswith(".tmp") for n in os.listdir(port.root))


# -- the registry lint ----------------------------------------------------------

METRIC_NAMES = ["conformance.traces", "a.b-c", "9lives", "x y/z", "tpu_bfs.wave",
                "ümlaut.metric", "ok_name:sub", ""]


@pytest.mark.parametrize("prefix", ["stateright", ""])
def test_sanitize_metric_name_matches_jax(prefix):
    for name in METRIC_NAMES:
        assert sanitize_metric_name(name, prefix) == jax_server.sanitize_metric_name(name, prefix)


def _lint_case(reg_cls, case):
    reg = reg_cls()
    if case == "clean":
        for n in ("conformance.traces", "conformance.batches"):
            reg.counter(n).inc()
        reg.gauge("conformance.traces_per_s").set(1.0)
        reg.histogram("conformance.batch_seconds").observe(0.5)
    elif case == "collision":
        reg.counter("a.b").inc()
        reg.gauge("a_b_total").set(1)
        reg.gauge("x.y").set(1)
        reg.gauge("x-y").set(2)
    else:  # with no prefix, an empty name stays Prometheus-illegal
        reg.gauge("").set(1)
        reg.gauge("ü").set(1)
    return reg


@pytest.mark.parametrize("case,prefix", [("clean", "stateright"), ("collision", "stateright"),
                                         ("illegal", "")])
def test_registry_hygiene_problems_match_jax(case, prefix):
    got = registry_hygiene_problems(_lint_case(MetricsRegistry, case), prefix)
    want = jax_server.registry_hygiene_problems(_lint_case(JaxRegistry, case), prefix)
    assert got == want
    assert (got == []) == (case == "clean")


# -- the zoo and the fault site ---------------------------------------------------


def test_zoo_matches_jax():
    port, ref = zoo.default_zoo(), jax_zoo.default_zoo()
    assert list(port) == list(ref)
    assert zoo.warm_shapes() == jax_zoo.warm_shapes()
    for name, args in [("2pc", {}), ("abd", {"clients": 2, "ordered": True}),
                       ("raft", {"retain": "election safety", "server_count": 3})]:
        assert zoo.aot_namespace(name, args) == jax_zoo.aot_namespace(name, args)
    # Each factory's default model has the JAX model's action space and
    # as many initial states, in the port's own classes.
    for name in ("2pc", "abd", "increment_lock", "single_copy_register", "sharded_kv",
                 "paxos"):
        m, j = port[name](), ref[name]()
        assert type(m).__module__.startswith("stateright_tpu_torch.")
        assert m.packed_action_count() == j.packed_action_count(), name
        assert len(m.init_states()) == len(j.init_states()), name
    ordered = port["abd"](ordered=True)
    assert ordered.packed_action_count() == ref["abd"](ordered=True).packed_action_count()
    raft = port["raft"](server_count=3, retain="election safety")
    assert [p.name for p in raft.properties()] == ["election safety"]


def test_conformance_batch_fault_site_is_registered():
    assert "conformance.batch" in FAULT_SITES
    with inject(FaultSpec("conformance.batch", at=1)) as inj:
        fault_point("conformance.batch")
        with pytest.raises(ConformanceBatchFault):
            fault_point("conformance.batch")
    assert inj.specs[0].triggered == 1
    assert ConformanceBatchFault.fault_class == "conformance_batch"
