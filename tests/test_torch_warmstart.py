"""The port's warm-start plane on the CPU: the twins of
``tests/test_warmstart.py`` (the fenced disk store, the warm pool, seeds
and their refusals), held to that file's assertions, plus the signature's
own cases.

The port's disk store keeps a namespace's record of kernels and drain
shapes, not executables (``storage/persist.py``): its two cases (stale
fence and corrupt entry refused; a second process hits the first's record
and builds no kernel) fail under JAX on this machine and are not compared
with a JAX run. ``build_seed_artifact`` and ``seed_compatibility`` equal
the JAX package's on the same structure and payload dicts. The model
signature is structural: it changes when one action's code, one
closed-over constant or one init value changes, and stays equal across two
processes for an unchanged model. The port's actions share one
whole-transition digest, so removing a provably dead action falls back to a
full recheck (the JAX package reseeds it): the recheck's verdict is the
seed-free one. Verdicts are held to the JAX ``spawn_tpu_bfs`` reference;
the tolerance is 0.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from stateright_tpu_torch.core.batch import BatchableModel
from stateright_tpu_torch.core.model import Model, Property
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.service import CheckService
from stateright_tpu_torch.storage import persist
from stateright_tpu_torch.storage.persist import (
    AotDiskStore,
    aot_fence,
    build_seed_artifact,
    model_structure_signature,
    seed_compatibility,
)
from stateright_tpu_torch.telemetry import metrics_registry, registry_hygiene_problems
from stateright_tpu_torch.utils.faults import FaultSpec, inject

from torch_service_refs import SPAWN, UNIQUE, assert_verdict, golden, jax_ref, wait_for

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)


def _strip_warm(text):
    return "".join(line for line in golden(text).splitlines(keepends=True)
                   if "warm-start:" not in line)


def _service(tmp_path, **kw):
    kw.setdefault("quantum_s", 60.0)
    kw.setdefault("default_spawn", dict(SPAWN))
    kw.setdefault("device", "cpu")
    return CheckService(service_dir=str(tmp_path), **kw)


# -- the disk store --------------------------------------------------------------


def test_aot_store_refuses_stale_fence_and_corrupt_entries(tmp_path):
    store = AotDiskStore(str(tmp_path / "aot"))
    record = {"kernels": ["hashset_insert"], "build": {"hashset_insert": "lib-x.so"}}
    assert store.save_entry("ns", ("sig",), "kernels", "cuda", record)
    loaded, outcome = store.load_entry("ns", ("sig",), "kernels", "cuda")
    assert outcome == "hit" and loaded == record
    assert store.load_entry("ns", ("sig",), "kernels", "cpu")[1] == "miss"

    path = store.entry_path("ns", ("sig",), "kernels", "cuda")
    with open(path, "rb") as f:
        entry = pickle.loads(f.read())
    assert entry["fence"] == aot_fence()
    assert entry["fence"]["csrc"] == persist.csrc_digest()

    entry["fence"] = dict(entry["fence"], torch_version="0.0.0-forged")
    with open(path, "wb") as f:
        f.write(pickle.dumps(entry))
    assert store.load_entry("ns", ("sig",), "kernels", "cuda") == (None, "stale")

    with open(path, "wb") as f:
        f.write(b"\x80\x04torn")
    assert store.load_entry("ns", ("sig",), "kernels", "cuda") == (None, "corrupt")

    reg = metrics_registry("tws-fence-unit")
    binding = store.binding("ns", ("sig",), registry=reg)
    assert binding.load("kernels", "cuda") is None
    assert binding.load("kernels", "cpu") is None
    binding.save("kernels", "other", record)
    snap = reg.snapshot()
    assert snap["aot_cache.refused_corrupt"] == 1
    assert snap["aot_cache.disk_miss"] == 1
    assert snap["aot_cache.saved"] == 1
    assert not [p for p in registry_hygiene_problems(reg) if "aot_cache" in p]


def _run_child(service_dir):
    proc = subprocess.run(
        [sys.executable, os.path.join(TESTS_DIR, "torch_warmstart_child.py"), str(service_dir)],
        capture_output=True, text=True, timeout=300, cwd=REPO_DIR,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in proc.stdout.splitlines():
        if line.startswith("WARMSTART-CHILD "):
            return json.loads(line[len("WARMSTART-CHILD "):])
    raise AssertionError(f"no child record in output: {proc.stdout[-500:]}")


def test_disk_aot_roundtrip_across_processes(tmp_path):
    """Two processes share one ``service_dir``: the first misses the
    namespace's record and saves it, the second hits it; neither records a
    compile phase on the CPU (no capture), and the second builds nothing."""
    cold = _run_child(tmp_path)
    assert cold["properties_hold"] is True
    assert cold["aot"]["aot_cache.disk_miss"] >= 1
    assert cold["aot"]["aot_cache.saved"] >= 1
    assert cold["aot"]["aot_cache.disk_hit"] == 0
    warm = _run_child(tmp_path)
    assert warm["unique"] == cold["unique"] == UNIQUE[3]
    assert warm["properties_hold"] is True
    assert warm["aot"]["aot_cache.disk_hit"] >= 1
    assert warm["aot"]["aot_cache.disk_miss"] == 0
    assert warm["aot"]["aot_cache.refused_stale"] == 0
    assert warm["compile_phase_s"] == 0


# -- the warm pool ---------------------------------------------------------------


def test_warm_pool_precompiles_to_ready(tmp_path):
    svc = _service(tmp_path, warm_pool=[("2pc", {"rm_count": 3})])
    try:
        wait_for(lambda: {e["state"] for e in svc.warm_pool_status.values()} - {"pending"},
                 240, "the warm pool")
        assert len(svc.warm_pool_status) == 1
        (entry,) = svc.warm_pool_status.values()
        assert entry["state"] == "ready", entry
        st = svc.status()
        assert st["warm_start"]["enabled"] is True
        (pool_entry,) = st["warm_start"]["pool"].values()
        assert pool_entry["state"] == "ready"
        assert all(v["jobs"] == 0 for v in svc.slo.snapshot()["modes"].values())
        assert not [p for p in registry_hygiene_problems()
                    if "warmstart" in p or "aot_cache" in p or "slo" in p]
    finally:
        svc.close()


# -- seeds -----------------------------------------------------------------------


def test_unchanged_model_reseed_completes_in_verify_only(tmp_path):
    svc1 = _service(tmp_path)
    try:
        h1 = svc1.submit(model_name="2pc", model_args={"rm_count": 3})
        r1 = h1.result(timeout=300)
        st1 = h1.status()
    finally:
        svc1.close()
    assert not st1.get("warm_start")
    assert_verdict(r1, jax_ref(3, "sort"))
    seeds = os.listdir(tmp_path / "seeds")
    assert len(seeds) == 1 and seeds[0].endswith(".seed")
    aot = metrics_registry(h1.job_id).snapshot()
    assert aot.get("aot_cache.saved", 0) + aot.get("aot_cache.save_refused", 0) > 0

    svc2 = _service(tmp_path)
    try:
        h2 = svc2.submit(model_name="2pc", model_args={"rm_count": 3})
        r2 = h2.result(timeout=300)
        st2 = h2.status()
    finally:
        svc2.close()
    assert st2["warm_start"] is True
    assert st2["seeded_from"]["mode"] == "exact"
    assert st2["seeded_from"]["keys"] == UNIQUE[3]
    assert st2["seeded_from"]["invalidated_uniques"] == 0
    assert r2["warm_start"] is True
    assert metrics_registry(h2.job_id).snapshot().get("gpu_bfs.waves", 0) == 0
    assert (r2["unique"], r2["states"], r2["max_depth"]) == (
        r1["unique"], r1["states"], r1["max_depth"])
    assert r2["properties_hold"] == r1["properties_hold"]
    assert _strip_warm(r2["report"]) == _strip_warm(r1["report"])
    assert "warm-start: seeded from persisted run" in r2["report"]
    assert "warm-start" not in r1["report"]


class SwitchBits(Model, BatchableModel):
    """K set-bit actions, plus an optional provably dead action (its guard
    never holds); ``edit_live`` rewrites one live guard into a
    semantically identical but structurally different form. The port's
    twin of ``tests/test_warmstart.py::SwitchBits``."""

    def __init__(self, nbits=3, dead=True, edit_live=False):
        self.nbits = int(nbits)
        self.dead = bool(dead)
        self.edit_live = bool(edit_live)

    def init_states(self):
        return [(0,) * self.nbits]

    def actions(self, state, actions):
        actions.extend(i for i in range(self.nbits) if state[i] == 0)

    def next_state(self, state, action):
        return tuple(1 if i == action else b for i, b in enumerate(state))

    def properties(self):
        return [Property.always("ok", lambda m, s: True)]

    def packed_action_count(self):
        return self.nbits + (1 if self.dead else 0)

    def packed_init_states(self, device="cpu"):
        return {"bits": torch.zeros((1, self.nbits), dtype=torch.int64, device=device)}

    def packed_expand(self, states):
        b = states["bits"]
        cands, valids = [], []
        for i in range(self.nbits):
            nb = b.clone()
            nb[:, i] = 1
            cands.append(nb)
            valids.append(b[:, i] < 1 if (i == 0 and self.edit_live) else b[:, i] == 0)
        if self.dead:
            cands.append(b.clone())
            valids.append(b[:, 0] > 1)
        return {"bits": torch.stack(cands, 1)}, torch.stack(valids, 1)

    def packed_conditions(self):
        return [lambda st: torch.ones(st["bits"].shape[0], dtype=torch.bool,
                                      device=st["bits"].device)]


def _jax_switch(**kw):
    from test_warmstart import SwitchBits as JaxSwitchBits

    c = JaxSwitchBits(**kw).checker().spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort",
                                                    **SPAWN).join()
    return c.unique_state_count(), c.state_count()


def _run_switch(svc, **kw):
    h = svc.submit(model=SwitchBits(**kw), spawn={"coverage": True})
    return h.result(timeout=300), h.status()


def test_dead_action_removal_falls_back_to_the_seed_free_verdict(tmp_path):
    """The port's structural signature cannot isolate an action: removing
    the provably dead action and editing a live one both land on the full
    recheck, whose verdicts equal seed-free runs and the JAX runs."""
    svc = _service(tmp_path / "seeded")
    try:
        r1, st1 = _run_switch(svc, nbits=3, dead=True)
        assert not st1.get("warm_start")
        assert r1["unique"] == 8
        assert r1["coverage"]["actions"]["table"]["action_3"]["fired"] == 0
        r2, st2 = _run_switch(svc, nbits=3, dead=False)
        assert not st2.get("warm_start")
        assert "not a pure removal" in st2["warm_start_reason"]
        # The recheck of the removal saved its own seed (three actions),
        # which the live edit's four actions are judged against.
        r3, st3 = _run_switch(svc, nbits=3, dead=True, edit_live=True)
        assert not st3.get("warm_start")
        assert "actions added" in st3["warm_start_reason"]
    finally:
        svc.close()
    fresh = _service(tmp_path / "fresh", warm_start=False)
    try:
        f2, _ = _run_switch(fresh, nbits=3, dead=False)
        f3, _ = _run_switch(fresh, nbits=3, dead=True, edit_live=True)
    finally:
        fresh.close()
    for r, f, kw in ((r2, f2, dict(dead=False)), (r3, f3, dict(dead=True, edit_live=True))):
        assert (r["unique"], r["states"], r["max_depth"]) == (
            f["unique"], f["states"], f["max_depth"])
        assert golden(r["report"]) == golden(f["report"])
        assert (r["unique"], r["states"]) == _jax_switch(nbits=3, **kw)
    assert (r1["unique"], r1["states"]) == _jax_switch(nbits=3, dead=True)


def test_corrupt_or_faulted_seed_falls_back_to_full_recheck(tmp_path):
    svc1 = _service(tmp_path)
    try:
        r1 = svc1.submit(model_name="2pc", model_args={"rm_count": 3}).result(timeout=300)
    finally:
        svc1.close()
    assert r1["unique"] == UNIQUE[3]
    (seed_name,) = os.listdir(tmp_path / "seeds")
    seed_path = tmp_path / "seeds" / seed_name

    def refused_run(svc):
        before = metrics_registry().snapshot().get("warmstart.seed_refused", 0)
        h = svc.submit(model_name="2pc", model_args={"rm_count": 3})
        r = h.result(timeout=300)
        st = h.status()
        after = metrics_registry().snapshot().get("warmstart.seed_refused", 0)
        assert not st.get("warm_start")
        assert st["warm_start_reason"]
        assert after == before + 1
        assert_verdict(r, jax_ref(3, "sort"))
        return st

    blob = seed_path.read_bytes()
    seed_path.write_bytes(blob[: len(blob) // 2])
    svc2 = _service(tmp_path)
    try:
        assert "seed artifact refused" in refused_run(svc2)["warm_start_reason"]
    finally:
        svc2.close()
    seed_path.write_bytes(blob)
    svc3 = _service(tmp_path)
    try:
        with inject(FaultSpec("warmstart.seed_load")):
            st = refused_run(svc3)
        assert "SeedLoadFault" in st["warm_start_reason"]
    finally:
        svc3.close()


# -- the seed artifact and its judge, against the JAX package ---------------------


def _payload(symmetry=False, with_storage=True):
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(1, 1 << 62, 300, dtype=np.uint64))
    payload = {"version": 2, "kind": "gpu_bfs", "model": "TwoPhaseSys", "symmetry": symmetry,
               "state_count": 1146, "unique_count": 288, "max_depth": 11,
               "discoveries": {"x": 7}, "children": keys[:200],
               "parents": np.zeros(200, np.uint64), "chunks": [], "capacity": 4096}
    if symmetry:
        payload["keys"] = keys[50:250]
    if with_storage:
        from stateright_tpu_torch.storage import FingerprintRun

        payload["storage"] = {"seq": 2, "l1": [FingerprintRun.build(keys[150:]).to_state()],
                              "l2": []}
    return payload


def _structure(actions, **over):
    s = {"format": 1, "fp_scheme": "fp1", "model": "M", "action_count": len(actions),
         "labels": [f"action_{i}" for i in range(len(actions))], "init": "i0",
         "actions": list(actions), "properties": [["ok", "Always", "p0"]],
         "boundary": "b0", "fingerprint": "f0", "digest": "d" + "".join(actions), "family": "fam"}
    s.update(over)
    return s


def _strip_storage(artifact):
    """An artifact with its runs' states decoded (the numpy and bytes
    fields compared by value)."""
    from stateright_tpu_torch.storage import FingerprintRun

    out = dict(artifact)
    ck = dict(out["checkpoint"])
    st = dict(ck["storage"])
    st["l1"] = [FingerprintRun.from_state(r).decode_all().tolist() for r in st["l1"]]
    ck["storage"] = st
    ck["children"] = np.asarray(ck["children"]).tolist()
    ck["parents"] = np.asarray(ck["parents"]).tolist()
    if "keys" in ck:
        ck["keys"] = np.asarray(ck["keys"]).tolist()
    out["checkpoint"] = ck
    return out


@pytest.mark.parametrize("symmetry", [False, True])
@pytest.mark.parametrize("with_storage", [False, True])
def test_build_seed_artifact_equals_jax(symmetry, with_storage):
    from stateright_tpu.storage.persist import build_seed_artifact as jax_build

    structure = _structure(["a", "b", "c"])
    coverage = {"actions": {"table": {"action_0": {"fired": 3, "fresh": 2},
                                      "action_2": {"fired": 0, "fresh": 0}}}}
    ours = build_seed_artifact(structure, _payload(symmetry, with_storage), coverage=coverage)
    theirs = jax_build(structure, _payload(symmetry, with_storage), coverage=coverage)
    assert _strip_storage(ours) == _strip_storage(theirs)
    with pytest.raises(ValueError, match="completed run"):
        build_seed_artifact(structure, dict(_payload(), chunks=[{}]))


def _judge_cases():
    meta_dead = [{"label": "action_0", "fired": 4, "fresh": 3},
                 {"label": "action_1", "fired": 0, "fresh": 0},
                 {"label": "action_2", "fired": 2, "fresh": 1}]
    old = _structure(["a", "b", "c"])
    art = {"structure": old, "actions_meta": meta_dead}
    return [
        (art, _structure(["a", "b", "c"])),
        (art, _structure(["a", "c"])),
        (art, _structure(["b", "c"])),
        (art, _structure(["a", "x", "c"])),
        (art, _structure(["a", "b", "c", "d"])),
        (art, _structure(["a", "c"], init="i1")),
        (art, _structure(["a", "c"], properties=[["ok", "Always", "p1"]])),
        (art, _structure(["a", "c"], format=2)),
        ({"structure": old, "actions_meta": None}, _structure(["a", "c"])),
        ({"structure": old, "actions_meta": meta_dead[:1]}, _structure(["a"])),
    ]


@pytest.mark.parametrize("case", range(10))
def test_seed_compatibility_equals_jax(case):
    from stateright_tpu.storage.persist import seed_compatibility as jax_judge

    artifact, structure = _judge_cases()[case]
    assert seed_compatibility(artifact, structure) == jax_judge(artifact, structure)


# -- the structural signature --------------------------------------------------------


class _Shifted(TwoPhaseSys):
    """2pc with one action's code edited (an extra no-op in the expansion)."""

    def packed_expand(self, states):
        out, valid = super().packed_expand(states)
        return out, valid & True


def _closure_model(k):
    class Closed(TwoPhaseSys):
        def packed_conditions(self):
            conds = super().packed_conditions()
            return [lambda st, c=c: c(st) | (k < 0) for c in conds]
    Closed.__qualname__ = "Closed"
    return Closed(3)


def test_signature_changes_with_code_constants_and_init():
    base = model_structure_signature(TwoPhaseSys(3))
    assert model_structure_signature(TwoPhaseSys(3)) == base
    shifted = model_structure_signature(_Shifted(3))
    assert shifted["digest"] != base["digest"]
    assert set(shifted["actions"]).isdisjoint(base["actions"])
    a, b = model_structure_signature(_closure_model(1)), model_structure_signature(_closure_model(2))
    assert a["properties"] != b["properties"] and a["digest"] != b["digest"]
    other_init = model_structure_signature(TwoPhaseSys(4))
    assert other_init["init"] != base["init"] and other_init["family"] != base["family"]
    assert len(set(base["actions"])) == 1 and len(base["actions"]) == base["action_count"]


def test_signature_is_stable_across_processes():
    code = ("import json, sys; sys.path.insert(0, '.');"
            "from stateright_tpu_torch.storage.persist import model_structure_signature;"
            "from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys;"
            "print(json.dumps(model_structure_signature(TwoPhaseSys(3))))")
    outs = []
    for seed in ("1", "2"):
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=REPO_DIR, env=dict(os.environ, PYTHONHASHSEED=seed))
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1] == json.loads(json.dumps(model_structure_signature(TwoPhaseSys(3))))


# -- edits the signature must see behind the model's attributes --------------------


from stateright_tpu_torch.actor import packed_register
from stateright_tpu_torch.actor.register import Internal
from stateright_tpu_torch.models.linearizable_register import (
    AbdActor,
    AbdModelCfg,
    AbdPackedCodec,
)
from stateright_tpu_torch.models.paxos import PaxosModelCfg, PaxosPackedCodec

_ABD_ON_MSG = AbdPackedCodec.on_msg_branches
_CLIENT_ON_MSG = packed_register.client_on_msg_branch


def _abd_deaf_to_records(self, model):
    """ABD's ``on_msg_branches`` edited in place: servers no longer adopt
    the value a Record carries (its ack still goes out)."""
    server, client = _ABD_ON_MSG(self, model)

    def server_on_msg(me, row, src, msg):
        row_out, sends, set_bits, cancel_bits, changed = server(me, row, src, msg)
        rec = msg[:, 0] == self.K_RECORD
        return (torch.where(rec[:, None], row, row_out), sends, set_bits, cancel_bits,
                changed & ~rec)

    return [server_on_msg, client]


_abd_deaf_to_records.__qualname__ = _ABD_ON_MSG.__qualname__
_ABD_HOST_ON_MSG = AbdActor.on_msg


def _abd_host_deaf_to_records(self, id, state, src, msg, o):
    """The same edit of the host actor, which paths are replayed on."""
    if isinstance(msg, Internal) and msg.msg[0] == "Record":
        o.send(src, Internal(("AckRecord", msg.msg[1])))
        return None
    return _ABD_HOST_ON_MSG(self, id, state, src, msg, o)


def _client_on_msg_edited(codec, put_count, server_count):
    return _CLIENT_ON_MSG(codec, put_count, server_count + 0)


_client_on_msg_edited.__qualname__ = _CLIENT_ON_MSG.__qualname__


def _abd():
    return AbdModelCfg(2, 2).into_model()


def test_signature_sees_codec_methods_module_aliases_and_class_constants(monkeypatch):
    """The actor models run their transitions through ``self.codec`` and
    ``pr.f``: an edit there, with every name kept, changes the digest."""
    base = model_structure_signature(_abd())
    paxos = model_structure_signature(PaxosModelCfg(2, 2).into_model())
    with monkeypatch.context() as m:
        m.setattr(AbdPackedCodec, "on_msg_branches", _abd_deaf_to_records)
        edited = model_structure_signature(_abd())
        assert edited["digest"] != base["digest"]
        assert edited["family"] == base["family"]
        assert set(edited["actions"]).isdisjoint(base["actions"])
    with monkeypatch.context() as m:
        m.setattr(packed_register, "client_on_msg_branch", _client_on_msg_edited)
        assert model_structure_signature(_abd())["digest"] != base["digest"]
        assert model_structure_signature(
            PaxosModelCfg(2, 2).into_model())["digest"] != paxos["digest"]
    with monkeypatch.context() as m:
        m.setattr(PaxosPackedCodec, "K_ACCEPTED", PaxosPackedCodec.K_ACCEPTED + 100)
        assert model_structure_signature(
            PaxosModelCfg(2, 2).into_model())["digest"] != paxos["digest"]
    assert model_structure_signature(_abd()) == base


def test_codec_edit_refuses_the_seed_and_runs_cold(tmp_path, monkeypatch):
    """A seed of ABD 2c/2s, then the same model with one codec branch
    edited in place: the service refuses the seed and the edited model's
    seed-free verdict comes back, not the seed's."""
    svc = _service(tmp_path)
    try:
        h1 = svc.submit(model=_abd())
        r1 = h1.result(timeout=300)
        assert not h1.status().get("warm_start")
        assert r1["unique"] == 544
        h2 = svc.submit(model=_abd())
        assert h2.result(timeout=300)["unique"] == 544
        assert h2.status()["warm_start"] is True
        monkeypatch.setattr(AbdPackedCodec, "on_msg_branches", _abd_deaf_to_records)
        monkeypatch.setattr(AbdActor, "on_msg", _abd_host_deaf_to_records)
        h3 = svc.submit(model=_abd())
        r3 = h3.result(timeout=300)
        st3 = h3.status()
    finally:
        svc.close()
    assert not st3.get("warm_start")
    assert st3["warm_start_reason"]
    direct = _abd().checker().spawn_gpu_bfs(device="cpu", **SPAWN).join()
    assert (r3["unique"], r3["states"], r3["max_depth"]) == (
        direct.unique_state_count(), direct.state_count(), direct.max_depth())
    assert r3["unique"] != r1["unique"]


def test_actor_signature_is_stable_across_processes():
    code = ("import json, sys; sys.path.insert(0, '.');"
            "from stateright_tpu_torch.storage.persist import model_structure_signature;"
            "from stateright_tpu_torch.models.linearizable_register import AbdModelCfg;"
            "print(json.dumps(model_structure_signature(AbdModelCfg(2, 2).into_model())))")
    outs = []
    for seed in ("1", "2"):
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=REPO_DIR, env=dict(os.environ, PYTHONHASHSEED=seed))
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1] == json.loads(json.dumps(model_structure_signature(_abd())))
