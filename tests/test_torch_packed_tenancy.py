"""Tenant packing in the port (``checker/packed_tenancy.py``) against the JAX
package, on the CPU.

Each scenario runs the JAX ``TenantPackedEngine`` and the port's
(``device="cpu"``) through the same admissions, steps and drops, on 2pc-3
and 2pc-4 at the JAX suite's settings (frontier 16, table 2^12, four
slots). Every packed tenant of the port equals the JAX pack's tenant and
the JAX solo run under ``wave_dedup="scatter"`` in unique and total counts,
depth, discoveries and golden report (``sec=`` masked, so paths and
fingerprints are compared), and equals the port's own ``spawn_gpu_bfs`` in
counts, depth and discovery names (that run compacts in key order). The
scenarios: a pair, a mid-run join, a lane drop resumed into a later pack
and into ``spawn_gpu_bfs``, the async pipeline, a budget with per-tenant
partitions in both pipeline modes, and an admission that restores under
budget pressure. Also the salts and the salted insert bit for bit, a
``spawn_gpu_bfs`` preempt payload admitted into a pack, per-tenant device
liveness, a tenant-attributed fault, the run-scoped registries and tracer,
the instruments' names, a forced growth retry, and the imports. Everything
compared is an integer or a string: the tolerance is 0.
"""

import io
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.checker.packed_tenancy import TenantPackedEngine as JaxEngine
from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops import fingerprint as jax_fp
from stateright_tpu.ops.hashset import hashset_insert_salted as jax_insert_salted
from stateright_tpu.ops.hashset import hashset_new as jax_hashset_new
from stateright_tpu import WriteReporter as JaxWriteReporter
from stateright_tpu.telemetry import discard_run_registry as jax_discard_run_registry
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu.telemetry import run_registries as jax_run_registries
from stateright_tpu.utils import faults as jax_faults
from stateright_tpu_torch import WriteReporter, interop
from stateright_tpu_torch.checker import TenantPackedEngine, TenantRun
from stateright_tpu_torch.checker import packed_tenancy
from stateright_tpu_torch.checker.gpu import GpuBfsChecker, min_admissible_hbm_budget_mib
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import fingerprint as port_fp
from stateright_tpu_torch.ops.hashset import hashset_new
from stateright_tpu_torch.ops.hashset_kernel import hashset_insert_salted
from stateright_tpu_torch.telemetry import (
    RunScopedTracer,
    Tracer,
    discard_run_registry,
    get_tracer,
    metrics_registry,
    run_registries,
)
from stateright_tpu_torch.utils import faults as port_faults

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(frontier_capacity=16, table_capacity=1 << 12, max_tenants=4)
SPAWN = dict(frontier_capacity=16, table_capacity=1 << 12)
UNIQUE = {3: 288, 4: 1568}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs count into the JAX package's process-wide registry,
    some of whose counters that package's own tests read exactly: leave it
    empty, as a fresh process has it, and drop the run registries this
    file made in both packages (every run id here starts ``tpk-``)."""
    yield
    jax_metrics_registry().reset()
    for run_id in jax_run_registries():
        if run_id.startswith("tpk-"):
            jax_discard_run_registry(run_id)
    for run_id in run_registries():
        if run_id.startswith("tpk-"):
            discard_run_registry(run_id)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """A packed wave at this size is many small torch operations, which the
    intra-op thread pool only slows down on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(checker):
    out = io.StringIO()
    reporter = JaxWriteReporter if type(checker).__module__.startswith("stateright_tpu.") \
        else WriteReporter
    checker.report(reporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


def _summary(ck):
    return (ck.unique_state_count(), ck.state_count(), ck.max_depth(),
            sorted(ck.discoveries()))


# -- the two packages, one script ------------------------------------------


class _Side:
    """One package's engine, model and solo checker, so a scenario runs the
    same script on both."""

    def __init__(self, port: bool):
        self.port = port
        self.Engine = TenantPackedEngine if port else JaxEngine
        self.TenantFaultError = (port_faults if port else jax_faults).TenantFaultError
        self.faults = port_faults if port else jax_faults

    def model(self, n):
        return TwoPhaseSys(n) if self.port else JaxTwoPhaseSys(n)

    def engine(self, n, **kw):
        extra = dict(device="cpu") if self.port else dict(aot_cache=f"tpk-{n}-{sorted(kw)}")
        return self.Engine(self.model(n), **ENGINE_KW, **kw, **extra)

    def budget(self, n):
        # The port's smallest admissible budget on both sides: the port's
        # table is at least one 2,048-row tile.
        return min_admissible_hbm_budget_mib(TwoPhaseSys(n), 16)

    def solo(self, n, **kw):
        b = self.model(n).checker()
        if self.port:
            return b.spawn_gpu_bfs(device="cpu", **SPAWN, **kw).join()
        return b.spawn_tpu_bfs(wave_dedup="scatter", **SPAWN, **kw).join()


PORT, JAX = _Side(True), _Side(False)


def _drive(engine, views=None, max_steps=20_000):
    """Steps the engine until no tenant is live; returns the finished
    tenants' views by key (slots released as they finish)."""
    views = {} if views is None else views
    steps = 0
    while engine.live_count():
        for key in engine.step():
            views[key] = engine.view(key)
            engine.release(key)
        steps += 1
        assert steps < max_steps, "packed engine did not converge"
    return views


def _run_scenario(side, name, n):
    """The scenario's results, ``{tenant: checker}``, and its engines."""
    if name in ("pair", "async", "budget", "budget_async"):
        kw = {}
        if name in ("async", "budget_async"):
            kw["async_pipeline"] = True
        if name.startswith("budget"):
            kw["hbm_budget_mib"] = side.budget(n)
        eng = side.engine(n, **kw)
        views = {k: eng.admit(k, f"tpk-{name}-{n}-{k}") for k in ("a", "b")}
        _drive(eng)
        eng.close()
        return views, [eng]
    if name == "join":
        eng = side.engine(n)
        views = {"early": eng.admit("early", f"tpk-j-{n}-e")}
        for _ in range(5):
            eng.step()
        views["late"] = eng.admit("late", f"tpk-j-{n}-l")
        _drive(eng)
        eng.close()
        return views, [eng]
    if name == "drop_later_pack":
        eng = side.engine(n)
        eng.admit("victim", f"tpk-d-{n}-v1")
        views = {"peer": eng.admit("peer", f"tpk-d-{n}-p")}
        for _ in range(6):
            eng.step()
        payload = eng.drop("victim")
        assert payload is not None and eng.view("victim") is None
        assert payload["kind"] == ("gpu_bfs" if side.port else "tpu_bfs")
        assert eng.free_slots() == 3
        _drive(eng)
        eng.close()
        later = side.engine(n)
        views["victim"] = later.admit("victim", f"tpk-d-{n}-v2", resume_from=payload)
        views["fresh"] = later.admit("fresh", f"tpk-d-{n}-f")
        _drive(later)
        later.close()
        return views, [eng, later]
    if name == "drop_to_solo":
        eng = side.engine(n)
        eng.admit("solo-bound", f"tpk-s-{n}")
        for _ in range(4):
            eng.step()
        payload = eng.drop("solo-bound")
        eng.close()
        return {"solo-bound": side.solo(n, resume_from=payload)}, [eng]
    raise ValueError(name)


SCENARIOS = ["pair", "join", "drop_later_pack", "drop_to_solo", "async"]
# Budgets bind at 2pc-4: the port's table is at least one 2,048-row tile,
# which 2pc-3's pair never fills past the load cap.
CASES = [(s, n) for s in SCENARIOS for n in (3, 4)] + [("budget", 4), ("budget_async", 4)]

_SOLO = {}


def _solo(side, n):
    key = (side.port, n)
    if key not in _SOLO:
        _SOLO[key] = side.solo(n)
    return _SOLO[key]


@pytest.mark.parametrize("name,n", CASES, ids=[f"{s}-2pc{n}" for s, n in CASES])
def test_packed_tenants_equal_the_jax_pack(name, n):
    port, _ = _run_scenario(PORT, name, n)
    jax, _ = _run_scenario(JAX, name, n)
    assert sorted(port) == sorted(jax)
    jax_solo, port_solo = _solo(JAX, n), _solo(PORT, n)
    for key, got in port.items():
        want = jax[key]
        assert got.unique_state_count() == UNIQUE[n], (name, key)
        assert _summary(got) == _summary(want), (name, key)
        assert _summary(got) == _summary(port_solo), (name, key)
        if isinstance(got, TenantRun):
            # A packed tenant: paths and fingerprints too, against the JAX
            # pack and the JAX solo run under scatter dedup.
            assert _golden(got) == _golden(want) == _golden(jax_solo), (name, key)
    if name.startswith("budget"):
        for key in port:
            snap = metrics_registry(f"tpk-{name}-{n}-{key}").snapshot()
            assert snap.get("pack.tenant.storage_stale", 0) > 0, (
                "the budget never bound (no per-tenant host probes happened)")
            if name == "budget":
                # With the async pipeline the count depends, in both
                # packages, on how many lanes the worker has pushed when a
                # wave is taken: only the synchronous count is the JAX one.
                assert snap["pack.tenant.storage_stale"] == jax_metrics_registry(
                    f"tpk-{name}-{n}-{key}").snapshot()["pack.tenant.storage_stale"]


def test_resume_admission_under_budget_pressure():
    """A payload restored under the smallest budget: the tenant is
    registered before its restore runs (so an eviction its own claims set
    off drains its keys into its partition), it finishes as the JAX pack's
    tenant does, and a failed admission leaves no ghost."""
    results = {}
    for side in (PORT, JAX):
        donor = side.engine(4)
        donor.admit("big", "tpk-big")
        steps = 0
        while donor.view("big").unique_state_count() < 1_200:
            donor.step()
            steps += 1
            assert steps < 20_000
        payload = donor.drop("big")
        donor.close()
        assert len(payload["children"]) >= 1_200
        tight = side.engine(4, hbm_budget_mib=side.budget(4))
        orig, seen = tight._restore_tenant, {}

        def spy(t, pl, tight=tight, orig=orig, seen=seen):
            seen["registered"] = tight._by_key.get("big") is t
            return orig(t, pl)

        tight._restore_tenant = spy
        resumed = tight.admit("big", "tpk-big2", resume_from=payload)
        assert seen["registered"] is True
        _drive(tight)
        tight.close()
        results[side.port] = resumed

        bad = dict(payload, fp_scheme="not-a-scheme")
        eng = side.engine(4)
        with pytest.raises(ValueError, match="fingerprint scheme"):
            eng.admit("ghost", "tpk-ghost", resume_from=bad)
        assert eng.view("ghost") is None and eng.free_slots() == 4
        eng.close()
    got, want = results[True], results[False]
    assert got.unique_state_count() == UNIQUE[4]
    assert _summary(got) == _summary(want)
    assert _golden(got) == _golden(want) == _golden(_solo(JAX, 4))


class _PreemptAfterDrain(GpuBfsChecker):
    """Requests the preempt from the worker once its ``n``-th drain is
    done; the run stops at the next drain boundary."""

    def __init__(self, *a, after, **kw):
        self._after = after
        super().__init__(*a, **kw)

    def _deep_drain(self, *a):
        out = super()._deep_drain(*a)
        if self.drains == self._after:
            self.request_preempt()
        return out


def test_solo_preempt_payload_admits_into_a_pack():
    """A ``spawn_gpu_bfs`` preempt payload admitted into a pack finishes as
    the uninterrupted solo run: counts, depth, discovery names."""
    checker = _PreemptAfterDrain(TwoPhaseSys(4).checker(), after=2, device="cpu",
                                 max_drain_waves=2, **SPAWN)
    for h in checker.handles():
        h.join()
    assert checker.worker_error() is None and checker.preempted
    payload = checker.preempt_payload()
    assert payload["kind"] == "gpu_bfs" and payload["unique_count"] < UNIQUE[4]
    eng = PORT.engine(4)
    view = eng.admit("resumed", "tpk-xr", resume_from=payload)
    peer = eng.admit("peer", "tpk-xr-peer")
    _drive(eng)
    eng.close()
    assert _summary(view) == _summary(_solo(PORT, 4))
    assert _golden(peer) == _golden(_solo(JAX, 4))
    for path in view.discoveries().values():
        assert path.into_states()  # replayed on the model


def test_dropped_tenant_payload_is_the_solo_format():
    """A drop's payload is a ``"gpu_bfs"`` checkpoint of live lanes, chunks
    of at most ``frontier_capacity``, as ``spawn_gpu_bfs`` writes them; a
    JAX payload is refused."""
    eng = PORT.engine(4)
    eng.admit("x", "tpk-fmt")
    for _ in range(8):
        eng.step()
    payload = eng.drop("x")
    eng.close()
    assert payload["version"] == 2 and payload["kind"] == "gpu_bfs"
    assert all("mask" not in c and 0 < len(c["hi"]) <= 16 for c in payload["chunks"])
    jax_eng = JAX.engine(4)
    jax_eng.admit("x", "tpk-fmt-jax")
    jax_eng.step()
    jax_payload = jax_eng.drop("x")
    jax_eng.close()
    with pytest.raises(ValueError, match="checkpoint kind"):
        PORT.engine(4).admit("y", resume_from=jax_payload)


# -- the salts and the salted insert -----------------------------------------


def test_salts_equal_jax():
    assert [port_fp.tenant_salt_pair(e) for e in range(200)] == [
        jax_fp.tenant_salt_pair(e) for e in range(200)]
    rng = np.random.default_rng(24)
    n = 4096
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    shi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    slo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    # Keys that salt onto the sentinels: the empty slot and the invalid lane.
    hi[:8], lo[:8] = shi[:8], slo[:8]
    hi[8:16], lo[8:16] = ~shi[8:16], ~slo[8:16]
    want = jax_fp.salt_keys(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(shi),
                            jnp.asarray(slo))
    t = [torch.from_numpy(x.astype(np.int64)) for x in (hi, lo, shi, slo)]
    got = port_fp.salt_keys(*t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert (got[1][:8] == 1).all() and (got[1][8:16] == 0xFFFFFFFE).all()


def test_salted_insert_equals_jax():
    """Two tenants' keys, with duplicates within and across, into one table
    twice: the same flags lane for lane and the same key set as JAX's."""
    rng = np.random.default_rng(7)
    B, cap = 3000, 1 << 12
    base = rng.integers(1, 1 << 32, (600, 2), dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, 600, B)
    hi, lo = base[pick, 0], base[pick, 1]
    tenant = rng.integers(0, 2, B)
    salts = [port_fp.tenant_salt_pair(e) for e in (1, 2)]
    shi = np.array([salts[t][0] for t in tenant], np.uint32)
    slo = np.array([salts[t][1] for t in tenant], np.uint32)
    active = rng.random(B) < 0.8
    jt = jax_hashset_new(cap)
    pt = hashset_new(cap)
    for rnd in range(2):
        sel = slice(0, B // 2) if rnd == 0 else slice(None)
        args = [x[sel] for x in (hi, lo, shi, slo)]
        act = active[sel]
        jt, *jflags = jax_insert_salted(jt, *map(jnp.asarray, args), jnp.asarray(act))
        pt, *pflags = hashset_insert_salted(
            pt, *(torch.from_numpy(x.astype(np.int64)) for x in args), torch.from_numpy(act))
        for g, w in zip(pflags, jflags):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        rows_j = np.asarray(jt)
        rows_p = interop.table_to_numpy(pt)

        def keys(rows):
            live = (rows[:, 0] != 0) | (rows[:, 1] != 0)
            return sorted(map(tuple, rows[live].tolist()))

        assert keys(rows_p) == keys(rows_j)
    assert np.asarray(jflags[0]).sum() > 0 and np.asarray(jflags[1]).sum() > 0


# -- liveness, faults, registries, instruments, growth -------------------------


def test_per_tenant_device_liveness_equals_solo_and_jax():
    import torch_host_fixtures as tf
    from test_device_liveness import PackedDGraph as JaxPackedDGraph

    kw = dict(frontier_capacity=16, table_capacity=1 << 10, max_tenants=4, liveness="device")
    results = {}
    for port, make, extra in ((True, lambda: tf.PackedDGraph([0, 2, 4, 2]), {"device": "cpu"}),
                              (False, lambda: JaxPackedDGraph([0, 2, 4, 2]), {})):
        eng = (TenantPackedEngine if port else JaxEngine)(make(), **kw, **extra)
        views = {k: eng.admit(k, f"tpk-live-{k}") for k in ("a", "b", "c")}
        done = set()
        for _ in range(200):
            done |= set(eng.step())
            if done >= set(views):
                break
        eng.close()
        assert done >= set(views)
        results[port] = views
        if port:
            assert any("rounded 1024 -> 2048" in n for n in eng.config_notes)
    solo = tf.PackedDGraph([0, 2, 4, 2]).checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=16, table_capacity=1 << 11, liveness="device",
        max_drain_waves=1).join()

    def states(ck):
        return {k: p.into_states() for k, p in ck.discoveries().items()}

    def verdicts(ck):
        return {k: r["verdict"] for k, r in ck.liveness_report()["outcomes"].items()}

    for key, view in results[True].items():
        jax_view = results[False][key]
        assert view.liveness_mode == "device"
        assert states(view) == states(solo) == states(jax_view)
        assert verdicts(view) == verdicts(solo) == verdicts(jax_view) == {"odd": "counterexample"}
        # The same relation; the pack absorbs a tenant's rows every wave,
        # the solo run when its device log fills, so only the absorb
        # counts differ.
        def relation(ck):
            return {k: v for k, v in ck._live_store.stats().items()
                    if k not in ("evictions", "chunks")}

        assert relation(view) == relation(solo)
        np.testing.assert_array_equal(view._live_store.edge_rows(), solo._live_store.edge_rows())


def test_tenant_fault_drops_only_that_tenant():
    """A ``pack.tenant.verdict`` fault for one tenant: only it is flagged
    and rolled back, its payload resumes solo to the full count, and its
    peer finishes as the solo run, as the JAX engine does on the same
    spec (the two payloads hold the same counts and keys)."""
    out = {}
    for side in (PORT, JAX):
        f = side.faults
        with f.inject(f.FaultSpec("pack.tenant.verdict", tenant="f-b", at=0)) as inj:
            eng = side.engine(3)
            peer = eng.admit("f-a", "tpk-f-a")
            eng.admit("f-b", "tpk-f-b")
            payload = None
            while eng.live_count():
                try:
                    for key in eng.step():
                        eng.release(key)
                except side.TenantFaultError as e:
                    assert e.tenant_key == "f-b" and eng.faulted_keys() == ["f-b"]
                    assert isinstance(eng.fault_error("f-b"), f.PackTenantFault)
                    payload = eng.drop("f-b")
            eng.close()
        assert inj.triggered() == 1 and payload is not None
        resumed = side.solo(3, resume_from=payload)
        assert resumed.unique_state_count() == UNIQUE[3]
        assert _golden(peer) == _golden(_solo(JAX, 3))
        out[side.port] = payload
    got, want = out[True], out[False]
    for k in ("state_count", "unique_count", "max_depth", "discoveries"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(np.sort(got["children"]), np.sort(want["children"]))
    assert sum(len(c["hi"]) for c in got["chunks"]) == sum(
        int(np.asarray(c["mask"]).sum()) for c in want["chunks"])


def test_run_registries_and_tracer_are_run_scoped():
    default = metrics_registry()
    reg = metrics_registry("tpk-reg-a")
    assert reg is metrics_registry("tpk-reg-a") and reg is not default
    assert metrics_registry("tpk-reg-b") is not reg
    assert run_registries()["tpk-reg-a"] is reg
    reg.counter("x").inc()
    assert "x" not in default.snapshot()
    discard_run_registry("tpk-reg-a")
    discard_run_registry("tpk-reg-a")  # absent: nothing happens
    assert "tpk-reg-a" not in run_registries()
    assert metrics_registry("tpk-reg-a").snapshot() == {}
    discard_run_registry("tpk-reg-a")
    discard_run_registry("tpk-reg-b")

    tracer = get_tracer()
    assert isinstance(tracer, Tracer) and tracer is get_tracer()
    scoped = get_tracer("tpk-trace")
    assert isinstance(scoped, RunScopedTracer)
    with scoped.span("tpk.span", k=1):
        pass
    scoped.instant("tpk.instant")
    tracer.instant("tpk.plain")
    events = {e["name"]: e for e in tracer.events()[-3:]}
    assert events["tpk.span"]["args"] == {"k": 1, "run_id": "tpk-trace"}
    assert events["tpk.instant"]["args"]["run_id"] == "tpk-trace"
    assert "run_id" not in events["tpk.plain"].get("args", {})

    eng = PORT.engine(3)
    view = eng.admit("r", "tpk-reg-view")
    assert view.metrics() is metrics_registry("tpk-reg-view")
    anon = eng.admit("anon")
    assert anon.metrics() is default
    eng.close()
    discard_run_registry("tpk-reg-view")


def test_instrument_names_equal_jax():
    """After the same budgeted run, the engine's registry and a tenant's
    hold the same ``pack.*`` and ``pack.tenant.*`` names in both packages."""
    names = {}
    for side in (PORT, JAX):
        reg_of = metrics_registry if side.port else jax_metrics_registry
        run = f"tpk-inst-{side.port}"
        eng = side.engine(4, hbm_budget_mib=side.budget(4), run_id=f"{run}-e")
        eng.admit("a", f"{run}-a")
        eng.admit("b", f"{run}-b")
        _drive(eng)
        eng.close()
        names[side.port] = [
            sorted(n for n in reg_of(r).snapshot() if n.startswith("pack."))
            for r in (f"{run}-e", f"{run}-a")]
        for r in (f"{run}-e", f"{run}-a", f"{run}-b"):
            (discard_run_registry if side.port else jax_discard_run_registry)(r)
    assert names[True] == names[False]
    engine_names, tenant_names = names[True]
    assert "pack.lanes_live" in engine_names and "pack.waves" in engine_names
    assert "pack.tenant.storage_stale" in tenant_names


def test_forced_growth_retry_keeps_the_counts(monkeypatch):
    """A wave whose claims overflow (half its lanes left pending, as a full
    probe window leaves them) grows the table and runs again; each
    attempt's fresh lanes are verdicted apart and the counts stay the solo
    run's."""
    real = packed_tenancy.hashset_insert_salted
    calls = {"n": 0}

    def overflowing(table, hi, lo, salt_hi, salt_lo, active):
        calls["n"] += 1
        if calls["n"] not in (12, 30):
            return real(table, hi, lo, salt_hi, salt_lo, active)
        first = active & (torch.cumsum(active.to(torch.int64), 0) <= int(active.sum()) // 2)
        table, fresh, found, pending = real(table, hi, lo, salt_hi, salt_lo, first)
        return table, fresh, found, pending | (active & ~first)

    monkeypatch.setattr(packed_tenancy, "hashset_insert_salted", overflowing)
    eng = PORT.engine(4)
    views = {k: eng.admit(k, f"tpk-grow-{k}") for k in ("a", "b")}
    _drive(eng)
    eng.close()
    assert eng.table_growths >= 2
    for view in views.values():
        assert _summary(view) == _summary(_solo(PORT, 4))


def test_engine_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantPackedEngine(TwoPhaseSys(3))
    with pytest.raises(TypeError, match="BatchableModel"):
        TenantPackedEngine(object(), device="cpu")
    assert TenantPackedEngine(TwoPhaseSys(3), device="cpu").device.type == "cpu"


def test_packed_tenancy_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO_DIR!r})\n"
        "import stateright_tpu_torch.checker.packed_tenancy\n"
        "import stateright_tpu_torch.checker.pipeline\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'stateright_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.slow
def test_packed_abd_equals_jax():
    """ABD (an actor model with the fingerprint-only expansion, which the
    pack does not take): two packed tenants equal the JAX pack's and the
    JAX solo materializing run."""
    solo = JaxAbdModelCfg(2, 2).into_model().checker().spawn_tpu_bfs(
        frontier_capacity=8, table_capacity=1 << 12, expand_fps=False,
        wave_dedup="scatter").join()
    res = {}
    for port in (True, False):
        model = (AbdModelCfg if port else JaxAbdModelCfg)(2, 2).into_model()
        extra = {"device": "cpu"} if port else {"aot_cache": "tpk-abd"}
        eng = (TenantPackedEngine if port else JaxEngine)(
            model, frontier_capacity=8, table_capacity=1 << 12, max_tenants=2, **extra)
        res[port] = {k: eng.admit(k, f"tpk-abd-{port}-{k}") for k in ("a", "b")}
        _drive(eng, max_steps=200_000)
        eng.close()
    for key, got in res[True].items():
        assert _summary(got) == _summary(res[False][key]) == _summary(solo)
        assert _golden(got) == _golden(res[False][key]) == _golden(solo)
