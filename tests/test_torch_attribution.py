"""Wave-timeline attribution on the port
(``stateright_tpu_torch/telemetry/attribution.py``, the GPU checker's
``attribution=True``), held to the JAX package on the CPU: the classifier
driven by one fake-clock script on both packages gives equal ledgers
(exactly: the same float arithmetic); ``hashset_probe_length_counts``
equals the JAX function's on the same table (exactly); attributed runs
are bit-identical to unattributed ones and to the JAX checker's, on both
engines, wave at a time, through the drain and under a budget, with
ledgers whose phases sum to the wall within the default 5% tolerance;
the off path touches no clock, fence or span (a spy counts); and the
JAX package's trace readers (``scripts/gap_report.py``,
``trace_summary.py``, ``coverage_report.py``) render a port trace."""

import io
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops.hashset import hashset_insert_unsorted as jax_insert_unsorted
from stateright_tpu.ops.hashset import hashset_new as jax_hashset_new
from stateright_tpu.ops.hashset import hashset_probe_length_counts as jax_probe_length_counts
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu.telemetry.attribution import WaveAttribution as JaxWaveAttribution
from stateright_tpu.telemetry.metrics import MetricsRegistry as JaxMetricsRegistry
from stateright_tpu.telemetry.trace import Tracer as JaxTracer
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker import base
from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.interop import keys_from_numpy, table_from_numpy, table_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.hashset import hashset_new, hashset_probe_length_counts
from stateright_tpu_torch.ops.hashset_kernel import hashset_insert_sorted
from stateright_tpu_torch.telemetry import get_tracer
from stateright_tpu_torch.telemetry.attribution import WaveAttribution, parse_profile_device_busy
from stateright_tpu_torch.telemetry.metrics import MetricsRegistry
from stateright_tpu_torch.telemetry.trace import _NULL_SPAN, Tracer

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO_DIR, "scripts")

SPAWN = dict(device="cpu", frontier_capacity=64, table_capacity=4096)
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}
DEVICE_PHASE = {"staged": "device", "fused": "wave_kernel"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs here count into the JAX package's process-wide metrics
    registry, some of whose counters that package's own tests read
    exactly: leave the registry empty, as a fresh process has it."""
    yield
    jax_metrics_registry().reset()


# -- the classifier, one fake-clock script on both packages ----------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _both(script):
    """Runs ``script(attr, clock)`` on the port's engine and the JAX one,
    each with its own fake clock, tracer and registry; asserts equal
    ledgers and equal ``t.pipeline`` span args; returns the port's report,
    engine and tracer."""
    got = []
    for engine, tracer_cls, registry_cls in ((WaveAttribution, Tracer, MetricsRegistry),
                                             (JaxWaveAttribution, JaxTracer, JaxMetricsRegistry)):
        clk, tracer = FakeClock(), tracer_cls()
        attr = engine("t", clock=clk, tracer=tracer, registry=registry_cls())
        script(attr, clk)
        spans = [e["args"] for e in tracer.events() if e["name"] == "t.pipeline"]
        got.append((attr.report(), attr, tracer, spans))
    (port, attr, tracer, spans), (jax, _a, _t, jax_spans) = got
    assert port == jax
    assert spans == jax_spans
    return port, attr, tracer


def test_phases_sum_to_wall_with_residual_gap():
    def script(attr, clk):
        with attr.wave():
            with attr.phase("device"):
                clk.advance(2.0)
            with attr.phase("host_probe"):
                clk.advance(1.0)
            clk.advance(0.5)  # unclassified host work -> gap

    rep, _, _ = _both(script)
    assert rep["wall_s"] == pytest.approx(3.5)
    assert rep["phases_s"] == {"device": pytest.approx(2.0), "host_probe": pytest.approx(1.0)}
    assert rep["gap_s"] == pytest.approx(0.5)
    assert sum(rep["phases_s"].values()) + rep["gap_s"] == pytest.approx(rep["wall_s"])
    assert rep["within_tolerance"] and rep["overrun_s"] == 0.0
    assert rep["utilization"] == pytest.approx(2.0 / 3.5)


def test_compile_detection_and_evict_window_classified():
    def script(attr, clk):
        with attr.wave():
            with attr.phase("compile"):
                clk.advance(4.0)
            with attr.phase("wave_kernel"):
                clk.advance(1.0)
            with attr.phase("evict"):
                clk.advance(2.0)
            with attr.phase("checkpoint"):
                clk.advance(0.5)

    rep, _, _ = _both(script)
    assert rep["phases_s"]["compile"] == pytest.approx(4.0)
    assert rep["phases_s"]["evict"] == pytest.approx(2.0)
    oh = rep["overlap_headroom"]
    assert oh["host_overlappable_s"] == pytest.approx(2.5)
    assert oh["device_s"] == pytest.approx(1.0)
    assert oh["headroom_s"] == pytest.approx(1.0)
    assert oh["predicted_wall_s"] == pytest.approx(rep["wall_s"] - 1.0)


def test_nested_phase_records_nothing():
    def script(attr, clk):
        with attr.wave():
            with attr.phase("device"):
                with attr.phase("evict"):  # nested: ignored by design
                    clk.advance(1.0)
                clk.advance(1.0)

    rep, _, _ = _both(script)
    assert rep["phases_s"] == {"device": pytest.approx(2.0)}
    assert rep["gap_s"] == pytest.approx(0.0)


def test_phase_outside_wave_reported_separately():
    def script(attr, clk):
        with attr.phase("evict"):  # a restore's rebuild evicting
            clk.advance(3.0)
        with attr.wave():
            with attr.phase("device"):
                clk.advance(1.0)

    rep, _, _ = _both(script)
    assert "evict" not in rep["phases_s"]
    assert rep["outside_wave_s"] == {"evict": pytest.approx(3.0)}
    assert rep["wall_s"] == pytest.approx(1.0)
    assert rep["within_tolerance"]


def test_wave_kind_drain_counts_drains_and_span_args():
    def script(attr, clk):
        with attr.wave("drain"):
            with attr.phase("wave_kernel"):
                clk.advance(1.5)
            clk.advance(0.5)

    rep, _, tracer = _both(script)
    assert rep["drains"] == 1 and rep["waves"] == 0
    (ev,) = [e for e in tracer.events() if e["name"] == "t.pipeline"]
    assert ev["args"]["kind"] == "drain"
    assert ev["args"]["wall_ms"] == pytest.approx(2000.0)
    assert ev["args"]["wave_kernel_ms"] == pytest.approx(1500.0)
    assert ev["args"]["gap_ms"] == pytest.approx(500.0)


def test_observe_probe_lengths_feeds_histogram_and_ledger():
    def script(attr, clk):
        attr.observe_probe_lengths([10, 5, 0, 1, 0, 0])

    rep, attr, _ = _both(script)
    assert rep["probe_length_counts"] == [10, 5, 0, 1]
    hist = attr._registry.histogram("t.hashset.probe_length").snapshot()
    assert hist["count"] == 16 and hist["max"] == 3


def test_abort_closes_the_open_window_and_an_overrun_breaks_the_tolerance():
    def script(attr, clk):
        with attr.wave():
            with attr.phase("device"):
                clk.advance(1.0)
        w = attr.wave()
        w.__enter__()
        attr.phase("checkpoint").__enter__()
        clk.advance(2.0)
        attr.abort()  # the crash path: phase flushed, window closed
        attr.abort()  # idempotent

    rep, _, _ = _both(script)
    assert rep["waves"] == 2 and rep["phases_s"]["checkpoint"] == pytest.approx(2.0)
    assert rep["within_tolerance"]


def test_parse_profile_device_busy_unions_the_device_intervals(tmp_path):
    """Busy time is the union of the device intervals (kernels, copies,
    fills), as ``scripts/torch_profile.py`` counts it; host events and
    other categories are left out; no device interval gives None."""
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 20.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memset", "ts": 24.0, "dur": 6.0},
        {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 100.0},
    ]
    (tmp_path / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    split = parse_profile_device_busy(str(tmp_path))
    assert split == {"busy_s": pytest.approx(25e-6), "idle_s": pytest.approx(5e-6),
                     "span_s": pytest.approx(30e-6), "source": "torch.profiler"}
    host = tmp_path / "host"
    host.mkdir()
    (host / "b.pt.trace.json").write_text(json.dumps({"traceEvents": events[-1:]}))
    assert parse_profile_device_busy(str(host)) is None
    assert parse_profile_device_busy(str(tmp_path / "none")) is None


# -- probe lengths ----------------------------------------------------------------


def _sorted_keys(rng, n):
    k = np.unique(rng.integers(1, 1 << 64, n, dtype=np.uint64))
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("seed,n,capacity", [(0, 500, 1 << 11), (1, 1100, 1 << 11),
                                             (2, 9000, 1 << 14)])
def test_probe_length_counts_equal_jax_on_the_ports_table(seed, n, capacity):
    hi, lo = _sorted_keys(np.random.default_rng(seed), n)
    table, fresh, _found, pending = hashset_insert_sorted(
        hashset_new(capacity), *keys_from_numpy(hi, lo), torch.ones(hi.shape[0], dtype=torch.bool))
    assert not bool(pending.any())
    got = hashset_probe_length_counts(table)
    want = jax_probe_length_counts(table_to_numpy(table))
    assert got.dtype == np.int64 and got.shape == (129,)
    assert np.array_equal(got, want)
    assert got.sum() == int(fresh.sum())


@pytest.mark.parametrize("seed", [3, 4])
def test_probe_length_counts_equal_jax_on_the_jax_table(seed):
    rng = np.random.default_rng(seed)
    hi = rng.integers(1, 1 << 32, 700, dtype=np.uint32)
    lo = rng.integers(1, 1 << 32, 700, dtype=np.uint32)
    table, fresh, _found, pending = jax_insert_unsorted(
        jax_hashset_new(1 << 11), jnp.asarray(hi), jnp.asarray(lo), jnp.ones((700,), bool))
    assert not bool(pending.any())
    want = jax_probe_length_counts(np.asarray(table))
    got = hashset_probe_length_counts(table_from_numpy(np.asarray(table)))
    assert np.array_equal(got, want) and got.sum() == int(fresh.sum())


def test_probe_length_counts_after_a_growth_sum_to_the_resident_keys():
    """After a rehash the port's layout is its own (ROADMAP Queue 3): the
    counts cover every resident key."""
    c = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", wave_kernel="staged", frontier_capacity=64, table_capacity=2048,
        max_drain_waves=1, attribution=True).join()
    assert c.table_growths >= 1
    assert sum(c.attribution_report()["probe_length_counts"]) == c.unique_state_count() == 1568


# -- the checker, against itself unattributed and against the JAX checker --------


@pytest.fixture(scope="module")
def jax_runs():
    return {mode: JaxTwoPhaseSys(4).checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", frontier_capacity=64, table_capacity=4096,
        **opts).join() for mode, opts in MODES.items()}


def _golden(checker):
    out = io.StringIO()
    checker.report(WriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


def _same(got, want):
    for k in ("unique_state_count", "state_count", "max_depth"):
        assert getattr(got, k)() == getattr(want, k)(), k
    assert got._discoveries_fp == want._discoveries_fp


def _run_stats(c):
    return (c.waves, c.drains, c.table_growths, c.noop_waves, c.graph_captures,
            dict(c.rungs), dict(c.drain_exits), c.evictions, c.stale_lanes)


def _ledger_sums(rep):
    assert rep["within_tolerance"], rep
    assert sum(rep["phases_s"].values()) + rep["gap_s"] + rep["overrun_s"] == pytest.approx(
        rep["wall_s"], rel=1e-9)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ["staged", "fused"])
def test_attributed_run_is_bit_identical_and_its_ledger_sums(engine, mode, jax_runs):
    spawn = dict(SPAWN, wave_kernel=engine, **MODES[mode])
    off = TwoPhaseSys(4).checker().spawn_gpu_bfs(**spawn).join()
    on = TwoPhaseSys(4).checker().spawn_gpu_bfs(attribution=True, **spawn).join()
    for c in (off, on):
        assert c.worker_error() is None
        _same(c, jax_runs[mode])
    assert on.unique_state_count() == 1568
    assert _golden(on) == _golden(off)
    for name, path in off.discoveries().items():
        assert on.discoveries()[name].encode() == path.encode()
    assert _run_stats(on) == _run_stats(off)
    assert off.attribution is None and off.attribution_report() is None
    rep = on.attribution_report()
    jax_keys = set(JaxWaveAttribution("t", tracer=JaxTracer(),
                                      registry=JaxMetricsRegistry()).report())
    assert jax_keys <= set(rep)
    assert rep["prefix"] == "gpu_bfs"
    _ledger_sums(rep)
    assert rep["phases_s"][DEVICE_PHASE[engine]] > 0
    assert DEVICE_PHASE["fused" if engine == "staged" else "staged"] not in rep["phases_s"]
    assert rep["phase_windows"].get("compile", 0) == on.graph_captures == 0
    assert rep["phase_windows"].get("table_grow", 0) == on.table_growths
    assert rep["drains"] == on.drains
    assert (rep["waves"] > 0) == (mode == "wave") and (rep["drains"] > 0) == (mode == "drain")
    assert sum(rep["probe_length_counts"]) == on.unique_state_count()
    assert "outside_wave_s" not in rep


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ["staged", "fused"])
def test_budgeted_run_attributes_evictions_and_the_host_probe(engine, mode):
    """At the smallest admissible budget the run evicts (in a wave window,
    or in a drain window closed before the handoff) and probes the host
    runs: an ``evict`` window for each eviction, ``host_probe`` windows
    whose total agrees with ``host_probe_s`` (the two time the same work:
    within 5% and 1 ms), and results equal to the unattributed run's."""
    F = 16
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), F)
    spawn = dict(SPAWN, wave_kernel=engine, frontier_capacity=F, hbm_budget_mib=budget,
                 **MODES[mode])
    off = TwoPhaseSys(4).checker().spawn_gpu_bfs(**spawn).join()
    on = TwoPhaseSys(4).checker().spawn_gpu_bfs(attribution=True, **spawn).join()
    assert on.worker_error() is None and on.unique_state_count() == 1568
    _same(on, off)
    assert _golden(on) == _golden(off)
    assert _run_stats(on) == _run_stats(off)
    rep = on.attribution_report()
    _ledger_sums(rep)
    assert rep["phase_windows"]["evict"] == on.evictions >= 1
    assert rep["phase_windows"]["host_probe"] >= 1
    probe = rep["phases_s"]["host_probe"]
    assert abs(probe - on.host_probe_s) <= 0.05 * on.host_probe_s + 1e-3
    assert rep["drains"] == on.drains
    assert sum(rep["probe_length_counts"]) == on._l0_count


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoint_windows_and_the_restore_outside_the_waves(mode, tmp_path):
    """A checkpointed run has a ``checkpoint`` window for each checkpoint
    written; a run resumed under the smallest budget rebuilds its table
    (evicting) before its first window, so that work is in
    ``outside_wave_s`` and the windows still sum to the wall."""
    path = str(tmp_path / "run.ckpt")
    spawn = dict(SPAWN, wave_kernel="fused", **MODES[mode])
    first = TwoPhaseSys(5).checker().target_state_count(35000).spawn_gpu_bfs(
        checkpoint_path=path, checkpoint_every_chunks=4, attribution=True,
        **dict(spawn, max_drain_waves=1)).join()
    rep = first.attribution_report()
    _ledger_sums(rep)
    assert rep["phase_windows"]["checkpoint"] == first.checkpoints_written >= 1
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(5), SPAWN["frontier_capacity"])
    resumed = TwoPhaseSys(5).checker().spawn_gpu_bfs(
        resume_from=path, hbm_budget_mib=budget, attribution=True, **spawn).join()
    assert resumed.worker_error() is None and resumed.unique_state_count() == 8832
    assert resumed.restore_inserts >= 2
    rep = resumed.attribution_report()
    _ledger_sums(rep)
    assert rep["outside_wave_s"].get("evict", 0) > 0
    assert rep["phase_windows"].get("evict", 0) + 1 <= resumed.evictions


# -- the off path ------------------------------------------------------------------


def test_attribution_off_reads_no_clock_and_fences_nothing(monkeypatch):
    """With attribution off no engine is built and every hook is the shared
    null context: a spy on the engine's methods counts nothing over runs
    on both engines, wave at a time, drained and under a budget, where the
    same spy counts every fence, phase, window and clock read of an
    attributed run."""
    calls = Counter()
    for name in ("__init__", "fence", "phase", "wave", "overlapped", "observe_probe_lengths",
                 "report", "abort"):
        orig = getattr(WaveAttribution, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(WaveAttribution, name, spy)
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
    runs = [dict(wave_kernel=e, **MODES[m]) for e in ("staged", "fused") for m in MODES]
    runs.append(dict(wave_kernel="fused", frontier_capacity=16, hbm_budget_mib=budget))
    for extra in runs:
        c = TwoPhaseSys(4).checker().spawn_gpu_bfs(**dict(SPAWN, **extra)).join()
        assert c.unique_state_count() == 1568 and c.attribution_report() is None
        assert c._phase("host_probe") is base._NULL_CTX
        assert c._wave_window("drain") is base._NULL_CTX
        assert c._phase_overlapped("checkpoint") is base._NULL_CTX
        assert c._span("gpu_bfs.wave") is _NULL_SPAN
    assert sum(calls.values()) == 0, calls
    # The host engines have no device/host boundary to attribute.
    assert TwoPhaseSys(3).checker().spawn_bfs().join().attribution_report() is None

    reads = Counter()

    def clock():
        reads["clock"] += 1
        return time.perf_counter()

    for extra in runs[1:2] + runs[-1:]:
        attr = WaveAttribution("gpu_bfs", clock=clock, tracer=Tracer(), registry=MetricsRegistry())
        c = TwoPhaseSys(4).checker().spawn_gpu_bfs(attribution=attr, **dict(SPAWN, **extra))
        c.join()
        assert c.attribution is attr
    assert calls["fence"] and calls["phase"] and calls["wave"] and reads["clock"]


def test_profile_window_exports_a_trace_and_finds_no_device_on_the_cpu(tmp_path):
    """An engine built with ``profile_dir`` runs ``torch.profiler`` over its
    first windows and exports a Chrome trace there; on the CPU it holds no
    device interval, so ``device_split`` stays None."""
    attr = WaveAttribution("gpu_bfs", profile_dir=str(tmp_path), profile_waves=2,
                           tracer=Tracer(), registry=MetricsRegistry())
    c = TwoPhaseSys(3).checker().spawn_gpu_bfs(
        attribution=attr, **dict(SPAWN, wave_kernel="fused", max_drain_waves=1)).join()
    assert c.unique_state_count() == 288
    assert attr._profile_state == "done" and list(tmp_path.glob("*.json"))
    rep = c.attribution_report()
    assert rep["device_split"] is None and rep["waves"] > 2
    _ledger_sums(rep)


# -- the trace readers on a port trace ----------------------------------------------


def _port_trace(tmp_path, model, **spawn):
    path = tmp_path / "trace.jsonl"
    tracer = get_tracer()
    sink = tracer.add_sink(str(path))
    try:
        c = model.checker().spawn_gpu_bfs(**dict(SPAWN, **spawn)).join()
    finally:
        tracer.remove_sink(sink)
    assert c.worker_error() is None
    return c, str(path)


def _script(name, *args):
    return subprocess.run([sys.executable, os.path.join(SCRIPTS, name), *args],
                          capture_output=True, text=True, timeout=120)


def test_gap_report_ledger_of_a_port_trace(tmp_path):
    c, path = _port_trace(tmp_path, TwoPhaseSys(4), wave_kernel="fused", attribution=True)
    rep = c.attribution_report()
    r = _script("gap_report.py", path)
    assert r.returncode == 0, r.stderr
    assert f"phase ledger: gpu_bfs ({rep['drains']} waves" in r.stdout
    assert "overlap headroom:" in r.stdout and "predicted wall under" in r.stdout
    r = _script("gap_report.py", path, "--json")
    assert r.returncode == 0, r.stderr
    led = json.loads(r.stdout)["gpu_bfs"]
    assert led["waves"] == rep["waves"] + rep["drains"]
    assert led["wall_ms"] == pytest.approx(rep["wall_s"] * 1e3, rel=1e-6)
    for phase, s in rep["phases_s"].items():
        assert led["phases_ms"][phase] == pytest.approx(s * 1e3, rel=1e-6)
    assert led["phases_ms"]["gap"] == pytest.approx(rep["gap_s"] * 1e3, rel=1e-6, abs=1e-9)


def test_gap_report_exits_nonzero_on_an_unattributed_port_trace(tmp_path):
    _c, path = _port_trace(tmp_path, TwoPhaseSys(3), coverage=True)
    r = _script("gap_report.py", path)
    assert r.returncode == 1
    assert "attribution" in r.stderr


def test_trace_summary_attribution_table_of_a_port_trace(tmp_path):
    c, path = _port_trace(tmp_path, TwoPhaseSys(4), wave_kernel="staged", max_drain_waves=1,
                          attribution=True)
    r = _script("trace_summary.py", path)
    assert r.returncode == 0, r.stderr
    assert "attribution (per-phase ms share of wave wall):" in r.stdout
    assert "gpu_bfs.pipeline" in r.stdout and "device=" in r.stdout
    # One row a wave from the gpu_bfs.wave spans' counts.
    assert r.stdout.count("gpu_bfs.wave") == c.attribution_report()["waves"]


def test_coverage_report_renders_a_port_run(tmp_path):
    c, path = _port_trace(tmp_path, TwoPhaseSys(3), coverage=True)
    r = _script("coverage_report.py", path, "--json", "--no-gate")
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)["gpu_bfs"]
    want = c.coverage_report()
    assert rep["unique"] == want["unique"] == 288
    assert rep["actions"] == json.loads(json.dumps(want["actions"]))
    r = _script("coverage_report.py", path)
    assert "gpu_bfs" in r.stdout


# -- the port stands alone ------------------------------------------------------------


# Modules the walk above must have imported: the device walkers', and the
# sharded checker's, its mesh's and the comm sieve's.
WALK_MODULES = (
    "stateright_tpu_torch.ops.threefry",
    "stateright_tpu_torch.checker.gpu_simulation",
    "stateright_tpu_torch.checker.swarm",
    "stateright_tpu_torch.parallel.base_mesh",
    "stateright_tpu_torch.parallel.sharded",
    "stateright_tpu_torch.ops.comm_sieve",
)


def test_no_module_of_the_port_nor_chip_smoke_imports_jax():
    """Every module of ``stateright_tpu_torch`` and ``chip_smoke.py``
    imported in a fresh process leave JAX and the JAX package out."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO_DIR!r})\n"
        "import stateright_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'stateright_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'stateright_tpu'))\n"
        f"missing = sorted(set({WALK_MODULES!r}) - set(sys.modules))\n"
        "print(len(sys.modules), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu():
    from stateright_tpu_torch.checker.breakdown import measure_pipeline_choice
    from stateright_tpu_torch.checker.gpu import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for call in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 lambda: TwoPhaseSys(3).checker().spawn_gpu_bfs(attribution=True),
                 lambda: measure_pipeline_choice(_paxos22())):
        with pytest.raises(RuntimeError):
            call()


def _paxos22():
    from stateright_tpu_torch.models.paxos import PaxosModelCfg

    return PaxosModelCfg(2, 2).into_model()
