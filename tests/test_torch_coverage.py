"""The port's coverage (``stateright_tpu_torch/telemetry/coverage.py``) against
the JAX package's (``stateright_tpu/telemetry/coverage.py``).

The ledger's units (sanitization, vacuity, near-miss depth, revisits, the
summary instant) as the JAX package's own tests hold them; the torch
``DeviceCoverage.wave_reduce`` against the JAX one on random seeded inputs
(A = 1 and depths past 63 included); single waves of the port's staged
wave (``torch_wave``) and of ``coverage_stage``'s CPU twin (the plain
twin of the CUDA stage ``fw_coverage``) against the JAX Pallas
``fused_wave`` with a coverage layout, in interpret mode, on the same
frontiers (masked and depth-capped lanes included); and whole runs, whose
``coverage_report()`` must equal the JAX package's on every field but
``prefix`` (``spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort",
coverage=True)`` against ``spawn_gpu_bfs(device="cpu", coverage=True)``,
both engines, wave at a time and drained). Coverage off must leave runs
bit-identical and run no antecedent and no coverage stage. Everything
compared is an integer count: the tolerance is 0.
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu import Model as JaxModel
from stateright_tpu import Property as JaxProperty
from stateright_tpu.core.batch import BatchableModel as JaxBatchableModel
from stateright_tpu.models.sharded_kv import ShardedKv as JaxShardedKv
from stateright_tpu.models.single_copy_register import (
    SingleCopyModelCfg as JaxSingleCopyModelCfg,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops.pallas_wave import fused_wave as jax_fused_wave
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu.telemetry.coverage import DeviceCoverage as JaxDeviceCoverage
from stateright_tpu_torch import BatchableModel, Model, Property, WriteReporter
from stateright_tpu_torch.models.sharded_kv import ShardedKv
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.interop import table_from_numpy
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops.hashset_kernel import hashset_insert_sorted
from stateright_tpu_torch.ops.hashset import u32_to_i32
from stateright_tpu_torch.telemetry import get_tracer
from stateright_tpu_torch.telemetry.coverage import (
    DEPTH_BINS,
    CoverageLedger,
    DeviceCoverage,
    coverage_action_labels,
    sanitize_component,
)
from stateright_tpu_torch.telemetry.metrics import MetricsRegistry
from stateright_tpu_torch.telemetry.trace import Tracer
from stateright_tpu_torch.testing import Chain

from test_torch_fused_wave import CAP, _initial, _to_port, jax_spec, port_spec
from test_tpu_bfs import Chain as JaxChain


class VacuousChain(Model, BatchableModel):
    """The seeded-vacuity fixture of the JAX package's coverage tests, in
    torch: a 0 -> 1 -> ... -> 8 chain whose second action is never enabled
    (dead), whose ``always`` invariant has an antecedent that never holds
    (vacuous pass) and whose ``sometimes`` target is unreachable
    (undiscovered)."""

    N = 8

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < self.N:
            actions.append("step")

    def next_state(self, state, action):
        return state + 1

    def properties(self):
        return [
            Property.always("guarded invariant", lambda m, s: True,
                            antecedent=lambda m, s: s > m.N),
            Property.sometimes("reach the unreachable", lambda m, s: s == 100),
        ]

    def packed_action_count(self):
        return 2

    def packed_action_labels(self):
        return ["step", "never_fires"]

    def packed_init_states(self, device="cpu"):
        return {"x": torch.zeros((1, 1), dtype=torch.int64, device=device)}

    def packed_expand(self, states):
        x = states["x"]  # (F, 1)
        step = x < self.N
        valid = torch.cat([step, torch.zeros_like(step)], dim=1)  # (F, 2)
        cand = torch.where(valid[:, :, None], x[:, None, :] + 1, x[:, None, :])
        return {"x": cand}, valid

    def packed_conditions(self):
        return [
            lambda s: torch.ones(s["x"].shape[0], dtype=torch.bool, device=s["x"].device),
            lambda s: s["x"][:, 0] == 100,
        ]

    def packed_antecedents(self):
        return [lambda s: s["x"][:, 0] > self.N, None]

    def pack_state(self, host_state):
        return {"x": torch.tensor([host_state], dtype=torch.int64)}

    def unpack_state(self, packed):
        return int(packed["x"][0])


class JaxVacuousChain(JaxModel, JaxBatchableModel):
    """The same fixture for the JAX package (``tests/test_coverage.py``)."""

    N = 8

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < self.N:
            actions.append("step")

    def next_state(self, state, action):
        return state + 1

    def properties(self):
        return [
            JaxProperty.always("guarded invariant", lambda m, s: True,
                               antecedent=lambda m, s: s > m.N),
            JaxProperty.sometimes("reach the unreachable", lambda m, s: s == 100),
        ]

    def packed_action_count(self):
        return 2

    def packed_action_labels(self):
        return ["step", "never_fires"]

    def packed_init_states(self):
        return {"x": jnp.zeros((1, 1), jnp.uint32)}

    def packed_step(self, state, action_id):
        x = state["x"]
        valid = (action_id == 0) & (x[0] < jnp.uint32(self.N))
        return {"x": jnp.where(valid, x + 1, x)}, valid

    def packed_conditions(self):
        return [lambda s: jnp.bool_(True), lambda s: s["x"][0] == jnp.uint32(100)]

    def packed_antecedents(self):
        return [lambda s: s["x"][0] > jnp.uint32(self.N), None]

    def pack_state(self, host_state):
        return {"x": np.asarray([host_state], np.uint32)}

    def unpack_state(self, packed):
        return int(np.asarray(packed["x"])[0])


# -- ledger units ---------------------------------------------------------------


def _props():
    return VacuousChain().properties()


def test_sanitize_component():
    assert sanitize_component("abort agreement") == "abort_agreement"
    assert sanitize_component("a/b:c?") == "a_b_c_"
    assert sanitize_component("") == "_"


def _vector(layout, *, evaluated=0, terminal=0, fired=(), fresh=(), exercised=(),
            succ=None, depth=None):
    """A device coverage vector in ``layout`` (lists pad with zeros;
    ``succ`` and ``depth`` map a bin to its count)."""
    v = [0] * layout.size
    v[0], v[1] = evaluated, terminal
    for sl, xs in ((layout.s_fired, fired), (layout.s_fresh, fresh),
                   (layout.s_props, exercised)):
        v[sl.start:sl.start + len(xs)] = list(xs)
    for sl, bins in ((layout.s_succ, succ or {}), (layout.s_depth, depth or {})):
        for i, n in bins.items():
            v[sl.start + i] = n
    return v


def test_ledger_block_recording_and_vacuity():
    reg = MetricsRegistry()
    layout = DeviceCoverage(2, 2)
    led = CoverageLedger("t", _props(), action_labels=["step", "never_fires"],
                         registry=reg, tracer=Tracer())
    led.record_seed(1)
    led.consume_device(
        _vector(layout, evaluated=9, terminal=1, fired=[8], fresh=[8],
                succ={0: 9}, depth={2: 4, 3: 4}),
        layout, max_depth=9)
    rep = led.report()
    assert rep["evaluated"] == 9
    assert rep["generated"] == 8
    assert rep["unique"] == 9  # seed + 8 fresh
    assert rep["terminal_states"] == 1
    assert rep["revisits"] == 0
    vac = rep["vacuity"]
    assert vac["dead_actions"] == ["never_fires"]
    assert vac["unexercised_always"] == ["guarded invariant"]
    assert vac["undiscovered_sometimes"] == ["reach the unreachable"]
    assert rep["vacuous"]
    assert rep["properties"]["reach the unreachable"]["near_miss_depth"] == 9
    snap = reg.snapshot()
    assert snap["t.coverage.action_fired.never_fires"] == 0
    assert snap["t.coverage.action_fired.step"] == 8
    assert snap["t.coverage.states_evaluated"] == 9


def test_ledger_revisits_and_never_new():
    layout = DeviceCoverage(2, 0)
    led = CoverageLedger("t", [], action_labels=["a", "b"], registry=MetricsRegistry(),
                         tracer=Tracer())
    led.consume_device(_vector(layout, evaluated=4, fired=[6, 4], fresh=[5, 0],
                               depth={1: 5}), layout)
    rep = led.report()
    assert rep["revisits"] == 5
    assert rep["revisit_rate"] == pytest.approx(0.5)
    assert rep["actions"]["never_new"] == ["b"]
    assert rep["vacuity"]["dead_actions"] == []


def test_ledger_consume_device_near_miss_and_retry():
    """Device vectors: the eval-based slices count once per logical wave
    (a retry adds only fresh-based slices), the near-miss depth follows
    the deepest frontier consumed while a ``sometimes`` property is
    unwitnessed, and stops once it is witnessed."""
    layout = DeviceCoverage(2, 2)
    led = CoverageLedger("t", _props(), action_labels=["step", "never_fires"],
                         registry=MetricsRegistry(), tracer=Tracer())
    led.record_seed(1)

    def vec(evaluated, fired, fresh, exercised, depth):
        v = [0] * layout.size
        v[0] = evaluated
        v[layout.s_fired] = fired
        v[layout.s_fresh] = fresh
        v[layout.s_props] = exercised
        v[layout.s_depth.start + depth] = sum(fresh)
        return v

    led.consume_device(vec(1, [1, 0], [1, 0], [0, 0], 2), layout, max_depth=1)
    led.consume_device(vec(1, [1, 0], [1, 0], [0, 0], 3), layout, max_depth=2)
    # A retry of the second wave: only its fresh-based slices count.
    led.consume_device(vec(5, [7, 0], [1, 0], [3, 3], 3), layout, first_attempt=False,
                       max_depth=2)
    rep = led.report()
    assert rep["evaluated"] == 2 and rep["generated"] == 2 and rep["unique"] == 4
    assert rep["shape"]["depth_hist"] == [0, 1, 1, 2]
    assert rep["properties"]["reach the unreachable"]["near_miss_depth"] == 2
    led.consume_device(vec(1, [1, 0], [0, 0], [0, 1], 3), layout, max_depth=7)
    led.consume_device(vec(1, [0, 0], [0, 0], [0, 0], 3), layout, max_depth=9)
    rep = led.report()
    assert rep["properties"]["reach the unreachable"]["near_miss_depth"] == 2
    assert rep["properties"]["reach the unreachable"]["exercised"] == 1


def test_ledger_finalize_emits_summary_and_discovered_set():
    tracer = Tracer()
    props = [Property.sometimes("w", lambda m, s: True)]
    led = CoverageLedger("t", props, registry=MetricsRegistry(), tracer=tracer)
    led.finalize(discovered={"w"})
    events = [e for e in tracer.events() if e["name"] == "t.coverage.summary"]
    assert len(events) == 1
    rep = events[0]["args"]["report"]
    assert rep["properties"]["w"]["discovered"] is True
    assert rep["vacuity"]["undiscovered_sometimes"] == []
    led.finalize(discovered=set())
    events = [e for e in tracer.events() if e["name"] == "t.coverage.summary"]
    assert len(events) == 2
    assert events[-1]["args"]["report"]["vacuity"]["undiscovered_sometimes"] == ["w"]


def test_coverage_action_labels_defaults_and_override():
    assert coverage_action_labels(VacuousChain(), 2) == ["step", "never_fires"]

    class Bare(BatchableModel):
        def packed_action_count(self):
            return 3

    assert coverage_action_labels(Bare(), 3) == ["action_0", "action_1", "action_2"]
    labels = TwoPhaseSys(3).packed_action_labels()
    assert labels == JaxTwoPhaseSys(3).packed_action_labels()
    assert labels[0] == "TmCommit" and len(labels) == 17


# -- the device reduction ---------------------------------------------------------


def test_device_layout_wave_reduce():
    layout = DeviceCoverage(action_count=2, property_count=2)
    vec = layout.wave_reduce(
        eval_mask=torch.tensor([True, True, False]),
        cvalid=torch.tensor([[True, False], [True, True], [False, False]]),
        fresh=torch.tensor([True, False, True, False, False, False]),
        lane_action=torch.arange(6) % 2,
        new_depth=torch.tensor([2, 2, 3, 3, 4, 4]),
        exercised=[torch.tensor([True, False, False]), torch.tensor([True, True, False])],
    ).tolist()
    assert vec[0] == 2 and vec[1] == 0
    assert vec[layout.s_fired] == [2, 1]
    assert vec[layout.s_fresh] == [2, 0]
    assert vec[layout.s_props] == [1, 2]
    assert vec[layout.s_succ] == [1, 1]
    depth_bins = vec[layout.s_depth]
    assert depth_bins[2] == 1 and depth_bins[3] == 1 and sum(depth_bins) == 2


@pytest.mark.parametrize("A,P,F,seed", [(1, 1, 40, 0), (2, 0, 33, 1), (7, 3, 64, 2),
                                        (42, 3, 96, 3), (125, 2, 20, 4)])
def test_wave_reduce_matches_jax(A, P, F, seed):
    """Random seeded inputs, child depths spread past the 64 bins (they
    saturate), through both reductions."""
    rng = np.random.default_rng(seed)
    B = F * A
    eval_mask = rng.random(F) < 0.8
    cvalid = (rng.random((F, A)) < 0.3) & eval_mask[:, None]
    fresh = rng.random(B) < 0.4
    lane_action = rng.integers(0, A, size=B)
    new_depth = rng.integers(1, 90, size=B)
    exercised = [rng.random(F) < 0.5 for _ in range(P)]
    jl, tl = JaxDeviceCoverage(A, P), DeviceCoverage(A, P)
    assert jl.size == tl.size and tl.succ_bins == jl.succ_bins
    jv = jl.wave_reduce(
        eval_mask=jnp.asarray(eval_mask), cvalid=jnp.asarray(cvalid),
        fresh=jnp.asarray(fresh), lane_action=jnp.asarray(lane_action, jnp.int32),
        new_depth=jnp.asarray(new_depth, jnp.int32),
        exercised=[jnp.asarray(e) for e in exercised],
    )
    tv = tl.wave_reduce(
        eval_mask=torch.from_numpy(eval_mask), cvalid=torch.from_numpy(cvalid),
        fresh=torch.from_numpy(fresh), lane_action=torch.from_numpy(lane_action),
        new_depth=torch.from_numpy(new_depth),
        exercised=[torch.from_numpy(e) for e in exercised],
    )
    assert tv.dtype == torch.int64 and tuple(tv.shape) == (tl.size,)
    assert tv.tolist() == np.asarray(jv).astype(np.int64).tolist()
    assert tv[tl.s_depth][DEPTH_BINS - 1] > 0  # depths past 63 saturate


def test_count_distinct_matches_jax():
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 4, size=200).astype(np.uint32)
    lo = rng.integers(0, 5, size=200).astype(np.uint32)
    hi[:3], lo[:3] = 0xFFFFFFFF, 0xFFFFFFFF
    valid = rng.random(200) < 0.7
    want = int(JaxDeviceCoverage.count_distinct(jnp.asarray(hi), jnp.asarray(lo),
                                                jnp.asarray(valid)))
    got = DeviceCoverage.count_distinct(_to_port(hi), _to_port(lo), torch.from_numpy(valid))
    assert int(got) == want
    assert int(DeviceCoverage.count_distinct(_to_port(hi), _to_port(lo),
                                             torch.zeros(200, dtype=torch.bool))) == 0


# -- single waves against the Pallas fused wave -------------------------------------


def _cov_specs(jmodel, tmodel):
    jspec, tspec = jax_spec(jmodel), port_spec(tmodel)
    P, A = len(jspec.conditions), jspec.action_count
    jspec = jspec.__class__(**{**jspec.__dict__, "cov_layout": JaxDeviceCoverage(A, P),
                               "cov_antecedents": tuple(jmodel.packed_antecedents())})
    tspec = fw.FusedWaveSpec(**{**tspec.__dict__, "cov_layout": DeviceCoverage(A, P),
                                "cov_antecedents": tuple(tmodel.packed_antecedents())})
    return jspec, tspec


def _chain_twin(tspec, table, states, hi, lo, ebits, depth, dcap, mask):
    """``coverage_stage`` on CPU tensors (the plain twin of ``fw_coverage``)
    over the inputs the kernel chain hands it: the model stage's valid
    bits, the antecedents, ``ebits_after``, and the sweep's outcome bytes
    and sorted lanes from the staged wave's own sort and insert."""
    F = hi.shape[0]
    cond, cvalid, cand = fw.model_stage(tspec, states, F)
    ant = fw.antecedent_stage(tspec, states, F)
    _ev, ebits_after, masked, _term = fw._frontier_plain(tspec, cond, cvalid, ebits, depth,
                                                          dcap, mask)
    shi, slo, sidx, unique = fw.sorted_dedup(*tspec.fingerprint(cand), masked)
    _t, fresh, _found, _pending = hashset_insert_sorted(table.clone(), u32_to_i32(shi),
                                                        u32_to_i32(slo), unique)
    return fw.coverage_stage(tspec, cvalid, depth, dcap, mask, cond, ant, ebits_after,
                             fresh.to(torch.uint8), sidx.to(torch.int32))


WAVES = {
    "2pc3": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3), 64, 5),
    "2pc5": (lambda: JaxTwoPhaseSys(5), lambda: TwoPhaseSys(5), 128, 4),
    # One action (a single successor bin) and an eventually property.
    "chain": (lambda: JaxChain(6, reach=9), lambda: Chain(6, reach=9), 8, 6),
    # Antecedents, torn writes.
    "skv_2_2_1": (lambda: JaxShardedKv(2, 2, 1), lambda: ShardedKv(2, 2, 1), 64, 5),
}


@pytest.mark.parametrize("name", list(WAVES))
def test_single_waves_coverage_matches_jax_fused_wave(name):
    """Consecutive waves from the initial state (each wave's inputs are the
    JAX wave's outputs before it), 10% of the lanes past the depth cap and
    eventually bits drawn from a seed (lane 0 always under the cap). The
    JAX frontier is padded to a fixed width under its lane mask; the port
    runs it twice, on the live lanes only and on the padded frontier with the JAX mask whose off lanes hold
    stale rows (other states of the wave). Each port vector (the staged
    wave's and the CUDA stage's plain twin's) equals the JAX wave's."""
    make_jax, make_port, F_pad, n_waves = WAVES[name]
    jmodel, tmodel = make_jax(), make_port()
    jspec, tspec = _cov_specs(jmodel, tmodel)
    n_ev = len(jspec.ebit)
    rng = np.random.default_rng(11 + len(name))
    jwave = jax.jit(lambda *a: jax_fused_wave(jspec, *a))

    states, hi, lo, depth = _initial(jmodel)
    table = np.zeros((CAP + 128, 2), np.uint32)
    compared = 0
    for _ in range(n_waves):
        F = min(hi.shape[0], F_pad)
        if F == 0:
            break
        states = jax.tree_util.tree_map(lambda x: x[:F], states)
        hi, lo, depth = hi[:F], lo[:F], depth[:F]
        d = int(depth.max())
        # Lane 0 stays under the cap, so a one-lane frontier goes on.
        capped = (rng.random(F) < 0.1) & (np.arange(F) > 0)
        depth = np.where(capped, d + 1, depth).astype(np.int32)
        ebits = rng.integers(0, 1 << n_ev, size=F).astype(np.uint32)
        # The padded frontier: live lanes first, stale copies after.
        fill = rng.integers(0, F, size=F_pad - F)

        def pad(x):
            return np.concatenate([x, x[fill]])

        mask = np.arange(F_pad) < F
        jout = jwave(table, jax.tree_util.tree_map(pad, states), pad(hi), pad(lo),
                     pad(ebits), pad(depth), mask, d + 1)
        want = np.asarray(jout["cov"]).astype(np.int64).tolist()

        def port(st, h, l, e, dp, m=None):
            tstates = {k: _to_port(v) for k, v in st.items()} if isinstance(st, dict) \
                else _to_port(st)
            args = (tstates, _to_port(h), _to_port(l), _to_port(e), _to_port(dp))
            _t, out = fw.torch_wave(tspec, table_from_numpy(table), *args, d + 1, mask=m)
            twin = _chain_twin(tspec, table_from_numpy(table), *args, d + 1, m)
            return out["cov"].tolist(), twin.tolist()

        live = port(states, hi, lo, ebits, depth)
        masked = port(jax.tree_util.tree_map(pad, states), pad(hi), pad(lo), pad(ebits),
                      pad(depth), torch.from_numpy(mask))
        assert live == (want, want)
        assert masked == (want, want)
        compared += 1
        table = np.asarray(jout["table"])
        n = int(np.asarray(jout["stats"])[1])
        states, hi, lo, depth = (
            jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], jout["new"][k])
            for k in ("states", "hi", "lo", "depth")
        )
    assert compared >= 3


# -- whole runs ----------------------------------------------------------------------

RUNS = {
    "2pc3": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3),
             dict(frontier_capacity=64, table_capacity=2048)),
    "2pc4": (lambda: JaxTwoPhaseSys(4), lambda: TwoPhaseSys(4),
             dict(frontier_capacity=256, table_capacity=4096)),
    "vacuous_chain": (JaxVacuousChain, VacuousChain,
                      dict(frontier_capacity=8, table_capacity=2048)),
    "skv_2_2_1_guarded": (lambda: JaxShardedKv(2, 2, 1, guarded=True),
                          lambda: ShardedKv(2, 2, 1, guarded=True),
                          dict(frontier_capacity=16, table_capacity=2048)),
    "skv_2_2_1": (lambda: JaxShardedKv(2, 2, 1), lambda: ShardedKv(2, 2, 1),
                  dict(frontier_capacity=16, table_capacity=2048)),
    # An actor model: the fused wave's comphash key route with coverage.
    "single_copy_2c1s": (lambda: JaxSingleCopyModelCfg(2, 1).into_model(),
                         lambda: SingleCopyModelCfg(2, 1).into_model(),
                         dict(frontier_capacity=64, table_capacity=4096)),
}
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


@pytest.fixture(scope="module", params=list(RUNS), ids=list(RUNS))
def runs(request):
    make_jax, make_port, spawn = RUNS[request.param]
    out = {"name": request.param}
    for mode, options in MODES.items():
        out[("jax", mode)] = make_jax().checker().spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", expand_fps=False, coverage=True,
            **spawn, **options).join()
        for engine in ("staged", "fused"):
            for cov in (True, False):
                out[(engine, mode, cov)] = make_port().checker().spawn_gpu_bfs(
                    device="cpu", wave_kernel=engine, coverage=cov, **spawn, **options
                ).join()
    return out


def _report(checker):
    rep = dict(checker.coverage_report())
    rep.pop("prefix")
    return rep


@pytest.mark.parametrize("engine", ["staged", "fused"])
@pytest.mark.parametrize("mode", list(MODES))
def test_coverage_report_matches_jax(runs, engine, mode):
    tc, jc = runs[(engine, mode, True)], runs[("jax", mode)]
    assert tc.worker_error() is None
    assert tc.coverage_report()["prefix"] == "gpu_bfs"
    assert _report(tc) == _report(jc)
    assert tc.unique_state_count() == jc.unique_state_count()
    rep = tc.coverage_report()
    assert sum(rep["shape"]["depth_hist"]) == rep["unique"] == tc.unique_state_count()
    assert rep["generated"] == sum(a["fired"] for a in rep["actions"]["table"].values())


@pytest.mark.parametrize("engine", ["staged", "fused"])
@pytest.mark.parametrize("mode", list(MODES))
def test_coverage_on_is_bit_identical_to_off(runs, engine, mode):
    on, off = runs[(engine, mode, True)], runs[(engine, mode, False)]
    assert off.coverage_report() is None and off.coverage is None
    assert on.unique_state_count() == off.unique_state_count()
    assert on.state_count() == off.state_count()
    assert on.max_depth() == off.max_depth()
    assert on.waves == off.waves and on.drains == off.drains
    assert on._discoveries_fp == off._discoveries_fp
    for name, path in off.discoveries().items():
        assert on.discoveries()[name].encode() == path.encode(), name
    assert _golden(on, WriteReporter) == _golden(off, WriteReporter)
    assert _golden(on, WriteReporter) == _golden(runs[("jax", mode)], JaxWriteReporter)


def _port_runs(make, spawn):
    """Coverage-on port runs of both engines, wave at a time and drained."""
    return {
        (engine, mode): make().checker().spawn_gpu_bfs(
            device="cpu", wave_kernel=engine, coverage=True, **spawn, **options).join()
        for engine in ("staged", "fused") for mode, options in MODES.items()
    }


def test_vacuity_fixture_flagged():
    for key, checker in _port_runs(VacuousChain, RUNS["vacuous_chain"][2]).items():
        rep = checker.coverage_report()
        vac = rep["vacuity"]
        assert vac["dead_actions"] == ["never_fires"], key
        assert vac["unexercised_always"] == ["guarded invariant"], key
        assert vac["undiscovered_sometimes"] == ["reach the unreachable"], key
        assert rep["vacuous"] and rep["terminal_states"] == 1
        assert sum(rep["shape"]["depth_hist"]) == 9


@pytest.mark.parametrize("guarded", [True, False])
def test_sharded_kv_exercises_antecedents(guarded):
    runs = _port_runs(lambda: ShardedKv(2, 2, 1, guarded=guarded),
                      RUNS["skv_2_2_1"][2])
    for key, checker in runs.items():
        rep = checker.coverage_report()
        for name in ("no torn writes", "no total tear"):
            entry = rep["properties"][name]
            assert entry["has_antecedent"]
            assert 0 < entry["exercised"] < rep["evaluated"], (key, name, entry)
        assert rep["vacuity"]["dead_actions"] == []
        assert rep["actions"]["table"]["MigrateStart_0_to_1"]["fired"] > 0
        assert set(checker.discoveries()) == (
            {"fully migrated", "saturated writes"} if guarded
            else {"no torn writes", "no total tear", "fully migrated", "saturated writes"}
        ), key


def test_finalize_emits_gpu_bfs_summary():
    tracer = get_tracer()
    before = len([e for e in tracer.events() if e["name"] == "gpu_bfs.coverage.summary"])
    c = TwoPhaseSys(3).checker().spawn_gpu_bfs(
        device="cpu", coverage=True, frontier_capacity=64, table_capacity=2048).join()
    events = [e for e in tracer.events() if e["name"] == "gpu_bfs.coverage.summary"]
    assert len(events) == before + 1
    rep = events[-1]["args"]["report"]
    assert rep == c.coverage_report()
    assert rep["properties"]["abort agreement"]["discovered"] is True
    snap = c.metrics().snapshot()
    assert snap["gpu_bfs.coverage.action_fired.TmCommit"] > 0


def test_coverage_off_runs_no_antecedent_and_no_coverage_stage(monkeypatch):
    """With coverage off, a wave on either engine calls no antecedent, no
    antecedent stage, no coverage reduction and no coverage stage, and its
    output has no ``cov``; with coverage on, each runs."""
    calls = {"ant": 0, "stage": 0, "reduce": 0, "ant_stage": 0}

    class Counted(ShardedKv):
        def packed_antecedents(self):
            def ant(st):
                calls["ant"] += 1
                return (st["inflight"] != self.S).any(dim=1)

            return [ant, ant, None, None]

    for name, target in (("stage", "coverage_stage"), ("ant_stage", "antecedent_stage")):
        orig = getattr(fw, target)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(fw, target, spy)
    reduce = DeviceCoverage.wave_reduce

    def spy_reduce(self, **k):
        calls["reduce"] += 1
        return reduce(self, **k)

    monkeypatch.setattr(DeviceCoverage, "wave_reduce", spy_reduce)
    outs = {}
    orig_wave = fw.torch_wave

    def record(*a, **k):
        t, out = orig_wave(*a, **k)
        outs.setdefault("keys", set()).update(out)
        return t, out

    monkeypatch.setattr(fw, "torch_wave", record)
    import stateright_tpu_torch.checker.gpu as gpu_mod
    monkeypatch.setattr(gpu_mod, "torch_wave", record)
    for engine in ("staged", "fused"):
        for mode in MODES.values():
            Counted(2, 2, 1, guarded=True).checker().spawn_gpu_bfs(
                device="cpu", wave_kernel=engine, frontier_capacity=16,
                table_capacity=2048, **mode).join()
    assert calls == {"ant": 0, "stage": 0, "reduce": 0, "ant_stage": 0}
    assert "cov" not in outs["keys"]
    Counted(2, 2, 1, guarded=True).checker().spawn_gpu_bfs(
        device="cpu", coverage=True, frontier_capacity=16, table_capacity=2048,
        max_drain_waves=1).join()
    assert calls["ant"] > 0 and calls["ant_stage"] > 0 and calls["reduce"] > 0
    assert "cov" in outs["keys"]
