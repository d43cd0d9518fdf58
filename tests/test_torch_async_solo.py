"""The solo checker's async pipeline (``spawn_gpu_bfs(async_pipeline=True)``)
on the CPU: the twins of ``tests/test_async_pipeline.py``'s visitor refusal
and of the async cases of ``tests/test_storage_equivalence.py`` (2pc-4 and
2pc-5 at the smallest budget, a checkpoint taken mid-pipeline and resumed,
the ABD register with and without the fingerprint-only expansion).

Each async run is held to the port's synchronous run of the same knobs and
to the JAX package's async run: counts, depth, discovery fingerprints,
evictions and the golden report with its paths. The JAX side runs
``spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort", max_drain_waves=1)``
under the port's ``min_admissible_hbm_budget_mib`` (the port's table is at
least one 2,048-row tile, so the budgets differ otherwise), and the port
pins ``max_drain_waves=1`` to match. How many fresh lanes the host probe
finds stale depends on which runs an eviction has built when a wave's
verdict runs, in both packages: only ``stale_lanes > 0`` is asserted of
it. The tolerance is 0.
"""

import io
import pickle

import pytest

from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

from torch_service_refs import golden

RUN_IDS = []


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    yield
    from stateright_tpu.telemetry import discard_run_registry as jax_discard
    from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

    jax_metrics_registry().reset()
    for run_id in RUN_IDS:
        jax_discard(run_id)


def _report(checker, reporter_cls):
    out = io.StringIO()
    checker.report(reporter_cls(out))
    return golden(out.getvalue())


def _port(model, **kw):
    c = model.checker().spawn_gpu_bfs(device="cpu", **kw).join()
    assert c.worker_error() is None, c.worker_error()
    return c


def _jax(model, run_id, **kw):
    from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

    RUN_IDS.append(run_id)
    c = model.checker().spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort", run_id=run_id,
                                      **kw).join()
    assert c.worker_error() is None
    evictions = jax_metrics_registry(run_id).snapshot().get("tpu_bfs.storage.evictions", 0)
    return c, evictions


def _same(ours, theirs, ours_evictions, theirs_evictions, jax_report=None):
    from stateright_tpu import WriteReporter as JaxWriteReporter

    assert ours.unique_state_count() == theirs.unique_state_count()
    assert ours.state_count() == theirs.state_count()
    assert ours.max_depth() == theirs.max_depth()
    assert ours._discoveries_fp == theirs._discoveries_fp
    assert ours_evictions == theirs_evictions
    theirs_report = (_report(theirs, JaxWriteReporter) if jax_report
                     else _report(theirs, WriteReporter))
    assert _report(ours, WriteReporter) == theirs_report


def test_async_pipeline_rejects_visitor():
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    class V:
        def visit(self, model, path):
            pass

    messages = []
    for make, spawn in ((lambda: JaxTwoPhaseSys(3), "spawn_tpu_bfs"),
                        (lambda: TwoPhaseSys(3), "spawn_gpu_bfs")):
        kw = dict(frontier_capacity=16, table_capacity=1 << 12, async_pipeline=True)
        if spawn == "spawn_gpu_bfs":
            kw["device"] = "cpu"
        with pytest.raises(ValueError, match="async_pipeline") as err:
            getattr(make().checker().visitor(V()), spawn)(**kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("rm,table", [(4, 1 << 12), (5, 1 << 14)])
def test_async_pipeline_identical_at_the_smallest_budget(rm, table):
    """The worker applies every probe and eviction one wave late, yet the
    run is the synchronous one's, and the JAX async run's."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(rm), 16)
    kw = dict(frontier_capacity=16, table_capacity=table, hbm_budget_mib=budget,
              max_drain_waves=1)
    sync = _port(TwoPhaseSys(rm), **kw)
    async_ = _port(TwoPhaseSys(rm), async_pipeline=True, **kw)
    assert sync.evictions >= 2
    _same(async_, sync, async_.evictions, sync.evictions)
    assert async_.stale_lanes > 0 and sync.stale_lanes > 0
    jax_async, jax_evictions = _jax(JaxTwoPhaseSys(rm), f"tas-2pc{rm}", async_pipeline=True, **kw)
    _same(async_, jax_async, async_.evictions, jax_evictions, jax_report=True)
    assert async_.unique_state_count() == {4: 1568, 5: 8832}[rm]
    async_.assert_properties()


def test_async_pipeline_after_the_drain_hands_off():
    """With the deep drain on, the run drains until the first eviction and
    goes on wave at a time through the pipeline: the synchronous run's."""
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
    kw = dict(frontier_capacity=16, table_capacity=1 << 12, hbm_budget_mib=budget)
    sync = _port(TwoPhaseSys(4), **kw)
    async_ = _port(TwoPhaseSys(4), async_pipeline=True, **kw)
    assert sync.handoff_wave is not None and async_.handoff_wave == sync.handoff_wave
    _same(async_, sync, async_.evictions, sync.evictions)


def test_async_checkpoint_mid_pipeline_resume(tmp_path):
    """A checkpoint taken mid-pipeline (the barrier drains the verdicts in
    flight, the payload is built after it, the pickle rides the worker)
    resumes to the uninterrupted run."""
    ckpt = tmp_path / "2pc4-async.ckpt"
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
    kw = dict(frontier_capacity=16, table_capacity=1 << 12, hbm_budget_mib=budget,
              max_drain_waves=1)
    first = (TwoPhaseSys(4).checker().target_state_count(2500)
             .spawn_gpu_bfs(device="cpu", checkpoint_path=str(ckpt), checkpoint_every_chunks=4,
                            async_pipeline=True, **kw).join())
    assert first.worker_error() is None
    assert first.unique_state_count() < 1568
    assert first.checkpoints_written >= 1
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    assert payload["version"] == 2 and payload["kind"] == "gpu_bfs"
    resumed = _port(TwoPhaseSys(4), resume_from=str(ckpt), async_pipeline=True, **kw)
    unbounded = _port(TwoPhaseSys(4), frontier_capacity=16, table_capacity=1 << 12,
                      max_drain_waves=1)
    _same(resumed, unbounded, 0, 0)
    assert resumed.evictions >= 1
    resumed.assert_properties()


@pytest.mark.parametrize("fps", [True, False])
def test_budget_identical_abd_expand_fps_async(fps):
    """The ABD register with the fingerprint-only expansion on and off: in
    async mode the survivors' children are made on the worker; the run is
    its budgeted and unbounded synchronous twins', and (``expand_fps`` on)
    the JAX async run's. The JAX case's 2c/2s space (544 states) fits the
    port's one-tile table, so the budget binds only on a larger one: 3c/2s
    to depth 20 (3,335 states)."""
    from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg

    def model(cfg=AbdModelCfg):
        return cfg(3, 2).into_model()

    kw = dict(frontier_capacity=32, table_capacity=1 << 12, expand_fps=fps, max_drain_waves=1)
    budget = min_admissible_hbm_budget_mib(model(), 32)

    def port(**extra):
        c = model().checker().target_max_depth(20).spawn_gpu_bfs(
            device="cpu", wave_kernel="staged", **kw, **extra).join()
        assert c.worker_error() is None, c.worker_error()
        return c

    async_ = port(hbm_budget_mib=budget, async_pipeline=True)
    sync = port(hbm_budget_mib=budget)
    unbounded = port()
    assert async_.evictions >= 2
    _same(async_, sync, async_.evictions, sync.evictions)
    _same(async_, unbounded, 0, 0)
    assert async_.stale_lanes > 0
    assert async_.unique_state_count() == 3335
    if fps:
        assert async_.host_takes > 0
        RUN_IDS.append("tas-abd")
        jax_async = model(JaxAbdModelCfg).checker().target_max_depth(20).spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", run_id="tas-abd", hbm_budget_mib=budget,
            async_pipeline=True, **kw).join()
        from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

        jax_evictions = jax_metrics_registry("tas-abd").snapshot()["tpu_bfs.storage.evictions"]
        _same(async_, jax_async, async_.evictions, jax_evictions, jax_report=True)
