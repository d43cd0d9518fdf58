"""Exact parity of the port's swarm (``spawn_swarm``,
``stateright_tpu_torch/checker/swarm.py``) with the JAX package's, on the
CPU: for the same model, seed and knobs the same discovery trails, walk
steps, depth and unique sample (the JAX tests' ``_fingerprint_result``),
while the sample table is not saturated; and once it saturates, the same
walks with saturation reported by both."""


import pytest
import torch

from stateright_tpu.models.sharded_kv import ShardedKv as JaxShardedKv
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch.configs import SWARM_CONFIGS
from stateright_tpu_torch.models.sharded_kv import ShardedKv
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

# One model instance a module on each side: the wave caches key on the
# model's identity, so same-shape runs share one built kernel (and on the
# JAX side one compiled scan).
MODEL_2PC3 = TwoPhaseSys(3)
JAX_2PC3 = JaxTwoPhaseSys(3)
SWARM_KW = dict(lanes=64, sample_capacity=1 << 12, aot_cache="t-swarm")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The walks' steps are many small operations, which the intra-op
    thread pool only slows down on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs count into the JAX package's process-wide registry,
    some of whose counters that package's own tests read exactly."""
    yield
    jax_metrics_registry().reset()


def _fingerprint_result(ck):
    """The JAX tests' determinism value: walk steps, the sample, depth,
    discovery trails and saturation."""
    return (
        ck.state_count(),
        ck.unique_state_count(),
        ck.max_depth(),
        dict(ck._discoveries_fps),
        ck.coverage_estimate()["saturated"],
    )


def _run(builder, port, **kw):
    ck = builder.spawn_swarm(**kw, **(dict(device="cpu") if port else {})).join()
    assert ck.worker_error() is None
    return ck


@pytest.mark.parametrize("seed,wave_steps", [(7, 32), (11, 16)])
def test_swarm_equals_jax_2pc3(seed, wave_steps):
    kw = dict(seed=seed, wave_steps=wave_steps, **SWARM_KW)
    got = _run(MODEL_2PC3.checker().target_state_count(20_000), True, **kw)
    want = _run(JAX_2PC3.checker().target_state_count(20_000), False, **kw)
    assert _fingerprint_result(got) == _fingerprint_result(want)
    assert got._discoveries_fps


def test_swarm_equals_jax_sharded_kv_unguarded():
    kw = dict(seed=5, wave_steps=32, **SWARM_KW)
    got = _run(ShardedKv(2, 2, 1, guarded=False).checker().target_state_count(100_000),
               True, **kw)
    want = _run(JaxShardedKv(2, 2, 1, guarded=False).checker()
                .target_state_count(100_000), False, **kw)
    assert _fingerprint_result(got) == _fingerprint_result(want)
    assert "no torn writes" in got._discoveries_fps


def test_swarm_equals_jax_deep_sharded_kv_at_full_width():
    """The JAX bench's deep sharded-KV leg (``bench.py:2419-2447``) at its
    full width: 1,024 lanes hunting "no total tear" in ShardedKv(4, 8, 3)."""
    cfg = SWARM_CONFIGS["skv483_deep"]
    got = cfg.make().checker().spawn_swarm(**cfg.spawn, device="cpu").join()
    want = (JaxShardedKv(4, 8, 3, retain=("no total tear",)).checker()
            .spawn_swarm(**cfg.spawn).join())
    assert _fingerprint_result(got) == _fingerprint_result(want)
    assert "no total tear" in got._discoveries_fps
    assert all(got.discoveries()["no total tear"].last_state().torn)


def test_swarm_saturating_sample_keeps_walks_equal():
    """A sample table that fills: both packages report saturation, and the
    walks (discoveries, walk steps, depth, walks and restarts) stay equal;
    only the sample's counts may differ, as the two tables' layouts do."""
    kw = dict(seed=4, lanes=64, wave_steps=32, sample_capacity=2048, sample_stride=1)
    got = (ShardedKv(4, 8, 3).checker().target_state_count(6_400)
           .spawn_swarm(device="cpu", **kw).join())
    want = (JaxShardedKv(4, 8, 3).checker().target_state_count(6_400)
            .spawn_swarm(**kw).join())
    assert got.coverage_estimate()["saturated"] and want.coverage_estimate()["saturated"]
    assert got._discoveries_fps
    gs, ws = got.engine.tenant_stats(0), want._engine.tenant_stats(0)
    assert ((got.state_count(), got.max_depth(), got._discoveries_fps, gs["walks"],
             gs["restarts"]) == (want.state_count(), want.max_depth(),
                                 want._discoveries_fps, ws["walks"], ws["restarts"]))
