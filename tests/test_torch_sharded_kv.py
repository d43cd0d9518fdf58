"""The port's ShardedKv (``stateright_tpu_torch/models/sharded_kv.py``) against
the JAX package's (``stateright_tpu/models/sharded_kv.py``).

On every reachable state (host BFS of the JAX model, packed by it and
carried across as numpy) the port's batched ``packed_expand`` gives the
same candidates, lane for lane, and the same valid bits as
``jax.vmap(packed_expand)``; the same conditions, antecedents, labels and
fingerprints; ``pack_state``/``unpack_state`` round-trip with the same host
fingerprints. Whole runs of ``spawn_gpu_bfs(device="cpu")`` on both engines,
wave at a time and drained, equal the JAX package's
``spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort")`` in counts,
discoveries, paths and golden reporter lines. Exact comparisons.
"""

import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stateright_tpu.core.fingerprint import fingerprint as jfingerprint
from stateright_tpu.models.sharded_kv import ShardedKv as JaxShardedKv
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.core.fingerprint import fingerprint as tfingerprint
from stateright_tpu_torch.interop import packed_states_from_numpy
from stateright_tpu_torch.models.sharded_kv import ShardedKv

from test_torch_fingerprint import reachable_states, stacked_packed

# (shards, keys, max_version, guarded): reachable host states
SPACES = {
    (2, 2, 1, False): 144,
    (2, 2, 1, True): 64,
    (3, 2, 2, False): 2025,
    (4, 1, 3, True): 64,
}


@pytest.fixture(scope="module", params=list(SPACES), ids=[str(k) for k in SPACES])
def space(request):
    s, k, v, g = request.param
    jmodel = JaxShardedKv(s, k, v, guarded=g)
    states = reachable_states(jmodel)
    packed = stacked_packed(jmodel, states)
    return request.param, jmodel, ShardedKv(s, k, v, guarded=g), states, packed


def _jax_states(packed):
    return {k: jnp.asarray(v) for k, v in packed.items()}


def test_reachable_counts(space):
    key, _jmodel, _tmodel, states, _packed = space
    assert len(states) == SPACES[key]


def test_packed_expand_matches_lane_for_lane(space):
    _key, jmodel, tmodel, _states, packed = space
    jcand, jvalid = jax.vmap(jmodel.packed_expand)(_jax_states(packed))
    tcand, tvalid = tmodel.packed_expand(packed_states_from_numpy(packed))
    assert tmodel.packed_action_count() == jmodel.packed_action_count()
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    assert set(jcand) == set(tcand)
    for k in jcand:
        assert tuple(tcand[k].shape) == jcand[k].shape, k
        assert np.array_equal(np.asarray(jcand[k]).astype(np.int64), tcand[k].numpy()), k


def test_conditions_antecedents_and_labels_match(space):
    _key, jmodel, tmodel, _states, packed = space
    jstates, tstates = _jax_states(packed), packed_states_from_numpy(packed)
    jconds, tconds = jmodel.packed_conditions(), tmodel.packed_conditions()
    assert len(jconds) == len(tconds) == 4
    for jc, tc in zip(jconds, tconds):
        assert np.array_equal(np.asarray(jax.vmap(jc)(jstates)), tc(tstates).numpy())
    jants, tants = jmodel.packed_antecedents(), tmodel.packed_antecedents()
    assert [a is None for a in jants] == [a is None for a in tants] == [False, False,
                                                                        True, True]
    for ja, ta in zip(jants, tants):
        if ja is not None:
            got = ta(tstates).numpy()
            assert np.array_equal(np.asarray(jax.vmap(ja)(jstates)), got)
            assert got.any() and not got.all()
    assert tmodel.packed_action_labels() == jmodel.packed_action_labels()
    assert [p.name for p in tmodel.properties()] == [p.name for p in jmodel.properties()]


def test_fingerprints_match(space):
    _key, jmodel, tmodel, _states, packed = space
    jhi, jlo = jax.vmap(jmodel.packed_fingerprint)(_jax_states(packed))
    thi, tlo = tmodel.packed_fingerprint(packed_states_from_numpy(packed))
    assert np.array_equal(np.asarray(jhi).astype(np.int64), thi.numpy())
    assert np.array_equal(np.asarray(jlo).astype(np.int64), tlo.numpy())


def test_pack_roundtrip_and_host_fingerprints(space):
    _key, jmodel, tmodel, states, packed = space
    for i in (0, len(states) // 2, len(states) - 1):
        one = tmodel.pack_state(states[i])
        for k, v in one.items():
            assert np.array_equal(v.numpy(), np.asarray(packed[k][i]).astype(np.int64)), k
        back = tmodel.unpack_state(one)
        assert dataclasses.astuple(back) == dataclasses.astuple(states[i])
        assert tfingerprint(back) == jfingerprint(states[i])
    init = tmodel.packed_init_states()
    jinit = jmodel.packed_init_states()
    for k in jinit:
        assert np.array_equal(init[k].numpy(), np.asarray(jinit[k]).astype(np.int64)), k


def test_retain_keeps_properties_aligned():
    model = ShardedKv(4, 2, 3, retain=("no total tear",))
    jmodel = JaxShardedKv(4, 2, 3, retain=("no total tear",))
    assert [p.name for p in model.properties()] == ["no total tear"]
    assert len(model.packed_conditions()) == len(model.packed_antecedents()) == 1
    assert len(jmodel.packed_antecedents()) == 1
    with pytest.raises(ValueError):
        ShardedKv(2, 2, 1, retain=("no such property",)).properties()


# -- whole runs -------------------------------------------------------------------

RUNS = {
    "2_2_1_guarded": ((2, 2, 1, True), dict(frontier_capacity=16, table_capacity=2048)),
    "2_2_1": ((2, 2, 1, False), dict(frontier_capacity=16, table_capacity=2048)),
    "4_2_3_guarded": ((4, 2, 3, True), dict(frontier_capacity=256, table_capacity=8192)),
}
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


@pytest.fixture(scope="module", params=list(RUNS), ids=list(RUNS))
def runs(request):
    (s, k, v, g), spawn = RUNS[request.param]
    out = {"name": request.param}
    for mode, options in MODES.items():
        out[("jax", mode)] = JaxShardedKv(s, k, v, guarded=g).checker().spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", **spawn, **options).join()
        for engine in ("staged", "fused"):
            out[(engine, mode)] = ShardedKv(s, k, v, guarded=g).checker().spawn_gpu_bfs(
                device="cpu", wave_kernel=engine, **spawn, **options).join()
    return out


@pytest.mark.parametrize("engine", ["staged", "fused"])
@pytest.mark.parametrize("mode", list(MODES))
def test_runs_match_jax(runs, engine, mode):
    tc, jc = runs[(engine, mode)], runs[("jax", mode)]
    assert tc.worker_error() is None
    assert tc.unique_state_count() == jc.unique_state_count()
    assert tc.state_count() == jc.state_count()
    assert tc.max_depth() == jc.max_depth()
    assert tc._discoveries_fp == jc._discoveries_fp
    jd, td = jc.discoveries(), tc.discoveries()
    assert set(td) == set(jd)
    for name in jd:
        assert td[name].encode() == jd[name].encode(), name
    assert _golden(tc, WriteReporter) == _golden(jc, JaxWriteReporter)


def test_guarded_counts_and_verdicts(runs):
    """The fixed protocol's keys are independent: 8 states a key at two
    shards and one version, 64 at four shards and three versions, so 64
    and 64 ** 2 states; its ``always`` properties hold and both
    ``sometimes`` are discovered. Unguarded, a write during a migration
    tears the key."""
    expected = {"2_2_1_guarded": 8 ** 2, "4_2_3_guarded": 64 ** 2}
    for key in [k for k in runs if isinstance(k, tuple) and k[0] != "jax"]:
        checker = runs[key]
        if runs["name"] in expected:
            assert checker.unique_state_count() == expected[runs["name"]], key
            checker.assert_properties()
        else:
            found = checker.discoveries()
            assert "no torn writes" in found, key
            actions = found["no torn writes"].into_actions()
            assert actions[0][0] == "MigrateStart" and actions[-1][0] == "Write", actions
