"""The port's named configurations (``stateright_tpu_torch/configs.py``),
which ``chip_smoke.py`` and the profiling scripts run, against the JAX
package's: the bench legs' spawn settings and counts (``bench.py``), raft4's
from ``tests/test_raft5.py``, skv4x4's (the swarm bench's ``ShardedKv(4, 8,
3)``, ``bench.py:2420``, cut to 4 keys: 64 states a key, 64 ** 4 in all),
and models of the same widths (action count, packed leaves and their
shapes, properties)."""

import numpy as np
import pytest

import bench
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.models.sharded_kv import ShardedKv as JaxShardedKv
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.configs import CONFIGS

# Each configuration: its JAX model, spawn settings and count.
BENCH_LEGS = {"paxos3": "paxos3", "abd3o": "abd3o", "raft5_ttc": "raft5"}
RAFT4_LOSSY = 24_545  # tests/test_raft5.py:21
SKV4X4_SPAWN = dict(frontier_capacity=8192, table_capacity=1 << 25, drain_log_factor=128)


def _reference(name):
    if name in BENCH_LEGS:
        leg = bench._leg_specs()[BENCH_LEGS[name]]
        return leg["model"], leg["spawn"], leg.get("expected")
    if name == "2pc8":
        # bench.py's 2pc leg, at 8 resource managers.
        leg = bench._leg_specs()["2pc"]
        return lambda: JaxTwoPhaseSys(8), leg["spawn"], 1_745_408
    if name == "skv4x4":
        return lambda: JaxShardedKv(4, 4, 3, guarded=True), SKV4X4_SPAWN, 64 ** 4
    assert name == "raft4"
    return (lambda: JaxRaftModelCfg(server_count=4, max_term=1, lossy=True).into_model(),
            dict(frontier_capacity=1 << 11, table_capacity=1 << 16), RAFT4_LOSSY)


def test_every_config_has_a_reference():
    assert set(CONFIGS) == set(BENCH_LEGS) | {"2pc8", "raft4", "skv4x4"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_the_jax_package(name):
    make_ref, spawn, unique = _reference(name)
    cfg = CONFIGS[name]
    assert cfg.name == name
    assert cfg.spawn == spawn
    assert cfg.unique == unique
    port, ref = cfg.make(), make_ref()
    assert port.packed_action_count() == ref.packed_action_count()
    assert [p.name for p in port.properties()] == [p.name for p in ref.properties()]
    got = {k: tuple(v.shape) for k, v in port.packed_init_states().items()}
    want = {k: tuple(np.asarray(v).shape) for k, v in ref.packed_init_states().items()}
    assert got == want
    assert [a is None for a in port.packed_antecedents()] == [
        a is None for a in ref.packed_antecedents()]


# -- the swarm leg (bench.py's _run_swarm_leg) ---------------------------------------


def _bench_swarm_spawns():
    """The ``spawn_swarm`` settings of the JAX bench's swarm leg, read from
    its source: every call there with constant keywords and a ``seed``
    (``aot_cache`` left out: the port's cache namespace is its own)."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(bench._run_swarm_leg)))
    spawns = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        try:
            kw = {k.arg: eval(compile(ast.Expression(k.value), "bench.py", "eval"), {})
                  for k in node.keywords if k.arg not in (None, "aot_cache")}
        except NameError:
            continue
        if "seed" in kw:
            spawns.append(kw)
    return spawns


def _jax_swarm_models():
    return {
        "skv483_deep": lambda: JaxShardedKv(4, 8, 3, retain=("no total tear",)),
        "raft3_live": lambda: JaxRaftModelCfg(server_count=3, max_term=1, lossy=True)
        .into_model().retain_properties("stable leader"),
        "2pc3_witness": lambda: JaxTwoPhaseSys(3),
    }


def test_every_swarm_config_is_a_bench_swarm_run():
    from stateright_tpu_torch.configs import SWARM_CONFIGS

    spawns = _bench_swarm_spawns()
    assert len(spawns) == 3
    assert sorted(map(sorted, (c.spawn.items() for c in SWARM_CONFIGS.values()))) == sorted(
        map(sorted, (s.items() for s in spawns)))
    import inspect

    src = inspect.getsource(bench._run_swarm_leg)
    for cfg in SWARM_CONFIGS.values():
        if cfg.target is not None:
            assert f"target_state_count({cfg.target:_})" in src


@pytest.mark.parametrize("name", ["skv483_deep", "raft3_live", "2pc3_witness"])
def test_swarm_config_matches_the_jax_package(name):
    from stateright_tpu_torch.configs import SWARM_CONFIGS

    cfg = SWARM_CONFIGS[name]
    assert cfg.name == name
    port, ref = cfg.make(), _jax_swarm_models()[name]()
    assert port.packed_action_count() == ref.packed_action_count()
    assert [p.name for p in port.properties()] == [p.name for p in ref.properties()]
    got = {k: tuple(v.shape) for k, v in port.packed_init_states().items()}
    want = {k: tuple(np.asarray(v).shape) for k, v in ref.packed_init_states().items()}
    assert got == want
    builder = cfg.builder()
    assert builder._target_state_count == cfg.target


# -- the liveness leg (bench.py's _run_liveness_leg) --------------------------------


def _bench_liveness_spawns():
    """The ``spawn_tpu_bfs`` settings of the JAX bench's liveness leg, read
    from its source, in call order (raft-3 check-live, then the DAG)."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(bench._run_liveness_leg)))
    return [{k.arg: eval(compile(ast.Expression(k.value), "bench.py", "eval"), {})
             for k in node.keywords}
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "spawn_tpu_bfs"]


def test_liveness_configs_are_the_bench_liveness_runs():
    from stateright_tpu_torch.configs import LIVENESS_CONFIGS, LevelDag

    raft, dag = _bench_liveness_spawns()
    assert LIVENESS_CONFIGS["raft3_check_live"].spawn == raft
    assert LIVENESS_CONFIGS["level_dag_absence"].spawn == dag
    # The card-sized run: the same DAG at W = 2^20, spawned as the leg
    # spawns it, at a frontier and a table fitted to its 2^20-wide levels.
    big = LIVENESS_CONFIGS["level_dag_2p20"]
    assert big.spawn == dict(frontier_capacity=1 << 16, table_capacity=1 << 23,
                             liveness="device")
    model = big.make()
    assert isinstance(model, LevelDag) and (model.W, model.WB, model.L) == (1 << 20, 20, 20)
    # Every level k holds min(2^k, W) values: 2^21 - 1 states.
    assert big.unique == sum(min(1 << k, model.W) for k in range(model.L + 1)) == 2_097_151
    default = LevelDag()
    assert (default.W, default.WB, default.L) == (bench._LevelDag.W, bench._LevelDag.WB,
                                                  bench._LevelDag.L)
    assert LIVENESS_CONFIGS["level_dag_absence"].unique == sum(
        min(1 << k, default.W) for k in range(default.L + 1)) == 73_727


def test_raft3_check_live_matches_the_jax_package():
    from stateright_tpu_torch.configs import LIVENESS_CONFIGS

    cfg = LIVENESS_CONFIGS["raft3_check_live"]
    port = cfg.make()
    ref = JaxRaftModelCfg(server_count=3, max_term=1, lossy=True).into_model() \
        .retain_properties("stable leader")
    assert port.packed_action_count() == ref.packed_action_count()
    assert [p.name for p in port.properties()] == [p.name for p in ref.properties()] == [
        "stable leader"]
    got = {k: tuple(v.shape) for k, v in port.packed_init_states().items()}
    want = {k: tuple(np.asarray(v).shape) for k, v in ref.packed_init_states().items()}
    assert got == want


def test_level_dag_is_the_bench_class_state_for_state():
    """On a small W (2^5, 7 levels) the port's ``LevelDag`` and the bench's
    ``_LevelDag`` give the same host states, actions, successors and
    verdicts of the condition, and the same packed words, successors and
    validity on every reachable state."""
    import jax
    import jax.numpy as jnp
    import torch

    from stateright_tpu.core.batch import BatchableModel as JaxBatchableModel
    from stateright_tpu.core.model import Model as JaxModel
    from stateright_tpu_torch.configs import LevelDag

    class Small(bench._LevelDag, JaxModel, JaxBatchableModel):
        W, WB, L = 1 << 5, 5, 7

    port, ref = LevelDag(5, 7), Small()
    assert port.init_states() == ref.init_states()
    prop, jprop = port.properties()[0], ref.properties()[0]
    assert prop.name == jprop.name == "done"
    seen, frontier = set(port.init_states()), list(port.init_states())
    while frontier:
        state = frontier.pop()
        assert prop.condition(port, state) == jprop.condition(ref, state)
        acts, jacts = [], []
        port.actions(state, acts)
        ref.actions(state, jacts)
        assert acts == jacts
        for a in acts:
            nxt = port.next_state(state, a)
            assert nxt == ref.next_state(state, a)
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    assert len(seen) == sum(min(1 << k, port.W) for k in range(port.L + 1))
    states = sorted(seen)
    words = np.array([int(port.pack_state(s)["s"]) for s in states], np.int64)
    np.testing.assert_array_equal(words, [int(ref.pack_state(s)["s"]) for s in states])
    assert [port.unpack_state({"s": torch.tensor(w)}) for w in words] == states
    cand, valid = port.packed_expand({"s": torch.from_numpy(words)})
    for a in range(2):
        jnxt, jvalid = jax.vmap(lambda s: ref.packed_step({"s": s}, jnp.int32(a)))(
            jnp.asarray(words.astype(np.uint32)))
        np.testing.assert_array_equal(cand["s"][:, a].numpy(), np.asarray(jnxt["s"]))
        np.testing.assert_array_equal(valid[:, a].numpy(), np.asarray(jvalid))
    cond = port.packed_conditions()[0]({"s": torch.from_numpy(words)})
    jcond = jax.vmap(ref.packed_conditions()[0])({"s": jnp.asarray(words.astype(np.uint32))})
    np.testing.assert_array_equal(cond.numpy(), np.asarray(jcond))
