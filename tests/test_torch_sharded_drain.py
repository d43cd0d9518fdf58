"""The port's sharded deep drain against the JAX package's, on the CPU.

Each case runs ``spawn_sharded_tpu_bfs`` and the port's
``spawn_sharded_gpu_bfs`` (8 shards in one process, on the CPU) at the
same knobs through the drain (the rings, the round-robin balance exchange,
the exit vote), and holds them equal in counts, depth, discoveries, every
discovery's path (fingerprint for fingerprint) and the exchange's lanes
shipped: 2pc-5 at the JAX suite's knobs; tiny rings and log with a waves
cap (many log-full exits, ring growth by export and re-push); a one-lane
frontier, whose round-robin quota is comparable to the whole ring; and the
runs that go wave at a time instead: a target max depth, and a visitor,
which sees every evaluated state's path in the JAX package's order.
Everything compared is an integer or a string: the tolerance is 0.
"""

import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

from torch_sharded_parity import discard, jax_run, paths_replay, port_run


@pytest.fixture(scope="module", autouse=True)
def _fresh_registries():
    yield
    discard()
    from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry

    jax_metrics_registry().reset()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = {
    # The JAX suite's 2pc-5 (test_sharded.py:28-37).
    "2pc5": (5, 8832, dict(frontier_per_device=256, table_capacity_per_device=512)),
    # Many log-full exits, ring growth, a waves cap (test_sharded.py:110-129).
    "tiny_rings_and_log": (5, 8832, dict(frontier_per_device=32,
                                         table_capacity_per_device=512,
                                         drain_log_factor=1, pool_factor=1,
                                         max_drain_waves=3)),
    # The received quota against the whole ring (test_sharded.py:149-166).
    "one_lane_frontier": (3, 288, dict(frontier_per_device=1, table_capacity_per_device=512,
                                       pool_factor=1, drain_log_factor=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_drain_equals_jax(case):
    rm, unique, kw = CASES[case]
    _, want = jax_run(JaxTwoPhaseSys(rm).checker(), 8, **kw)
    port, got = port_run(TwoPhaseSys(rm).checker(), 8, **kw)
    assert got["unique"] == unique
    assert got == want
    assert port.drains >= 1
    paths_replay(port)
    port.assert_properties()


def test_tiny_rings_grow_and_the_log_fills():
    port, _ = port_run(TwoPhaseSys(5).checker(), 8, **CASES["tiny_rings_and_log"][2])
    assert port.ring_growths >= 1
    # A waves cap of 3 splits the run into many drains.
    assert port.drains > port.waves // 3 - 1


def test_target_max_depth_equals_jax():
    kw = dict(frontier_per_device=64)
    _, want = jax_run(JaxTwoPhaseSys(3).checker().target_max_depth(3), 8, **kw)
    port, got = port_run(TwoPhaseSys(3).checker().target_max_depth(3), 8, **kw)
    assert got == want
    assert got["depth"] <= 3 and got["unique"] < 288
    assert port.drains == 0  # a depth cap runs wave at a time


def test_visitor_sees_the_jax_paths():
    # A visitor runs wave at a time and sees each evaluated state's path,
    # in the JAX package's chunk order.
    kw = dict(frontier_per_device=16, table_capacity_per_device=1 << 12)

    def visits(builder, spawn):
        seen = []
        builder.visitor(lambda _model, path: seen.append(repr(path.last_state())))
        checker, got = spawn(builder, 4, **kw)
        return checker, got, seen

    _, want, jax_seen = visits(JaxTwoPhaseSys(3).checker(), jax_run)
    checker, got, port_seen = visits(TwoPhaseSys(3).checker(), port_run)
    assert checker.drains == 0
    assert got == want
    assert len(port_seen) == 288 and port_seen == jax_seen
