"""The comm sieve of the port's sharded BFS against the JAX package's, on
the CPU, and one actor model wave at a time.

With the sieve on each shard drops the lanes its receipt cache proves
resident at their owner and the exchange runs at a compacted rung. Here the
port and ``spawn_sharded_tpu_bfs`` run with the sieve off and on, wave at a
time and through the drain: results identical off and on (counts, depth,
discoveries, paths), lanes shipped falling with the sieve on, and
``sharded_bfs.comms.lanes_shipped``, ``sieve.killed`` and every
``rung_dispatch.<R>`` equal to the JAX run's; the JAX bench's multichip leg
(2pc-5 on 8 shards, ``frontier_per_device=64``, 2^14 rows) sieved through
the drain, equal to the JAX run. Also paxos (2 clients, 2 servers) wave at
a time, equal to the JAX sharded run. Everything compared is an integer or
a string: the tolerance is 0.
"""

import pytest
import torch

from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosModelCfg
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

from torch_sharded_parity import discard, jax_run, paths_replay, port_run

KW_2PC4 = dict(frontier_per_device=32, table_capacity_per_device=1 << 13)


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


def _results(summary):
    return {k: summary[k] for k in ("unique", "states", "depth", "discoveries", "paths")}


@pytest.mark.parametrize("mode", ["wave", "drain"])
def test_sieve_on_equals_jax_and_off(mode):
    kw = dict(KW_2PC4, **({"max_drain_waves": 1} if mode == "wave" else {}))
    _, want = jax_run(JaxTwoPhaseSys(4).checker(), 4, sieve=True, **kw)
    on, got = port_run(TwoPhaseSys(4).checker(), 4, sieve=True, **kw)
    _, off = port_run(TwoPhaseSys(4).checker(), 4, sieve=False, **kw)
    assert got == want
    assert got["unique"] == 1568
    assert _results(got) == _results(off)
    assert 0 < got["lanes_shipped"] < off["lanes_shipped"]
    assert 0 < got["killed"]
    # The compacted rungs ran below the full width.
    assert min(got["rungs"]) < max(off["rungs"])
    paths_replay(on)


def test_sieve_off_ledger_equals_jax():
    kw = dict(KW_2PC4, max_drain_waves=1)
    _, want = jax_run(JaxTwoPhaseSys(4).checker(), 4, sieve=False, **kw)
    _, got = port_run(TwoPhaseSys(4).checker(), 4, sieve=False, **kw)
    assert got == want
    assert got["killed"] == 0 and len(got["rungs"]) == 1


def test_multichip_leg_sieved_equals_jax():
    kw = dict(frontier_per_device=max(8, 512 // 8), table_capacity_per_device=1 << 14,
              sieve=True)
    _, want = jax_run(JaxTwoPhaseSys(5).checker(), 8, **kw)
    _, got = port_run(TwoPhaseSys(5).checker(), 8, **kw)
    assert got == want
    assert got["unique"] == 8832


def test_paxos_wave_at_a_time_equals_jax():
    kw = dict(frontier_per_device=16, table_capacity_per_device=1 << 12, max_drain_waves=1)
    _, want = jax_run(JaxPaxosModelCfg(2, 2).into_model().checker(), 4, **kw)
    port, got = port_run(PaxosModelCfg(2, 2).into_model().checker(), 4, **kw)
    assert got["unique"] == 111
    assert got == want
    assert set(got["discoveries"]) == {"value chosen"}
    paths_replay(port)
