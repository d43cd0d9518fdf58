"""The port's sharded BFS on symmetry and the actor models, against the JAX
package, on the CPU.

- Symmetry (``test_device_symmetry.py``'s sharded case): 2pc-5 under
  ``.symmetry()`` on 8 shards, 314 orbits, the visited keys the orbit keys
  of ``checker/symmetry.py``, equal to the JAX sharded run in counts,
  depth, discoveries and paths.
- An ``eventually`` counterexample through the drain: raft with 3 servers,
  ``max_term=1``, lossy (665 states, "stable leader" a terminal leaderless
  schedule), equal to the JAX sharded run, its paths replayed.
- ABD (``test_comm_sieve.py``'s ``expand_fps`` cases): the sieved sharded
  run of the port against the JAX single-device checker with the
  fingerprint-only expansion on and off (the sharded wave always makes
  the candidates): 544 states, the same depth and discoveries.

Everything compared is an integer or a string: the tolerance is 0.
"""

import pytest
import torch

from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.raft import LEADER, RaftModelCfg
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


def test_symmetry_2pc5_equals_jax():
    kw = dict(frontier_per_device=64, table_capacity_per_device=1 << 10)
    _, want = jax_run(JaxTwoPhaseSys(5).checker().symmetry(), 8, **kw)
    port, got = port_run(TwoPhaseSys(5).checker().symmetry(), 8, **kw)
    assert got["unique"] == 314
    assert got == want
    # The key log holds the claimed orbit keys, one a unique state.
    assert sum(len(k) for k in port._key_log) >= 314
    paths_replay(port)
    port.assert_properties()


def test_raft_eventually_counterexample_equals_jax():
    kw = dict(frontier_per_device=64, table_capacity_per_device=1 << 10)
    cfg = dict(server_count=3, max_term=1, lossy=True)
    _, want = jax_run(JaxRaftModelCfg(**cfg).into_model().checker(), 8, **kw)
    port, got = port_run(RaftModelCfg(**cfg).into_model().checker(), 8, **kw)
    assert got["unique"] == 665
    assert got == want
    paths = port.discoveries()
    assert set(paths) == {"leader elected", "stable leader"}
    assert any(s.role == LEADER for s in paths["leader elected"].last_state().actor_states)
    assert not any(s.role == LEADER for s in paths["stable leader"].last_state().actor_states)


@pytest.mark.parametrize("fps", [True, False])
def test_abd_sieved_equals_jax_single_device(fps):
    single = (JaxAbdModelCfg(2, 2).into_model().checker()
              .spawn_tpu_bfs(frontier_capacity=8, table_capacity=1 << 12, expand_fps=fps)
              .join())
    port, got = port_run(AbdModelCfg(2, 2).into_model().checker(), 4, sieve=True,
                         frontier_per_device=16, table_capacity_per_device=1 << 12)
    assert got["unique"] == single.unique_state_count() == 544
    assert got["depth"] == single.max_depth()
    assert set(got["discoveries"]) == set(single.discoveries())
    paths_replay(port)
