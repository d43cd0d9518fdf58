"""The port's fingerprint-sharded BFS (``parallel/sharded.py``) against the
JAX package's, on the CPU.

A port mesh of ``n`` shards in one process against ``spawn_sharded_tpu_bfs``
on a JAX mesh of the same ``n`` virtual devices, at the same
``frontier_per_device``: 2pc-3, 2pc-4 and 2pc-5 (288, 1,568 and 8,832
states) at n = 1, 2, 4 and 8, wave at a time, equal in counts, depth,
discoveries, every discovery's path (fingerprint for fingerprint) and the
exchange's lanes shipped and rungs; and the JAX package's
``wave_kernel="fused"`` refusal. The tables are sized so that the JAX wave
path never grows: its compiled-wave cache is keyed on the shard count, not
the capacity, so a growth there stops the JAX run
(``test_torch_sharded_mesh.py`` holds the port's own growth, drain and
mesh). Everything compared is an integer or a string: the tolerance is 0.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import default_mesh

from torch_sharded_parity import discard, jax_run, paths_replay, port_run

UNIQUE = {3: 288, 4: 1568, 5: 8832}
# (frontier_per_device, table_capacity_per_device) a size.
KNOBS = {3: (64, 512), 4: (32, 1 << 13), 5: (64, 1 << 15)}


@pytest.fixture(scope="module", autouse=True)
def _fresh_registries():
    """The JAX runs here record into run registries (``tsh-``), and the
    JAX package's own tests read its process-wide registry exactly: drop
    the run registries and leave that one empty."""
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


def _knobs(rm):
    f, cap = KNOBS[rm]
    return dict(frontier_per_device=f, table_capacity_per_device=cap)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("rm", [3, 4, 5])
def test_wave_at_a_time_equals_jax(rm, n):
    kw = dict(_knobs(rm), max_drain_waves=1)
    _, want = jax_run(JaxTwoPhaseSys(rm).checker(), n, **kw)
    port, got = port_run(TwoPhaseSys(rm).checker(), n, **kw)
    assert got["unique"] == UNIQUE[rm]
    assert got == want
    assert set(got["discoveries"]) == {"abort agreement", "commit agreement"}
    paths_replay(port)
    port.assert_properties()


def test_fused_wave_kernel_refused_as_in_jax():
    with pytest.raises(ValueError, match="no sharded path") as jax_err:
        JaxTwoPhaseSys(3).checker().spawn_sharded_tpu_bfs(
            mesh=Mesh(np.array(jax.devices()[:4]), ("fp",)), frontier_per_device=32,
            wave_kernel="fused")
    with pytest.raises(ValueError, match="no sharded path") as port_err:
        TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
            mesh=default_mesh(4, device="cpu"), frontier_per_device=32, wave_kernel="fused")
    assert str(port_err.value) == str(jax_err.value)
