"""The port's sharded BFS on its own, on the CPU: the deep drain, growth,
the mesh, the knobs and the entry points.

Through the deep drain, 2pc-3, 2pc-4 and 2pc-5 at n = 1, 2, 4 and 8 shards
count what the wave path counts (states, depth, discoveries; the paths
replay), and a run whose 2^8-row shard tables round up to one 2,048-row
tile grows them shard by shard. Also ``ShardMesh`` and ``default_mesh``,
``fleet=True`` raising ``NotImplementedError`` until the fleet ledger is
ported (ROADMAP Queue 1 #12), the JAX package's messages for the refusals
of the budget knobs, device liveness and the async pipeline (the
constructor's, each against the JAX checker's own) and of a checkpoint
resumed across the liveness mode, the smallest budget the checker
admits (``min_hbm_budget_mib``), the rung ladder against the JAX
package's, ``state_digest()``, and the entry points on ``cuda`` unless
the CPU is asked for.
"""

import pytest
import torch

from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.hashset_kernel import TILE_ROWS
from stateright_tpu_torch.parallel import AXIS, ShardMesh, default_mesh
from stateright_tpu_torch.parallel.sharded import ShardedGpuBfsChecker, comm_rungs
from stateright_tpu_torch.storage import max_table_rows_for_budget

from torch_sharded_parity import discard, paths_replay, port_run

# (frontier_per_device, table_capacity_per_device) a size.
KNOBS = {3: (64, 512), 4: (32, 1 << 13), 5: (64, 1 << 15)}


@pytest.fixture(scope="module", autouse=True)
def _drop_registries():
    yield
    discard()


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
def test_deep_drain_counts_equal_the_wave_path(rm, n):
    drained, got = port_run(TwoPhaseSys(rm).checker(), n, **_knobs(rm))
    _, wave = port_run(TwoPhaseSys(rm).checker(), n, max_drain_waves=1, **_knobs(rm))
    assert drained.drains >= 1
    for key in ("unique", "states", "depth"):
        assert got[key] == wave[key], key
    assert set(got["discoveries"]) == set(wave["discoveries"])
    paths_replay(drained)

def test_table_growth_and_rounding():
    # 2^8 rows a shard round up to one tile of the insert kernel, and the
    # run grows its tables, shard by shard, through the kernel's twin.
    checker, got = port_run(TwoPhaseSys(5).checker(), 2, frontier_per_device=256,
                            table_capacity_per_device=256, max_drain_waves=1)
    assert got["unique"] == 8832
    assert checker.table_growths >= 1
    assert checker.table_capacity_per_shard() > TILE_ROWS
    assert any("rounded 256 -> 2048" in note for note in checker.config_notes)

# Spawn settings the constructors refuse, each with the JAX checker's
# ValueError: (builder settings, spawn settings).
REFUSED = {
    "host_budget_without_hbm": ({}, dict(host_budget_mib=1.0)),
    "spill_dir_without_host_budget": ({}, dict(hbm_budget_mib=4.0, spill_dir="/nonexistent")),
    "budget_below_one_wave": ({}, dict(hbm_budget_mib=0.01)),
    "liveness_unknown_mode": ({}, dict(liveness="always")),
    "liveness_capped_run": (dict(target_max_depth=3), dict(liveness="device")),
    "liveness_under_symmetry": (dict(symmetry=True), dict(liveness="device")),
}


def _builder(jax, settings):
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    b = (JaxTwoPhaseSys if jax else TwoPhaseSys)(3).checker()
    if settings.get("target_max_depth"):
        b = b.target_max_depth(settings["target_max_depth"])
    if settings.get("symmetry"):
        b = b.symmetry()
    return b


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_keep_jax_messages(case):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    settings, spawn = REFUSED[case]
    with pytest.raises(ValueError) as want:
        _builder(True, settings).spawn_sharded_tpu_bfs(
            mesh=Mesh(np.array(jax.devices()[:2]), ("fp",)), frontier_per_device=32, **spawn)
    with pytest.raises(ValueError) as got:
        _builder(False, settings).spawn_sharded_gpu_bfs(
            mesh=default_mesh(2, device="cpu"), frontier_per_device=32, **spawn)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n, frontier", [(2, 32), (8, 8)])
def test_min_hbm_budget_is_the_least_admitted(n, frontier):
    # The smallest budget ``min_hbm_budget_mib`` names runs the check to its
    # end at that cap; a byte less is refused with the one-wave message.
    from stateright_tpu_torch.parallel.sharded import min_hbm_budget_mib

    model = TwoPhaseSys(4)
    budget = min_hbm_budget_mib(frontier, model.packed_action_count())
    with pytest.raises(ValueError, match="one wave"):
        model.checker().spawn_sharded_gpu_bfs(
            mesh=default_mesh(n, device="cpu"), frontier_per_device=frontier,
            hbm_budget_mib=budget - 1 / (1 << 20))
    checker, got = port_run(model.checker(), n, frontier_per_device=frontier,
                            hbm_budget_mib=budget)
    assert got["unique"] == 1568
    assert checker.table_capacity_per_shard() == max_table_rows_for_budget(budget)


@pytest.mark.parametrize("direction", ["live_payload_plain_resume",
                                       "plain_payload_live_resume"])
def test_resume_across_the_liveness_mode_is_refused(direction):
    # A liveness run's payload carries its edge store; resuming across the
    # mode would end with a truncated relation: the JAX messages.
    import torch_host_fixtures as tf

    live = direction == "live_payload_plain_resume"
    cut = tf.PackedDGraph([0, 2, 4, 2], [0, 6], [6, 8, 10, 6]).checker()
    cut = cut.spawn_sharded_gpu_bfs(mesh=default_mesh(2, device="cpu"), frontier_per_device=1,
                                    liveness="device" if live else None)
    cut.request_preempt()
    cut.join()
    payload = cut.preempt_payload() or cut.checkpoint_payload([])
    assert ("liveness" in payload) == live
    resumed = tf.PackedDGraph([0, 2, 4, 2], [0, 6], [6, 8, 10, 6]).checker().spawn_sharded_gpu_bfs(
        mesh=default_mesh(2, device="cpu"), frontier_per_device=1, resume_from=payload,
        liveness=None if live else "device")
    with pytest.raises(RuntimeError):
        resumed.join()
    err = resumed.worker_error()
    want = ("checkpoint carries a liveness edge store" if live
            else "liveness='device' cannot resume a checkpoint written without it")
    assert isinstance(err, ValueError) and str(err).startswith(want), err

def test_fleet_is_off_and_refused_until_ported():
    with pytest.raises(NotImplementedError, match="#12"):
        TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
            mesh=default_mesh(2, device="cpu"), fleet=True)

def test_async_pipeline_refusals_keep_jax_messages():
    with pytest.raises(ValueError, match="incompatible with a visitor"):
        TwoPhaseSys(3).checker().visitor(lambda m, p: None).spawn_sharded_gpu_bfs(
            mesh=default_mesh(2, device="cpu"), async_pipeline=True)
    two = ShardMesh(n=8, local=4, rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="single-controller only"):
        TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(mesh=two, async_pipeline=True)

def test_mesh_layout():
    m = default_mesh(4, device="cpu")
    assert (m.n, m.local, m.rank, m.world) == (4, 4, 0, 1) and AXIS == "fp"
    assert not m.distributed and list(m.shards) == [0, 1, 2, 3]
    # Global shard d = rank * local + j: the JAX mesh's process-major order.
    two = ShardMesh(n=8, local=4, rank=1, world=2, device=torch.device("cpu"))
    assert list(two.shards) == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        ShardMesh(n=6, local=4, world=2)
    # The CPU has one device: the default mesh has one shard.
    assert default_mesh(device="cpu").n == 1

def test_entry_points_run_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert default_mesh().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        default_mesh()
    with pytest.raises(RuntimeError):
        TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs()
    assert isinstance(
        TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(device="cpu").join(),
        ShardedGpuBfsChecker)

def test_shard_mesh_without_a_device_is_not_on_the_cpu():
    if torch.cuda.is_available():
        assert ShardMesh(n=8, local=8).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardMesh(n=8, local=8)
    m = ShardMesh(n=2, local=2, device="cpu")
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="disagrees"):
        TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(mesh=m, device="cuda")

def test_comm_rungs_match_jax():
    from stateright_tpu.parallel.sharded import ShardedTpuBfsChecker

    for m in (1, 8, 9, 100, 544, 43008):
        assert comm_rungs(m) == ShardedTpuBfsChecker._comm_rungs(None, m)

def test_state_digest_declares_the_engine():
    checker, _ = port_run(TwoPhaseSys(3).checker(), 2, frontier_per_device=32, sieve=True)
    d = checker.state_digest()
    assert d["wave_kernel"] == "staged" and d["sieve"] is True and d["shards"] == 2
    assert d["comm_sieve"]["cache_slots"] > 0 and d["comm_sieve"]["bloom_bits"] > 0
    assert d["unique_state_count"] == 288 and d["done"]
