"""The port's sharded BFS across two processes, over gloo on the CPU.

Two processes (``tests/torch_multiprocess_child.py``, which imports only
the port), each holding 4 shards, join one 8-shard mesh through
``bootstrap_mesh`` and run the same host loop: exchanges through
``all_to_all_single``, host reads through ``all_gather_into_tensor``, the
drain's vote through one ``all_reduce`` a wave. 2pc-3 plain and with the
sieve: both ranks print the same results, equal field for field (counts,
depth, discoveries, paths, lanes shipped, rungs) to the one-process
8-shard run. A checkpoint that the two processes write (process 0 writes
the file) resumes in one process on 8 and on 4 shards. Each child runs
under its own timeout, so a hang fails.
"""

import itertools
import json
import os
import socket
import subprocess
import sys

import pytest

from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.parallel.sharded import run_summary
from stateright_tpu_torch.telemetry import discard_run_registry, run_registries

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multiprocess_child.py")
CHILD_TIMEOUT_S = 120
_ids = itertools.count()


@pytest.fixture(scope="module", autouse=True)
def _drop_registries():
    yield
    for run_id in list(run_registries()):
        if run_id.startswith("tmp-"):
            discard_run_registry(run_id)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(mode, *extra):
    """Runs both ranks; returns each one's JSON results."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    procs = [subprocess.Popen([sys.executable, CHILD, str(r), port, mode, *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        line = [x for x in out.splitlines() if x.startswith("SHARDED-RESULT ")]
        assert line, out[-3000:]
        results.append(json.loads(line[-1][len("SHARDED-RESULT "):]))
    return results


def _one_process(sieve):
    checker = TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
        mesh=default_mesh(8, device="cpu"), frontier_per_device=32,
        table_capacity_per_device=512, sieve=sieve, run_id=f"tmp-one-{next(_ids)}").join()
    return json.loads(json.dumps(run_summary(checker)))


@pytest.mark.parametrize("mode", ["plain", "sieve"])
def test_two_processes_equal_one(mode):
    ranks = _two_ranks(mode)
    assert ranks[0] == ranks[1]
    assert ranks[0] == _one_process(mode == "sieve")
    assert ranks[0]["unique"] == 288


def test_sieve_ships_fewer_lanes_across_processes():
    plain, sieved = _one_process(False), _one_process(True)
    assert {k: plain[k] for k in ("unique", "states", "depth", "paths")} == \
        {k: sieved[k] for k in ("unique", "states", "depth", "paths")}
    assert sieved["lanes_shipped"] < plain["lanes_shipped"]


@pytest.mark.parametrize("n", [8, 4])
def test_checkpoint_of_two_processes_resumes_in_one(tmp_path, n):
    path = str(tmp_path / "two.ckpt")
    ranks = _two_ranks("checkpoint", path)
    assert ranks[0] == ranks[1] and ranks[0]["unique"] < 288
    resumed = TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
        mesh=default_mesh(n, device="cpu"), frontier_per_device=32,
        table_capacity_per_device=512, resume_from=path).join()
    assert resumed.unique_state_count() == 288
    resumed.assert_properties()


def test_one_rank_group_equals_the_one_process_mesh():
    """A group of one process (the path ``chip_smoke.py`` takes over NCCL on
    one card) goes through the collectives and equals the mesh without
    them; a second initialization is a no-op."""
    import torch.distributed as dist

    from stateright_tpu_torch.parallel import bootstrap_mesh, initialize_distributed

    mesh = bootstrap_mesh(8, device="cpu", init_method=f"tcp://localhost:{_free_port()}",
                          world_size=1, rank=0, timeout_s=60)
    try:
        assert mesh.distributed and (mesh.n, mesh.local, mesh.world) == (8, 8, 1)
        assert initialize_distributed(device="cpu") is False
        checker = TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
            mesh=mesh, frontier_per_device=32, table_capacity_per_device=512,
            run_id="tmp-one-rank").join()
        got = json.loads(json.dumps(run_summary(checker)))
    finally:
        dist.destroy_process_group()
    assert got == _one_process(False)
