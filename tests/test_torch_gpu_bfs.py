"""The port's GPU checker (on the CPU) against the JAX package's checker.

``spawn_gpu_bfs(device="cpu", max_drain_waves=1)`` runs the port's wave
path with the plain twin of the insert kernel; the JAX side runs
``spawn_tpu_bfs`` with the Pallas insert (interpret mode), the staged
sort-dedup wave and one wave per host exit. The deep drain is held to the
JAX drain in ``test_torch_deep_drain.py``. Counts, depths, discoveries, discovery paths and the
reporter's golden lines must be equal. The ``Chain`` fixture's semantics
(depth cap, boundary, ``eventually``) are held to the JAX host BFS.
"""

import io
import re
import subprocess
import sys

import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.core.visitor import PathRecorder
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.testing import Chain

from test_tpu_bfs import Chain as JaxChain

ABORT_PATH = {
    n: [("TmAbort",)] + [("RmRcvAbortMsg", i) for i in range(n)] for n in (3, 5)
}


def jax_run(n, frontier, table):
    return (
        JaxTwoPhaseSys(n)
        .checker()
        .spawn_tpu_bfs(
            frontier_capacity=frontier, table_capacity=table,
            hashset_impl="pallas", max_drain_waves=1,
        )
        .join()
    )


def port_run(n, frontier, table):
    return (
        TwoPhaseSys(n)
        .checker()
        .spawn_gpu_bfs(
            wave_kernel="staged", frontier_capacity=frontier, table_capacity=table, device="cpu",
            max_drain_waves=1,
        )
        .join()
    )


@pytest.fixture(
    scope="module",
    params=[(3, 64, 2048), (4, 64, 2048), (5, 1024, 16384)],
    ids=["2pc3", "2pc4", "2pc5"],
)
def pair(request):
    n, frontier, table = request.param
    return n, jax_run(n, frontier, table), port_run(n, frontier, table)


def test_counts_and_depth(pair):
    n, jc, tc = pair
    assert tc.worker_error() is None
    assert tc.unique_state_count() == jc.unique_state_count() == {3: 288, 4: 1568, 5: 8832}[n]
    assert tc.state_count() == jc.state_count()
    assert tc.max_depth() == jc.max_depth()
    tc.assert_properties()


def test_discovery_paths(pair):
    n, jc, tc = pair
    jd, td = jc.discoveries(), tc.discoveries()
    assert set(jd) == set(td) == {"abort agreement", "commit agreement"}
    for name in jd:
        assert td[name].into_actions() == jd[name].into_actions(), name
        assert td[name].encode() == jd[name].encode(), name
    if n in ABORT_PATH:
        tc.assert_discovery("abort agreement", ABORT_PATH[n])


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


def test_golden_reporter_lines(pair):
    _n, jc, tc = pair
    golden = _golden(jc, JaxWriteReporter)
    assert golden.startswith("Done. states=")
    assert _golden(tc, WriteReporter) == golden


def test_table_grows_from_small_start(pair):
    """From a small table the port grows (doubling + rehash through the
    insert) on the same schedule as the reference, and the counts above
    still match exactly."""
    _n, jc, tc = pair
    assert tc.table_growths >= 1
    assert tc.table_capacity() == jc._capacity


def test_frontier_split_into_many_chunks():
    """A frontier of 8 lanes splits every BFS level into many chunks, which
    changes parents and paths; the port splits exactly as the JAX package
    does, so the paths still agree."""
    jc = jax_run(3, 8, 2048)
    tc = port_run(3, 8, 2048)
    assert tc.unique_state_count() == jc.unique_state_count() == 288
    assert tc.state_count() == jc.state_count()
    for name, path in jc.discoveries().items():
        assert tc.discoveries()[name].into_actions() == path.into_actions()


def _host(model, **caps):
    b = model.checker()
    if "depth" in caps:
        b = b.target_max_depth(caps["depth"])
    return b.spawn_bfs().join()


def _port(model, **caps):
    b = model.checker()
    if "depth" in caps:
        b = b.target_max_depth(caps["depth"])
    return b.spawn_gpu_bfs(device="cpu").join()


@pytest.mark.parametrize(
    "args,caps",
    [
        ((5, 5, None), {}),  # eventually satisfied
        ((5, 7, None), {}),  # eventually counterexample at the terminal
        ((10, None, None), {"depth": 3}),
        ((10, None, 4), {}),  # within_boundary
    ],
    ids=["eventually_met", "eventually_cex", "target_max_depth", "boundary"],
)
def test_chain_semantics_match_jax_host_bfs(args, caps):
    host = _host(JaxChain(*args), **caps)
    port = _port(Chain(*args), **caps)
    assert port.unique_state_count() == host.unique_state_count()
    assert port.state_count() == host.state_count()
    assert port.max_depth() == host.max_depth()
    hd, pd = host.discoveries(), port.discoveries()
    assert set(pd) == set(hd)
    for name in hd:
        assert pd[name].into_states() == hd[name].into_states()


def test_chain_visitor_paths_match_jax_host_bfs():
    from stateright_tpu.core.visitor import PathRecorder as JaxPathRecorder

    jrec, trec = JaxPathRecorder(), PathRecorder()
    JaxChain(4).checker().visitor(jrec).spawn_bfs().join()
    port = Chain(4).checker().visitor(trec).spawn_gpu_bfs(device="cpu").join()
    assert port.drains == 0  # a visitor keeps the run on the wave path
    as_tuples = lambda rec: {tuple(p.into_vec()) for p in rec.paths}  # noqa: E731
    assert as_tuples(trec) == as_tuples(jrec)
    assert len(trec.paths) == 5


def test_port_host_bfs_matches_gpu_path():
    """The port's own host oracle agrees with its GPU checker."""
    host = TwoPhaseSys(3).checker().spawn_bfs().join()
    gpu = port_run(3, 64, 2048)
    assert host.unique_state_count() == gpu.unique_state_count() == 288
    assert host.state_count() == gpu.state_count()
    assert set(host.discoveries()) == set(gpu.discoveries())


def test_target_state_count_stops_early():
    checker = (
        TwoPhaseSys(4).checker().target_state_count(100)
        .spawn_gpu_bfs(frontier_capacity=16, table_capacity=2048, device="cpu")
        .join()
    )
    assert 100 <= checker.state_count() < 8258
    assert checker.drains == 0  # a target count keeps the run on the wave path


def test_cpu_run_launches_no_kernel():
    before = hk.launches
    port_run(3, 64, 2048)
    assert hk.launches == before


def test_spawn_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cuda")


def test_spawn_refusals():
    from stateright_tpu_torch.core.model import FnModel

    with pytest.raises(ValueError, match="multiple of 2048"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(
            wave_kernel="staged", table_capacity=3000, device="cpu")
    with pytest.raises(ValueError, match="multiple of 2048"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(
            wave_kernel="staged", table_capacity=1024, device="cpu")
    model = FnModel(lambda s, out: out.append(0) if s is None else None)
    with pytest.raises(TypeError, match="BatchableModel"):
        model.checker().spawn_gpu_bfs(device="cpu")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import stateright_tpu_torch\n"
        "import stateright_tpu_torch.checker.gpu\n"
        "import stateright_tpu_torch.checker.bfs\n"
        "import stateright_tpu_torch.interop\n"
        "import stateright_tpu_torch.testing\n"
        "import stateright_tpu_torch.models.two_phase_commit\n"
        "import stateright_tpu_torch.ops.hashset_kernel\n"
        "import stateright_tpu_torch.ops.ring\n"
        "import stateright_tpu_torch.checker.job_market\n"
        "import stateright_tpu_torch.checker.liveness\n"
        "import stateright_tpu_torch.checker.dfs\n"
        "import stateright_tpu_torch.checker.on_demand\n"
        "import stateright_tpu_torch.checker.simulation\n"
        "import stateright_tpu_torch.checker.explorer\n"
        "import stateright_tpu_torch.telemetry.instruments\n"
        "import stateright_tpu_torch.semantics.write_once_register\n"
        "import stateright_tpu_torch.actor.write_once_register\n"
        "import stateright_tpu_torch.actor.ordered_reliable_link\n"
        "import stateright_tpu_torch.actor.wire\n"
        "import stateright_tpu_torch.actor.spawn\n"
        "import stateright_tpu_torch.models.timers\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'stateright_tpu' or m.startswith('stateright_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
