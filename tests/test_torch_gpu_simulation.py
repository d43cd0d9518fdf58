"""The port's GPU random-walk checker (``spawn_gpu_simulation``,
``checker/gpu_simulation.py``) on the CPU: the counterparts of the JAX
package's ``tests/test_tpu_simulation.py``, and exact parity with its
``spawn_tpu_simulation`` (the same discoveries, counts, depth and trace
overflows for the same seed and knobs)."""

import io

import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch import FnModel
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.report import WriteReporter

MODEL = TwoPhaseSys(3)
JAX_MODEL = JaxTwoPhaseSys(3)


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


def _sim(target, seed, max_depth=None, **kw):
    b = MODEL.checker().target_state_count(target)
    if max_depth is not None:
        b = b.target_max_depth(max_depth)
    ck = b.spawn_gpu_simulation(seed=seed, device="cpu", **kw).join()
    assert ck.worker_error() is None
    return ck


def test_gpu_simulation_finds_sometimes_properties():
    # 2pc's holding "consistent" can never be discovered, so (as in the
    # reference) simulation samples until the target.
    ck = _sim(50_000, 7, lanes=128, steps_per_call=32)
    paths = ck.discoveries()
    assert "abort agreement" in paths and "commit agreement" in paths


def test_gpu_simulation_respects_target_state_count():
    ck = _sim(5_000, 3, lanes=64, steps_per_call=16)
    assert ck.state_count() >= 1
    assert ck.unique_state_count() == ck.state_count()


def test_gpu_simulation_discovery_paths_replay():
    ck = _sim(20_000, 11, lanes=256, steps_per_call=32)
    for name, path in ck.discoveries().items():
        final = path.last_state()
        if name == "abort agreement":
            assert all(s == "Aborted" for s in final.rm_state)
        if name == "commit agreement":
            assert all(s == "Committed" for s in final.rm_state)


def test_gpu_simulation_max_depth_cap():
    ck = _sim(2_000, 5, max_depth=4, lanes=64, steps_per_call=16)
    assert ck.max_depth() <= 4


def test_gpu_simulation_trace_overflow_counted_and_reported():
    ck = _sim(5_000, 3, lanes=64, steps_per_call=16, max_trace_len=4)
    assert ck._trace_overflows > 0
    assert ck.metrics().snapshot().get("swarm.trace_overflow", 0) > 0
    out = io.StringIO()
    ck.report(WriteReporter(out))
    assert "truncated at the trace buffer" in out.getvalue()


def test_gpu_simulation_depth_cap_is_not_overflow():
    # An explicit target_max_depth is the buffer bound: a semantic choice,
    # not truncation.
    ck = _sim(2_000, 5, max_depth=4, lanes=64, steps_per_call=16)
    assert ck._trace_overflows == 0


def test_gpu_simulation_rejects_symmetry():
    with pytest.raises(NotImplementedError):
        MODEL.checker().symmetry().spawn_gpu_simulation(seed=1, device="cpu")


def test_gpu_simulation_rejects_non_batchable():
    def fn(prev, out):
        if prev is None:
            out.append(0)
        elif prev < 3:
            out.append(prev + 1)

    with pytest.raises(TypeError):
        FnModel(fn).checker().spawn_gpu_simulation(seed=1, device="cpu")


def test_gpu_simulation_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="spawn_gpu_simulation runs on a CUDA device"):
        MODEL.checker().target_state_count(100).spawn_gpu_simulation(seed=1)


# name: (target, max depth, seed, knobs)
PARITY = {
    "2pc3_seed7": (50_000, None, 7, dict(lanes=128, steps_per_call=32)),
    "2pc3_seed11": (20_000, None, 11, dict(lanes=256, steps_per_call=32)),
    "2pc3_overflow": (5_000, None, 3, dict(lanes=64, steps_per_call=16, max_trace_len=4)),
    "2pc3_depth_cap": (2_000, 4, 5, dict(lanes=64, steps_per_call=16)),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_gpu_simulation_equals_jax(name):
    target, max_depth, seed, kw = PARITY[name]
    b = JAX_MODEL.checker().target_state_count(target)
    if max_depth is not None:
        b = b.target_max_depth(max_depth)
    want = b.spawn_tpu_simulation(seed=seed, **kw).join()
    got = _sim(target, seed, max_depth, **kw)
    assert (got.state_count(), got.max_depth(), got._trace_overflows,
            got._discoveries_fps) == (want.state_count(), want.max_depth(),
                                      want._trace_overflows, want._discoveries_fps)
