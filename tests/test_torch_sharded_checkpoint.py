"""Checkpoints, preemption and resume of the port's sharded BFS, on the CPU.

A run of ``spawn_sharded_gpu_bfs`` stopped by ``target_state_count`` with a
checkpoint every chunk resumes to the full space (2pc-4, 1,568 states), its
paths replaying through the restored parent map, with the sieve off and on
(the sieve starts cold on resume) and on another shard count (8 shards to
4 and 2: keys re-route by ``hi % n``), as the JAX package's
``test_checkpoint.py:79-170`` does; the payload's kind is
``"sharded_gpu_bfs"``, and a JAX sharded payload, a solo ``gpu_bfs``
payload and another model's payload are refused with the JAX package's
messages, as is a sharded payload given to ``spawn_gpu_bfs``. A run
preempted at a drain or wave boundary (``request_preempt()`` from the
worker, so the boundary is deterministic) resumes from its payload to the
uninterrupted run's counts and discoveries (``test_preempt_resume.py:235``),
wave at a time bit-identically, paths included. The JAX runs here are
the uninterrupted references' twins: their counts equal the port's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.parallel.sharded import CHECKPOINT_KIND, ShardedGpuBfsChecker

from torch_sharded_parity import discard, jax_run, paths_replay, port_run

KW = dict(frontier_per_device=32, table_capacity_per_device=512)


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


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted 2pc-4 run on 8 shards, and the JAX package's."""
    _, jax_ref = jax_run(JaxTwoPhaseSys(4).checker(), 8, **KW)
    _, ref = port_run(TwoPhaseSys(4).checker(), 8, **KW)
    assert ref == jax_ref and ref["unique"] == 1568
    return ref


def _results(s):
    return {k: s[k] for k in ("unique", "states", "depth", "discoveries", "paths")}


def _checkpointed(path, rm=4, n=8, **kw):
    checker, _ = port_run(TwoPhaseSys(rm).checker().target_state_count(500), n,
                          checkpoint_path=str(path), checkpoint_every_chunks=1, **KW, **kw)
    assert path.exists() and checker.checkpoints_written >= 1
    return checker


@pytest.mark.parametrize("sieve", [False, True])
def test_resume_completes_the_space(tmp_path, reference, sieve):
    ckpt = tmp_path / "2pc4.ckpt"
    first = _checkpointed(ckpt, sieve=sieve)
    assert first.unique_state_count() < 1568
    resumed, got = port_run(TwoPhaseSys(4).checker(), 8, resume_from=str(ckpt), sieve=sieve,
                            **KW)
    assert got["unique"] == 1568
    assert set(got["discoveries"]) == set(reference["discoveries"])
    paths_replay(resumed)
    resumed.assert_properties()
    import pickle

    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    assert payload["kind"] == CHECKPOINT_KIND and payload["n_shards"] == 8


@pytest.mark.parametrize("n", [4, 2])
def test_resume_on_another_shard_count(tmp_path, n):
    ckpt = tmp_path / "elastic.ckpt"
    _checkpointed(ckpt, n=8)
    resumed, got = port_run(TwoPhaseSys(4).checker(), n, resume_from=str(ckpt), **KW)
    assert got["unique"] == 1568
    resumed.assert_properties()


def _refused(checker, match):
    with pytest.raises(RuntimeError):
        checker.join()
    err = checker.worker_error()
    assert isinstance(err, ValueError) and match in str(err), err
    return str(err)


def test_refuses_a_jax_sharded_payload(tmp_path):
    ckpt = tmp_path / "jax.ckpt"
    JaxTwoPhaseSys(3).checker().target_state_count(50).spawn_sharded_tpu_bfs(
        mesh=Mesh(np.array(jax.devices()[:8]), ("fp",)), checkpoint_path=str(ckpt),
        checkpoint_every_chunks=1, run_id="tsh-jax-ckpt", **KW).join()
    assert ckpt.exists()
    msg = _refused(TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
        mesh=default_mesh(8, device="cpu"), resume_from=str(ckpt), **KW), "kind")
    assert "'sharded'" in msg


def test_refuses_a_solo_payload_and_the_solo_checker_refuses_a_sharded_one(tmp_path):
    solo = tmp_path / "solo.ckpt"
    TwoPhaseSys(3).checker().target_state_count(50).spawn_gpu_bfs(
        device="cpu", frontier_capacity=64, checkpoint_path=str(solo),
        checkpoint_every_chunks=1).join()
    msg = _refused(TwoPhaseSys(3).checker().spawn_sharded_gpu_bfs(
        mesh=default_mesh(8, device="cpu"), resume_from=str(solo), **KW), "kind")
    # The JAX package's hint, for the port's own solo payload.
    assert "do not carry the frontier pool this restore needs" in msg
    sharded = tmp_path / "sharded.ckpt"
    _checkpointed(sharded, rm=3)
    _refused(TwoPhaseSys(3).checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=64, resume_from=str(sharded)), "kind")


def test_refuses_another_model(tmp_path):
    ckpt = tmp_path / "2pc3.ckpt"
    _checkpointed(ckpt, rm=3)
    _refused(TwoPhaseSys(4).checker().spawn_sharded_gpu_bfs(
        mesh=default_mesh(8, device="cpu"), resume_from=str(ckpt), **KW),
        "differently-configured")


class _PreemptAfter(ShardedGpuBfsChecker):
    """Asks for preemption from the worker after its second drain, or its
    fourth wave, so the boundary does not depend on timing."""

    def _drain(self, *a, **kw):
        res = super()._drain(*a, **kw)
        if self.drains >= 2:
            self.request_preempt()
        return res

    def _call_wave(self, *a, **kw):
        out = super()._call_wave(*a, **kw)
        if self.waves >= 4 and self.drains == 0:
            self.request_preempt()
        return out


@pytest.mark.parametrize("mode", ["drain", "wave"])
def test_preempt_resume_is_bit_identical(reference, mode):
    kw = dict(KW, max_drain_waves=2 if mode == "drain" else 1)
    _, whole = port_run(TwoPhaseSys(4).checker(), 8, **kw)
    first = _PreemptAfter(TwoPhaseSys(4).checker(), mesh=default_mesh(8, device="cpu"),
                          run_id="tsh-preempted", **kw).join()
    assert first.preempted and first.unique_state_count() < 1568
    assert first.preempt_payload()["kind"] == CHECKPOINT_KIND
    resumed, got = port_run(TwoPhaseSys(4).checker(), 8,
                            resume_from=first.preempt_payload(), **kw)
    same = ("unique", "states", "discoveries")
    assert {k: got[k] for k in same} == {k: whole[k] for k in same}
    assert {k: got[k] for k in same} == {k: reference[k] for k in same}
    if mode == "wave":
        # Wave at a time the pool is the whole frontier, in order: the paths
        # too are the uninterrupted run's. A drain's rings go back through
        # the pool's round-robin deal, so its paths and depth labels may
        # differ (as in the JAX package, whose test compares the above).
        assert _results(got) == _results(whole)
    resumed.assert_properties()
