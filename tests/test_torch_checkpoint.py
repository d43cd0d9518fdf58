"""Checkpoint and resume of the port's GPU checker (on the CPU) against the
JAX package's ``TpuBfsChecker``.

Mirrors the JAX package's ``tests/test_checkpoint.py``. Cut by
``target_state_count`` with a checkpoint every few chunks, wave at a time,
the port's last checkpoint equals the JAX package's (its staged wave with
the XLA insert and ``wave_dedup="sort"``) in every field that does not
depend on the package's layout: the counters, the discoveries, the
(child, parent) pairs and the pending frontier's live-lane fingerprints in
order (the JAX chunks are padded to ``frontier_capacity`` with a mask, the
port's hold live lanes only; under symmetry also the claimed keys). The
resumed run completes the space, checkpoints of another kind, model,
configuration or format version are refused, and a failed write leaves
the previous checkpoint whole and resumable. Everything compared is an
integer: the tolerance is 0.
"""

import io
import os
import pickle
import re
import shutil

import numpy as np
import pytest

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker import gpu
from stateright_tpu_torch.checker.gpu import (
    GpuBfsChecker,
    checkpoint_header,
    validate_checkpoint_header,
)
from stateright_tpu_torch.checker.symmetry import CUSTOM_REP_SCHEME, SYM_KEY_SCHEME
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.utils.faults import CheckpointWriteFault, FaultSpec, inject


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """The JAX runs here count into the JAX package's process-wide metrics
    registry, some of whose counters that package's own tests read
    exactly: leave the registry empty, as a fresh process has it."""
    yield
    jax_metrics_registry().reset()


SPAWN = dict(frontier_capacity=16, table_capacity=1 << 12, max_drain_waves=1)

# name: (n, symmetry, target_state_count, checkpoint_every_chunks)
CUTS = {
    "2pc3": (3, False, 600, 2),
    "2pc4": (4, False, 3000, 3),
    "2pc4_symmetry": (4, True, 400, 2),
}


def _golden(checker):
    out = io.StringIO()
    checker.report(WriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


def _builder(model, symmetry, target=None):
    b = model.checker()
    if symmetry:
        b = b.symmetry()
    if target is not None:
        b = b.target_state_count(target)
    return b


@pytest.fixture(scope="module")
def jax_cuts(tmp_path_factory):
    """The JAX package's last checkpoint at each cut, read once."""
    out = {}
    for name, (n, sym, target, every) in CUTS.items():
        path = tmp_path_factory.mktemp("jax") / f"{name}.ckpt"
        checker = _builder(JaxTwoPhaseSys(n), sym, target).spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", checkpoint_path=str(path),
            checkpoint_every_chunks=every, **SPAWN).join()
        assert checker.worker_error() is None
        out[name] = pickle.loads(path.read_bytes())
    return out


def _port_cut(name, wave_kernel, path):
    n, sym, target, every = CUTS[name]
    checker = _builder(TwoPhaseSys(n), sym, target).spawn_gpu_bfs(
        device="cpu", wave_kernel=wave_kernel, checkpoint_path=str(path),
        checkpoint_every_chunks=every, **SPAWN).join()
    assert checker.checkpoints_written > 0 and checker.checkpoint_bytes > 0
    return checker, pickle.loads(path.read_bytes())


def _pairs(payload):
    order = np.argsort(payload["children"])
    return payload["children"][order], payload["parents"][order]


def _pending(chunks):
    """The live lanes' fingerprints, in queue order."""
    out = [np.zeros(0, np.uint64)]
    for c in chunks:
        hi = np.asarray(c["hi"]).astype(np.uint64)
        lo = np.asarray(c["lo"]).astype(np.uint64)
        if "mask" in c:
            mask = np.asarray(c["mask"])
            hi, lo = hi[mask], lo[mask]
        out.append((hi << np.uint64(32)) | lo)
    return np.concatenate(out)


# Symmetry runs on the staged engine only.
@pytest.mark.parametrize("name, wave_kernel", [
    (name, engine) for name in CUTS for engine in ("staged", "fused")
    if not (CUTS[name][1] and engine == "fused")
])
def test_payload_at_a_cut_equals_jax(jax_cuts, tmp_path, name, wave_kernel):
    _, ours = _port_cut(name, wave_kernel, tmp_path / "port.ckpt")
    theirs = jax_cuts[name]
    assert ours["version"] == 2 and ours["kind"] == "gpu_bfs"
    assert theirs["kind"] == "tpu_bfs"
    for k in ("state_count", "unique_count", "max_depth", "discoveries", "symmetry",
              "sym_scheme", "fp_scheme"):
        assert ours[k] == theirs[k], k
    for a, b in zip(_pairs(ours), _pairs(theirs)):
        assert np.array_equal(a, b)
    assert np.array_equal(_pending(ours["chunks"]), _pending(theirs["chunks"]))
    assert all(c["hi"].shape[0] > 0 for c in ours["chunks"])
    if CUTS[name][1]:
        assert np.array_equal(np.sort(ours["keys"]), np.sort(theirs["keys"]))
    assert "storage" not in ours


@pytest.mark.parametrize("name", ["2pc4", "2pc4_symmetry"])
def test_resume_completes_the_space(tmp_path, name):
    n, sym = CUTS[name][:2]
    first, _ = _port_cut(name, "staged", tmp_path / "cut.ckpt")
    whole = _builder(TwoPhaseSys(n), sym).spawn_gpu_bfs(
        device="cpu", wave_kernel="staged", **SPAWN).join()
    assert first.unique_state_count() < whole.unique_state_count()
    resumed = _builder(TwoPhaseSys(n), sym).spawn_gpu_bfs(
        device="cpu", wave_kernel="staged", resume_from=str(tmp_path / "cut.ckpt"),
        **SPAWN).join()
    assert resumed.unique_state_count() == whole.unique_state_count() == (166 if sym else 1568)
    assert resumed.state_count() == whole.state_count()
    assert resumed.max_depth() == whole.max_depth()
    assert _golden(resumed) == _golden(whole)
    resumed.assert_properties()
    for path in resumed.discoveries().values():
        assert len(path) >= 1


def _refused(tmp_path, payload, match, model=None, symmetry=False):
    path = tmp_path / "refused.ckpt"
    path.write_bytes(pickle.dumps(payload))
    checker = _builder(model or TwoPhaseSys(4), symmetry).spawn_gpu_bfs(
        device="cpu", resume_from=str(path), **SPAWN)
    with pytest.raises(RuntimeError):
        checker.join()
    err = checker.worker_error()
    assert isinstance(err, ValueError) and match in str(err), err


def test_resume_refuses_a_differently_configured_model(tmp_path):
    _, payload = _port_cut("2pc3", "staged", tmp_path / "2pc3.ckpt")
    _refused(tmp_path, payload, "differently-configured")


def test_resume_refuses_a_jax_checkpoint(jax_cuts, tmp_path):
    _refused(tmp_path, jax_cuts["2pc4"], "kind")
    legacy = {k: v for k, v in jax_cuts["2pc4"].items() if k != "kind"}
    _refused(tmp_path, legacy, "kind")


def test_resume_refuses_a_version_3_payload(tmp_path):
    _, payload = _port_cut("2pc4", "staged", tmp_path / "v2.ckpt")
    _refused(tmp_path, dict(payload, version=3, liveness={}), "liveness")
    _refused(tmp_path, dict(payload, version=4), "unsupported checkpoint version")


def test_resume_refuses_a_symmetry_mismatch(tmp_path):
    _, payload = _port_cut("2pc4", "staged", tmp_path / "plain.ckpt")
    _refused(tmp_path, payload, "symmetry setting", symmetry=True)
    _, sym_payload = _port_cut("2pc4_symmetry", "staged", tmp_path / "sym.ckpt")
    _refused(tmp_path, dict(sym_payload, sym_scheme="orbitmin-v1"),
             "symmetry-key scheme", symmetry=True)


def test_stale_sym_scheme_header_is_refused():
    model = TwoPhaseSys(3)

    def validate(payload, sym_scheme=SYM_KEY_SCHEME):
        validate_checkpoint_header(payload, model, model.packed_action_count(), True,
                                   sym_scheme)

    good = checkpoint_header(model, model.packed_action_count(), True)
    validate(good)
    for bad in (dict(good, sym_scheme="orbitmin-v1"), dict(good, sym_scheme=None)):
        with pytest.raises(ValueError, match="symmetry-key scheme"):
            validate(bad)
    with pytest.raises(ValueError, match="symmetry-key scheme"):
        validate(good, sym_scheme=CUSTOM_REP_SCHEME)
    with pytest.raises(ValueError, match="fingerprint scheme"):
        validate(dict(good, fp_scheme="murmur-v0"))


def test_resume_rejects_non_batchable_model(tmp_path):
    from stateright_tpu_torch import FnModel

    def fn(prev, out):
        if prev is None:
            out.append(0)

    with pytest.raises(TypeError):
        FnModel(fn).checker().spawn_gpu_bfs(device="cpu",
                                            resume_from=str(tmp_path / "nope.ckpt"))


def test_checkpoint_counts_are_coherent(tmp_path):
    path = tmp_path / "2pc3.ckpt"
    checker = TwoPhaseSys(3).checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=32, table_capacity=1 << 12,
        checkpoint_path=str(path), checkpoint_every_chunks=1).join()
    assert checker.unique_state_count() == 288
    # With a checkpoint path a drain runs at most max(2, every) waves.
    assert checker._max_drain_waves == 2 and checker.checkpoints_written > 0
    resumed = TwoPhaseSys(3).checker().spawn_gpu_bfs(
        device="cpu", frontier_capacity=32, table_capacity=1 << 12,
        resume_from=str(path)).join()
    assert resumed.unique_state_count() == 288
    assert resumed.state_count() == checker.state_count()


class _CopyAside(GpuBfsChecker):
    """Copies the checkpoint file aside after its ``k``-th write."""

    def __init__(self, *a, copy_after, copy_to, **kw):
        self._copy = (copy_after, copy_to)
        super().__init__(*a, **kw)

    def save_checkpoint(self, path, queue, drain=None):
        super().save_checkpoint(path, queue, drain)
        if self.checkpoints_written == self._copy[0]:
            shutil.copyfile(path, self._copy[1])


@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
def test_drain_checkpoint_copied_aside_resumes_bit_identically(tmp_path, wave_kernel):
    spawn = dict(frontier_capacity=16, table_capacity=1 << 12, wave_kernel=wave_kernel,
                 checkpoint_path=str(tmp_path / "run.ckpt"), checkpoint_every_chunks=4)
    aside = tmp_path / "aside.ckpt"
    whole = _CopyAside(TwoPhaseSys(4).checker(), device="cpu", copy_after=5,
                       copy_to=str(aside), **spawn).join()
    assert whole.drains > 5 and whole.checkpoints_written == whole.drains - 1
    payload = pickle.loads(aside.read_bytes())
    assert payload["unique_count"] < 1568 and "drain" in payload
    resumed = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", resume_from=str(aside), **spawn).join()
    assert resumed.unique_state_count() == 1568
    assert resumed.state_count() == whole.state_count()
    assert resumed._discoveries_fp == whole._discoveries_fp
    assert _golden(resumed) == _golden(whole)


def test_failed_write_leaves_the_previous_checkpoint_whole(tmp_path):
    path = tmp_path / "run.ckpt"
    spawn = dict(SPAWN, wave_kernel="staged")
    with inject(FaultSpec("checkpoint.write", at=2)) as inj:
        checker = TwoPhaseSys(4).checker().spawn_gpu_bfs(
            device="cpu", checkpoint_path=str(path), checkpoint_every_chunks=2, **spawn)
        with pytest.raises(RuntimeError):
            checker.join()
    assert inj.triggered("checkpoint.write") == 1
    assert isinstance(checker.worker_error(), CheckpointWriteFault)
    assert checker.checkpoints_written == 2
    assert not os.path.exists(f"{path}.tmp")
    payload = pickle.loads(path.read_bytes())
    assert 0 < payload["unique_count"] < 1568
    resumed = TwoPhaseSys(4).checker().spawn_gpu_bfs(
        device="cpu", resume_from=str(path), **spawn).join()
    whole = TwoPhaseSys(4).checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert resumed.unique_state_count() == 1568
    assert _golden(resumed) == _golden(whole)


def test_header_names_the_port_kind():
    model = TwoPhaseSys(3)
    header = checkpoint_header(model, model.packed_action_count(), False)
    assert header["version"] == 2 and header["kind"] == "gpu_bfs"
    assert header["model_digest"] == gpu.packed_model_digest(model, model.packed_action_count())
    assert header["model_digest"] != gpu.packed_model_digest(
        TwoPhaseSys(4), TwoPhaseSys(4).packed_action_count())
