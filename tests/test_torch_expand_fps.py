"""The port's fingerprint-only expansion against the JAX package's.

``PackedActorModel.packed_expand_fps`` gives every candidate's fingerprint
and validity from its parent's component pairs, with no candidate made,
and ``packed_take`` makes the children of chosen (row, action) pairs; the
staged wave of ``spawn_gpu_bfs`` then makes only its fresh children. Over
the six model families of the JAX package's ``tests/test_expand_fps.py``
(ABD on ordered and unordered networks, the single-copy register, paxos,
raft with lossy timers and raft with a crash), on reachable states drawn
with a seeded numpy generator:

1. the port's ``packed_expand_fps`` equals the JAX ``packed_expand_fps``
   and the port's ``packed_fingerprint`` of its ``packed_expand``
   candidates on every valid lane, and its validity equals both exactly;
2. ``packed_take`` of every valid (row, action) equals the candidate.

Then whole checks: the staged engine turns the fps wave on by default and
counts as the JAX package does at its defaults (abd 544, single-copy 93,
paxos 16,668); ``expand_fps`` resolves and refuses as in the JAX package;
coverage on an fps run equals JAX's; and a drain whose waves have more
fresh lanes than it makes on the device (``take full`` exits) ends with
the counts and paths of the wave engine and of a drain without them.
"""

import io
import re

import jax
import numpy as np
import pytest
import torch

from stateright_tpu.actor import Network as JaxNetwork
from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg
from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosModelCfg
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.models.single_copy_register import (
    SingleCopyModelCfg as JaxSingleCopyModelCfg,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.actor.network import Network
from stateright_tpu_torch.checker import gpu
from stateright_tpu_torch.core.batch import map_leaves, supports_expand_fps
from stateright_tpu_torch.interop import packed_states_to_numpy
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

# (JAX model, port model): the families of the JAX package's
# tests/test_expand_fps.py:69-83.
FAMILIES = {
    "abd_ordered": (
        lambda: JaxAbdModelCfg(2, 2, network=JaxNetwork.new_ordered(), envelope_capacity=8,
                               flow_capacity=2).into_model(),
        lambda: AbdModelCfg(2, 2, network=Network.new_ordered(), envelope_capacity=8,
                            flow_capacity=2).into_model(),
    ),
    "abd_unordered": (lambda: JaxAbdModelCfg(2, 2).into_model(),
                      lambda: AbdModelCfg(2, 2).into_model()),
    "single_copy": (lambda: JaxSingleCopyModelCfg(2, 1).into_model(),
                    lambda: SingleCopyModelCfg(2, 1).into_model()),
    "paxos": (lambda: JaxPaxosModelCfg(2, 3).into_model(),
              lambda: PaxosModelCfg(2, 3).into_model()),
    "raft_lossy_timers": (lambda: JaxRaftModelCfg(3, max_term=1, lossy=True).into_model(),
                          lambda: RaftModelCfg(3, max_term=1, lossy=True).into_model()),
    "raft_crashes": (
        lambda: JaxRaftModelCfg(3, max_term=1, lossy=True, max_crashes=1).into_model(),
        lambda: RaftModelCfg(3, max_term=1, lossy=True, max_crashes=1).into_model(),
    ),
}
SPAWN = dict(frontier_capacity=256, table_capacity=1 << 16)


def _reachable(model, seed, levels=8, per_level=48, want=96):
    """Reachable packed states of the port's ``model``: a breadth-first
    search of the packed transition, each level cut to ``per_level``
    distinct states, then ``want`` of all the levels' states drawn with a
    numpy generator seeded by ``seed``."""
    A = model.packed_action_count()
    frontier = model.packed_init_states()
    seen, found = set(), [frontier]
    for _ in range(levels):
        F = frontier["rows"].shape[0]
        cand, valid = model.packed_expand(frontier)
        flat = map_leaves(lambda x: x.reshape((F * A,) + x.shape[2:]), cand)
        valid = valid.reshape(-1) & model.packed_within_boundary(flat)
        hi, lo = model.packed_fingerprint(flat)
        keep = []
        for lane in valid.nonzero().squeeze(1).tolist():
            fp = (int(hi[lane]), int(lo[lane]))
            if fp not in seen:
                seen.add(fp)
                keep.append(lane)
        if not keep:
            break
        frontier = map_leaves(lambda x: x[torch.tensor(keep[:per_level])], flat)
        found.append(frontier)
    states = {k: torch.cat([f[k] for f in found]) for k in found[0]}
    n = states["rows"].shape[0]
    pick = np.random.default_rng(seed).permutation(n)[:want]
    return map_leaves(lambda x: x[torch.from_numpy(pick)], states)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fps_lanes_match_jax_and_the_materializing_expand(family):
    make_jax, make_port = FAMILIES[family]
    jm, tm = make_jax(), make_port()
    assert supports_expand_fps(tm) and tm.packed_expand_fps_supported()
    A = tm.packed_action_count()
    assert A == jm.packed_action_count()
    states = _reachable(tm, seed=sorted(FAMILIES).index(family))
    F = states["rows"].shape[0]

    hi, lo, valid = tm.packed_expand_fps(states)
    assert hi.shape == lo.shape == valid.shape == (F, A)
    jhi, jlo, jvalid = jax.jit(jax.vmap(jm.packed_expand_fps))(packed_states_to_numpy(states))
    jvalid = np.asarray(jvalid)
    assert (valid.numpy() == jvalid).all(), "validity against JAX"
    v = jvalid
    assert (hi.numpy()[v] == np.asarray(jhi).astype(np.int64)[v]).all(), "hi against JAX"
    assert (lo.numpy()[v] == np.asarray(jlo).astype(np.int64)[v]).all(), "lo against JAX"

    cand, cvalid = tm.packed_expand(states)
    flat = map_leaves(lambda x: x.reshape((F * A,) + x.shape[2:]), cand)
    cvalid = cvalid.reshape(-1) & tm.packed_within_boundary(flat)
    chi, clo = tm.packed_fingerprint(flat)
    assert torch.equal(valid.reshape(-1), cvalid), "validity against packed_expand"
    assert torch.equal(hi.reshape(-1)[cvalid], chi[cvalid])
    assert torch.equal(lo.reshape(-1)[cvalid], clo[cvalid])

    lanes = cvalid.nonzero().squeeze(1)
    assert lanes.numel() > 0, f"{family}: no valid candidate exercised"
    parents = map_leaves(lambda x: x[lanes // A], states)
    taken = tm.packed_take(parents, lanes % A)
    assert set(taken) == set(flat)
    for k in flat:
        assert torch.equal(taken[k], flat[k][lanes]), (family, k)


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


def _same_run(port, ref, port_reporter=WriteReporter, ref_reporter=JaxWriteReporter):
    assert port.worker_error() is None, port.worker_error()
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    pd, rd = port.discoveries(), ref.discoveries()
    assert set(pd) == set(rd)
    for name in rd:
        assert pd[name].encode() == rd[name].encode(), name
    assert _golden(port, port_reporter) == _golden(ref, ref_reporter)


@pytest.mark.parametrize(
    "family, expected",
    [("abd_unordered", 544), ("single_copy", 93), ("paxos", 16_668)],
    ids=["abd544", "scr93", "paxos16668"],
)
@pytest.mark.parametrize("mode", ["wave", "drain"])
def test_fps_checker_counts_match_jax_defaults(family, expected, mode):
    """The staged engine with its defaults runs the fps wave and counts
    the JAX package's exact counts; wave at a time it equals the JAX
    checker at its defaults (fps on) in counts, paths and golden lines
    (paxos: the counts alone, to keep the file's time)."""
    make_jax, make_port = FAMILIES[family]
    options = dict(max_drain_waves=1) if mode == "wave" else {}
    port = make_port().checker().spawn_gpu_bfs(
        wave_kernel="staged", device="cpu", **SPAWN, **options).join()
    assert port._use_fps
    assert port.unique_state_count() == expected
    if mode == "wave":
        assert port.host_takes > 0
    if mode == "wave" and family != "paxos":
        ref = make_jax().checker().spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", **SPAWN, **options).join()
        assert ref._use_fps
        _same_run(port, ref)
    if mode == "drain":
        assert port.drains > 0
    port.assert_properties()


def test_expand_fps_resolves_and_refuses_as_jax():
    """``expand_fps``: None turns it on for a staged actor run only; False
    forces the materializing wave; True raises with the fused wave and on a
    model without the hooks (2pc), as the JAX package's resolution does."""
    spawn = dict(frontier_capacity=64, table_capacity=4096)
    cases = {
        ("staged", None): True, ("staged", False): False, ("staged", True): True,
        ("fused", None): False, ("fused", False): False,
    }
    for (engine, fps), want in cases.items():
        c = SingleCopyModelCfg(2, 1).into_model().checker().spawn_gpu_bfs(
            device="cpu", wave_kernel=engine, expand_fps=fps, **spawn).join()
        assert c._use_fps is want, (engine, fps)
        assert c.unique_state_count() == 93
        if engine == "staged":
            j = JaxSingleCopyModelCfg(2, 1).into_model().checker().spawn_tpu_bfs(
                expand_fps=fps, **spawn).join()
            assert j._use_fps is want, (engine, fps)
    with pytest.raises(ValueError, match="wave_kernel='fused'"):
        SingleCopyModelCfg(2, 1).into_model().checker().spawn_gpu_bfs(
            device="cpu", wave_kernel="fused", expand_fps=True, **spawn)
    with pytest.raises(ValueError, match="wave_kernel='fused'"):
        JaxSingleCopyModelCfg(2, 1).into_model().checker().spawn_tpu_bfs(
            wave_kernel="fused", expand_fps=True, **spawn)
    for make, spawn_fn in ((lambda: TwoPhaseSys(3), "spawn_gpu_bfs"),
                           (lambda: JaxTwoPhaseSys(3), "spawn_tpu_bfs")):
        kwargs = dict(spawn, expand_fps=True)
        if spawn_fn == "spawn_gpu_bfs":
            kwargs["device"] = "cpu"
        with pytest.raises(ValueError, match="packed_expand_fps"):
            getattr(make().checker(), spawn_fn)(**kwargs)
    assert not supports_expand_fps(TwoPhaseSys(3))
    c = TwoPhaseSys(3).checker().spawn_gpu_bfs(wave_kernel="staged", device="cpu", **spawn).join()
    assert not c._use_fps and c.unique_state_count() == 288


def test_symmetry_is_still_refused_by_name():
    """Symmetry of a model with an auxiliary history is refused as in the
    JAX package (``NotImplementedError`` naming the history; the checker's
    ``TypeError``), and symmetry turns the fingerprint-only wave off."""
    with pytest.raises(NotImplementedError, match="history"):
        PaxosModelCfg(2, 2).into_model().packed_symmetry()
    with pytest.raises(TypeError, match="history"):
        PaxosModelCfg(2, 2).into_model().checker().symmetry().spawn_gpu_bfs(device="cpu")
    raft = RaftModelCfg(server_count=3, max_term=1).into_model()
    c = raft.checker().symmetry().spawn_gpu_bfs(device="cpu", frontier_capacity=64,
                                                table_capacity=4096).join()
    assert supports_expand_fps(raft) and not c._use_fps
    assert c.unique_state_count() == 121


@pytest.mark.parametrize("mode", ["wave", "drain"])
def test_fps_coverage_matches_jax(mode):
    """Coverage on the staged fps wave equals the JAX staged wave's with
    fps on, field for field but the prefix."""
    options = dict(max_drain_waves=1) if mode == "wave" else {}
    spawn = dict(frontier_capacity=64, table_capacity=4096, coverage=True, **options)
    port = SingleCopyModelCfg(2, 1).into_model().checker().spawn_gpu_bfs(
        wave_kernel="staged", device="cpu", **spawn).join()
    ref = JaxSingleCopyModelCfg(2, 1).into_model().checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", **spawn).join()
    assert port._use_fps and ref._use_fps
    rep, jrep = dict(port.coverage_report()), dict(ref.coverage_report())
    assert rep.pop("prefix") == "gpu_bfs"
    jrep.pop("prefix")
    assert rep == jrep
    assert port.unique_state_count() == ref.unique_state_count() == 93


def _drain_runs(make, spawn, factor, monkeypatch):
    """A drain with the device's take width at ``factor`` times the rung
    width, and the wave engine, at ``spawn``."""
    monkeypatch.setattr(gpu, "_TAKE_FACTOR", factor)
    drain = make().checker().spawn_gpu_bfs(wave_kernel="staged", device="cpu", **spawn).join()
    monkeypatch.undo()
    wave = make().checker().spawn_gpu_bfs(
        wave_kernel="staged", device="cpu", max_drain_waves=1, **spawn).join()
    return drain, wave


@pytest.mark.parametrize("family", ["paxos_2c2s", "raft_crashes"])
def test_drain_take_full_exits_match_the_wave_engine(family, monkeypatch):
    """Every BFS level fits in one wave of a one-rung drain, so the drain
    and the wave engine run the same waves: a take width of 4 lanes stops
    the drain on every wave with more fresh lanes than that (``take
    full``), the host makes those children, and the counts, depth,
    discoveries and paths equal the wave engine's and the JAX checker's."""
    make_jax, make_port = {
        "paxos_2c2s": (lambda: JaxPaxosModelCfg(2, 2).into_model(),
                       lambda: PaxosModelCfg(2, 2).into_model()),
        "raft_crashes": FAMILIES["raft_crashes"],
    }[family]
    spawn = dict(frontier_capacity=1024, table_capacity=1 << 14, bucket_ladder=0)
    drain, wave = _drain_runs(make_port, spawn, 4 / spawn["frontier_capacity"], monkeypatch)
    assert drain._use_fps and drain.drain_exits["take full"] > 0, dict(drain.drain_exits)
    assert drain.host_takes > 0
    _same_run(drain, wave, WriteReporter, WriteReporter)
    ref = make_jax().checker().spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort",
                                             max_drain_waves=1, **spawn).join()
    _same_run(drain, ref)


def test_drain_take_full_exits_keep_the_rung_and_the_paths(monkeypatch):
    """On the bucket ladder a drain stopped by ``take full`` hands its rung
    to the next drain, so the ring takes the same rows in the same order
    as a drain with a take width no wave exceeds: the same counts, waves,
    rungs and paths."""
    spawn = dict(frontier_capacity=512, table_capacity=1 << 16)
    make = FAMILIES["paxos"][1]
    monkeypatch.setattr(gpu, "_TAKE_FACTOR", 0.5)
    small = make().checker().spawn_gpu_bfs(wave_kernel="staged", device="cpu", **spawn).join()
    monkeypatch.setattr(gpu, "_TAKE_FACTOR", 512)
    whole = make().checker().spawn_gpu_bfs(wave_kernel="staged", device="cpu", **spawn).join()
    assert small.drain_exits["take full"] > 0 and "take full" not in whole.drain_exits
    assert small.waves == whole.waves
    assert set(small.rungs) == set(whole.rungs)
    _same_run(small, whole, WriteReporter, WriteReporter)
    assert small.unique_state_count() == 16_668
