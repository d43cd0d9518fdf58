"""The port's fused wave (on the CPU) against the JAX package's Pallas fused wave.

On a CPU table ``ops/fused_wave.py::fused_wave`` runs ``fused_wave_plain``,
the plain twin of the CUDA kernels; the JAX side runs
``ops/pallas_wave.py::fused_wave`` in Pallas interpret mode. Single waves
take the same numpy-made inputs (reachable frontiers, a 4,096-row table of
two tiles filled by the waves before, per-lane depths and eventually bits
drawn from a seed) and must agree on every output field; whole runs of
``spawn_gpu_bfs(wave_kernel="fused", device="cpu")`` must agree with the
JAX package's fused runs and with the port's staged runs in counts,
discovery fingerprints, paths and golden reports. Everything compared is
an integer: the tolerance is 0. The kernels themselves are held against
the twin on the card (``test_torch_cuda_kernels.py``).
"""

import ctypes
import io
import os
import re
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops.pallas_wave import FusedWaveSpec as JaxFusedWaveSpec
from stateright_tpu.ops.pallas_wave import fused_wave as jax_fused_wave
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.interop import table_from_numpy, table_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import _build
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.ops.fingerprint import fingerprint_words, state_words
from stateright_tpu_torch.testing import Chain, sweep_table

from test_tpu_bfs import Chain as JaxChain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 4096  # two tile-sweep tiles: the apron chains from tile 0 to tile 1


def _ebit_pairs(properties):
    ev = [i for i, p in enumerate(properties) if p.expectation.value == "eventually"]
    return tuple((pi, b) for b, pi in enumerate(ev))


def jax_spec(model):
    props = model.properties()
    return JaxFusedWaveSpec(
        expand=model.packed_expand,
        within_boundary=model.packed_within_boundary,
        fp_fn=model.packed_fingerprint,
        conditions=tuple(model.packed_conditions()),
        expectations=tuple(p.expectation.value for p in props),
        ebit=_ebit_pairs(props),
        action_count=model.packed_action_count(),
        interpret=True,
    )


def port_spec(model):
    props = model.properties()
    return fw.FusedWaveSpec(
        expand=model.packed_expand,
        within_boundary=model.packed_within_boundary,
        conditions=tuple(model.packed_conditions()),
        expectations=tuple(p.expectation.value for p in props),
        ebit=_ebit_pairs(props),
        action_count=model.packed_action_count(),
    )


def _to_port(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _leaves(states):
    """(name, leaf) pairs of a packed state: a dict's items, or a bare leaf."""
    return sorted(states.items()) if isinstance(states, dict) else [("", states)]


WAVES = {
    # model pair, padded frontier width, waves
    "2pc3": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3), 64, 6),
    "2pc5": (lambda: JaxTwoPhaseSys(5), lambda: TwoPhaseSys(5), 128, 4),
    "chain": (lambda: JaxChain(6, reach=9), lambda: Chain(6, reach=9), 8, 7),
}


def _compare_wave(jwave, tspec, table, states, hi, lo, ebits, depth, dcap, F_pad):
    """One wave through the JAX fused wave (the frontier padded to
    ``F_pad`` under its lane mask) and the port's (the live lanes only, as
    its checker's chunks hold them); asserts that every output field
    agrees and returns the JAX wave's new frontier and table."""
    F = hi.shape[0]

    def pad(x):
        return np.concatenate([x, np.zeros((F_pad - F,) + x.shape[1:], x.dtype)])

    jout = jwave(
        table, jax.tree_util.tree_map(pad, states), pad(hi), pad(lo), pad(ebits),
        pad(depth), pad(np.ones(F, bool)), dcap,
    )
    tstates = (
        {k: _to_port(v) for k, v in states.items()} if isinstance(states, dict)
        else _to_port(states)
    )
    ttable, tout = fw.fused_wave(
        tspec, table_from_numpy(table), tstates, _to_port(hi), _to_port(lo),
        _to_port(ebits), _to_port(depth), dcap,
    )

    jtable = np.asarray(jout["table"])
    assert np.array_equal(table_to_numpy(ttable), jtable)
    stats = tout["stats"].tolist()
    jstats = np.asarray(jout["stats"]).tolist()
    assert stats[: len(jstats)] == jstats
    if "prop_hit" in jout:
        assert stats[5::3] == np.asarray(jout["prop_hit"]).astype(int).tolist()
        assert stats[6::3] == np.asarray(jout["prop_hi"]).tolist()
        assert stats[7::3] == np.asarray(jout["prop_lo"]).tolist()
    n = stats[1]
    jnew = jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], jout["new"])
    for k in ("hi", "lo", "ebits", "depth"):
        assert np.array_equal(tout["new"][k][:n].numpy(), jnew[k].astype(np.int64)), k
    for k in ("parent_hi", "parent_lo"):
        assert np.array_equal(tout[k][:n].numpy(), np.asarray(jout[k])[:n]), k
    for (jk, jleaf), (tk, tleaf) in zip(_leaves(jnew["states"]), _leaves(tout["new"]["states"])):
        assert jk == tk
        assert np.array_equal(tleaf[:n].numpy(), jleaf.astype(np.int64)), jk
    return jnew, jtable, stats


def _initial(jmodel):
    states = jax.tree_util.tree_map(np.asarray, jmodel.packed_init_states())
    hi, lo = (np.asarray(x) for x in jax.vmap(jmodel.packed_fingerprint)(states))
    return states, hi, lo, np.ones(hi.shape[0], np.int32)


@pytest.mark.parametrize("name", list(WAVES))
def test_single_waves_match_jax_fused_wave(name):
    """Consecutive waves from the initial state: each wave's inputs are the
    JAX wave's outputs before it (its frontier and its table), with 10% of
    the lanes moved past the depth cap and eventually bits drawn from a
    seed; the JAX frontier is padded to a fixed width under its lane mask,
    the port's holds the live lanes only (as its checker's chunks do)."""
    make_jax, make_port, F_pad, n_waves = WAVES[name]
    jmodel, tmodel = make_jax(), make_port()
    jspec, tspec = jax_spec(jmodel), port_spec(tmodel)
    n_ev = len(jspec.ebit)
    rng = np.random.default_rng(len(name))
    jwave = jax.jit(lambda *a: jax_fused_wave(jspec, *a))

    states, hi, lo, depth = _initial(jmodel)
    table = np.zeros((CAP + 128, 2), np.uint32)
    compared = 0
    for _ in range(n_waves):
        F = min(hi.shape[0], F_pad)
        if F == 0:
            break
        states = jax.tree_util.tree_map(lambda x: x[:F], states)
        hi, lo, depth = hi[:F], lo[:F], depth[:F]
        d = int(depth.max())
        depth = np.where(rng.random(F) < 0.1, d + 1, depth).astype(np.int32)
        ebits = rng.integers(0, 1 << n_ev, size=F).astype(np.uint32)
        jnew, table, _stats = _compare_wave(
            jwave, tspec, table, states, hi, lo, ebits, depth, d + 1, F_pad
        )
        compared += 1
        states, hi, lo, depth = jnew["states"], jnew["hi"], jnew["lo"], jnew["depth"]
    assert compared >= 3


@pytest.mark.parametrize("kind", ["empty_after_home", "load_0_9"])
def test_wave_over_sweep_repair_tables(kind):
    """A 2pc-5 wave of 256 states over an 8,192-row table built around the
    wave's own keys so that the CUDA sweep's ordered repair has work in
    every tile (``testing.sweep_table``: every tile spilling into the
    next and into the overflow rows, or a load of 0.9 with keys going
    pending): the port's fused wave equals the JAX fused wave."""
    jmodel, tmodel = JaxTwoPhaseSys(5), TwoPhaseSys(5)
    jspec, tspec = jax_spec(jmodel), port_spec(tmodel)
    jwave = jax.jit(lambda *a: jax_fused_wave(jspec, *a))
    F, cap = 256, 8192
    states, hi, lo, depth = _initial(jmodel)
    table = np.zeros((cap + 128, 2), np.uint32)
    while hi.shape[0] < F:  # grow the frontier, padded to F lanes
        F_now = hi.shape[0]

        def pad(x):
            return np.concatenate([x, np.zeros((F - F_now,) + x.shape[1:], x.dtype)])

        jout = jwave(table, jax.tree_util.tree_map(pad, states), pad(hi), pad(lo),
                     np.zeros(F, np.uint32), pad(depth), pad(np.ones(F_now, bool)), 100)
        n = int(np.asarray(jout["stats"])[1])
        table = np.asarray(jout["table"])
        states, hi, lo, depth = (
            jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], jout["new"][k])
            for k in ("states", "hi", "lo", "depth")
        )
    states = jax.tree_util.tree_map(lambda x: x[:F], states)
    hi, lo, depth = hi[:F], lo[:F], depth[:F]
    # The wave's distinct keys, from the port's own stages.
    tstates = {k: _to_port(v) for k, v in states.items()}
    _cond, cvalid, cand = fw.model_stage(tspec, tstates, F)
    khi, klo = fingerprint_words(state_words(cand))
    keys = np.unique(((khi << 32) | klo)[cvalid].numpy().astype(np.uint64))
    sweep = sweep_table(cap, (keys >> np.uint64(32)).astype(np.uint32),
                        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), kind)
    _jnew, after, stats = _compare_wave(
        jwave, tspec, sweep, states, hi, lo, np.zeros(F, np.uint32), depth, 100, F
    )
    assert keys.size > 500 and stats[1] > 0
    if kind == "empty_after_home":
        assert (after[cap:] != 0).all()
    else:
        assert stats[2] > 0  # pending keys


# -- whole runs ------------------------------------------------------------------

RUNS = {
    "2pc3": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3),
             dict(frontier_capacity=64, table_capacity=2048)),
    "2pc4": (lambda: JaxTwoPhaseSys(4), lambda: TwoPhaseSys(4),
             dict(frontier_capacity=256, table_capacity=4096)),
    "chain_eventually_violation": (lambda: JaxChain(6, reach=9), lambda: Chain(6, reach=9),
                                   dict(frontier_capacity=64, table_capacity=4096)),
    "chain_eventually_pass": (lambda: JaxChain(6, reach=6), lambda: Chain(6, reach=6),
                              dict(frontier_capacity=64, table_capacity=4096)),
}


@pytest.fixture(scope="module", params=list(RUNS), ids=list(RUNS))
def runs(request):
    make_jax, make_port, spawn = RUNS[request.param]
    jax_fused = make_jax().checker().spawn_tpu_bfs(
        wave_kernel="fused", max_drain_waves=1, **spawn
    ).join()
    fused = make_port().checker().spawn_gpu_bfs(
        wave_kernel="fused", device="cpu", max_drain_waves=1, **spawn
    ).join()
    staged = make_port().checker().spawn_gpu_bfs(
        wave_kernel="staged", device="cpu", max_drain_waves=1, **spawn
    ).join()
    return jax_fused, fused, staged


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


def test_fused_runs_match_jax_fused_runs(runs):
    jc, fused, _staged = runs
    assert fused.worker_error() is None
    assert fused.unique_state_count() == jc.unique_state_count()
    assert fused.state_count() == jc.state_count()
    assert fused.max_depth() == jc.max_depth()
    assert fused._discoveries_fp == jc._discoveries_fp
    jd, td = jc.discoveries(), fused.discoveries()
    assert set(td) == set(jd)
    for name in jd:
        assert td[name].encode() == jd[name].encode(), name
    assert _golden(fused, WriteReporter) == _golden(jc, JaxWriteReporter)
    assert fused.table_capacity() == jc._capacity


def test_fused_runs_match_port_staged_runs(runs):
    _jc, fused, staged = runs
    assert fused.unique_state_count() == staged.unique_state_count()
    assert fused.state_count() == staged.state_count()
    assert fused.max_depth() == staged.max_depth()
    assert fused.waves == staged.waves
    assert fused.table_growths == staged.table_growths
    assert fused._discoveries_fp == staged._discoveries_fp
    assert _golden(fused, WriteReporter) == _golden(staged, WriteReporter)


def test_fused_2pc_counts_and_properties(runs):
    jc, fused, _staged = runs
    if isinstance(fused.model(), TwoPhaseSys):
        n = fused.model().rm_count
        assert fused.unique_state_count() == {3: 288, 4: 1568}[n]
        assert fused.state_count() == {3: 1146, 4: 8258}[n]
        fused.assert_properties()


# -- the port's own checks -------------------------------------------------------


def test_fused_rounds_table_capacity_with_note():
    spawn = dict(frontier_capacity=64, table_capacity=3000, wave_kernel="fused")
    checker = Chain(6).checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert checker.config_notes == [
        "table_capacity rounded 3000 -> 4096 (tile-sweep kernels grid over "
        "2048-row table tiles)"
    ]
    golden = _golden(checker, WriteReporter)
    assert "Note: table_capacity rounded 3000 -> 4096" in golden
    assert checker.unique_state_count() == 7
    jc = JaxChain(6).checker().spawn_tpu_bfs(max_drain_waves=1, **spawn).join()
    assert golden == _golden(jc, JaxWriteReporter)
    # The staged path keeps its refusal, and an admissible size adds no note.
    with pytest.raises(ValueError, match="multiple of 2048"):
        Chain(6).checker().spawn_gpu_bfs(wave_kernel="staged", table_capacity=3000, device="cpu")
    plain = Chain(6).checker().spawn_gpu_bfs(
        wave_kernel="staged", table_capacity=4096, device="cpu").join()
    assert plain.config_notes == [] and "Note:" not in _golden(plain, WriteReporter)


def test_wave_kernel_refusal():
    with pytest.raises(ValueError, match="wave_kernel must be 'staged' or 'fused'"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(wave_kernel="megakernel", device="cpu")


class _SaltedTwoPhaseSys(TwoPhaseSys):
    def packed_fingerprint(self, states):
        hi, lo = super().packed_fingerprint(states)
        return hi, lo ^ 1


def test_fused_refuses_a_custom_fingerprint():
    """The fused wave no longer refuses a model that overrides
    ``packed_fingerprint``: such a model takes the ``"pairs"`` key route
    (its fingerprint in the torch model stage, ``fw_keys_pairs`` on the
    card) and gives the staged wave's counts, discoveries and paths, wave
    at a time and drained."""
    for options in (dict(max_drain_waves=1), {}):
        spawn = dict(frontier_capacity=64, table_capacity=2048, device="cpu", **options)
        fused = _SaltedTwoPhaseSys(3).checker().spawn_gpu_bfs(
            wave_kernel="fused", **spawn).join()
        staged = _SaltedTwoPhaseSys(3).checker().spawn_gpu_bfs(wave_kernel="staged", **spawn).join()
        assert fused.keys_route == staged.keys_route == "pairs"
        assert fused.unique_state_count() == staged.unique_state_count() == 288
        assert fused.state_count() == staged.state_count() == 1146
        assert fused.max_depth() == staged.max_depth()
        assert fused._discoveries_fp == staged._discoveries_fp
        fd, sd = fused.discoveries(), staged.discoveries()
        assert set(fd) == set(sd) == {"abort agreement", "commit agreement"}
        for name in fd:
            assert fd[name].encode() == sd[name].encode(), name
        # The salt reaches the keys: they are not the default fold's.
        plain = TwoPhaseSys(3).checker().spawn_gpu_bfs(wave_kernel="fused", **spawn).join()
        assert plain.keys_route == "fold"
        assert fused._discoveries_fp != plain._discoveries_fp
        assert _golden(fused, WriteReporter) == _golden(staged, WriteReporter)


def _c_signatures(source):
    """name -> ctypes types of each ``extern "C"`` function of a source."""
    text = open(os.path.join(ROOT, "stateright_tpu_torch", "csrc", source)).read()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types_ = []
        for param in params.split(","):
            if "*" in param:
                types_.append(ctypes.c_void_p)
            elif "int64_t" in param:
                types_.append(ctypes.c_int64)
            else:
                assert re.match(r"\s*int\s+\w+\s*$", param), param
                types_.append(ctypes.c_int)
        out[name] = types_
    return out


def test_entry_points_bind_every_argument(monkeypatch):
    """Every C entry point is bound with ctypes types that match its C
    declaration: left undeclared, ctypes passes pointers and the stream as
    32-bit ints."""
    assert _c_signatures("fused_wave.cu") == fw.ARGTYPES
    fake = types.SimpleNamespace(**{n: ctypes.CDLL(None).strlen for n in fw.ARGTYPES})
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(fw, "_fns", {})
    fns = fw._lib()
    assert set(fns) == set(fw.ARGTYPES)
    for name, fn in fns.items():
        assert fn.argtypes == fw.ARGTYPES[name], name
        assert fn.restype is ctypes.c_int
    insert = ctypes.CDLL(None).strlen
    monkeypatch.setattr(
        _build, "load", lambda name: types.SimpleNamespace(hashset_insert_launch=insert)
    )
    assert hk._kernel().argtypes == _c_signatures("hashset_insert.cu")["hashset_insert_launch"]


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """An edited header changes the artifact of every source that includes
    it, and only those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    assert [p.name for p in _build.sources("fused_wave")] == ["fused_wave.cu", "tile_sweep.cuh"]
    assert [p.name for p in _build.sources("hashset_insert")] == [
        "hashset_insert.cu", "tile_sweep.cuh"
    ]
    before = {n: _build.library_path(n) for n in ("fused_wave", "hashset_insert")}
    with open(csrc / "tile_sweep.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert all(p.parent == tmp_path / "_build" for p in after.values())
    with open(csrc / "fused_wave.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("fused_wave") != after["fused_wave"]
    assert _build.library_path("hashset_insert") == after["hashset_insert"]


def test_cpu_fused_run_never_touches_the_cuda_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the CPU path must not build a CUDA kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    before = fw.launches
    checker = TwoPhaseSys(3).checker().spawn_gpu_bfs(
        frontier_capacity=64, table_capacity=2048, wave_kernel="fused", device="cpu"
    ).join()
    assert checker.unique_state_count() == 288
    assert fw.launches == before


@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
def test_queued_chunks_hold_only_the_fresh_rows(monkeypatch, wave_kernel):
    """The queued frontier chunks are not views of a wave's B-row outputs,
    which would keep those alive until the wave's last chunk runs."""
    from stateright_tpu_torch.checker import gpu

    consume, sizes = gpu.GpuBfsChecker._consume_wave, []

    def spy(self, table, chunk, queue):
        table = consume(self, table, chunk, queue)
        for c in queue:
            leaves = [c["hi"], c["lo"], c["ebits"], c["depth"], *c["states"].values()]
            sizes.append(max(x.untyped_storage().nbytes() // max(1, x[:1].nbytes)
                             for x in leaves))
        return table

    monkeypatch.setattr(gpu.GpuBfsChecker, "_consume_wave", spy)
    checker = TwoPhaseSys(3).checker().spawn_gpu_bfs(
        frontier_capacity=64, table_capacity=2048, wave_kernel=wave_kernel, device="cpu",
        max_drain_waves=1,
    ).join()
    assert checker.unique_state_count() == 288
    # B = 64 x 17 = 1,088 rows a wave; no wave finds more than the 288 states.
    assert sizes and max(sizes) <= 288, max(sizes)


def test_fused_wave_plain_refuses_a_device_table():
    spec = port_spec(Chain(3))
    with pytest.raises(ValueError, match="CPU tensors"):
        fw.fused_wave_plain(spec, torch.zeros((2048 + 128, 2), dtype=torch.int32,
                                              device="meta"),
                            None, None, None, None, None, 1)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import stateright_tpu_torch.ops.fused_wave\n"
        "import stateright_tpu_torch.ops.ring\n"
        "import stateright_tpu_torch.checker.gpu\n"
        "import stateright_tpu_torch.actor\n"
        "import stateright_tpu_torch.actor.packed\n"
        "import stateright_tpu_torch.actor.packed_register\n"
        "import stateright_tpu_torch.actor.register\n"
        "import stateright_tpu_torch.semantics\n"
        "import stateright_tpu_torch.semantics.packed_linearizability\n"
        "import stateright_tpu_torch.models.paxos\n"
        "import stateright_tpu_torch.models.single_copy_register\n"
        "import stateright_tpu_torch.models.linearizable_register\n"
        "import stateright_tpu_torch.models.raft\n"
        "import stateright_tpu_torch.configs\n"
        "import stateright_tpu_torch.telemetry\n"
        "import stateright_tpu_torch.telemetry.coverage\n"
        "import stateright_tpu_torch.telemetry.metrics\n"
        "import stateright_tpu_torch.telemetry.trace\n"
        "import stateright_tpu_torch.models.sharded_kv\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'stateright_tpu' or m.startswith('stateright_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
