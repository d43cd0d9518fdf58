"""The port's deep drain (on the CPU) against the JAX package's deep drain.

``spawn_gpu_bfs(device="cpu")`` with ``max_drain_waves > 1`` keeps the
pending frontier in the device ring (``ops/ring.py``) and drains it on the
bucket ladder exactly as ``spawn_tpu_bfs`` does; on the CPU each drain
runs its waves uncaptured. The JAX side runs the staged wave with the XLA
insert and ``wave_dedup="sort"`` (given explicitly: the CPU default,
``"scatter"``, compacts in another order); its fused wave is held to its
staged wave by the JAX package's own tests, so the one JAX drain is the
reference for both port engines. Each case runs the JAX drain once (one
compile per rung and shape). Held equal: unique and generated counts, max
depth, the discoveries, their paths and the golden reporter lines. The
drain is also held to the port's own wave path (``max_drain_waves=1``) on
counts, depth and verdicts. The frontier mask of both wave engines and the
ring are held to their JAX counterparts. Everything compared is an
integer: the tolerance is 0.
"""

import io
import re

import jax
import numpy as np
import pytest
import torch

from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops import ring as jax_ring
from stateright_tpu.ops.pallas_wave import fused_wave as jax_fused_wave
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.checker import gpu
from stateright_tpu_torch.interop import table_from_numpy, table_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops import ring
from stateright_tpu_torch.testing import Chain

from test_torch_fused_wave import _initial, _leaves, _to_port, jax_spec, port_spec
from test_tpu_bfs import Chain as JaxChain

TINY = dict(frontier_capacity=32, table_capacity=2048, drain_log_factor=1,
            pool_factor=1, max_drain_waves=3)

# name: (JAX model, port model, spawn options, target_max_depth)
CASES = {
    # Ring growth, ring-full and budget exits, many drains at the cap.
    "tiny_2pc3": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3), TINY, None),
    "tiny_2pc4": (lambda: JaxTwoPhaseSys(4), lambda: TwoPhaseSys(4), TINY, None),
    "tiny_2pc5": (lambda: JaxTwoPhaseSys(5), lambda: TwoPhaseSys(5), TINY, None),
    # The ladder at 64 lanes, and one that enters every rung: at 64 lanes
    # the 2pc frontier never stays below 32 lanes for two drains in a row,
    # at 128 it does.
    "ladder_2pc4_f64": (lambda: JaxTwoPhaseSys(4), lambda: TwoPhaseSys(4),
                        dict(frontier_capacity=64, table_capacity=2048,
                             bucket_ladder=2), None),
    "ladder_2pc3_f128": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3),
                         dict(frontier_capacity=128, table_capacity=2048,
                              bucket_ladder=2, max_drain_waves=2), None),
    # Log-full exits at the default log and ring sizes.
    "log_full_2pc5": (lambda: JaxTwoPhaseSys(5), lambda: TwoPhaseSys(5),
                      dict(frontier_capacity=64, table_capacity=2048), None),
    # A depth cap on a chain whose eventually target lies past it, on
    # narrow rungs.
    "chain_depth_cap": (lambda: JaxChain(20, reach=25), lambda: Chain(20, reach=25),
                        dict(frontier_capacity=64, table_capacity=2048,
                             bucket_ladder=2, max_drain_waves=2), 12),
}


def _spawn(model, depth_cap):
    b = model.checker()
    if depth_cap is not None:
        b = b.target_max_depth(depth_cap)
    return b


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def drains(request):
    make_jax, make_port, spawn, depth_cap = CASES[request.param]
    jc = _spawn(make_jax(), depth_cap).spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", **spawn
    ).join()
    runs = {
        wk: _spawn(make_port(), depth_cap).spawn_gpu_bfs(
            device="cpu", wave_kernel=wk, **spawn
        ).join()
        for wk in ("staged", "fused")
    }
    wave_path = _spawn(make_port(), depth_cap).spawn_gpu_bfs(
        wave_kernel="staged", device="cpu", **dict(spawn, max_drain_waves=1)
    ).join()
    return request.param, jc, runs, wave_path


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
def test_drain_matches_jax_drain(drains, wave_kernel):
    _name, jc, runs, _wave = drains
    tc = runs[wave_kernel]
    assert tc.worker_error() is None
    assert tc.drains > 1
    assert tc.unique_state_count() == jc.unique_state_count()
    assert tc.state_count() == jc.state_count()
    assert tc.max_depth() == jc.max_depth()
    assert tc._discoveries_fp == jc._discoveries_fp
    jd, td = jc.discoveries(), tc.discoveries()
    assert set(td) == set(jd)
    for name in jd:
        assert td[name].encode() == jd[name].encode(), name
    assert _golden(tc, WriteReporter) == _golden(jc, JaxWriteReporter)
    # The same rungs, and the same ring growth.
    assert set(tc.rungs) == set(jc._drain_jits)
    assert tc._pool_capacity == jc._pool_capacity


def test_drain_cases_reach_their_exits(drains):
    """Each case exercises what it is there for."""
    name, _jc, runs, _wave = drains
    tc = runs["staged"]
    assert runs["fused"].drain_exits == tc.drain_exits
    assert runs["fused"].rungs == tc.rungs
    if name.startswith("tiny"):
        assert tc.drain_exits["max waves"] > 1
    if name == "tiny_2pc5":
        assert tc._pool_capacity > 1024 and tc.drain_exits["ring full"] >= 1
    if name in ("ladder_2pc3_f128", "chain_depth_cap"):
        assert len(tc.rungs) > 1
    if name == "log_full_2pc5":
        assert tc.drain_exits["log full"] >= 1


def test_drain_matches_port_wave_path(drains):
    """Counts, depth and verdicts equal the wave-at-a-time run's. A ring
    take changes which lanes share a wave, so the paths need not."""
    _name, _jc, runs, wave_path = drains
    for tc in runs.values():
        assert tc.unique_state_count() == wave_path.unique_state_count()
        assert tc.state_count() == wave_path.state_count()
        assert tc.max_depth() == wave_path.max_depth()
        assert set(tc.discoveries()) == set(wave_path.discoveries())
    assert wave_path.drains == 0


def test_bucket_ladder_matches_jax():
    from stateright_tpu.checker.tpu import bucket_for as jax_bucket_for
    from stateright_tpu.checker.tpu import bucket_ladder_widths as jax_widths

    for f_max in (8, 32, 64, 512, 8192):
        for steps in range(6):
            widths = gpu.bucket_ladder_widths(f_max, steps)
            assert widths == jax_widths(f_max, steps)
            for live in (0, 1, 7, 8, 9, 33, f_max // 3, f_max):
                assert gpu.bucket_for(widths, live) == jax_bucket_for(widths, live)


def test_drain_options_default_as_the_reference():
    c = TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu", frontier_capacity=512).join()
    assert c._max_drain_waves == 100_000 and c.drains >= 1
    assert c._buckets == [512, 256, 128, 64, 32]
    assert c._drain_log_capacity == max(8 * 512, 512 * 17)
    assert c._pool_capacity >= 16 * 512
    assert c.unique_state_count() == 288
    with pytest.raises(ValueError, match="bucket_ladder"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu", bucket_ladder=-1)


# -- the frontier mask ------------------------------------------------------------


def _frontier_with_stale_lanes(live_frac, seed):
    """A 2pc-5 frontier of 128 lanes from the JAX fused wave: its live
    lanes, and masked lanes that hold other reachable states (fresh ones
    the wave would insert, 40 levels deeper than the live lanes), plus the
    table after the waves before."""
    jmodel = JaxTwoPhaseSys(5)
    jwave = jax.jit(lambda *a: jax_fused_wave(jax_spec(jmodel), *a))
    states, hi, lo, depth = _initial(jmodel)
    table = np.zeros((4096 + 128, 2), np.uint32)
    F = 128
    levels = []
    while len(levels) < 8:
        Fn = hi.shape[0]
        pad = lambda x: np.concatenate([x, np.zeros((F - Fn,) + x.shape[1:], x.dtype)])  # noqa: E731
        out = jwave(table, jax.tree_util.tree_map(pad, states), pad(hi), pad(lo),
                    np.zeros(F, np.uint32), pad(depth), pad(np.ones(Fn, bool)), 100)
        n = min(int(np.asarray(out["stats"])[1]), F)
        levels.append((table, states, hi, lo, depth))
        table = np.asarray(out["table"])
        states, hi, lo, depth = (
            jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], out["new"][k])
            for k in ("states", "hi", "lo", "depth")
        )
    # Live lanes from level 5, stale lanes from levels 6 and 7 (never
    # inserted in level 5's table).
    table, s5, hi5, lo5, d5 = levels[5]
    _t7, s7, hi7, lo7, d7 = levels[7]
    rng = np.random.default_rng(seed)
    mask = rng.random(F) < live_frac
    pick5 = rng.integers(0, hi5.shape[0], size=F)
    pick7 = rng.integers(0, hi7.shape[0], size=F)
    take = lambda a, b: np.where(  # noqa: E731
        mask.reshape((F,) + (1,) * (a.ndim - 1)), a[pick5], b[pick7]
    )
    states = jax.tree_util.tree_map(take, s5, s7)
    depth = np.where(mask, d5[pick5], d7[pick7] + 40).astype(np.int32)
    ebits = rng.integers(0, 2, size=F).astype(np.uint32)
    return table, states, take(hi5, hi7), take(lo5, lo7), ebits, depth, mask


def _port_cols(states, hi, lo, ebits, depth):
    return ({k: _to_port(v) for k, v in states.items()},
            *(_to_port(x) for x in (hi, lo, ebits, depth)))


def _assert_outputs_equal(a, b):
    (ta, oa), (tb, ob) = a, b
    assert torch.equal(ta, tb)
    assert oa["stats"].tolist() == ob["stats"].tolist()
    n = oa["stats"].tolist()[1]
    for k in ("hi", "lo", "ebits", "depth"):
        assert torch.equal(oa["new"][k][:n], ob["new"][k][:n]), k
    for k in ("parent_hi", "parent_lo"):
        assert torch.equal(oa[k][:n], ob[k][:n]), k
    for k, v in oa["new"]["states"].items():
        assert torch.equal(v[:n], ob["new"]["states"][k][:n]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_wave_matches_jax_fused_wave(seed):
    """Any mask pattern: the port's masked wave (both engines' plain path)
    equals the JAX fused wave in interpret mode with that mask."""
    table, states, hi, lo, ebits, depth, mask = _frontier_with_stale_lanes(0.5, seed)
    jmodel, tmodel = JaxTwoPhaseSys(5), TwoPhaseSys(5)
    jout = jax.jit(lambda *a: jax_fused_wave(jax_spec(jmodel), *a))(
        table, states, hi, lo, ebits, depth, mask, 100
    )
    spec = port_spec(tmodel)
    cols = _port_cols(states, hi, lo, ebits, depth)
    tmask = torch.from_numpy(mask)
    for wave in (fw.fused_wave, fw.torch_wave):
        ttable, tout = wave(spec, table_from_numpy(table), *cols, 100, mask=tmask)
        assert np.array_equal(table_to_numpy(ttable), np.asarray(jout["table"]))
        stats = tout["stats"].tolist()
        assert stats[:5] == np.asarray(jout["stats"]).tolist()
        assert stats[5::3] == np.asarray(jout["prop_hit"]).astype(int).tolist()
        assert stats[6::3] == np.asarray(jout["prop_hi"]).tolist()
        assert stats[7::3] == np.asarray(jout["prop_lo"]).tolist()
        n = stats[1]
        assert n > 0
        for k in ("hi", "lo", "ebits", "depth"):
            assert np.array_equal(tout["new"][k][:n].numpy(),
                                  np.asarray(jout["new"][k])[:n].astype(np.int64)), k
        for k in ("parent_hi", "parent_lo"):
            assert np.array_equal(tout[k][:n].numpy(), np.asarray(jout[k])[:n]), k
        jnew = jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], jout["new"]["states"])
        for (jk, jl), (tk, tl) in zip(_leaves(jnew), _leaves(tout["new"]["states"])):
            assert jk == tk and np.array_equal(tl[:n].numpy(), jl.astype(np.int64)), jk


def test_masked_wave_equals_the_live_only_wave():
    """A ring take's mask is a prefix: the masked lanes (reachable,
    would-be fresh states, deeper than the live ones) change nothing
    against the wave over the live lanes alone."""
    table, states, hi, lo, ebits, depth, _ = _frontier_with_stale_lanes(1.0, 2)
    stale = _frontier_with_stale_lanes(0.0, 3)
    k = 77
    mask = np.arange(128) < k
    cat = lambda a, b: np.concatenate([a[:k], b[k:]])  # noqa: E731
    full = _port_cols(jax.tree_util.tree_map(cat, states, stale[1]), cat(hi, stale[2]),
                      cat(lo, stale[3]), cat(ebits, stale[4]), cat(depth, stale[5]))
    live = _port_cols(jax.tree_util.tree_map(lambda x: x[:k], states), hi[:k], lo[:k],
                      ebits[:k], depth[:k])
    spec = port_spec(TwoPhaseSys(5))
    for wave in (fw.fused_wave, fw.torch_wave):
        masked = wave(spec, table_from_numpy(table), *full, 100,
                      mask=torch.from_numpy(mask))
        alone = wave(spec, table_from_numpy(table), *live, 100)
        unmasked = wave(spec, table_from_numpy(table), *full, 100)
        _assert_outputs_equal(masked, alone)
        # Without the mask the stale lanes would have counted.
        assert unmasked[1]["stats"][0] > masked[1]["stats"][0]
        assert unmasked[1]["stats"][3] > masked[1]["stats"][3]


# -- the ring --------------------------------------------------------------------------


def _jax_rows(rows):
    return {
        "states": {k: jax.numpy.asarray(v.numpy().astype(np.uint32))
                   for k, v in rows["states"].items()},
        **{k: jax.numpy.asarray(rows[k].numpy().astype(
            np.int32 if k == "depth" else np.uint32)) for k in ("hi", "lo", "ebits", "depth")},
    }


def _assert_rows_equal(t, j, n=None):
    sl = slice(None) if n is None else slice(0, n)
    for k in ("hi", "lo", "ebits", "depth"):
        assert np.array_equal(t[k][sl].numpy(), np.asarray(j[k])[sl].astype(np.int64)), k
    for k, v in t["states"].items():
        assert np.array_equal(v[sl].numpy(), np.asarray(j["states"][k])[sl].astype(np.int64)), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_ops_match_jax_ring(seed):
    """Pushes with random masks and takes of random widths, wrapping the
    ring many times: the same pool, head, count, frontiers and export."""
    rng = np.random.default_rng(seed)
    cap = 64
    tmodel, jmodel = TwoPhaseSys(3), JaxTwoPhaseSys(3)
    tpool = ring.ring_rows(tmodel, cap + 1)
    jpool = jax_ring.ring_rows(jmodel, cap)
    thead = tcount = torch.zeros((), dtype=torch.int64)
    jhead = jcount = np.int32(0)
    for step in range(40):
        if rng.random() < 0.55:
            m = int(rng.integers(1, 24))
            rows = {
                "states": {
                    "rm": torch.from_numpy(rng.integers(0, 4, size=(m, 3))),
                    "tm": torch.from_numpy(rng.integers(0, 3, size=m)),
                    "prepared": torch.from_numpy(rng.integers(0, 8, size=m)),
                    "msgs": torch.from_numpy(rng.integers(0, 32, size=m)),
                },
                **{k: torch.from_numpy(rng.integers(0, 1 << 32, size=m))
                   for k in ("hi", "lo", "ebits")},
                "depth": torch.from_numpy(rng.integers(1, 50, size=m)),
            }
            mask = rng.random(m) < 0.6
            room = cap - int(tcount)
            mask &= np.cumsum(mask) <= room
            tcount = ring.ring_push(tpool, thead, tcount, rows, torch.from_numpy(mask), cap)
            jpool, jcount = jax_ring.ring_push(jpool, jhead, jcount, _jax_rows(rows),
                                               mask, cap)
        else:
            width = int(rng.choice([8, 16, 32]))
            tfr, thead, tcount, n = ring.ring_take(tpool, thead, tcount, cap, width)
            jfr, jhead, jcount = jax_ring.ring_take(jpool, jhead, jcount, cap, width)
            assert np.array_equal(tfr["mask"].numpy(), np.asarray(jfr["mask"]))
            assert int(n) == int(np.asarray(jfr["mask"]).sum())
            _assert_rows_equal(tfr, jfr, int(n))
        assert int(thead) == int(jhead) and int(tcount) == int(jcount)
        pool = {"states": {k: v[:cap] for k, v in tpool["states"].items()},
                **{k: tpool[k][:cap] for k in ("hi", "lo", "ebits", "depth")}}
        _assert_rows_equal(pool, jpool)
    texp = ring.ring_export(tpool, thead, tcount, cap)
    jexp = jax_ring.ring_export(jpool, jhead, jcount, cap)
    assert np.array_equal(texp["mask"].numpy(), np.asarray(jexp["mask"]))
    _assert_rows_equal(texp, jexp, int(tcount))


def test_ring_take_with_go_zero_takes_nothing():
    pool = ring.ring_rows(TwoPhaseSys(3), 17)
    head = torch.tensor(5)
    count = torch.tensor(9)
    fr, h, c, n = ring.ring_take(pool, head, count, 16, 8, go=torch.tensor(0))
    assert int(n) == 0 and int(h) == 5 and int(c) == 9 and not fr["mask"].any()
    fr, h, c, n = ring.ring_take(pool, head, count, 16, 8, go=torch.tensor(1))
    assert int(n) == 8 and int(h) == 13 and int(c) == 1 and fr["mask"].all()
