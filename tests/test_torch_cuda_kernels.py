"""The port's CUDA kernels on the card, against their plain torch twins.

The visited-set insert (``csrc/hashset_insert.cu``) against
``hashset_insert_sorted_plain``, and the fused wave's kernels
(``csrc/fused_wave.cu``) against ``fused_wave_plain``: single waves at
small shapes built to reach each hard case (masked frontiers included),
the fingerprint and sort stages alone, and whole runs on the card against
the CPU twin, wave at a time and through the captured deep drain.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs on a machine with only PyTorch; there, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.checker.gpu import _GRAPH_WAVES
from stateright_tpu_torch.core.batch import map_leaves
from stateright_tpu_torch.interop import keys_from_numpy, table_from_numpy, table_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.ops.fingerprint import fingerprint_state, fingerprint_words
from stateright_tpu_torch.ops.hashset import MAX_PROBES
from stateright_tpu_torch.ops.fingerprint import state_words
from stateright_tpu_torch.testing import SWEEP_CASES, sweep_case, sweep_table, tiles_to_redo

TILE_ROWS = hk.TILE_ROWS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sorted_batch(rng, n, active_frac=0.9, dup_frac=0.0, span=None):
    hi = rng.integers(0, span or (1 << 32), size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    if dup_frac:
        k = max(1, int(n * dup_frac))
        hi[:k] = hi[n // 2 : n // 2 + k]
        lo[:k] = lo[n // 2 : n // 2 + k]
    active = rng.random(n) < active_frac
    hi = np.where(active, hi, 0xFFFFFFFF).astype(np.uint32)
    lo = np.where(active, lo, 0xFFFFFFFF).astype(np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], active[order]


def empty_table(cap):
    return np.zeros((cap + MAX_PROBES, 2), np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "dense_overflow", "probe_overflow", "cross_tile"])
def test_cuda_insert_matches_plain_twin(cuda_device, case):
    rng = np.random.default_rng(0)
    if case == "random":
        table = empty_table(TILE_ROWS * 8)
        hi, lo, active = sorted_batch(rng, 20000, dup_frac=0.1)
    elif case == "dense_overflow":
        table = empty_table(TILE_ROWS * 2)
        hi, lo, active = sorted_batch(rng, 3500, active_frac=1.0, dup_frac=0.2, span=1 << 31)
    elif case == "probe_overflow":
        table = empty_table(TILE_ROWS * 2)
        n = MAX_PROBES + 16
        hi, lo, active = np.zeros(n, np.uint32), np.arange(1, n + 1, dtype=np.uint32), np.ones(n, bool)
    else:
        table = empty_table(TILE_ROWS * 2)
        shift = 32 - ((TILE_ROWS * 2).bit_length() - 1)
        hi = np.concatenate([np.full(64, (TILE_ROWS - 1) << shift), np.full(64, TILE_ROWS << shift)]).astype(np.uint32)
        lo = np.concatenate([np.arange(1, 65), np.arange(1, 65)]).astype(np.uint32)
        active = np.ones(128, bool)
    khi, klo = keys_from_numpy(hi, lo)
    act = torch.from_numpy(active)
    before = hk.launches
    pt, pf, pfo, pp = hk.hashset_insert_sorted(table_from_numpy(table), khi, klo, act)
    ct, cf, cfo, cp = hk.hashset_insert_sorted(
        table_from_numpy(table, cuda_device), khi.to(cuda_device),
        klo.to(cuda_device), act.to(cuda_device),
    )
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert np.array_equal(table_to_numpy(ct), table_to_numpy(pt))
    for p, c in ((pf, cf), (pfo, cfo), (pp, cp)):
        assert torch.equal(p, c.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_cuda_insert_repair_cases(cuda_device, case):
    """The hard cases of the ordered repair (``testing.SWEEP_CASES``): the
    kernel equals the plain twin, and its repair redid exactly the tiles
    whose predecessor spilled in the ordered result."""
    table, hi, lo, active = sweep_case(case)
    cap = table.shape[0] - MAX_PROBES
    khi, klo = keys_from_numpy(hi, lo)
    act = torch.from_numpy(active)
    pt, pf, pfo, pp = hk.hashset_insert_sorted(table_from_numpy(table), khi, klo, act)
    ct = table_from_numpy(table, cuda_device)
    dhi, dlo, dact = khi.to(cuda_device), klo.to(cuda_device), act.to(cuda_device)
    flags = [torch.empty_like(dact) for _ in range(3)]
    scratch = hk._launch(ct, dhi, dlo, dact, hk.tile_starts(dhi, cap), *flags)
    torch.cuda.synchronize()
    after = table_to_numpy(pt)
    assert np.array_equal(table_to_numpy(ct), after)
    for p, c in zip((pf, pfo, pp), flags):
        assert torch.equal(p, c.cpu())
    assert hk.tiles_redone(scratch) == tiles_to_redo(table, after, hi, lo, active) > 0


@pytest.mark.cuda
def test_cuda_checker_matches_cpu_twin(cuda_device):
    """2pc-5 on the card and on the CPU twin: same counts, same paths."""
    runs = [
        TwoPhaseSys(5).checker().spawn_gpu_bfs(
            frontier_capacity=256, table_capacity=1 << 12, device=d, max_drain_waves=1
        ).join()
        for d in (cuda_device, "cpu")
    ]
    gpu, cpu = runs
    assert gpu.unique_state_count() == cpu.unique_state_count() == 8832
    assert gpu.state_count() == cpu.state_count()
    assert gpu.max_depth() == cpu.max_depth()
    assert gpu.table_growths == cpu.table_growths >= 1
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()


# -- the fused wave ------------------------------------------------------------


def hop_spec(n, actions=4, bound=None):
    """A wave over states x in [0, n): action a takes x to (x + a) % n, so
    neighbouring frontier lanes share children (in-wave duplicates). Leaves
    of three dtypes exercise the byte-row gather; properties of all three
    kinds exercise the hits and the eventually bit."""

    def expand(st):
        x = st["x"][:, None] + torch.arange(actions, device=st["x"].device)
        x = x % n
        cand = {
            "x": x,
            "tag": torch.stack([x, x * 3, x * 7], dim=-1).to(torch.int16),
            "odd": (x % 2) == 1,
        }
        return cand, x != st["x"][:, None]

    def within(c):
        return torch.ones_like(c["x"], dtype=torch.bool) if bound is None else c["x"] < bound

    return fw.FusedWaveSpec(
        expand=expand,
        within_boundary=within,
        conditions=(lambda st: st["x"] % 97 != 5, lambda st: st["x"] % 101 == 3,
                    lambda st: st["x"] == n // 2),
        expectations=("always", "sometimes", "eventually"),
        ebit=((2, 0),),
        action_count=actions,
    )


def hop_frontier(xs, depth, ebits=1, device="cpu"):
    x = torch.as_tensor(xs, dtype=torch.int64)
    states = {"x": x, "tag": torch.stack([x, x * 3, x * 7], dim=-1).to(torch.int16),
              "odd": (x % 2) == 1}
    hi, lo = fingerprint_state(states)
    F = x.shape[0]
    cols = {"hi": hi, "lo": lo, "ebits": torch.full((F,), ebits, dtype=torch.int64),
            "depth": torch.as_tensor(depth, dtype=torch.int64).expand(F).contiguous()}
    return map_leaves(lambda t: t.to(device), states), {k: v.to(device) for k, v in cols.items()}


def fused_both(spec, table_np, states, cols, depth_cap, dev, mask=None):
    """One wave through the kernels and through the plain twin; asserts
    that every output agrees bit for bit and returns the plain stats."""
    before = fw.launches
    pt, pout = fw.fused_wave_plain(spec, table_from_numpy(table_np), states,
                                   cols["hi"], cols["lo"], cols["ebits"], cols["depth"], depth_cap,
                                   mask=mask)
    ct, cout = fw.fused_wave(
        spec, table_from_numpy(table_np, dev), map_leaves(lambda t: t.to(dev), states),
        *(cols[k].to(dev) for k in ("hi", "lo", "ebits", "depth")), depth_cap,
        mask=None if mask is None else mask.to(dev),
    )
    torch.cuda.synchronize()
    assert fw.launches == before + 1
    assert np.array_equal(table_to_numpy(ct), table_to_numpy(pt))
    stats = pout["stats"].tolist()
    assert cout["stats"].cpu().tolist() == stats
    n = stats[1]
    for k in ("hi", "lo", "ebits", "depth"):
        assert torch.equal(cout["new"][k][:n].cpu(), pout["new"][k][:n]), k
    for k in ("parent_hi", "parent_lo"):
        assert torch.equal(cout[k][:n].cpu(), pout[k][:n]), k
    for k, leaf in pout["new"]["states"].items():
        assert torch.equal(cout["new"]["states"][k][:n].cpu(), leaf[:n]), k
    return stats, table_to_numpy(pt)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["empty_frontier", "all_invalid", "duplicates", "overflow_rerun", "cross_tile"]
)
def test_cuda_fused_wave_matches_plain_twin(cuda_device, case):
    cap = TILE_ROWS * 2
    table = empty_table(cap)
    spec = hop_spec(5000)
    if case == "empty_frontier":
        states, cols = hop_frontier([], 1)
        stats, _ = fused_both(spec, table, states, cols, 10, cuda_device)
        assert stats[:5] == [0, 0, 0, 0, 0]
    elif case == "all_invalid":
        # Every lane is past the depth cap: nothing is generated, and the
        # terminal-only eventually property does not fire.
        states, cols = hop_frontier(list(range(64)), 5)
        stats, _ = fused_both(spec, table, states, cols, 5, cuda_device)
        assert stats[0] == stats[1] == 0 and stats[3] == 5
    elif case == "duplicates":
        # 600 consecutive states with 8 actions: most children come from 8
        # lanes; the lowest lane must win (the plain twin's stable sort).
        # Lanes at the boundary are terminal; every property hits.
        spec = hop_spec(5000, actions=8, bound=2590)
        states, cols = hop_frontier(list(range(2000, 2600)), 3)
        stats, _ = fused_both(spec, table, states, cols, 10, cuda_device)
        assert stats[1] == 589 and stats[4] == 1
        assert stats[5] == stats[8] == stats[11] == 1
    elif case == "overflow_rerun":
        # More fresh keys than a 4,096-row table holds: keys go pending;
        # the same wave again on the grown table (as the checker re-runs
        # it) must agree too.
        spec = hop_spec(1 << 20, actions=8)
        states, cols = hop_frontier(list(range(0, 8 * 700, 8)), 2)
        stats, after = fused_both(spec, table, states, cols, 10, cuda_device)
        assert stats[2] > 0
        grown = empty_table(cap * 4)
        stats2, _ = fused_both(spec, grown, states, cols, 10, cuda_device)
        assert stats2[2] == 0 and stats2[1] == 700 * 7
    else:
        # Rows around the tile boundary are taken, so keys homing below it
        # claim rows past it, which the next tile's keys must see.
        rng = np.random.default_rng(1)
        table[TILE_ROWS - 200 : TILE_ROWS + 40] = rng.integers(
            1, 1 << 32, size=(240, 2), dtype=np.uint64
        ).astype(np.uint32)
        states, cols = hop_frontier(list(range(0, 3000, 3)), 2)
        stats, after = fused_both(spec, table, states, cols, 10, cuda_device)
        assert (after[TILE_ROWS + 40 : TILE_ROWS + MAX_PROBES, 0] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["empty_after_home", "load_0_9"])
def test_cuda_fused_wave_over_sweep_tables(cuda_device, kind, monkeypatch):
    """A wave of 300 states over an 8,192-row table built around its own
    keys so that the sweep's repair has work (``testing.sweep_table``):
    the kernels equal the plain twin, and the repair redid exactly the
    tiles whose predecessor spilled in the ordered result."""
    spec = hop_spec(1 << 20, actions=8)
    states, cols = hop_frontier(list(range(0, 8 * 300, 8)), 2)
    _cond, cvalid, cand = fw.model_stage(spec, states, 300)
    khi, klo = fingerprint_words(state_words(cand))
    # The sweep's batch: valid keys sorted, the rest as (MAX, MAX) last;
    # the first copy of each key is active.
    key = np.sort(np.where(cvalid.numpy(), ((khi << 32) | klo).numpy().astype(np.uint64),
                           np.uint64(2**64 - 1)))
    active = (key != np.uint64(2**64 - 1)) & np.concatenate([[True], key[1:] != key[:-1]])
    hi, lo = (key >> np.uint64(32)).astype(np.uint32), (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    table = sweep_table(TILE_ROWS * 4, hi[active], lo[active], kind)
    scratches = []
    sweep_stage = fw.sweep_stage

    def spy(*args):
        flag, scratch = sweep_stage(*args)
        scratches.append(scratch)
        return flag, scratch

    monkeypatch.setattr(fw, "sweep_stage", spy)
    stats, after = fused_both(spec, table, states, cols, 10, cuda_device)
    assert stats[1] > 0 and stats[2] > 0
    assert hk.tiles_redone(scratches[0]) == tiles_to_redo(table, after, hi, lo, active) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [11, 65, 391])
def test_cuda_fingerprint_stage_matches_fingerprint_words(cuda_device, width):
    rng = np.random.default_rng(width)
    words = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(3000, width), dtype=np.uint64).astype(np.int64)
    )
    words[:2] = 0  # all-zero rows
    key, idx = fw.keys_stage(words.to(cuda_device),
                             torch.ones(3000, dtype=torch.bool, device=cuda_device))
    key = key.cpu()
    hi, lo = fingerprint_words(words)
    assert torch.equal((key >> 32) & 0xFFFFFFFF, hi)
    assert torch.equal(key & 0xFFFFFFFF, lo)
    assert torch.equal(idx.cpu(), torch.arange(3000, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2047, 2049, 50000])
def test_cuda_radix_sort_matches_stable_torch_sort(cuda_device, n):
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    dup = rng.integers(0, n, size=n // 2)
    hi[dup], lo[dup] = hi[dup[::-1]], lo[dup[::-1]]  # many equal keys
    hi[: n // 10] = 0xFFFFFFFF  # and the invalid-lane sentinel
    lo[: n // 10] = 0xFFFFFFFF
    thi = torch.from_numpy(hi.astype(np.int64))
    tlo = torch.from_numpy(lo.astype(np.int64))
    skey, sidx = torch.sort(hk.sort_key(thi, tlo), stable=True)
    key = ((thi << 32) | tlo).to(cuda_device)
    idx = torch.arange(n, dtype=torch.int32, device=cuda_device)
    fw.sort_stage(key, idx)
    assert torch.equal(key.cpu(), skey ^ (-(1 << 63)))
    assert torch.equal(idx.cpu().to(torch.int64), sidx)


@pytest.mark.cuda
def test_cuda_fused_checker_matches_cpu_twin(cuda_device):
    """2pc-5 through the fused kernels on the card and through the CPU
    twin: same counts, growths and paths."""
    fw.launches = 0
    gpu, cpu = [
        TwoPhaseSys(5).checker().spawn_gpu_bfs(
            frontier_capacity=256, table_capacity=1 << 12, device=d, wave_kernel="fused",
            max_drain_waves=1,
        ).join()
        for d in (cuda_device, "cpu")
    ]
    assert fw.launches >= gpu.waves > 0
    assert gpu.unique_state_count() == cpu.unique_state_count() == 8832
    assert gpu.state_count() == cpu.state_count()
    assert gpu.max_depth() == cpu.max_depth()
    assert gpu.waves == cpu.waves
    assert gpu.table_growths == cpu.table_growths >= 1
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["prefix", "random", "none_live"])
def test_cuda_masked_fused_wave_matches_plain_twin(cuda_device, pattern):
    """A frontier whose masked lanes hold other states (deeper, and some
    where every property hits): the kernels equal the plain twin with the
    mask, and the masked lanes count for nothing."""
    spec = hop_spec(5000, actions=8, bound=4000)
    xs = list(range(0, 3000, 3)) + list(range(3990, 4100))
    rng = np.random.default_rng(len(pattern))
    F = len(xs)
    if pattern == "prefix":
        mask = torch.arange(F) < 700
    elif pattern == "random":
        mask = torch.from_numpy(rng.random(F) < 0.5)
    else:
        mask = torch.zeros(F, dtype=torch.bool)
    depth = torch.where(mask, 2, 9)
    states, cols = hop_frontier(xs, depth)
    stats, _ = fused_both(spec, empty_table(TILE_ROWS * 4), states, cols, 10, cuda_device,
                          mask=mask)
    assert stats[3] == (2 if mask.any() else 0)
    if pattern == "none_live":
        assert stats[:5] == [0, 0, 0, 0, 0]


DRAIN_CASES = {
    # Ring growth, ring-full, budget and max-waves exits, many drains.
    "tiny": dict(frontier_capacity=32, table_capacity=2048, drain_log_factor=1,
                 pool_factor=1, max_drain_waves=3),
    # Every rung of a ladder, table growth between drains.
    "ladder": dict(frontier_capacity=256, table_capacity=1 << 12, bucket_ladder=2,
                   max_drain_waves=2),
    # The defaults: few long drains.
    "default": dict(frontier_capacity=256, table_capacity=1 << 12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
@pytest.mark.parametrize("case", list(DRAIN_CASES))
def test_cuda_captured_drain_matches_cpu_drain(cuda_device, wave_kernel, case):
    """2pc-5 through the captured drain on the card and the uncaptured
    drain of the CPU twin: the same counts, paths, drains, exits, rungs and
    growths; the card's waves ran in replayed graphs, and every replay
    counted the launches of all its waves (live, no-op) besides the
    warm-up waves."""
    spawn = dict(DRAIN_CASES[case], wave_kernel=wave_kernel)
    counter = fw if wave_kernel == "fused" else hk
    counter.launches = 0
    gpu = TwoPhaseSys(5).checker().spawn_gpu_bfs(device=cuda_device, **spawn).join()
    launches = counter.launches
    cpu = TwoPhaseSys(5).checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert gpu.worker_error() is None, gpu.worker_error()
    assert gpu.unique_state_count() == cpu.unique_state_count() == 8832
    assert gpu.state_count() == cpu.state_count() == 58146
    assert gpu.max_depth() == cpu.max_depth()
    assert gpu.waves == cpu.waves
    assert gpu.drains == cpu.drains > 1
    assert gpu.drain_exits == cpu.drain_exits
    assert gpu.rungs == cpu.rungs
    assert gpu.table_growths == cpu.table_growths
    assert gpu._pool_capacity == cpu._pool_capacity
    assert gpu.graph_captures >= 2 and gpu.graph_replays >= 2 * gpu.drains
    assert cpu.graph_captures == cpu.graph_replays == cpu.noop_waves == 0
    assert cpu.warmup_waves == 0
    assert gpu.warmup_waves == gpu.graph_captures // 2
    # Every replayed wave is live or a no-op; overflow retries add waves.
    assert gpu.waves + gpu.noop_waves >= gpu.graph_replays * _GRAPH_WAVES
    assert launches >= gpu.waves + gpu.noop_waves + gpu.warmup_waves
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()
    gpu.assert_properties()


class _SaltedTwoPhaseSys(TwoPhaseSys):
    """2pc with its own ``packed_fingerprint``: the ``"pairs"`` key route."""

    def packed_fingerprint(self, states):
        hi, lo = super().packed_fingerprint(states)
        return hi, lo ^ 1


def _route_model(route):
    from stateright_tpu_torch.models.paxos import PaxosModelCfg

    if route == "fold":
        return TwoPhaseSys(4), 1568
    if route == "comphash":
        return PaxosModelCfg(2, 2).into_model(), 111
    return _SaltedTwoPhaseSys(4), 1568


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fold", "comphash", "pairs"])
def test_cuda_key_routes_match_plain_twin(cuda_device, route):
    """Each key route of the fused wave on the card against the plain twin:
    the keys stage alone on a wave's candidates, then whole fused runs,
    wave at a time and drained, against the CPU twin."""
    model, expected = _route_model(route)
    checker = model.checker().spawn_gpu_bfs(
        device=cuda_device, wave_kernel="fused", frontier_capacity=64,
        table_capacity=1 << 12, max_drain_waves=1,
    ).join()
    assert checker.keys_route == route
    spec = checker._spec
    states = model.packed_init_states(cuda_device)
    F = states[next(iter(states))].shape[0]
    for _ in range(3):  # a few expansions deep, to reach varied candidates
        cand, valid = model.packed_expand(states)
        keep = valid.reshape(-1).nonzero().squeeze(1)
        states = map_leaves(lambda x: x.reshape((-1,) + x.shape[2:])[keep].contiguous(), cand)
        F = keep.shape[0]
    A = spec.action_count
    depth = torch.arange(F, device=cuda_device) % 5
    mask = torch.arange(F, device=cuda_device) % 3 != 0
    _cond, cvalid, cand_flat = fw.model_stage(spec, states, F)
    kin = fw.keys_input(spec, cand_flat)
    acc = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    key, idx = fw.route_keys_stage(spec, kin, cand_flat, cvalid, depth, 4, acc, mask)
    chi, clo = spec.fingerprint(map_leaves(lambda x: x.cpu(), cand_flat))
    pkey, pidx = fw.keys_plain(chi, clo, cvalid.cpu(), depth.cpu(), 4, A, mask.cpu())
    assert torch.equal(key.cpu(), pkey) and torch.equal(idx.cpu(), pidx)
    assert int(acc[0]) == int((pkey != -1).sum()) > 0
    for options in (dict(max_drain_waves=1), {}):
        spawn = dict(frontier_capacity=64, table_capacity=1 << 12, wave_kernel="fused",
                     **options)
        fw.comphash_launches = 0
        gpu = _route_model(route)[0].checker().spawn_gpu_bfs(device=cuda_device,
                                                            **spawn).join()
        assert (fw.comphash_launches > 0) == (route == "comphash")
        cpu = _route_model(route)[0].checker().spawn_gpu_bfs(device="cpu", **spawn).join()
        assert gpu.unique_state_count() == cpu.unique_state_count() == expected
        assert gpu.state_count() == cpu.state_count()
        assert gpu.max_depth() == cpu.max_depth() and gpu.waves == cpu.waves
        for name, path in cpu.discoveries().items():
            assert gpu.discoveries()[name].encode() == path.encode()
