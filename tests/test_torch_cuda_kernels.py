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

import dataclasses
import math

import numpy as np
import pytest
import torch

from stateright_tpu_torch.checker.gpu import _GRAPH_WAVES
from stateright_tpu_torch.core.batch import leaves, map_leaves
from stateright_tpu_torch.interop import keys_from_numpy, table_from_numpy, table_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.ops.fingerprint import fingerprint_state, fingerprint_words
from stateright_tpu_torch.ops.hashset import MAX_PROBES
from stateright_tpu_torch.ops.fingerprint import state_words
from stateright_tpu_torch.testing import SWEEP_CASES, sweep_case, sweep_table, tiles_to_redo

from torch_dedup_cases import A as DEDUP_A
from torch_dedup_cases import CASES as DEDUP_CASES
from torch_dedup_cases import DEPTH_CAP as DEDUP_DEPTH_CAP
from torch_dedup_cases import sorted_wave, wave_lanes

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
            wave_kernel="staged", frontier_capacity=256, table_capacity=1 << 12, device=d,
            max_drain_waves=1
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


@pytest.mark.cuda
@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
def test_cuda_budgeted_resume_matches_cpu_twin(cuda_device, tmp_path, wave_kernel):
    """A 2pc-5 checkpoint written with no budget resumes at the smallest
    admissible budget on the card as on the CPU twin: the restore's batched
    rebuild through the insert kernel evicts, and the run goes on wave at a
    time with the host probe. Same counts, evictions and paths."""
    from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib

    spawn = dict(wave_kernel=wave_kernel, frontier_capacity=64, table_capacity=1 << 12)
    budget = min_admissible_hbm_budget_mib(TwoPhaseSys(5), 64)
    runs = []
    for d in (cuda_device, "cpu"):
        path = tmp_path / f"{d}.ckpt"
        TwoPhaseSys(5).checker().target_state_count(35000).spawn_gpu_bfs(
            device=d, checkpoint_path=str(path), checkpoint_every_chunks=8,
            max_drain_waves=1, **spawn).join()
        runs.append(TwoPhaseSys(5).checker().spawn_gpu_bfs(
            device=d, hbm_budget_mib=budget, resume_from=str(path), **spawn).join())
    gpu, cpu = runs
    assert gpu.worker_error() is None
    assert gpu.unique_state_count() == cpu.unique_state_count() == 8832
    assert gpu.state_count() == cpu.state_count()
    assert gpu.max_depth() == cpu.max_depth()
    assert gpu.restore_inserts == cpu.restore_inserts >= 2
    assert gpu.evictions == cpu.evictions >= 1
    assert gpu.storage_fps == cpu.storage_fps
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()


@pytest.mark.cuda
@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
@pytest.mark.parametrize("max_drain_waves", [1, 100_000])
def test_cuda_attributed_run_matches_cpu_twin(cuda_device, wave_kernel, max_drain_waves):
    """2pc-5 attributed on the card and on the CPU twin: the same counts and
    paths, the ledger within tolerance on the card, a ``compile`` window for
    each drain graph captured, and probe-length counts over every key."""
    spawn = dict(wave_kernel=wave_kernel, frontier_capacity=256, table_capacity=1 << 12,
                 max_drain_waves=max_drain_waves, attribution=True)
    runs = [TwoPhaseSys(5).checker().spawn_gpu_bfs(device=d, **spawn).join()
            for d in (cuda_device, "cpu")]
    gpu, cpu = runs
    assert gpu.worker_error() is None
    assert gpu.unique_state_count() == cpu.unique_state_count() == 8832
    assert gpu.state_count() == cpu.state_count()
    assert gpu.max_depth() == cpu.max_depth()
    assert (gpu.waves, gpu.drains, dict(gpu.rungs)) == (cpu.waves, cpu.drains, dict(cpu.rungs))
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()
    rep = gpu.attribution_report()
    assert rep["within_tolerance"], rep
    assert rep["phase_windows"].get("compile", 0) == gpu.graph_captures
    assert (gpu.graph_captures > 0) == (max_drain_waves > 1)
    assert rep["drains"] == gpu.drains
    phase = "wave_kernel" if wave_kernel == "fused" else "device"
    assert rep["phases_s"][phase] > 0
    assert sum(rep["probe_length_counts"]) == 8832
    assert rep["probe_length_counts"] == cpu.attribution_report()["probe_length_counts"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,capacity", [(0, 3000, 1 << 13), (1, 70_000, 1 << 17)])
def test_cuda_probe_length_counts_match_cpu(cuda_device, seed, n, capacity):
    """``hashset_probe_length_counts`` of a table on the card equals the
    counts of the same table on the CPU."""
    from stateright_tpu_torch.ops.hashset import hashset_probe_length_counts

    rng = np.random.default_rng(seed)
    hi, lo, active = sorted_batch(rng, n, active_frac=0.9, dup_frac=0.05)
    table = table_from_numpy(empty_table(capacity), cuda_device)
    table, fresh, _found, pending = hk.hashset_insert_sorted(
        table, *keys_from_numpy(hi, lo, cuda_device), torch.from_numpy(active).to(cuda_device))
    assert not bool(pending.any())
    got = hashset_probe_length_counts(table)
    want = hashset_probe_length_counts(table.cpu())
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert got.sum() == int(fresh.sum())


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


# Two-word rows whose fold, before the nudges, is (0, 0) and (MAX, MAX):
# found by a search over the first word, the second solving the hi lane.
NUDGED_ROWS = [[1689074672, 2638689674], [3058510183, 416712412]]

# Element dtypes of the fold route's leaves (every dtype ``_leaf_words``
# converts), taken in turn by ``fold_state``.
FOLD_DTYPES = (torch.int64, torch.int8, torch.int16, torch.bool, torch.uint8, torch.uint16,
               torch.int32, torch.float32)


def fold_leaf(rng, B, w, dtype):
    """B rows of w elements of ``dtype``: negative small ints, int64 with
    its high bits set, float32 NaN, -0.0 and infinities among them."""
    if dtype == torch.bool:
        x = rng.random((B, w)) < 0.5
    elif dtype == torch.float32:
        x = rng.standard_normal((B, w)).astype(np.float32)
        x.reshape(-1)[::5] = np.nan
        x.reshape(-1)[1::5] = -0.0
        x.reshape(-1)[2::7] = -np.inf
    elif dtype == torch.int64:
        x = rng.integers(-(1 << 63), (1 << 63) - 1, (B, w), dtype=np.int64)
    else:
        info = torch.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, (B, w), dtype=np.int64)
        return torch.from_numpy(x).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(x))


def all_ones(x):
    """Every element of x with all its bits set, in place."""
    if x.dtype == torch.bool:
        x.fill_(True)
    elif x.dtype == torch.float32:
        x.view(torch.int32).fill_(-1)
    else:
        x.fill_(-1 if torch.iinfo(x.dtype).min < 0 else torch.iinfo(x.dtype).max)


def fold_state(rng, B, W):
    """A packed state of B lanes whose rows are W words: leaves of odd
    widths (1, 3, 5, ...), the last taking what is left, their dtypes in
    turn from ``FOLD_DTYPES``; lanes 0-1 hold all-zero words, lanes 2-3
    all-ones words (every element -1, or true)."""
    state, left, i = {}, W, 0
    while left:
        w = min(2 * i + 1, left)
        dtype = FOLD_DTYPES[i % len(FOLD_DTYPES)]
        x = fold_leaf(rng, B, w, dtype)
        x[:2] = 0
        all_ones(x[2:4])
        state[f"leaf{i:02d}"] = x if w > 1 or i % 2 else x.reshape(B)
        left -= w
        i += 1
    return state


def check_fold_keys(state, B, dev, masked, seed=0, dstate=None):
    """``keys_stage`` on the card (over ``dstate``, or ``state`` copied to
    ``dev``) against ``keys_plain`` over ``fingerprint_state``
    (``fingerprint_words(state_words(...))``) of ``state``, bit for bit,
    with its count of valid lanes; returns the valid count."""
    rng = np.random.default_rng(seed)
    A = 7
    cvalid = torch.from_numpy(rng.random(B) < 0.6)
    cvalid[:4] = True
    depth = mask = None
    if masked:
        F = -(-B // A)
        depth = torch.from_numpy(rng.integers(0, 6, F, dtype=np.int64))
        mask = torch.from_numpy(rng.random(F) < 0.8)
        depth[0] = 0
        mask[0] = True
    acc = torch.full((5,), 0, dtype=torch.int64, device=dev)
    on = lambda x: None if x is None else x.to(dev)  # noqa: E731
    before = fw.keys_launches
    dstate = map_leaves(on, state) if dstate is None else dstate
    key, idx = fw.keys_stage(dstate, cvalid.to(dev), on(depth), 4, A, acc, on(mask))
    torch.cuda.synchronize()
    assert fw.keys_launches == before + 1
    chi, clo = fingerprint_state(state)
    pkey, pidx = fw.keys_plain(chi, clo, cvalid, depth, 4, A, mask)
    assert torch.equal(key.cpu(), pkey)
    assert torch.equal(idx.cpu(), pidx)
    n_valid = int((pkey != -1).sum())
    assert int(acc[0]) == n_valid
    return n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("W", [1, 11, 16, 64, 65, 391])
def test_cuda_fold_keys_read_leaves_in_place(cuda_device, W, masked):
    """The fold route's keys stage over leaves of every dtype that
    ``_leaf_words`` converts, in odd widths summing to W words a row (the
    serial fold up to 64 words, the chunked fold above), at B = 3,001
    lanes (not a multiple of a block), with and without the frontier's
    depth cap and mask."""
    state = fold_state(np.random.default_rng(W), 3001, W)
    assert sum(math.prod(x.shape[1:]) for x in leaves(state)) == W
    assert check_fold_keys(state, 3001, cuda_device, masked, seed=W) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "empty", "no_valid_lane", "nudged"])
def test_cuda_fold_keys_edge_cases(cuda_device, case):
    """Leaf views at odd offsets (base addresses not 16-byte aligned), no
    lane, a batch with no valid lane, and rows whose fold
    before the nudges is (0, 0) or (MAX, MAX) (found by a search; the
    nudges make them (0, 1) and (MAX, MAX - 1))."""
    rng = np.random.default_rng(7)
    B = 1000
    if case == "unaligned":
        big = {k: fold_leaf(rng, B + 4, 5, dt) for k, dt in
               (("a", torch.int8), ("b", torch.int64), ("c", torch.int16), ("d", torch.bool))}
        dbig = map_leaves(lambda x: x.to(cuda_device), big)
        dstate = {k: x[i + 1:i + 1 + B] for i, (k, x) in enumerate(dbig.items())}
        assert sorted(x.data_ptr() % 16 for x in leaves(dstate)) == [0, 4, 5, 14]
        state = {k: x[i + 1:i + 1 + B] for i, (k, x) in enumerate(big.items())}
        check_fold_keys(state, B, cuda_device, True, dstate=dstate)
    elif case == "empty":
        state = {"a": torch.zeros((0, 3), dtype=torch.int64), "b": torch.zeros(0, dtype=torch.int8)}
        assert check_fold_keys(state, 0, cuda_device, False) == 0
    elif case == "no_valid_lane":
        state = fold_state(rng, B, 11)
        cvalid = torch.zeros(B, dtype=torch.bool, device=cuda_device)
        acc = torch.zeros(4, dtype=torch.int64, device=cuda_device)
        key, idx = fw.keys_stage(map_leaves(lambda x: x.to(cuda_device), state), cvalid, acc=acc)
        assert (key.cpu() == -1).all() and int(acc[0]) == 0
        assert torch.equal(idx.cpu(), torch.arange(B, dtype=torch.int32))
    else:
        words = torch.tensor(NUDGED_ROWS, dtype=torch.int64)
        hi, lo = fingerprint_words(words)
        assert hi.tolist() == [0, 0xFFFFFFFF] and lo.tolist() == [1, 0xFFFFFFFE]
        state = {"w": torch.cat([words, torch.zeros((B - 2, 2), dtype=torch.int64)])}
        check_fold_keys(state, B, cuda_device, False)


@pytest.mark.cuda
def test_cuda_fold_keys_replay_in_a_cuda_graph(cuda_device):
    """The fold keys stage captured in a CUDA Graph and replayed over new
    leaf contents written in place (the drain's replays read the leaves the
    model stage rewrote), equal to the plain twin each time."""
    rng = np.random.default_rng(11)
    B = 20000
    state = map_leaves(lambda x: x.to(cuda_device), fold_state(rng, B, 16))
    cvalid = torch.from_numpy(rng.random(B) < 0.3).to(cuda_device)
    acc = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fw.keys_stage(state, cvalid, acc=acc)  # warm-up: builds and loads the kernels
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc.zero_()
        key, idx = fw.keys_stage(state, cvalid, acc=acc)
    for seed in (1, 2, 3):
        fresh = fold_state(np.random.default_rng(seed), B, 16)
        for x, y in zip(leaves(state), leaves(fresh)):
            x.copy_(y)
        cvalid.copy_(torch.from_numpy(np.random.default_rng(seed).random(B) < 0.5))
        graph.replay()
        torch.cuda.synchronize()
        chi, clo = fingerprint_state(fresh)
        pkey, _ = fw.keys_plain(chi, clo, cvalid.cpu())
        assert torch.equal(key.cpu(), pkey)
        assert int(acc[0]) == int(cvalid.sum())


def frontier_inputs(F, A, P, masked, seed=0):
    """A frontier stage's inputs (CPU): properties of all three kinds in
    turn, dense conditions (many hits per property, so the first hit is
    the lowest of many), eventually bits, depths around the cap, a fifth of
    the lanes with no valid candidate, and a mask when ``masked``."""
    rng = np.random.default_rng(seed)
    kinds = tuple(("always", "sometimes", "eventually")[i % 3] for i in range(P))
    ev = [i for i, k in enumerate(kinds) if k == "eventually"]
    spec = fw.FusedWaveSpec(expand=None, within_boundary=None,
                            conditions=tuple(None for _ in range(P)), expectations=kinds,
                            ebit=tuple((pi, b % 32) for b, pi in enumerate(ev)),
                            action_count=A)
    cond = torch.from_numpy(rng.random((P, F)) < np.where(np.arange(P) % 3 == 0, 0.9, 0.3)[:, None])
    cvalid = torch.from_numpy(((rng.random((F, A)) < 0.2) & (rng.random(F) < 0.8)[:, None])
                              .reshape(-1))
    ebits = torch.from_numpy(rng.integers(0, 1 << 32, F, dtype=np.int64))
    depth = torch.from_numpy(rng.integers(0, 12, F, dtype=np.int64))
    mask = torch.from_numpy(rng.random(F) < 0.7) if masked else None
    return spec, cond, cvalid, ebits, depth, mask


def check_frontier(spec, ins, dev, depth_cap=9):
    """``frontier_stage`` on the card against ``frontier_plain`` on the
    CPU: ``ebits_after``, every ``acc`` slot and the stats vector that
    ``fw_compact`` then writes from them."""
    P = len(spec.conditions)
    on = lambda x: None if x is None else x.to(dev)  # noqa: E731
    cond, cvalid, ebits, depth, mask = ins
    pacc = torch.zeros(4 + P, dtype=torch.int64)
    peb = fw.frontier_plain(spec, cond, cvalid, ebits, depth, depth_cap, pacc, mask)
    acc = torch.full((4 + P,), -5, dtype=torch.int64, device=dev)  # reset by the stage
    before = fw.frontier_launches
    eb = fw.frontier_stage(spec, *map(on, ins[:4]), depth_cap, acc, on(mask))
    F = depth.shape[0]
    hi = torch.arange(F, dtype=torch.int64, device=dev) * 3 + 1
    # The stats vector as fw_compact writes it, over a wave
    # with no fresh key.
    B = F * spec.action_count
    stats = torch.empty(5 + 3 * P, dtype=torch.int64, device=dev)
    fw.compact_stage(torch.zeros(B, dtype=torch.uint8, device=dev),
                     torch.full((B,), -1, dtype=torch.int64, device=dev),
                     torch.arange(B, dtype=torch.int32, device=dev), spec.action_count, eb,
                     on(depth), hi, hi + 1, acc, stats=stats)
    torch.cuda.synchronize()
    assert fw.frontier_launches == before + 1 and fw.frontier_device_ops == 2
    assert torch.equal(eb.cpu(), peb)
    assert torch.equal(acc.cpu(), pacc)
    first = [~x if x else 0 for x in pacc[4:].tolist()]
    want = [0, 0, 0, int(pacc[3]), int(any(pacc[4:].tolist()))]
    for f, x in zip(first, pacc[4:].tolist()):
        want += [int(x != 0), 3 * f + 1 if F else 0, 3 * f + 2 if F else 0]
    assert stats.cpu().tolist() == want
    return pacc


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P", [0, 1, fw.MAX_PROPS])
@pytest.mark.parametrize("A", [1, 42, 125])
def test_cuda_frontier_matches_plain_twin(cuda_device, A, P, masked):
    """``fw_frontier`` (a memset and one kernel a wave) against its plain
    twin, F = 2,049 frontier lanes (not a multiple of a block's), A
    actions, P properties of all three kinds, with masked lanes and depth
    caps."""
    spec, *ins = frontier_inputs(2049, A, P, masked, seed=A + P)
    acc = check_frontier(spec, ins, cuda_device)
    if P:
        assert (acc[4:] != 0).any()


@pytest.mark.cuda
def test_cuda_frontier_edge_cases(cuda_device):
    """No frontier lane, every lane past the cap, a single lane, and a
    wider frontier (9,001 lanes)."""
    spec, *ins = frontier_inputs(0, 5, 3, True)
    check_frontier(spec, ins, cuda_device)
    spec, *ins = frontier_inputs(300, 5, 3, False, seed=1)
    acc = check_frontier(spec, ins, cuda_device, depth_cap=0)
    assert acc[4:].tolist() == [0, 0, 0]
    spec, *ins = frontier_inputs(1, 125, fw.MAX_PROPS, False, seed=2)
    check_frontier(spec, ins, cuda_device)
    spec, *ins = frontier_inputs(9001, 3, 3, True, seed=3)
    acc = check_frontier(spec, ins, cuda_device)
    assert (acc[4:] != 0).all()


@pytest.mark.cuda
def test_cuda_frontier_replays_in_a_cuda_graph(cuda_device):
    """The frontier stage and the stats captured in a CUDA Graph and
    replayed over new conditions, valid bits and depths: the memset inside
    the graph resets the counters each replay."""
    F, A, P = 8192, 42, 6
    spec, *ins = frontier_inputs(F, A, P, True)
    dev_ins = [x.to(cuda_device) for x in ins]
    acc = torch.zeros(4 + P, dtype=torch.int64, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fw.frontier_stage(spec, *dev_ins[:4], 9, acc, dev_ins[4])  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eb = fw.frontier_stage(spec, *dev_ins[:4], 9, acc, dev_ins[4])
    for seed in (3, 4, 5):
        _spec, *new = frontier_inputs(F, A, P, True, seed=seed)
        for x, y in zip(dev_ins, new):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        pacc = torch.zeros(4 + P, dtype=torch.int64)
        peb = fw.frontier_plain(spec, *new[:4], 9, pacc, new[4])
        assert torch.equal(eb.cpu(), peb) and torch.equal(acc.cpu(), pacc)
        assert (pacc[4:] != 0).any()


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


def sort_keys(n, sentinels, placement, seed=0):
    """u64 keys (repeats, values at and above 2^63) with a share of ~0
    sentinel lanes placed first, last or interleaved."""
    rng = np.random.default_rng(seed + n)
    keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    keys[rng.integers(0, n, size=n // 2)] = keys[rng.integers(0, n, size=n // 2)]
    k = int(round(n * sentinels))
    if placement == "first":
        where = np.arange(k)
    elif placement == "last":
        where = np.arange(n - k, n)
    else:
        where = rng.permutation(n)[:k]
    keys[where] = np.uint64(2**64 - 1)
    return keys


def check_sort(keys, dev):
    n = keys.shape[0]
    key = torch.from_numpy(keys.view(np.int64).copy()).to(dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    before = fw.sort_launches
    fw.sort_stage(key, idx)
    torch.cuda.synchronize()
    assert fw.sort_launches == before + 1 and fw.sort_device_ops == 10
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(key.cpu().numpy().view(np.uint64), keys[order])
    assert np.array_equal(idx.cpu().numpy(), order.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["first", "last", "interleaved"])
@pytest.mark.parametrize("sentinels", [0.0, 0.1, 0.76, 1.0])
@pytest.mark.parametrize("n", [1, 2047, 2049, 50000, 344064])
def test_cuda_onesweep_sort_matches_stable_torch_sort(cuda_device, n, sentinels, placement):
    """``fw_sort`` (the partition, then 8 onesweep passes over the keyed
    lanes) against a stable sort of the u64 keys, at the tile edges and at
    2pc-8's width, with 0 to 100% sentinel lanes anywhere."""
    check_sort(sort_keys(n, sentinels, placement), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_keyed_lane", "all_ones_among_keys", "top_bit",
                                  "one_digit_value"])
def test_cuda_onesweep_sort_edge_cases(cuda_device, case):
    """No keyed lane (n_live = 0); keys next to the sentinel
    (0xFFFF...FFFE, (MAX, 0)) among sentinels; keys with the top bit set
    (negative as int64) that must sort above the others; every key equal
    in all but one byte."""
    rng = np.random.default_rng(7)
    n = 70000
    if case == "no_keyed_lane":
        keys = np.full(n, 2**64 - 1, dtype=np.uint64)
    elif case == "all_ones_among_keys":
        keys = rng.choice(np.array([2**64 - 1, 2**64 - 2, 0xFFFFFFFF00000000, 1, 0],
                                   dtype=np.uint64), size=n)
    elif case == "top_bit":
        keys = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
        keys[rng.random(n) < 0.5] |= np.uint64(1 << 63)
    else:
        keys = np.full(n, 0x0123456789ABCDEF, dtype=np.uint64)
        keys ^= rng.integers(0, 256, size=n, dtype=np.uint64) << np.uint64(40)
    check_sort(keys, cuda_device)


@pytest.mark.cuda
def test_cuda_onesweep_sort_replays_in_a_cuda_graph(cuda_device):
    """The sort captured in a CUDA Graph and replayed twice over new keys:
    its tickets, histograms and look-back words are reset on the stream
    inside the graph, so each replay sorts its own keys."""
    n = 50000
    key = torch.zeros(n, dtype=torch.int64, device=cuda_device)
    idx = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    first = sort_keys(n, 0.3, "interleaved", seed=1)
    key.copy_(torch.from_numpy(first.view(np.int64)))
    idx.copy_(iota)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fw.sort_stage(key, idx)  # warm-up: builds and loads the kernels
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fw.sort_stage(key, idx)
    for seed, sentinels in ((2, 0.76), (3, 0.0)):
        keys = sort_keys(n, sentinels, "interleaved", seed=seed)
        key.copy_(torch.from_numpy(keys.view(np.int64)))
        idx.copy_(iota)
        graph.replay()
        torch.cuda.synchronize()
        order = np.argsort(keys, kind="stable")
        assert np.array_equal(key.cpu().numpy().view(np.uint64), keys[order])
        assert np.array_equal(idx.cpu().numpy(), order.astype(np.int32))


def gather_leaves(rng, Bn, case):
    """Candidate leaves of many dtypes and widths (rows of 1 to 4,304 B,
    some not a multiple of 16 B), or more than 16 leaves."""
    ints = lambda shape, dt: torch.from_numpy(  # noqa: E731
        rng.integers(-(1 << 30), 1 << 30, size=shape).astype(dt))
    if case == "many_leaves":
        return {f"l{i}": ints((Bn,) + (i % 5 + 1,), np.int64 if i % 2 else np.int32)
                for i in range(20)}
    if case == "narrow":
        return {"bytes3": ints((Bn, 3), np.int8), "int3": ints((Bn, 3), np.int32),
                "flag": torch.from_numpy(rng.random(Bn) < 0.5)}
    if case == "medium":
        return {"long11": ints((Bn, 11), np.int64), "short5": ints((Bn, 5), np.int16)}
    return {
        "bytes3": ints((Bn, 3), np.int8),
        "short5": ints((Bn, 5), np.int16),
        "int3": ints((Bn, 3), np.int32),
        "long3": ints((Bn, 3), np.int64),
        "long6": ints((Bn, 2, 3), np.int64),
        "flag": torch.from_numpy(rng.random(Bn) < 0.5),
        "wide": ints((Bn, 538), np.int64),
    }


# The lanes a row that ``_group`` gives each case's widest leaf: 3 units
# (narrow), 5 (many_leaves: 40-byte rows of 8-byte units), 11 (medium:
# 2pc-8's 88-byte rows) and 269 (widths: paxos3's 4,304-byte rows).
GATHER_GROUPS = {"narrow": 4, "many_leaves": 8, "medium": 16, "widths": 32}


@pytest.mark.cuda
@pytest.mark.parametrize("n_new", ["zero", "some", "all"])
@pytest.mark.parametrize("case", list(GATHER_GROUPS))
def test_cuda_gather_matches_plain_twin(cuda_device, case, n_new):
    """``fw_gather`` against ``gather_plain`` (``x[src]`` over the first
    ``n_new`` rows): 1-, 2-, 4-, 8- and 16-byte units, rows that are not a
    multiple of 16 B, more than 16 leaves (two launches), n_new of 0 and of
    B, and each group of lanes a row, 4 to 32, reached through the leaves'
    widths."""
    rng = np.random.default_rng(len(case) + len(n_new))
    Bn = 3000
    cand = gather_leaves(rng, Bn, case)
    n = {"zero": 0, "some": 1234, "all": Bn}[n_new]
    src = torch.from_numpy(rng.integers(0, Bn, size=Bn).astype(np.int64))
    acc = torch.tensor([0, n, 0, 0], dtype=torch.int64)
    want = fw.gather_plain(src, acc, cand)
    dev = map_leaves(lambda x: x.to(cuda_device), cand)
    rbs = [x[0].numel() * x.element_size() for x in leaves(dev)]
    units = [rb // fw._unit(rb, x.data_ptr()) for rb, x in zip(rbs, leaves(dev))]
    assert fw._group(units) == GATHER_GROUPS[case]
    before = fw.gather_launches
    got = fw.gather_stage(src.to(cuda_device), acc.to(cuda_device), dev)
    torch.cuda.synchronize()
    assert fw.gather_launches == before + (2 if case == "many_leaves" else 1)
    for k, x in want.items():
        assert got[k].shape == x.shape and got[k].dtype == x.dtype, k
        assert torch.equal(got[k][:n].cpu(), x[:n]), k


def ones_spec(n, actions, target):
    """A wave over states x in [0, n) whose every action is valid (x to
    (x + a + 1) % n) and whose fingerprint, on the ``"pairs"`` key route,
    is (MAX, MAX) for the candidate ``target``."""
    base = hop_spec(n, actions=actions)

    def expand(st):
        x = (st["x"][:, None] + 1 + torch.arange(actions, device=st["x"].device)) % n
        cand = {"x": x, "tag": torch.stack([x, x * 3, x * 7], dim=-1).to(torch.int16),
                "odd": (x % 2) == 1}
        return cand, torch.ones_like(x, dtype=torch.bool)

    def fingerprint(cand):
        hi, lo = fingerprint_state(cand)
        ones = cand["x"] == target
        return torch.where(ones, 0xFFFFFFFF, hi), torch.where(ones, 0xFFFFFFFF, lo)

    return dataclasses.replace(base, expand=expand, fingerprint=fingerprint,
                               keys_route="pairs")


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["valid_first", "after_invalid"])
def test_cuda_all_ones_fingerprint_matches_plain_twin(cuda_device, order):
    """A valid candidate whose fingerprint is (MAX, MAX): where it is the
    lowest lane holding that key, the plain twin (and the reference,
    ``cvalid[sidx] & uniq``) inserts it, and so must the chain on the card;
    where a masked lane's sentinel sorts before it, neither does."""
    spec = ones_spec(5000, 4, target=101)
    states, cols = hop_frontier(list(range(100, 400)), 2)
    mask = None
    if order == "after_invalid":
        mask = torch.ones(300, dtype=torch.bool)
        mask[0] = False  # lanes 0..3 sink to the sentinel, below lane 4 (x = 102)
        spec = ones_spec(5000, 4, target=102)
    stats, after = fused_both(spec, empty_table(TILE_ROWS * 4), states, cols, 10, cuda_device,
                              mask=mask)
    has_ones = bool(((after[:, 0] == 0xFFFFFFFF) & (after[:, 1] == 0xFFFFFFFF)).any())
    assert has_ones == (order == "valid_first")
    assert stats[1] > 0


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


def two_phase_frontier(n, waves):
    """The spec of ``TwoPhaseSys(n)`` with every property, and its frontier
    after ``waves`` waves of the plain wave from the initial states with
    the table it ran on."""
    from stateright_tpu_torch.core.model import Expectation

    model = TwoPhaseSys(n)
    props = model.properties()
    ebit = [i for i, p in enumerate(props) if p.expectation == Expectation.EVENTUALLY]
    spec = fw.FusedWaveSpec(
        expand=model.packed_expand, within_boundary=model.packed_within_boundary,
        conditions=tuple(model.packed_conditions()),
        expectations=tuple(p.expectation.value for p in props),
        ebit=tuple((pi, b) for b, pi in enumerate(ebit)),
        action_count=model.packed_action_count())
    states = model.packed_init_states()
    hi, lo = model.packed_fingerprint(states)
    F = hi.shape[0]
    cols = {"hi": hi, "lo": lo,
            "ebits": torch.full((F,), sum(1 << b for b in range(len(ebit))), dtype=torch.int64),
            "depth": torch.ones(F, dtype=torch.int64)}
    table = table_from_numpy(empty_table(1 << 16))
    for _ in range(waves):
        table, out = fw.fused_wave_plain(spec, table, states, cols["hi"], cols["lo"],
                                         cols["ebits"], cols["depth"], 1 << 20)
        n_new = int(out["stats"][1])
        states = map_leaves(lambda x: x[:n_new].clone(), out["new"]["states"])
        cols = {k: out["new"][k][:n_new].clone() for k in ("hi", "lo", "ebits", "depth")}
    return spec, table_to_numpy(table), states, cols


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2pc8", "property_hit", "zero_lane_drain_wave",
                                  "no_property"])
def test_cuda_compact_writes_the_stats_vector(cuda_device, case):
    """The wave's stats vector, written by ``fw_compact``'s last tile with
    no stage of its own (no ``stats_stage``, no ``stats_kernel``), equals
    the plain wave's ``_stats`` bit for bit: on a 2pc-8 wave, on a wave
    where every property hits, on a drain wave that takes no lane, and on a
    spec with no property (P = 0)."""
    assert not hasattr(fw, "stats_stage")
    if case == "2pc8":
        spec, table, states, cols = two_phase_frontier(8, 5)
        before = fw.compact_launches
        stats, _ = fused_both(spec, table, states, cols, 1 << 20, cuda_device)
        assert fw.compact_launches == before + 1
        assert stats[1] > 0 and len(stats) == 5 + 3 * len(spec.conditions)
        return
    spec = hop_spec(5000, actions=8, bound=2590)
    states, cols = hop_frontier(list(range(2000, 2600)), 3)
    mask = None
    if case == "zero_lane_drain_wave":
        mask = torch.zeros(600, dtype=torch.bool)
    elif case == "no_property":
        spec = dataclasses.replace(spec, conditions=(), expectations=(), ebit=())
    stats, _ = fused_both(spec, empty_table(TILE_ROWS * 2), states, cols, 10, cuda_device,
                          mask=mask)
    if case == "property_hit":
        assert stats[4] == 1 and stats[5] == stats[8] == stats[11] == 1
    elif case == "zero_lane_drain_wave":
        # No lane hits: each property's (hi, lo) is lane 0's, as jnp.argmax.
        assert stats[:5] == [0, 0, 0, 0, 0] and stats[5::3] == [0, 0, 0]
        assert stats[6::3] == [int(cols["hi"][0])] * 3 and stats[7::3] == [int(cols["lo"][0])] * 3
    else:
        assert len(stats) == 5 and stats[1] == 589 and stats[4] == 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("take_factor", [1 / 32, 4])
@pytest.mark.parametrize("model", ["paxos_2c2s", "raft_crash"])
def test_cuda_fps_drain_matches_cpu_drain(cuda_device, model, take_factor, monkeypatch):
    """The staged engine's fingerprint-only wave through the captured drain
    on the card and the uncaptured drain of the CPU twin, with a take
    width of 2 lanes that some waves exceed (``take full`` exits, finished
    on the host, the width then grown and the graphs captured again) and
    the default one: the same counts, paths, drains, exits and rungs, and
    the host's takes alike."""
    from stateright_tpu_torch.checker import gpu as gpu_mod
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    from stateright_tpu_torch.models.raft import RaftModelCfg

    make = {"paxos_2c2s": lambda: PaxosModelCfg(2, 2).into_model(),
            "raft_crash": lambda: RaftModelCfg(3, 1, lossy=True, max_crashes=1).into_model()}
    monkeypatch.setattr(gpu_mod, "_TAKE_FACTOR", take_factor)
    spawn = dict(frontier_capacity=64, table_capacity=1 << 12, wave_kernel="staged")
    gpu = make[model]().checker().spawn_gpu_bfs(device=cuda_device, **spawn).join()
    cpu = make[model]().checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert gpu.worker_error() is None, gpu.worker_error()
    assert gpu._use_fps and cpu._use_fps
    assert gpu.unique_state_count() == cpu.unique_state_count()
    assert gpu.state_count() == cpu.state_count()
    assert gpu.max_depth() == cpu.max_depth()
    assert gpu.waves == cpu.waves and gpu.drains == cpu.drains
    assert gpu.drain_exits == cpu.drain_exits and gpu.rungs == cpu.rungs
    assert gpu.host_takes == cpu.host_takes and gpu.host_take_rows == cpu.host_take_rows
    if take_factor < 1:
        assert gpu.drain_exits["take full"] > 0
    assert gpu.graph_replays >= 2 * gpu.drains
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()


class _SaltedTwoPhaseSys(TwoPhaseSys):
    """2pc with its own ``packed_fingerprint``: the ``"pairs"`` key route."""

    def packed_fingerprint(self, states):
        hi, lo = super().packed_fingerprint(states)
        return hi, lo ^ 1


def _route_model(case):
    """(model, its state count) of each key-route case: the ``comphash``
    route on an unordered network (paxos), over ordered flows (ABD) and with
    timers, drops and crashes (raft)."""
    from stateright_tpu_torch.actor.network import Network
    from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    from stateright_tpu_torch.models.raft import RaftModelCfg

    if case == "fold":
        return TwoPhaseSys(4), 1568
    if case == "comphash":
        return PaxosModelCfg(2, 2).into_model(), 111
    if case == "comphash_ordered":
        return AbdModelCfg(2, 2, network=Network.new_ordered()).into_model(), 620
    if case == "comphash_raft_crash":
        return RaftModelCfg(3, 1, lossy=True, max_crashes=1).into_model(), 2252
    return _SaltedTwoPhaseSys(4), 1568


@pytest.mark.cuda
@pytest.mark.parametrize(
    "route", ["fold", "comphash", "comphash_ordered", "comphash_raft_crash", "pairs"])
def test_cuda_key_routes_match_plain_twin(cuda_device, route):
    """Each key route of the fused wave on the card against the plain twin:
    the keys stage alone on a wave's candidates, then whole fused runs,
    wave at a time and drained, against the CPU twin."""
    model, expected = _route_model(route)
    checker = model.checker().spawn_gpu_bfs(
        device=cuda_device, wave_kernel="fused", frontier_capacity=64,
        table_capacity=1 << 12, max_drain_waves=1,
    ).join()
    assert checker.keys_route == route.split("_")[0]
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
        assert (fw.comphash_launches > 0) == route.startswith("comphash")
        cpu = _route_model(route)[0].checker().spawn_gpu_bfs(device="cpu", **spawn).join()
        assert gpu.unique_state_count() == cpu.unique_state_count() == expected
        assert gpu.state_count() == cpu.state_count()
        assert gpu.max_depth() == cpu.max_depth() and gpu.waves == cpu.waves
        for name, path in cpu.discoveries().items():
            assert gpu.discoveries()[name].encode() == path.encode()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["identity", "flow_pairs"])
def test_cuda_comphash_ordered_matches_plain_twin(cuda_device, layout):
    """The ordered route of ``fw_comphash_keys`` on random ordered states
    (words at and above 2^31, empty and full flows, masked and past-cap
    lanes): the identity flow layout (raft, 9 flows of 8) and a
    ``with_flow_pairs`` subset with a history (abd3o's layout, 14 flows of
    2), against the plain twin bit for bit."""
    from stateright_tpu_torch.actor.network import Network
    from stateright_tpu_torch.interop import packed_states_from_numpy
    from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
    from stateright_tpu_torch.models.raft import RaftModelCfg

    if layout == "identity":
        model = RaftModelCfg(3, 1, network=Network.new_ordered()).into_model()
    else:
        model = AbdModelCfg(3, 2, network=Network.new_ordered(), envelope_capacity=12,
                            flow_capacity=2).into_model()
    N, P, Q = model._N, model._P, model._Q
    W, R, H = model.codec.msg_width, model.codec.state_width, model.codec.history_width
    B, A = 3000, 6
    rng = np.random.default_rng(P)

    def words(*shape):
        x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
        return np.where(rng.random(shape) < 0.33, x | np.uint32(1 << 31), x)

    states = {"rows": words(B, N, R), "timers": words(B, N), "flow_msg": words(B, P, Q, W),
              "flow_len": rng.integers(0, Q + 1, size=(B, P)).astype(np.uint32)}
    states["flow_len"][:A] = 0
    states["flow_len"][A : 2 * A] = Q
    if H:
        states["hist"] = words(B, H)
    cand = packed_states_from_numpy(states, cuda_device)
    cvalid = torch.from_numpy(rng.random(B) < 0.8).to(cuda_device)
    depth = torch.from_numpy(rng.integers(0, 6, size=B // A)).to(cuda_device)
    mask = torch.from_numpy(rng.random(B // A) < 0.8).to(cuda_device)
    tables = fw.comphash_tables(model.packed_comphash_layout(), cuda_device)
    acc = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    key, idx = fw.comphash_keys_stage(tables, cand, cvalid, depth, 4, A, acc, mask)
    chi, clo = model.packed_fingerprint(map_leaves(lambda x: x.cpu(), cand))
    pkey, pidx = fw.keys_plain(chi, clo, cvalid.cpu(), depth.cpu(), 4, A, mask.cpu())
    assert torch.equal(key.cpu(), pkey) and torch.equal(idx.cpu(), pidx)
    assert int(acc[0]) == int((pkey != -1).sum()) > 0


UNORDERED_LAYOUTS = ("paxos_e24", "raft_e60", "abd_ordered")


def comphash_model(layout):
    """A packed actor model of each layout: paxos check 3 (an unordered
    network of 24 envelope slots, a history), raft with 5 servers (60 slots,
    more than a warp's lanes, no history) and abd3o's ordered flows."""
    from stateright_tpu_torch.actor.network import Network
    from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    from stateright_tpu_torch.models.raft import RaftModelCfg

    if layout == "paxos_e24":
        return PaxosModelCfg(3, 3, envelope_capacity=24).into_model()
    if layout == "raft_e60":
        return RaftModelCfg(server_count=5, max_term=1, lossy=True).into_model()
    return AbdModelCfg(3, 2, network=Network.new_ordered(), envelope_capacity=12,
                       flow_capacity=2).into_model()


def random_actor_states(model, B, rng):
    """Random packed states of ``model``'s layout: words at and above 2^31;
    on an unordered network about half the envelope slots empty and lanes
    with no active envelope at all; on an ordered one empty and full
    flows."""
    lay = model.packed_comphash_layout()
    N, R, E, P, Q, W, H = (lay[k] for k in ("N", "R", "E", "P", "Q", "W", "H"))

    def words(*shape):
        x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
        return np.where(rng.random(shape) < 0.33, x | np.uint32(1 << 31), x)

    states = {"rows": words(B, N, R), "timers": words(B, N)}
    if lay["ordered"]:
        states["flow_msg"] = words(B, P, Q, W)
        states["flow_len"] = rng.integers(0, Q + 1, size=(B, P)).astype(np.uint32)
        states["flow_len"][::7] = 0
        states["flow_len"][1::7] = Q
    else:
        states.update(net_src=words(B, E), net_dst=words(B, E), net_msg=words(B, E, W))
        cnt = rng.integers(1, 4, size=(B, E)).astype(np.uint32)
        cnt[rng.random((B, E)) < 0.5] = 0
        cnt[::5] = 0  # lanes with no active envelope
        states["net_cnt"] = cnt
    if H:
        states["hist"] = words(B, H)
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "all_valid", "no_valid_block"])
@pytest.mark.parametrize("layout", UNORDERED_LAYOUTS)
def test_cuda_comphash_warp_lanes_match_plain_twin(cuda_device, layout, case):
    """``fw_comphash_keys`` (a warp a valid lane) on random states of each
    layout against the model's torch ``packed_fingerprint`` through
    ``keys_plain``, bit for bit: ``mixed`` has invalid, masked and
    depth-capped lanes; ``all_valid`` every lane valid, with no mask or
    depth; ``no_valid_block`` no valid lane in its first blocks' spans. The
    kernel's valid count is the twin's."""
    from stateright_tpu_torch.interop import packed_states_from_numpy

    model = comphash_model(layout)
    B, A = 5000, 10
    rng = np.random.default_rng(len(layout) * 10 + len(case))
    cand = packed_states_from_numpy(random_actor_states(model, B, rng), cuda_device)
    if case == "all_valid":
        cvalid = torch.ones(B, dtype=torch.bool, device=cuda_device)
        depth = mask = None
    else:
        cvalid = torch.from_numpy(rng.random(B) < 0.8).to(cuda_device)
        depth = torch.from_numpy(rng.integers(0, 6, size=B // A)).to(cuda_device)
        mask = torch.from_numpy(rng.random(B // A) < 0.8).to(cuda_device)
        if case == "no_valid_block":
            cvalid[:1000] = False
    tables = fw.comphash_tables(model.packed_comphash_layout(), cuda_device)
    acc = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    before = fw.comphash_launches
    key, idx = fw.comphash_keys_stage(tables, cand, cvalid, depth, 4, A, acc, mask)
    assert fw.comphash_launches == before + 1
    chi, clo = model.packed_fingerprint(map_leaves(lambda x: x.cpu(), cand))
    cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
    pkey, pidx = fw.keys_plain(chi, clo, cvalid.cpu(), cpu(depth), 4, A, cpu(mask))
    assert torch.equal(key.cpu(), pkey) and torch.equal(idx.cpu(), pidx)
    n_valid = int((pkey != -1).sum())
    assert int(acc[0]) == n_valid
    if case == "all_valid":
        assert n_valid == B
    elif case == "no_valid_block":
        assert not (pkey[:1000] != -1).any() and n_valid > 0


def check_dedup(case, dev, seed=0):
    """``fw_dedup`` on the card against ``dedup_plain`` on the CPU on one
    sorted wave of ``torch_dedup_cases``; returns the twin's output."""
    hi, lo, cvalid, depth, mask, capacity = wave_lanes(case, seed)
    ins = sorted_wave(hi, lo, cvalid, depth, mask)
    key, idx, cv, dp, mk = ins
    A = DEDUP_A
    want = fw.dedup_plain(key, idx, capacity, cv, A, dp, DEDUP_DEPTH_CAP, mk)
    on = lambda x: None if x is None else x.to(dev)  # noqa: E731
    before = fw.dedup_launches
    got = fw.dedup_stage(*map(on, (key, idx)), capacity, on(cv), A, on(dp), DEDUP_DEPTH_CAP,
                         on(mk))
    torch.cuda.synchronize()
    assert fw.dedup_launches == before + 1
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DEDUP_CASES))
def test_cuda_dedup_matches_plain_twin(cuda_device, case):
    """``fw_dedup`` (one pass; each tile's start from the run boundaries of
    the sorted homes, long runs filled by a warp) against ``dedup_plain``:
    empty tile runs at the start, in the middle and at the end, only
    sentinels, one keyed lane, keys in the last tile only, a one-tile
    table, a valid all-ones fingerprint, an empty wave, and sparse waves of
    skv4x4's width (at most 64 keyed lanes) into a 2^25-row table, spread
    over its tiles or in one."""
    active, starts = check_dedup(case, cuda_device)
    if case.startswith("sparse"):
        assert 0 < int(active.sum()) <= 64 and starts.shape[0] == (1 << 25) // TILE_ROWS + 1


@pytest.mark.cuda
def test_cuda_dedup_replays_in_a_cuda_graph(cuda_device):
    """``fw_dedup`` captured once in a CUDA Graph (its launch shape depends
    on B alone) and replayed over a dense wave and a sparse one of the same
    width, each equal to ``dedup_plain``."""
    waves = []
    for case in ("sparse_64_lanes_2p25", "sparse_one_tile_2p25"):
        hi, lo, cvalid, depth, mask, capacity = wave_lanes(case, 1)
        waves.append(sorted_wave(hi, lo, cvalid, depth, mask))
    hi, lo, cvalid, depth, mask, capacity = wave_lanes("sparse_64_lanes_2p25", 2)
    cvalid[:] = np.random.default_rng(5).random(cvalid.shape[0]) < 0.5
    waves.append(sorted_wave(hi, lo, cvalid, depth, mask))
    A = DEDUP_A
    key, idx, cv, dp = (x.to(cuda_device) for x in waves[0][:4])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fw.dedup_stage(key, idx, capacity, cv, A, dp, DEDUP_DEPTH_CAP, None)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        active, starts = fw.dedup_stage(key, idx, capacity, cv, A, dp, DEDUP_DEPTH_CAP, None)
    for wk, wi, wcv, wdp, _m in waves[::-1]:
        for dst, src in ((key, wk), (idx, wi), (cv, wcv), (dp, wdp)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = fw.dedup_plain(wk, wi, capacity, wcv, A, wdp, DEDUP_DEPTH_CAP, None)
        assert torch.equal(active.cpu(), want[0]) and torch.equal(starts.cpu(), want[1])


def compact_inputs(n, pattern, dev, seed=0):
    """The compaction's inputs over n sorted positions: outcome bytes
    (fresh = 1, found 2, pending 4, inactive 0) in ``pattern``, random keys
    and lanes, and the frontier columns of F = ceil(n / A) lanes."""
    rng = np.random.default_rng(seed + n)
    A = 7
    F = -(-n // A)
    flag = rng.choice(np.array([0, 2, 4], np.uint8), size=n)
    if pattern == "all":
        flag[:] = 1
    elif pattern == "alternate":
        flag[::2] = 1
    elif pattern == "tail":
        flag[-min(n, 300):] = 1
    elif pattern == "random":
        flag[rng.random(n) < 0.06] = 1
    key = rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
    idx = rng.integers(0, n, size=n).astype(np.int32)
    cols = [rng.integers(0, 1 << 32, size=F, dtype=np.int64) for _ in range(4)]
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return (t(flag), t(key), t(idx), A) + tuple(t(c) for c in cols)


def check_compact(args, acc, out):
    want, n_new = fw.compact_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    n = int(n_new)
    assert int(acc[1]) == n
    for k, v in want.items():
        assert torch.equal(out[k][:n].cpu(), v[:n]), k
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["none", "all", "alternate", "tail"])
@pytest.mark.parametrize("n", [1, 2048, 2049, (1 << 20) + 3])
def test_cuda_compact_matches_plain_twin(cuda_device, n, pattern):
    """``fw_compact`` (one look-back pass) against ``compact_plain`` on one
    lane, one tile, one tile and a lane, and more than 2^20 lanes: the
    first ``n_new`` rows of every output and ``n_new`` in ``acc[1]``; two
    device operations, one launch counted."""
    args = compact_inputs(n, pattern, cuda_device)
    acc = torch.full((6,), -1, dtype=torch.int64, device=cuda_device)
    before = fw.compact_launches
    out = fw.compact_stage(*args, acc)
    torch.cuda.synchronize()
    assert fw.compact_launches == before + 1 and fw.compact_device_ops == 2
    got = check_compact(args, acc, out)
    assert got == {"none": 0, "all": n}.get(pattern, got)
    assert acc[0].item() == acc[2].item() == -1


@pytest.mark.cuda
def test_cuda_compact_reads_unaligned_flags(cuda_device):
    """Outcome bytes that do not start on an 8-byte boundary are read a
    byte at a time, with the same result."""
    flag, *rest = compact_inputs(50001, "random", cuda_device)
    wide = torch.zeros(flag.shape[0] + 1, dtype=torch.uint8, device=cuda_device)
    wide[1:] = flag
    args = (wide[1:],) + tuple(rest)
    assert args[0].data_ptr() % 8
    acc = torch.zeros(6, dtype=torch.int64, device=cuda_device)
    out = fw.compact_stage(*args, acc)
    torch.cuda.synchronize()
    assert check_compact(args, acc, out) > 0


@pytest.mark.cuda
def test_cuda_compact_replays_in_a_cuda_graph(cuda_device):
    """The compaction captured in a CUDA Graph and replayed twice over new
    outcome bytes: its ticket and status words are reset on the stream
    inside the graph, so each replay compacts its own flags."""
    n = 300000
    args = list(compact_inputs(n, "random", cuda_device))
    flag = args[0]
    acc = torch.zeros(6, dtype=torch.int64, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fw.compact_stage(*args, acc)  # warm-up: builds and loads the kernels
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fw.compact_stage(*args, acc)
    seen = []
    for seed, pattern in ((2, "alternate"), (3, "random"), (4, "none")):
        flag.copy_(compact_inputs(n, pattern, cuda_device, seed=seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        seen.append(check_compact(args, acc, out))
    assert seen[0] == n // 2 and seen[1] > 0 and seen[2] == 0


# -- coverage ----------------------------------------------------------------------


def cov_spec(spec, antecedent=None):
    """``spec`` with coverage on: its layout and, for its first property
    (an ``always``), ``antecedent``."""
    from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

    P = len(spec.conditions)
    return dataclasses.replace(
        spec, cov_layout=DeviceCoverage(spec.action_count, P),
        cov_antecedents=(antecedent,) + (None,) * (P - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "masked", "depth_capped", "one_action", "empty"])
def test_cuda_coverage_stage_matches_plain_twin(cuda_device, case):
    """The fused chain's coverage vector, which ``fw_frontier`` and
    ``fw_compact`` add with no stage of their own, against the plain twin's
    (``coverage_plain``, as ``torch_wave`` computes it): in-wave
    duplicates, terminal lanes, every property kind with an antecedent on
    the ``always``, masked lanes holding other states, lanes past the depth
    cap, a single action (one successor bin) and an empty frontier; bit for
    bit, against the whole wave's twin and against ``coverage_plain`` on the
    chain's own scratch; one coverage launch of each kernel a wave, and
    ``coverage_stage`` refuses a CUDA tensor."""
    actions = 1 if case == "one_action" else 8
    spec = cov_spec(hop_spec(5000, actions=actions, bound=4000),
                    antecedent=lambda st: st["x"] % 3 == 0)
    xs = [] if case == "empty" else list(range(0, 3000, 3)) + list(range(3990, 4100))
    F = len(xs)
    mask = None
    depth = torch.full((F,), 2, dtype=torch.int64)
    if case == "masked":
        mask = torch.from_numpy(np.random.default_rng(3).random(F) < 0.5)
        depth = torch.where(mask, 2, 9)
    elif case == "depth_capped":
        depth = torch.from_numpy(np.random.default_rng(4).integers(1, 80, size=F))
    states, cols = hop_frontier(xs, depth, ebits=1)
    table = empty_table(TILE_ROWS * 4)
    dcap = 70 if case == "depth_capped" else 10
    before = (fw.coverage_launches, fw.coverage_fresh_launches, fw.frontier_launches)
    _pt, pout = fw.fused_wave_plain(spec, table_from_numpy(table), states, cols["hi"],
                                    cols["lo"], cols["ebits"], cols["depth"], dcap, mask=mask)
    dstates = map_leaves(lambda t: t.to(cuda_device), states)
    dcols = [cols[k].to(cuda_device) for k in ("hi", "lo", "ebits", "depth")]
    dmask = None if mask is None else mask.to(cuda_device)
    _ct, cout = fw.fused_wave(spec, table_from_numpy(table, cuda_device), dstates, *dcols,
                              dcap, mask=dmask)
    torch.cuda.synchronize()
    assert (fw.coverage_launches, fw.coverage_fresh_launches, fw.frontier_launches) == tuple(
        b + 1 for b in before)
    assert cout["cov"].dtype == torch.int64
    assert cout["cov"].cpu().tolist() == pout["cov"].tolist()
    assert cout["stats"].cpu().tolist() == pout["stats"].tolist()
    lay = spec.cov_layout
    vec = pout["cov"].tolist()
    if F:
        assert vec[0] > 0 and sum(vec[lay.s_fresh]) == pout["stats"].tolist()[1]
    cond, cvalid, cand = fw.model_stage(spec, dstates, F)
    ant = fw.antecedent_stage(spec, dstates, F)
    taps = {}
    fw.kernel_chain(spec, table_from_numpy(table, cuda_device), *dcols, dcap, cond, cvalid,
                    fw.keys_input(spec, cand), cand, mask=dmask, ant=ant, taps=taps)
    args = (spec, cvalid, dcols[3], dcap, dmask, cond, ant, taps["ebits_after"], taps["flag"],
            taps["idx"])
    want = fw.coverage_plain(*args)
    torch.cuda.synchronize()
    assert taps["cov"].cpu().tolist() == want.cpu().tolist() == vec
    with pytest.raises(ValueError, match="fw_frontier and fw_compact"):
        fw.coverage_stage(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P", [0, 1, fw.MAX_PROPS])
@pytest.mark.parametrize("A", [1, 42, 125])
def test_cuda_frontier_coverage_half_matches_plain_twin(cuda_device, A, P, masked):
    """``fw_frontier`` with coverage on: the counters as with it off
    (``frontier_plain``) and, in the vector after them (zeroed by the same
    memset), the frontier half (``coverage_frontier_plain``): evaluated,
    terminal, fired, exercised and successor bins, the rest 0; still two
    device operations."""
    from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

    spec, cond, cvalid, ebits, depth, mask = frontier_inputs(2049, A, P, masked, seed=A + P)
    spec = dataclasses.replace(spec, cov_layout=DeviceCoverage(A, P))
    rng = np.random.default_rng(A * P + 1)
    ant = torch.from_numpy(np.where(
        np.array([k == "always" for k in spec.expectations], bool)[:, None],
        rng.random((P, 2049)) < 0.5, True))
    on = lambda x: None if x is None else x.to(cuda_device)  # noqa: E731
    pacc = torch.zeros(4 + P, dtype=torch.int64)
    peb = fw.frontier_plain(spec, cond, cvalid, ebits, depth, 9, pacc, mask)
    want = fw.coverage_frontier_plain(spec, cvalid, depth, 9, mask, cond, ant, peb)
    acc = torch.full((4 + P + spec.cov_layout.size,), -5, dtype=torch.int64, device=cuda_device)
    before = fw.coverage_launches
    eb = fw.frontier_stage(spec, *map(on, (cond, cvalid, ebits, depth)), 9, acc, on(mask),
                           on(ant))
    torch.cuda.synchronize()
    assert fw.coverage_launches == before + 1 and fw.frontier_device_ops == 2
    assert torch.equal(eb.cpu(), peb)
    assert acc[:4 + P].cpu().tolist() == pacc.tolist()
    assert acc[4 + P:].cpu().tolist() == want.tolist()
    assert want[0] > 0 and want[1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["none", "all", "random", "tail"])
@pytest.mark.parametrize("n", [1, 2049, (1 << 20) + 3])
def test_cuda_compact_coverage_half_matches_plain_twin(cuda_device, n, pattern):
    """``fw_compact`` with coverage on: its outputs as with it off
    (``compact_plain``) and, added to the vector ``fw_frontier`` zeroed, the
    fresh half (``coverage_fresh_plain``): each fresh row's action bin and
    its child's depth bin (depths past 63 saturate), the rest untouched."""
    from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

    args = compact_inputs(n, pattern, cuda_device)
    flag, _key, idx, A, _eb, depth = args[:6]
    depth.copy_(torch.from_numpy(np.random.default_rng(n).integers(0, 90, depth.shape[0])))
    spec = fw.FusedWaveSpec(expand=None, within_boundary=None, conditions=(None,) * 2,
                            expectations=("always", "sometimes"), ebit=(), action_count=A,
                            cov_layout=DeviceCoverage(A, 2))
    cov = torch.zeros(spec.cov_layout.size, dtype=torch.int64, device=cuda_device)
    acc = torch.full((6,), -1, dtype=torch.int64, device=cuda_device)
    before = fw.coverage_fresh_launches
    out = fw.compact_stage(*args, acc, cov)
    torch.cuda.synchronize()
    assert fw.coverage_fresh_launches == before + 1 and fw.compact_device_ops == 2
    got = check_compact(args, acc, out)
    want = fw.coverage_fresh_plain(spec, depth.cpu(), flag.cpu(), idx.cpu())
    assert cov.cpu().tolist() == want.tolist()
    assert int(want[spec.cov_layout.s_fresh].sum()) == got


COVERAGE_DRAIN_MODELS = {
    "2pc5": (lambda: TwoPhaseSys(5), 8832),
    "skv_4_2_3_guarded": (lambda: _sharded_kv(4, 2, 3, True), 4096),
    "skv_2_2_1": (lambda: _sharded_kv(2, 2, 1, False), None),
}


def _sharded_kv(*args):
    from stateright_tpu_torch.models.sharded_kv import ShardedKv

    s, k, v, g = args
    return ShardedKv(s, k, v, guarded=g)


@pytest.mark.cuda
@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
@pytest.mark.parametrize("case", ["tiny", "default"])
@pytest.mark.parametrize("model", list(COVERAGE_DRAIN_MODELS))
def test_cuda_coverage_drain_matches_cpu_twin(cuda_device, wave_kernel, case, model):
    """A coverage-on run through the captured drain on the card and the
    uncaptured drain of the CPU twin: equal coverage reports and counts;
    with the fused wave, every replayed wave ran the coverage epilogue in
    ``fw_frontier`` and ``fw_compact``; the coverage-off run on the card
    runs no coverage epilogue and keeps its counts and its launches."""
    make, expected = COVERAGE_DRAIN_MODELS[model]
    spawn = dict(DRAIN_CASES[case], wave_kernel=wave_kernel)
    fw.launches = fw.coverage_launches = fw.coverage_fresh_launches = 0
    gpu = make().checker().spawn_gpu_bfs(device=cuda_device, coverage=True, **spawn).join()
    on_launches, cov_launches = fw.launches, fw.coverage_launches
    assert fw.coverage_fresh_launches == cov_launches
    cpu = make().checker().spawn_gpu_bfs(device="cpu", coverage=True, **spawn).join()
    fw.launches = fw.coverage_launches = fw.coverage_fresh_launches = 0
    off = make().checker().spawn_gpu_bfs(device=cuda_device, **spawn).join()
    assert gpu.worker_error() is None, gpu.worker_error()
    assert gpu.coverage_report() == cpu.coverage_report()
    rep = gpu.coverage_report()
    assert sum(rep["shape"]["depth_hist"]) == rep["unique"] == gpu.unique_state_count()
    if expected is not None:
        assert gpu.unique_state_count() == expected
    for c in (cpu, off):
        assert gpu.unique_state_count() == c.unique_state_count()
        assert gpu.state_count() == c.state_count()
        assert gpu.max_depth() == c.max_depth()
        assert gpu.drains == c.drains and gpu.waves == c.waves
    assert fw.coverage_launches == fw.coverage_fresh_launches == 0
    if wave_kernel == "fused":
        assert cov_launches == on_launches == fw.launches > 0
    else:
        assert cov_launches == on_launches == fw.launches == 0


# -- the device walkers (simulation and swarm) ---------------------------------------


def _walk_result(ck):
    return (ck.state_count(), ck.unique_state_count(), ck.max_depth(),
            dict(ck._discoveries_fps), ck.coverage_estimate()["saturated"])


@pytest.mark.cuda
def test_cuda_unsorted_insert_matches_plain_twin(cuda_device):
    """The swarm's sample insert (duplicates in lane order) on the card and
    on the CPU twin: the same flags and the same table, batch after batch."""
    rng = np.random.default_rng(22)
    universe = rng.integers(1, 1 << 32, size=(3000, 2), dtype=np.uint64).astype(np.uint32)
    cpu = table_from_numpy(empty_table(1 << 13))
    card = cpu.to(cuda_device)
    for _ in range(12):
        pick = universe[rng.integers(0, len(universe), size=1024)]
        hi, lo = keys_from_numpy(pick[:, 0], pick[:, 1])
        active = torch.from_numpy(rng.random(1024) < 0.8)
        cpu, *want = hk.hashset_insert_unsorted(cpu, hi, lo, active)
        card, *got = hk.hashset_insert_unsorted(card, hi.to(cuda_device), lo.to(cuda_device),
                                                active.to(cuda_device))
        for w, g in zip(want, got):
            assert torch.equal(w, g.cpu())
        assert np.array_equal(table_to_numpy(card), table_to_numpy(cpu))


@pytest.mark.cuda
def test_cuda_swarm_matches_cpu_twin(cuda_device):
    """A 2pc-3 swarm on the card (one captured step, replayed) and on the
    CPU twin: the same walks, sample and trails; the insert kernel launched
    once a step."""
    runs = []
    for d in ("cuda", "cpu"):
        hk.launches = 0
        runs.append(TwoPhaseSys(3).checker().target_state_count(20_000).spawn_swarm(
            seed=11, lanes=64, wave_steps=16, sample_capacity=1 << 12, device=d).join())
        if d == "cuda":
            assert hk.launches == 16 * runs[0].engine._wave_calls
    assert _walk_result(runs[0]) == _walk_result(runs[1])
    assert runs[0].engine.graph_captures == 1


@pytest.mark.cuda
def test_cuda_swarm_capture_survives_garbage_graphs(cuda_device):
    """Another run's CUDA Graph that becomes cyclic garbage while a swarm
    step is being captured, with the collector set to run at every
    allocation, is not collected inside the capture (destroying it there
    would invalidate the capture): the swarm equals its CPU twin."""
    import gc

    class Baited(TwoPhaseSys):
        bait = None

        def packed_expand(self, states):
            if self.bait is not None and torch.cuda.is_current_stream_capturing():
                cycle = [self.bait]
                cycle.append(cycle)
                self.bait = None
                del cycle
            return super().packed_expand(states)

    spawn = dict(seed=11, lanes=64, wave_steps=16, sample_capacity=1 << 12)
    graph, x = torch.cuda.CUDAGraph(), torch.zeros(1, device=cuda_device)
    with torch.cuda.graph(graph):
        x.add_(1)
    model = Baited(3)
    model.bait = graph
    del graph
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        card = model.checker().target_state_count(20_000).spawn_swarm(
            device=cuda_device, **spawn).join()
    finally:
        gc.set_threshold(*thresholds)
    assert model.bait is None and card.engine.graph_captures == 1
    cpu = TwoPhaseSys(3).checker().target_state_count(20_000).spawn_swarm(
        device="cpu", **spawn).join()
    assert _walk_result(card) == _walk_result(cpu)


@pytest.mark.cuda
def test_cuda_gpu_simulation_matches_cpu_twin(cuda_device):
    runs = [TwoPhaseSys(3).checker().target_state_count(20_000).spawn_gpu_simulation(
        seed=7, lanes=128, steps_per_call=32, device=d).join() for d in ("cuda", "cpu")]
    assert ((runs[0].state_count(), runs[0].max_depth(), runs[0]._discoveries_fps)
            == (runs[1].state_count(), runs[1].max_depth(), runs[1]._discoveries_fps))
    assert runs[0].graph_captures == 1


def _liveness_outcomes(checker):
    return {name: {k: v for k, v in rec.items() if k != "seconds"}
            for name, rec in checker.liveness_report()["outcomes"].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("edge_log_capacity", [None, 24], ids=["default_log", "tiny_log"])
@pytest.mark.parametrize("model", ["cycle", "level_dag_small"])
def test_cuda_device_liveness_drain_matches_cpu_twin(cuda_device, model, edge_log_capacity):
    """``liveness="device"`` through the captured drain on the card and the
    uncaptured drain of the CPU twin: the same counts, drains and exits
    ("edge log full" with the tiny log), the same logged relation array for
    array, the same verdicts, outcome records and certificates; the card's
    waves ran the insert kernel, and its trim and reach ran on the card."""
    from stateright_tpu_torch.configs import LevelDag
    from torch_host_fixtures import PackedDGraph

    make = {"cycle": lambda: PackedDGraph([0, 2, 4, 2], [0, 6], [6, 8, 10, 6]),
            "level_dag_small": lambda: LevelDag(6, 10)}[model]
    spawn = dict(frontier_capacity=8, table_capacity=2048, liveness="device",
                 edge_log_capacity=edge_log_capacity)
    hk.launches = 0
    gpu = make().checker().spawn_gpu_bfs(device=cuda_device, **spawn).join()
    launches = hk.launches
    cpu = make().checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert gpu.worker_error() is None, gpu.worker_error()
    assert gpu._wave_kernel == "staged" and gpu.graph_replays >= 1
    assert launches >= gpu.waves > 0
    assert gpu.unique_state_count() == cpu.unique_state_count()
    assert gpu.drains == cpu.drains and gpu.drain_exits == cpu.drain_exits
    if edge_log_capacity and model == "level_dag_small":
        assert gpu.drain_exits["edge log full"] >= 1
    assert _liveness_outcomes(gpu) == _liveness_outcomes(cpu)
    assert gpu._live_store.stats() == cpu._live_store.stats()
    rows, cpu_rows = gpu._live_store.edge_rows(), cpu._live_store.edge_rows()
    np.testing.assert_array_equal(rows, cpu_rows)
    assert {k: p.encode() for k, p in gpu.discoveries().items()} == {
        k: p.encode() for k, p in cpu.discoveries().items()}
    want = "counterexample" if model == "cycle" else "absent"
    assert list(gpu.liveness_report()["outcomes"].values())[0]["verdict"] == want


@pytest.mark.cuda
def test_cuda_drain_capture_survives_garbage_graphs(cuda_device):
    """Another run's CUDA Graph that becomes cyclic garbage while a drain is
    being captured, with the collector set to run at every allocation, is
    not collected inside the capture (destroying it there would invalidate
    the capture): the run equals its CPU twin."""
    import gc

    from torch_host_fixtures import PackedDGraph

    class Baited(PackedDGraph):
        bait = None

        def packed_expand(self, states):
            if self.bait is not None and torch.cuda.is_current_stream_capturing():
                cycle = [self.bait]
                cycle.append(cycle)
                self.bait = None
                del cycle
            return super().packed_expand(states)

    paths = ([0, 2, 4, 2], [0, 6], [6, 8, 10, 6])
    spawn = dict(frontier_capacity=8, table_capacity=2048, liveness="device")
    graph, x = torch.cuda.CUDAGraph(), torch.zeros(1, device=cuda_device)
    with torch.cuda.graph(graph):
        x.add_(1)
    model = Baited(*paths)
    model.bait = graph
    del graph
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        gpu = model.checker().spawn_gpu_bfs(device=cuda_device, **spawn).join()
    finally:
        gc.set_threshold(*thresholds)
    assert model.bait is None and gpu.graph_captures >= 2
    cpu = PackedDGraph(*paths).checker().spawn_gpu_bfs(device="cpu", **spawn).join()
    assert _liveness_outcomes(gpu) == _liveness_outcomes(cpu)
    assert {k: p.encode() for k, p in gpu.discoveries().items()} == {
        k: p.encode() for k, p in cpu.discoveries().items()}


# -- tenant packing ---------------------------------------------------------------


def _pack_run(make, device, n_tenants, **kw):
    """``n_tenants`` tenants of one pack driven to the end; returns their
    views in admission order."""
    from stateright_tpu_torch.checker import TenantPackedEngine

    eng = TenantPackedEngine(make(), device=device, **kw)
    views = [eng.admit(f"t{i}", f"tpk-card-{device}-{i}") for i in range(n_tenants)]
    steps = 0
    while eng.live_count():
        for key in eng.step():
            eng.release(key)
        steps += 1
        assert steps < 20_000
    eng.close()
    return eng, views


def _pack_golden(view):
    import io
    import re

    from stateright_tpu_torch import WriteReporter

    out = io.StringIO()
    view.report(WriteReporter(out))
    return re.sub(r"sec=\d+", "sec=_", out.getvalue())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pair", "budget_sync", "budget_async", "liveness_trio"])
def test_cuda_tenant_pack_matches_cpu_twin(cuda_device, case):
    """A pack on the card and the same pack on the CPU twin: every tenant's
    counts, depth and golden report (paths included), with device liveness
    the verdicts, the certificates and the logged relation; on the card
    every salted claim went through the insert kernel (at least one launch
    a wave)."""
    from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
    from torch_host_fixtures import PackedDGraph

    kw = dict(frontier_capacity=16, table_capacity=1 << 12, max_tenants=4)
    make, n = (lambda: TwoPhaseSys(3)), 2
    if case.startswith("budget"):
        make = lambda: TwoPhaseSys(4)  # noqa: E731 - the budget binds at 2pc-4
        kw["hbm_budget_mib"] = min_admissible_hbm_budget_mib(TwoPhaseSys(4), 16)
        kw["async_pipeline"] = case == "budget_async"
    elif case == "liveness_trio":
        make, n = (lambda: PackedDGraph([0, 2, 4, 2])), 3
        kw.update(table_capacity=1 << 10, liveness="device")
    hk.launches = 0
    card, card_views = _pack_run(make, cuda_device, n, **kw)
    assert hk.launches >= card.waves > 0
    cpu, cpu_views = _pack_run(make, "cpu", n, **kw)
    if not kw.get("async_pipeline"):
        # Synchronous verdicts make the schedule the device's own; with the
        # async pipeline a wave takes the lanes pushed so far, so its
        # widths may differ (the claims, and so the results, do not).
        assert (card.waves, card.lanes_live, card.evictions) == (cpu.waves, cpu.lanes_live,
                                                                 cpu.evictions)
    if case.startswith("budget"):
        assert card.evictions > 0
    for got, want in zip(card_views, cpu_views):
        assert got.unique_state_count() == want.unique_state_count()
        assert got.state_count() == want.state_count()
        assert got.max_depth() == want.max_depth()
        assert _pack_golden(got) == _pack_golden(want)
        if case == "liveness_trio":
            assert _liveness_outcomes(got) == _liveness_outcomes(want)
            assert np.array_equal(got._live_store.edge_rows(), want._live_store.edge_rows())


# -- fingerprint sharding ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n1_wave", "n4_drain", "n8_sieve_drain", "n8_sym_wave",
                                  "n4_growth"])
def test_cuda_sharded_matches_cpu_twin(cuda_device, case):
    """``spawn_sharded_gpu_bfs`` with n shards on the card and the same run
    on the CPU twin: counts, depth, discoveries, paths, lanes shipped and
    rungs; on the card every owner insert went through the insert kernel
    (a launch a shard a wave at least)."""
    from stateright_tpu_torch.parallel import default_mesh
    from stateright_tpu_torch.parallel.sharded import run_summary

    n = int(case.split("_")[0][1:])
    kw = dict(frontier_per_device=32, table_capacity_per_device=1 << 12,
              sieve="sieve" in case)
    if "wave" in case:
        kw["max_drain_waves"] = 1
    if case == "n4_growth":
        kw.update(frontier_per_device=64, table_capacity_per_device=256)
    rm = 3 if "sym" in case else 4

    def run(device, tag):
        b = TwoPhaseSys(rm).checker()
        if "sym" in case:
            b = b.symmetry()
        checker = b.spawn_sharded_gpu_bfs(mesh=default_mesh(n, device=device),
                                          run_id=f"tsh-cuda-{case}-{tag}", **kw).join()
        return checker, run_summary(checker)

    hk.launches = 0
    card, got = run(cuda_device, "card")
    assert hk.launches >= card.waves * n > 0
    _cpu, want = run("cpu", "cpu")
    assert got == want
    assert got["unique"] == (80 if "sym" in case else 1568)
    if case == "n4_growth":
        assert card.table_growths >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n8_budget_sieve", "n2_budget_async", "n4_coverage",
                                  "n2_liveness", "n8_attribution"])
def test_cuda_sharded_knobs_match_cpu_twin(cuda_device, case):
    """The per-shard tiers (with the sieve, with the async pipeline),
    coverage, device liveness and attribution of ``spawn_sharded_gpu_bfs``
    on the card against the same run on the CPU twin: counts, depth,
    discoveries, paths, lanes shipped and rungs, and the coverage report,
    the liveness verdicts and relation, evictions."""
    from stateright_tpu_torch.configs import LevelDag
    from stateright_tpu_torch.parallel import default_mesh
    from stateright_tpu_torch.parallel.sharded import run_summary
    from stateright_tpu_torch.storage import table_budget_mib

    n = int(case.split("_")[0][1:])
    budget = table_budget_mib(2048)
    kw, make = dict(frontier_per_device=32, table_capacity_per_device=1 << 12), (
        lambda: TwoPhaseSys(4))
    if case == "n8_budget_sieve":
        kw = dict(frontier_per_device=8, table_capacity_per_device=2048, sieve=True,
                  hbm_budget_mib=budget)
        make = lambda: TwoPhaseSys(5)  # noqa: E731
    elif case == "n2_budget_async":
        kw = dict(frontier_per_device=16, table_capacity_per_device=4096, async_pipeline=True,
                  hbm_budget_mib=table_budget_mib(4096))
        make = lambda: TwoPhaseSys(5)  # noqa: E731
    elif case == "n4_coverage":
        kw["coverage"] = True
    elif case == "n2_liveness":
        kw = dict(frontier_per_device=4, liveness="device")
        make = lambda: LevelDag(6, 10)  # noqa: E731
    else:
        kw["attribution"] = True

    def run(device, tag):
        checker = make().checker().spawn_sharded_gpu_bfs(
            mesh=default_mesh(n, device=device), run_id=f"tsh-cuda-{case}-{tag}", **kw).join()
        return checker, run_summary(checker)

    hk.launches = 0
    card, got = run(cuda_device, "card")
    assert hk.launches >= card.waves * n > 0
    cpu, want = run("cpu", "cpu")
    assert got == want
    assert card.evictions == cpu.evictions
    if "budget" in case:
        assert card.evictions >= 1
    if case == "n4_coverage":
        assert card.coverage_report() == cpu.coverage_report()
    if case == "n2_liveness":
        assert _liveness_outcomes(card) == _liveness_outcomes(cpu)
        assert np.array_equal(card._live_store.edge_rows(), cpu._live_store.edge_rows())
    if case == "n8_attribution":
        assert card.attribution_report()["within_tolerance"]
