"""The port's out-of-core store (``stateright_tpu_torch.storage``) against
the JAX package's ``stateright_tpu.storage``.

The port copies the JAX package's varint codec, Bloom filter, runs and
tiered store; these tests hold the copies to the originals on seeded
inputs: byte-equal frames, bit-equal Bloom words, stores whose exported
state loads into the other package's store with identical probe answers
(both ways), and the JAX package's own store cases (merges, L2 spills and
their compaction, corruption refused) on the port's store. Then the
checker's admission checks for the budget knobs. Everything compared is
an integer or a byte: the tolerance is 0.
"""

import os
import pickle

import numpy as np
import pytest

from stateright_tpu import storage as jax_storage
from stateright_tpu.checker.tpu import (
    min_admissible_hbm_budget_mib as jax_min_admissible_hbm_budget_mib,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch import storage
from stateright_tpu_torch.checker.gpu import min_admissible_hbm_budget_mib
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.hashset_kernel import TILE_ROWS
from stateright_tpu_torch.storage import (
    RUN_BLOCK,
    BloomFilter,
    FingerprintRun,
    TieredVisitedStore,
    decode_sorted_fps,
    decode_varint_u64,
    encode_sorted_fps,
    encode_varint_u64,
)
from stateright_tpu_torch.telemetry import metrics_registry


def _keys(seed, n, hi=1 << 62):
    return np.random.default_rng(seed).integers(1, hi, n, dtype=np.uint64)


# -- byte equality with the JAX package ---------------------------------------


@pytest.mark.parametrize("n", [0, 1, 5, RUN_BLOCK + 1, 20_000])
def test_sorted_frames_and_bloom_bits_equal_jax(n):
    keys = np.unique(_keys(n, n, hi=(1 << 64) - 1))
    assert encode_sorted_fps(keys) == jax_storage.encode_sorted_fps(keys)
    assert np.array_equal(decode_sorted_fps(encode_sorted_fps(keys)), keys)
    assert encode_varint_u64(keys) == jax_storage.encode_varint_u64(keys)
    ours, theirs = BloomFilter.build(keys), jax_storage.BloomFilter.build(keys)
    assert ours.m_bits == theirs.m_bits
    assert np.array_equal(ours.words, theirs.words)
    if not n:
        return  # runs are never empty
    run, jax_run = FingerprintRun.build(keys), jax_storage.FingerprintRun.build(keys)
    state, jax_state = run.to_state(), jax_run.to_state()
    assert state.keys() == jax_state.keys()
    for k in state:
        if k == "bloom":
            assert np.array_equal(state[k]["words"], jax_state[k]["words"])
        else:
            assert np.array_equal(np.asarray(state[k]), np.asarray(jax_state[k])), k


def _filled(module, tmp_path, tag, prefix):
    """A store of either package with L1 runs and spilled L2 runs."""
    spill = tmp_path / tag
    store = module.TieredVisitedStore(host_budget_mib=0.1, spill_dir=str(spill),
                                      prefix=prefix)
    batches = [_keys(40 + i, 6_000) for i in range(5)]
    for b in batches:
        store.evict(b)
    store.evict(_keys(50, 300))  # a small run that stays in L1
    assert store.l1 and store.l2
    return store, np.unique(np.concatenate(batches + [_keys(50, 300)]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exported_state_loads_across_packages(tmp_path, direction):
    src_mod, dst_mod = ((jax_storage, storage) if direction == "jax_to_port"
                        else (storage, jax_storage))
    src, present = _filled(src_mod, tmp_path, "src", "t_cross_src")
    state = pickle.loads(pickle.dumps(src.export_state()))
    dst = dst_mod.TieredVisitedStore(prefix="t_cross_dst")
    dst.load_state(state)
    probes = np.concatenate([present[::7], _keys(99, 20_000)])
    got, want = dst.probe(probes), src.probe(probes)
    assert np.array_equal(got, want)
    assert got[: len(present[::7])].all()
    assert dst.total_fps == src.total_fps
    assert [r.count for r in dst.l1 + dst.l2] == [r.count for r in src.l1 + src.l2]


# -- the JAX package's store cases, on the port's store -------------------------


def test_varint_roundtrip_edges():
    vals = np.array([0, 1, 127, 128, (1 << 35) - 1, 1 << 35, (1 << 64) - 1], dtype=np.uint64)
    assert np.array_equal(decode_varint_u64(encode_varint_u64(vals)), vals)
    assert encode_varint_u64(np.zeros(0, np.uint64)) == b""
    assert len(decode_varint_u64(b"")) == 0


def test_bloom_no_false_negatives_and_low_fp_rate():
    keys = np.unique(_keys(11, 40_000))
    bf = BloomFilter.build(keys)
    assert bf.contains(keys).all()
    probes = _keys(12, 100_000)
    probes = probes[~np.isin(probes, keys)]
    assert bf.contains(probes).mean() < 0.02


@pytest.mark.parametrize("n", [5, RUN_BLOCK, RUN_BLOCK + 1, 3 * RUN_BLOCK + 17])
def test_run_probe_exact_and_block_boundaries(n):
    keys = np.unique(_keys(n, n))
    run = FingerprintRun.build(keys)
    assert np.array_equal(run.decode_all(), keys)
    q = np.concatenate([keys[::3], _keys(n + 1, 999)])
    assert np.array_equal(run.probe(q), np.isin(q, keys))


def test_run_checkpoint_roundtrip_and_corruption_rejected():
    keys = np.unique(_keys(5, 9_000))
    state = pickle.loads(pickle.dumps(FingerprintRun.build(keys).to_state()))
    assert np.array_equal(FingerprintRun.from_state(state).decode_all(), keys)
    corrupt = dict(state, payload=state["payload"][:-1] + b"\x00")
    with pytest.raises(ValueError, match="CRC"):
        FingerprintRun.from_state(corrupt)
    torn = dict(state, count=state["count"] + 1)
    with pytest.raises(ValueError, match="does not match its payload"):
        FingerprintRun.from_state(torn)
    torn["count"] = state["count"] + RUN_BLOCK
    with pytest.raises(ValueError, match="block structure"):
        FingerprintRun.from_state(torn)


def test_run_spill_probe_uniform(tmp_path):
    keys = np.unique(_keys(9, 12_000))
    run = FingerprintRun.build(keys)
    spilled = run.spill(str(tmp_path / "r.fpr"))
    q = np.concatenate([keys[::5], _keys(10, 2_000)])
    assert np.array_equal(spilled.probe(q), run.probe(q))
    assert spilled.disk_nbytes > 0 and spilled.payload is None


def test_store_merges_at_threshold_and_dedups_cross_run_twins():
    store = TieredVisitedStore(merge_run_threshold=3, prefix="t_merge")
    batch = _keys(13, 5_000)
    store.evict(batch)
    store.evict(batch[:2_000])
    assert len(store.l1) == 2
    store.evict(_keys(14, 1_000))
    assert len(store.l1) == 1
    assert store.l1[0].count < 5_000 + 2_000 + 1_000
    assert store.probe(np.unique(batch)).all()


def test_store_spills_past_host_budget_and_probes_union(tmp_path):
    store = TieredVisitedStore(host_budget_mib=0.02, spill_dir=str(tmp_path),
                               prefix="t_spill")
    batches = [_keys(17 + i, 6_000) for i in range(4)]
    for b in batches:
        store.evict(b)
    assert store.l2, "host budget never spilled"
    allk = np.unique(np.concatenate(batches))
    assert store.probe(allk).all()
    miss = _keys(30, 3_000)
    miss = miss[~np.isin(miss, allk)]
    assert not store.probe(miss).any()
    back = TieredVisitedStore(prefix="t_spill_back")
    back.load_state(pickle.loads(pickle.dumps(store.export_state())))
    assert back.probe(allk).all() and not back.probe(miss).any()


def test_store_compacts_l2_at_threshold(tmp_path):
    store = TieredVisitedStore(host_budget_mib=0.001, spill_dir=str(tmp_path),
                               merge_run_threshold=3, prefix="t_l2c")
    batches = [_keys(23 + i, 4_000) for i in range(7)]
    for b in batches:
        store.evict(b)
    assert len(store.l2) < 3, f"L2 never compacted: {len(store.l2)} runs"
    assert len(os.listdir(tmp_path)) == len(store.l2)
    assert store.probe(np.unique(np.concatenate(batches))).all()


def test_store_requires_spill_dir_with_host_budget():
    with pytest.raises(ValueError, match="spill_dir"):
        TieredVisitedStore(host_budget_mib=1.0, prefix="t_bad")


def test_storage_instruments_carry_the_jax_metric_names():
    storage.StorageInstruments("t_names")
    jax_storage.StorageInstruments("t_names")
    from stateright_tpu.telemetry import metrics_registry as jax_registry

    ours = {k for k in metrics_registry().snapshot() if k.startswith("t_names.")}
    theirs = {k for k in jax_registry().snapshot() if k.startswith("t_names.")}
    assert ours and ours == theirs


# -- the checker's budget admission ------------------------------------------------


def test_checker_rejects_host_budget_without_hbm_budget(tmp_path):
    with pytest.raises(ValueError, match="hbm_budget_mib"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(
            device="cpu", frontier_capacity=16, table_capacity=1 << 12,
            host_budget_mib=1.0, spill_dir=str(tmp_path))
    with pytest.raises(ValueError, match="spill_dir requires host_budget_mib"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(
            device="cpu", hbm_budget_mib=1.0, spill_dir=str(tmp_path))


def test_checker_rejects_budget_below_one_wave():
    with pytest.raises(ValueError, match="worst-case wave"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(
            device="cpu", frontier_capacity=1 << 10, table_capacity=1 << 12,
            hbm_budget_mib=0.001)


@pytest.mark.parametrize("wave_kernel", ["staged", "fused"])
def test_checker_rejects_a_budget_below_one_tile(wave_kernel):
    # One wave of 2pc-3 at 8 lanes fits 256 rows, less than one tile.
    budget = ((256 + 128) * 8) / (1 << 20)
    with pytest.raises(ValueError, match="tile"):
        TwoPhaseSys(3).checker().spawn_gpu_bfs(
            device="cpu", frontier_capacity=8, table_capacity=1 << 12,
            wave_kernel=wave_kernel, hbm_budget_mib=budget)


@pytest.mark.parametrize("n, frontier", [(3, 16), (4, 16), (4, 64), (8, 8192)])
def test_min_admissible_budget_is_the_jax_one_in_whole_tiles(n, frontier):
    ours = min_admissible_hbm_budget_mib(TwoPhaseSys(n), frontier)
    theirs = jax_min_admissible_hbm_budget_mib(JaxTwoPhaseSys(n), frontier)
    tile = ((TILE_ROWS + 128) * 8) / (1 << 20)
    assert ours == max(theirs, tile)
    assert storage.max_table_rows_for_budget(ours) == \
        jax_storage.max_table_rows_for_budget(ours)
    # The checker takes it, and refuses anything below.
    checker = TwoPhaseSys(n).checker().target_state_count(1).spawn_gpu_bfs(
        device="cpu", frontier_capacity=frontier, table_capacity=1 << 12,
        hbm_budget_mib=ours).join()
    assert checker.worker_error() is None
    with pytest.raises(ValueError):
        TwoPhaseSys(n).checker().spawn_gpu_bfs(
            device="cpu", frontier_capacity=frontier, table_capacity=1 << 12,
            hbm_budget_mib=ours * 0.9)


def test_store_fault_seams_fire_and_keep_the_tiers_whole(tmp_path):
    from stateright_tpu_torch.utils.faults import (
        FAULT_SITES,
        FaultSpec,
        HostProbeFault,
        SpillFault,
        inject,
    )

    from stateright_tpu.utils.faults import FAULT_SITES as JAX_FAULT_SITES

    assert FAULT_SITES == JAX_FAULT_SITES == {
        "checkpoint.write", "storage.host_probe", "storage.spill", "swarm.wave",
        "swarm.tenant.verdict", "liveness.edge_evict", "pipeline.worker", "device.wave",
        "pack.tenant.verdict", "pack.tenant.evict", "conformance.batch",
        "warmstart.seed_load", "wave.stall"}
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("warmstart.no_such_site")
    store = TieredVisitedStore(host_budget_mib=0.01, spill_dir=str(tmp_path),
                               prefix="t_faults")
    keys = np.unique(_keys(60, 6_000))
    with inject(FaultSpec("storage.spill")) as inj:
        with pytest.raises(SpillFault):
            store.evict(keys)
    # The spill failed before any tier list changed: the run is still in L1.
    assert inj.triggered("storage.spill") == 1
    assert len(store.l1) == 1 and not store.l2
    with inject(FaultSpec("storage.host_probe", at=1)):
        assert store.probe(keys[:10]).all()
        with pytest.raises(HostProbeFault):
            store.probe(keys[:10])
    assert store.probe(keys).all()
