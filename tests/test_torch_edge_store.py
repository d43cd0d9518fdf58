"""The device liveness edge log and its fixpoints in the port against the JAX
package: ``ops/edge_store.py`` (``lasso_trim``, ``reach_any``,
``edge_log_append``), ``checker/device_liveness.py::wave_edge_rows`` and
``storage/edge_log.py::LivenessEdgeStore``, on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.checker import device_liveness as jax_dl
from stateright_tpu.ops import edge_store as jax_es
from stateright_tpu.storage import LivenessEdgeStore as JaxLivenessEdgeStore
from stateright_tpu_torch.checker.device_liveness import seed_root_mask, wave_edge_rows
from stateright_tpu_torch.ops import edge_store as es
from stateright_tpu_torch.storage import LivenessEdgeStore
from stateright_tpu_torch.utils.faults import FaultSpec, LivenessEvictFault, inject


def _graph(kind, n, seed):
    """(src, dst) int32 edge arrays of a seeded graph over ``n`` nodes."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        src, dst = np.arange(n - 1), np.arange(1, n)
    elif kind == "cycle":
        src = np.arange(n)
        dst = np.roll(src, -1)
    elif kind == "chain_into_cycle":
        k = n // 2
        src = np.arange(n)
        dst = np.where(src < n - 1, src + 1, k)
    elif kind == "forest_of_chains":
        src = np.arange(n - 1)
        dst = src + 1
        keep = rng.random(n - 1) > 0.01
        src, dst = src[keep], dst[keep]
    else:
        # A random DAG (edges to higher ids), plus ``back`` back edges.
        m = 3 * n
        a, b = rng.integers(0, n, m), rng.integers(0, n, m)
        src, dst = np.minimum(a, b), np.maximum(a, b)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        back = {"dag": 0, "dag_back": 3}[kind]
        if back:
            u, v = rng.integers(0, n, back), rng.integers(0, n, back)
            src = np.concatenate([src, np.maximum(u, v)])
            dst = np.concatenate([dst, np.minimum(u, v)])
        perm = rng.permutation(len(src))
        src, dst = src[perm], dst[perm]
    return src.astype(np.int32), dst.astype(np.int32)


# JAX's test_trim_kernel_shapes cases, then seeded graphs up to N = 4,096.
SHAPES = {
    "jax_chain_4096": (np.arange(4095), np.arange(1, 4096), 4096),
    "jax_cycle_8": (np.arange(8), np.roll(np.arange(8), -1), 8),
    "jax_chain_into_cycle": (np.array([0, 1, 2, 3]), np.array([1, 2, 3, 2]), 4),
    "jax_one_edge": (np.array([1]), np.array([2]), 3),
}
for _kind, _n, _seed in (("chain", 700, 1), ("cycle", 257, 2), ("chain_into_cycle", 1000, 3),
                         ("forest_of_chains", 4096, 4), ("dag", 300, 5), ("dag_back", 300, 6),
                         ("dag", 4096, 7), ("dag_back", 4096, 8)):
    SHAPES[f"{_kind}_{_n}"] = (*_graph(_kind, _n, _seed), _n)


def _inputs(name):
    src, dst, n = SHAPES[name]
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    rng = np.random.default_rng(len(src))
    evalid = rng.random(len(src)) > 0.02 if name.startswith("dag") else np.ones(len(src), bool)
    nvalid = np.ones(n, bool)
    return src, dst, evalid, nvalid


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_trim_and_reach_match_jax(name):
    src, dst, evalid, nvalid = _inputs(name)
    alive, rounds = es.lasso_trim(src, dst, evalid, nvalid)
    jalive, jrounds = jax_es.lasso_trim(src, dst, evalid, nvalid)
    np.testing.assert_array_equal(alive, np.asarray(jalive))
    assert rounds == jrounds
    n = len(nvalid)
    rng = np.random.default_rng(n)
    # Roots at node 0 and two random nodes; candidates: the survivors and
    # the nodes without a valid out-edge (the analysis' shape), a few
    # random nodes, and none (the full fixpoint: one round a step of the
    # longest path, so only up to 1,024 nodes).
    roots = np.zeros(n, bool)
    roots[0] = True
    roots[rng.integers(0, n, 2)] = True
    cand = alive | (np.bincount(src[evalid], minlength=n) == 0)
    cands = [cand, rng.random(n) < 0.01] + ([np.zeros(n, bool)] if n <= 1024 else [])
    for c in cands:
        hit, reach = es.reach_any(src, dst, evalid, roots, c)
        jhit, jreach = jax_es.reach_any(src, dst, evalid, roots, c)
        assert hit == jhit
        np.testing.assert_array_equal(reach, np.asarray(jreach))


def test_trim_shapes_as_jax_states_them():
    """The properties JAX's ``test_trim_kernel_shapes`` pins: a 4,096 chain
    dies in at most 3 rounds; a cycle and a chain into it survive whole."""
    src, dst, ev, nv = _inputs("jax_chain_4096")
    alive, rounds = es.lasso_trim(src, dst, ev, nv)
    assert not alive.any() and rounds <= 3
    assert es.lasso_trim(*_inputs("jax_cycle_8"))[0].all()
    assert es.lasso_trim(*_inputs("jax_chain_into_cycle"))[0].all()
    hit, reach = es.reach_any(np.array([1], np.int32), np.array([2], np.int32),
                              np.ones(1, bool), np.array([True, False, False]),
                              np.array([False, False, True]))
    assert not hit and reach.tolist() == [True, False, False]


def _rows(rng, m):
    return {c: rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
            for c in es.EDGE_COLS}


@pytest.mark.parametrize("appends", [[(5, 6)], [(6, 6), (6, 6)], [(0, 4), (8, 8), (3, 5)]],
                         ids=["one", "overflow", "overflow_after_full"])
def test_edge_log_append_matches_jax(appends):
    """(n, m) appends into a capacity-8 log: the first n of m rows each;
    rows past the capacity drop and the count still advances."""
    cap, rng = 8, np.random.default_rng(sum(n for n, _m in appends))
    log, jlog = es.edge_log_new(cap, "cpu"), jax_es.edge_log_new(cap)
    for n, m in appends:
        rows = _rows(rng, m)
        es.edge_log_append(log, {c: torch.from_numpy(v.astype(np.int64)) for c, v in rows.items()},
                           torch.tensor(n), cap)
        jlog = jax_es.edge_log_append(jlog, {c: jnp.asarray(v) for c, v in rows.items()},
                                      jnp.int32(n), cap)
    assert int(log["count"]) == int(jlog["count"]) == sum(n for n, _m in appends)
    for c in es.EDGE_COLS:
        np.testing.assert_array_equal(log[c][:cap].numpy(), np.asarray(jlog[c]).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_edge_rows_match_jax(seed):
    """A staged wave's rows on the same inputs (F = 16 frontier rows, A = 3
    actions, two eventually properties at bits 0 and 1, the first
    condition-free property at index 1 skipped): the port's first ``n``
    rows are JAX's, and so is ``n``."""
    rng = np.random.default_rng(seed)
    F, A = 16, 3
    B = F * A
    # Batched for the port, per state under vmap for JAX: the same code.
    conds = [lambda st: st["s"] % 2 == 1, None, lambda st: st["s"] % 3 == 0]
    jconds = conds
    ebit = {0: 0, 2: 1}
    front = rng.integers(0, 50, F).astype(np.uint32)
    cand = rng.integers(0, 50, B).astype(np.uint32)
    cvalid = rng.random(B) < 0.6
    terminal = rng.random(F) < 0.3
    hi, lo, chi, clo = (rng.integers(1, 1 << 32, k, dtype=np.uint64).astype(np.uint32)
                        for k in (F, F, B, B))
    cond_np = np.stack([front % 2 == 1, np.zeros(F, bool), front % 3 == 0])
    t = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
         (("hi", hi), ("lo", lo), ("chi", chi), ("clo", clo))}
    rows, n = wave_edge_rows(conds, ebit, torch.from_numpy(cond_np),
                             {"s": torch.from_numpy(cand.astype(np.int64))},
                             torch.from_numpy(cvalid), torch.from_numpy(terminal),
                             t["hi"], t["lo"], t["chi"], t["clo"], A)
    jrows, jn = jax_dl.wave_edge_rows(
        jconds, ebit, [jnp.asarray(r) for r in cond_np], {"s": jnp.asarray(cand)},
        jnp.asarray(cvalid), jnp.asarray(terminal), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(chi), jnp.asarray(clo), A)
    n = int(n)
    assert n == int(jn) > 0
    for c in es.EDGE_COLS:
        assert rows[c].shape == (B + F,)
        np.testing.assert_array_equal(rows[c][:n].numpy(),
                                      np.asarray(jrows[c])[:n].astype(np.int64))
    # The seed's roots, on the frontier as init states.
    valid = rng.random(F) < 0.8
    mask = seed_root_mask(conds, ebit, {"s": torch.from_numpy(front.astype(np.int64))},
                          torch.from_numpy(valid))
    jmask = jax_dl.seed_root_mask(jconds, ebit, {"s": jnp.asarray(front)}, jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask).astype(np.int64))


def _absorbs(seed, chunks=4, m=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(chunks):
        phi = rng.integers(0, 4, m).astype(np.uint32)
        plo = rng.integers(1, 40, m).astype(np.uint32)
        chi = rng.integers(0, 4, m).astype(np.uint32)
        clo = rng.integers(1, 40, m).astype(np.uint32)
        emask = rng.integers(0, 4, m).astype(np.uint32)
        tmask = np.where(emask == 0, rng.integers(0, 4, m), 0).astype(np.uint32)
        chi[emask == 0] = clo[emask == 0] = 0
        out.append(dict(phi=phi, plo=plo, chi=chi, clo=clo, emask=emask, tmask=tmask))
    return out


def _fill(store, absorbs, as_int64=False):
    for cols in absorbs:
        store.absorb(**{c: (v.astype(np.int64) if as_int64 else v) for c, v in cols.items()})
    store.add_roots(np.array([(1 << 32) | 5, 7], np.uint64), np.array([1, 3]))
    return store


def _slices(store):
    rows = store.edge_rows()
    return [store.property_slice(b, rows=rows) for b in (0, 1)]


def _assert_slices_equal(a, b):
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y)


def test_store_matches_jax_and_round_trips(tmp_path):
    absorbs = _absorbs(0)
    port = _fill(LivenessEdgeStore(), absorbs, as_int64=True)
    ref = _fill(JaxLivenessEdgeStore(), absorbs)
    _assert_slices_equal(_slices(port), _slices(ref))
    assert port.stats() == ref.stats()
    # Under a tiny host budget the chunks spill to CRC-checked files, and
    # the relation reads back the same.
    spilled = _fill(LivenessEdgeStore(spill_dir=str(tmp_path), host_budget_mib=0.001),
                    absorbs, as_int64=True)
    assert spilled.stats()["spilled_chunks"] >= 2
    _assert_slices_equal(_slices(spilled), _slices(ref))
    # export_state / load_state round trip, across the packages too.
    for state in (spilled.export_state(), ref.export_state()):
        other = LivenessEdgeStore()
        other.load_state(state)
        _assert_slices_equal(_slices(other), _slices(ref))
        bad = dict(state, crc=state["crc"] ^ 1)
        with pytest.raises(ValueError, match="CRC"):
            LivenessEdgeStore().load_state(bad)
    # A spill file that changed on disk fails its CRC on read-back.
    path = spilled._spilled[0]
    with np.load(path) as z:
        edges, crc = z["edges"].copy(), z["crc"]
    edges[0, 0] ^= 1
    np.savez(path, edges=edges, crc=crc)
    with pytest.raises(ValueError, match="CRC"):
        spilled.edge_rows()


def test_absorb_fault_site_raises_before_any_row_lands():
    store = LivenessEdgeStore()
    with inject(FaultSpec("liveness.edge_evict")) as inj:
        with pytest.raises(LivenessEvictFault):
            _fill(store, _absorbs(1, chunks=1))
    assert inj.triggered("liveness.edge_evict") == 1
    assert store.stats()["edges_logged"] == 0 and store.stats()["evictions"] == 0
