"""Symmetry reduction on the port (``checker/symmetry.py``, the 2pc hooks)
against the JAX package's device symmetry.

The permutation tables, the 2pc group action and refinement, and the keys
of every route (refined, orbit minimum, refined with a weak hook that
falls back on some lanes, custom representative) are held to the JAX
package's ``permutation_tables``, hooks and ``_make_key_fn`` on the same
packed states, made from a seed with numpy and carried across through
``interop.py``. Whole runs (``spawn_gpu_bfs(device="cpu")`` against
``spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort")``, both with
``.symmetry()``) must give the same counts, depths, discoveries and paths,
wave at a time and drained, and the 2pc-4 count must equal a brute-force
count of host orbits. The refusals are the JAX package's, by error type.
Everything compared is an integer: the tolerance is 0.

The module imports no JAX at its top: its ``cuda`` tests (the captured
drain and its fallback exit against the CPU drain, the insert kernel on
canonical keys against its plain twin) run on a machine with only PyTorch,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_symmetry.py
"""

from collections import deque

import numpy as np
import pytest
import torch

from stateright_tpu_torch.checker.symmetry import (
    CUSTOM_REP_SCHEME,
    SYM_KEY_SCHEME,
    make_key_fn,
)
from stateright_tpu_torch.core.batch import (
    MAX_SYMMETRY_ACTORS,
    BatchableModel,
    permutation_tables,
)
from stateright_tpu_torch.checker.builder import default_representative
from stateright_tpu_torch.interop import packed_states_from_numpy, packed_states_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.fingerprint import fp64_pairs
from stateright_tpu_torch.utils.rewrite import RewritePlan

TWO_PC_5_ORBITS = 314
SPAWN = dict(frontier_capacity=256, table_capacity=1 << 14)
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}


# -- the models of both packages -------------------------------------------------


class WeakRefine2pc(TwoPhaseSys):
    """A refine hook that says nothing (one tie class everywhere): every
    lane that is not fully symmetric fails its check and takes the orbit
    minimum."""

    def packed_refine_colors(self, states, colors):
        return torch.zeros_like(colors)


class NoRefine2pc(TwoPhaseSys):
    """2pc with the refine hook hidden: the orbit-minimum route."""

    packed_refine_colors = BatchableModel.packed_refine_colors


K = 3  # the partial symmetry of Partial2pc: the first three RMs


def rep3(state):
    """The host representative of Partial2pc: sort the first K RMs."""
    order = sorted(range(K), key=lambda i: (state.rm_state[i], state.tm_prepared[i],
                                            ("Prepared", i) in state.msgs))
    mapping = list(range(len(state.rm_state)))
    for new, old in enumerate(order):
        mapping[old] = new
    return state._permuted(RewritePlan(mapping))


class Partial2pc(TwoPhaseSys):
    """A partial symmetry over the first K RMs, through
    ``packed_representative`` (the JAX test's model, batched)."""

    def packed_representative(self, states):
        n = self.rm_count
        idx = torch.arange(n)
        prep = (states["prepared"][:, None] >> idx) & 1
        msg = (states["msgs"][:, None] >> idx) & 1
        key = states["rm"] * 4 + prep * 2 + msg
        order3 = torch.sort(key[:, :K], dim=1, stable=True).indices
        L = key.shape[0]
        n2o = torch.cat([order3, torch.arange(K, n).expand(L, n - K)], dim=1)
        o2n = torch.empty_like(n2o).scatter_(1, n2o, torch.arange(n).expand(L, n))
        return self.packed_apply_permutation(states, n2o, o2n)


def _jax_models():
    """The JAX twins of the models above (JAX is imported here, not at the
    module's top)."""
    import jax.numpy as jnp

    from stateright_tpu.core.batch import BatchableModel as JaxBatchableModel
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    class JaxWeak(JaxTwoPhaseSys):
        def packed_refine_colors(self, state, colors):
            return jnp.zeros_like(colors)

    class JaxNoRefine(JaxTwoPhaseSys):
        packed_refine_colors = JaxBatchableModel.packed_refine_colors

    class JaxPartial(JaxTwoPhaseSys):
        def packed_representative(self, state):
            n = self.rm_count
            idx = jnp.arange(n, dtype=jnp.uint32)
            prep = (state["prepared"] >> idx) & jnp.uint32(1)
            msg = (state["msgs"] >> idx) & jnp.uint32(1)
            key = state["rm"] * jnp.uint32(4) + prep * jnp.uint32(2) + msg
            order3 = jnp.argsort(key[:K], stable=True).astype(jnp.int32)
            n2o = jnp.concatenate([order3, jnp.arange(K, n, dtype=jnp.int32)])
            o2n = jnp.zeros((n,), jnp.int32).at[n2o].set(jnp.arange(n, dtype=jnp.int32))
            return self.packed_apply_permutation(state, n2o, o2n)

    return {"plain": JaxTwoPhaseSys, "weak": JaxWeak, "norefine": JaxNoRefine,
            "partial": JaxPartial}


PORT_MODELS = {"plain": TwoPhaseSys, "weak": WeakRefine2pc, "norefine": NoRefine2pc,
               "partial": Partial2pc}


def _random_2pc(rng, B, n):
    """B random packed 2pc states of n RMs (any field values in range), as
    the JAX package's uint32 layout."""
    return {
        "rm": rng.integers(0, 4, (B, n)).astype(np.uint32),
        "tm": rng.integers(0, 3, (B,)).astype(np.uint32),
        "prepared": rng.integers(0, 1 << n, (B,)).astype(np.uint32),
        "msgs": rng.integers(0, 1 << (n + 2), (B,)).astype(np.uint32),
    }


def _reachable_2pc(n):
    """Every reachable 2pc state of n RMs, breadth first (host order)."""
    model = TwoPhaseSys(n)
    init = model.init_states()
    seen, queue, out = set(init), deque(init), []
    while queue:
        s = queue.popleft()
        out.append(s)
        actions = []
        model.actions(s, actions)
        for a in actions:
            t = model.next_state(s, a)
            if t not in seen:
                seen.add(t)
                queue.append(t)
    return out


def _packed(model, host_states):
    packed = [model.pack_state(s) for s in host_states]
    return {k: torch.stack([p[k] for p in packed]) for k in packed[0]}


def _u64(hi, lo):
    return fp64_pairs(np.asarray(hi), np.asarray(lo))


# -- tables, group action, refinement ---------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_permutation_tables_match_jax(n):
    from stateright_tpu.core.batch import permutation_tables as jax_tables

    n2o, o2n = permutation_tables(n)
    jn2o, jo2n = jax_tables(n)
    assert n2o.dtype == jn2o.dtype and (n2o == jn2o).all() and (o2n == jo2n).all()
    # Each old_to_new row inverts its new_to_old row.
    assert (np.take_along_axis(o2n, n2o.astype(np.int64), axis=1)
            == np.arange(n)).all()


def test_permutation_tables_refuse_past_the_bound():
    from stateright_tpu.core.batch import permutation_tables as jax_tables

    assert MAX_SYMMETRY_ACTORS == 9
    with pytest.raises(ValueError, match="bound"):
        permutation_tables(10)
    with pytest.raises(ValueError, match="bound"):
        jax_tables(10)


def test_2pc_group_action_matches_jax():
    """Every one of the 24 permutations of 2pc-4 on seeded packed states:
    one row a lane and one row shared by the batch, against the JAX
    package's ``packed_apply_permutation``."""
    import jax
    import jax.numpy as jnp

    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    n, B = 4, 16
    rng = np.random.default_rng(4)
    jm, pm = JaxTwoPhaseSys(n), TwoPhaseSys(n)
    n2o, o2n = pm.packed_symmetry()
    P = n2o.shape[0]
    assert P == 24
    states = _random_2pc(rng, B, n)
    # Lane b * P + k: state b under permutation k.
    rep = {k: np.repeat(v, P, axis=0) for k, v in states.items()}
    rn2o, ro2n = np.tile(n2o, (B, 1)), np.tile(o2n, (B, 1))
    want = jax.vmap(jm.packed_apply_permutation)(
        {k: jnp.asarray(v) for k, v in rep.items()}, jnp.asarray(rn2o), jnp.asarray(ro2n))
    got = pm.packed_apply_permutation(packed_states_from_numpy(rep),
                                      torch.from_numpy(rn2o), torch.from_numpy(ro2n))
    got = packed_states_to_numpy(got)
    for k in want:
        assert (np.asarray(want[k]) == got[k]).all(), k
    # A shared (n,) row gives each lane the same permutation.
    port = packed_states_from_numpy(states)
    for k in range(P):
        shared = packed_states_to_numpy(pm.packed_apply_permutation(
            port, torch.from_numpy(n2o[k]), torch.from_numpy(o2n[k])))
        for leaf in shared:
            assert (shared[leaf] == got[leaf][k::P]).all(), (k, leaf)


def test_2pc_refine_colors_match_jax():
    import jax
    import jax.numpy as jnp

    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    n, B = 5, 64
    rng = np.random.default_rng(5)
    states = _random_2pc(rng, B, n)
    colors = rng.integers(0, 1 << 32, (B, n), dtype=np.uint64).astype(np.uint32)
    want = jax.vmap(JaxTwoPhaseSys(n).packed_refine_colors)(
        {k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(colors))
    got = TwoPhaseSys(n).packed_refine_colors(
        packed_states_from_numpy(states), torch.from_numpy(colors.astype(np.int64)))
    assert (np.asarray(want).astype(np.int64) == got.numpy()).all()


# -- the keys of every route ---------------------------------------------------------


def _key_batch(n, seed):
    """Reachable 2pc-n states (every 7th), seeded random ones, and a random
    permutation of each: orbit-mates among them key alike."""
    rng = np.random.default_rng(seed)
    reach_states = _packed(TwoPhaseSys(n), _reachable_2pc(n)[::7])
    base = packed_states_to_numpy(reach_states)
    rand = _random_2pc(rng, 64, n)
    both = {k: np.concatenate([base[k], rand[k]]) for k in base}
    L = both["tm"].shape[0]
    n2o, o2n = permutation_tables(n)
    pick = rng.integers(0, n2o.shape[0], L)
    permuted = packed_states_to_numpy(TwoPhaseSys(n).packed_apply_permutation(
        packed_states_from_numpy(both), torch.from_numpy(n2o[pick].astype(np.int64)),
        torch.from_numpy(o2n[pick].astype(np.int64))))
    return {k: np.concatenate([both[k], permuted[k]]) for k in both}


def _jax_keys(route, n, batch):
    import jax
    import jax.numpy as jnp

    from stateright_tpu.checker.builder import default_representative as jax_default
    from stateright_tpu.checker.tpu import _make_key_fn

    model = _jax_models()[route](n)
    sym = rep3 if route == "partial" else jax_default
    fn = _make_key_fn(model, model.packed_fingerprint, sym)
    hi, lo = jax.jit(fn)({k: jnp.asarray(v) for k, v in batch.items()})
    return _u64(hi, lo)


@pytest.mark.parametrize("route", ["plain", "norefine", "weak", "partial"])
def test_keys_match_jax_on_every_route(route):
    """The port's exact keys (``SymmetryKeys.keys``) equal the JAX package's
    ``_make_key_fn`` bit for bit on 2pc-5: refined, orbit minimum (the
    refine hook hidden), refined with a weak hook whose failed lanes fall
    back, and a custom representative."""
    n = 5
    batch = _key_batch(n, seed=55)
    model = PORT_MODELS[route](n)
    sym = rep3 if route == "partial" else default_representative
    keys = make_key_fn(model, model.packed_fingerprint, sym, "cpu")
    want_route = {"plain": "refined", "weak": "refined", "norefine": "orbit",
                  "partial": "custom"}[route]
    assert keys.route == want_route
    hi, lo = keys.keys(packed_states_from_numpy(batch))
    got = _u64(hi.numpy(), lo.numpy())
    want = _jax_keys(route, n, batch)
    assert (got == want).all()
    if route == "weak":
        assert keys.fallback_lanes > 0
    if route == "plain":
        # WL never falls back on 2pc; orbit-mates share a key.
        assert keys.fallback_lanes == 0
        half = got.shape[0] // 2
        assert (got[:half] == got[half:]).all()


def test_refined_and_orbit_keys_partition_alike():
    """The refined keys and the exact orbit minimum induce the same
    partition of a 2pc-5 batch (and every refined lane verifies)."""
    n = 5
    states = packed_states_from_numpy(_key_batch(n, seed=7))
    refined = make_key_fn(TwoPhaseSys(n), TwoPhaseSys(n).packed_fingerprint,
                          default_representative, "cpu")
    khi, klo, ok = refined.refined(states)
    assert ok.all()
    mhi, mlo = refined.orbit_min(states)
    r, m = _u64(khi.numpy(), klo.numpy()), _u64(mhi.numpy(), mlo.numpy())
    assert ((r[:, None] == r[None, :]) == (m[:, None] == m[None, :])).all()


def test_capturable_keys_hold_where_a_valid_lane_failed():
    """``wave_keys(exact=False)`` reads nothing back: its ``hold`` is true
    exactly when a valid lane failed the refined check, and its keys equal
    the exact ones on the lanes that passed."""
    n = 4
    states = packed_states_from_numpy(_key_batch(n, seed=9))
    L = states["tm"].shape[0]
    weak = WeakRefine2pc(n)
    keys = make_key_fn(weak, weak.packed_fingerprint, default_representative, "cpu")
    _, _, ok = keys.refined(states)
    assert not ok.all() and ok.any()
    for valid, want in ((torch.ones(L, dtype=torch.bool), True), (ok, False),
                        (torch.zeros(L, dtype=torch.bool), False)):
        hi, lo, hold = keys.wave_keys(states, valid, exact=False)
        assert hold.dim() == 0 and bool(hold) is want
        ehi, elo, none = keys.wave_keys(states, valid)
        assert none is None
        assert (hi[ok] == ehi[ok]).all() and (lo[ok] == elo[ok]).all()


# -- whole runs ------------------------------------------------------------------


def _jax_run(route, n, mode, **extra):
    from stateright_tpu.checker.builder import default_representative as jax_default

    model = _jax_models()[route](n)
    b = model.checker()
    b = b.symmetry_fn(rep3) if route == "partial" else b.symmetry()
    assert b._symmetry is not None and (route == "partial" or b._symmetry is jax_default)
    return b.spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort", **SPAWN,
                           **MODES[mode], **extra).join()


def _port_run(route, n, mode, **extra):
    b = PORT_MODELS[route](n).checker()
    b = b.symmetry_fn(rep3) if route == "partial" else b.symmetry()
    return b.spawn_gpu_bfs(device="cpu", **SPAWN, **MODES[mode], **extra).join()


def _same_run(port, ref):
    assert port.worker_error() is None, port.worker_error()
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    pd, rd = port.discoveries(), ref.discoveries()
    assert set(pd) == set(rd)
    for name in rd:
        assert pd[name].encode() == rd[name].encode(), name


def _same_key_log(port, ref):
    """The visited-set keys both runs logged, wave by wave (the seed's
    first): one a unique state, the same multiset in both packages."""
    got, want = np.concatenate(port._key_log), np.concatenate(ref._key_log)
    assert got.shape[0] == port.unique_state_count()
    assert (np.sort(got) == np.sort(want)).all()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [4, 5])
def test_2pc_counts_discoveries_and_paths_match_jax(n, mode):
    port = _port_run("plain", n, mode)
    ref = _jax_run("plain", n, mode)
    _same_run(port, ref)
    assert port._sym_scheme == SYM_KEY_SCHEME == ref._sym_scheme
    if n == 5:
        assert port.unique_state_count() == TWO_PC_5_ORBITS
    assert set(port.discoveries()) == {"abort agreement", "commit agreement"}
    port.assert_properties()
    # The paths replay through concrete states.
    path = port.discoveries()["commit agreement"]
    assert all(s == "Committed" for s in path.last_state().rm_state)
    assert port._sym.fallback_lanes == port._sym.fallback_waves == 0
    if mode == "drain":
        assert port.drains > 0
    _same_key_log(port, ref)


def test_2pc4_equals_the_brute_force_orbit_count():
    """Every reachable 2pc-4 state mapped to its host orbit representative
    (the least of its 24 permutations): as many orbits as the port's
    symmetric run visits."""
    states = _reachable_2pc(4)
    assert len(states) == 1568
    orbits = {s.orbit_representative() for s in states}
    port = _port_run("plain", 4, "drain")
    assert port.unique_state_count() == len(orbits) == 166


@pytest.mark.parametrize("mode", list(MODES))
def test_weak_refine_hook_falls_back_exactly(mode):
    """A refine hook that says nothing costs fallbacks, never counts: 314 at
    2pc-5, equal to the JAX package's run with the same hook. Drained, the
    failing waves stop their drains ("orbit fallback") and the host runs
    them exactly."""
    port = _port_run("weak", 5, mode)
    ref = _jax_run("weak", 5, mode)
    _same_run(port, ref)
    assert port.unique_state_count() == TWO_PC_5_ORBITS
    assert port._sym.fallback_lanes > 0
    exits = port.drain_exits.get("orbit fallback", 0)
    if mode == "drain":
        # Each exit's wave runs once more on the host, exactly.
        assert exits == port._sym.fallback_waves > 0
    else:
        assert exits == 0 and port._sym.fallback_waves > 0
    _same_key_log(port, ref)


@pytest.mark.parametrize("mode", list(MODES))
def test_orbit_minimum_route_matches_jax(mode):
    port = _port_run("norefine", 4, mode)
    assert port._sym.route == "orbit"
    _same_run(port, _jax_run("norefine", 4, mode))


@pytest.mark.parametrize("mode", list(MODES))
def test_custom_representative_matches_jax(mode):
    """A partial symmetry over the first three RMs of 2pc-4, through
    ``packed_representative``: the JAX package's counts, fewer than the
    unreduced space's."""
    port = _port_run("partial", 4, mode)
    assert port._sym.route == "custom" and port._sym_scheme == CUSTOM_REP_SCHEME
    _same_run(port, _jax_run("partial", 4, mode))
    full = TwoPhaseSys(4).checker().spawn_gpu_bfs(device="cpu", **SPAWN).join()
    assert port.unique_state_count() < full.unique_state_count() == 1568


def test_refusals_match_jax():
    """The fused wave and ``expand_fps=True`` refuse symmetry, and a custom
    ``symmetry_fn`` without ``packed_representative`` is refused, each with
    the JAX package's error type; ``expand_fps=None`` resolves to off."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    cases = (
        (dict(wave_kernel="fused"), ValueError, "wave_kernel='fused'"),
        (dict(expand_fps=True), ValueError, "expand_fps"),
    )
    for options, err, match in cases:
        with pytest.raises(err, match=match):
            TwoPhaseSys(3).checker().symmetry().spawn_gpu_bfs(device="cpu", **options)
        with pytest.raises(err):
            JaxTwoPhaseSys(3).checker().symmetry().spawn_tpu_bfs(**options)
    with pytest.raises(ValueError, match="packed_representative"):
        TwoPhaseSys(3).checker().symmetry_fn(lambda s: s.representative()).spawn_gpu_bfs(
            device="cpu")
    with pytest.raises(ValueError):
        JaxTwoPhaseSys(3).checker().symmetry_fn(lambda s: s.representative()).spawn_tpu_bfs()
    c = TwoPhaseSys(3).checker().symmetry().spawn_gpu_bfs(device="cpu", **SPAWN).join()
    assert not c._use_fps and c.unique_state_count() == 80
    # The host oracle ignores symmetry, as the JAX package's host BFS does.
    host = TwoPhaseSys(3).checker().symmetry().spawn_bfs().join()
    assert host.unique_state_count() == 288


@pytest.mark.parametrize("mode", list(MODES))
def test_coverage_under_symmetry_matches_jax(mode):
    """``uniq_fp`` and ``uniq_key`` (the report's symmetry block) and every
    other field but the prefix equal the JAX package's report at 2pc-5."""
    port = _port_run("plain", 5, mode, coverage=True)
    ref = _jax_run("plain", 5, mode, coverage=True)
    _same_run(port, ref)
    rep, jrep = dict(port.coverage_report()), dict(ref.coverage_report())
    assert rep.pop("prefix") == "gpu_bfs"
    jrep.pop("prefix")
    assert rep["symmetry"]["wave_distinct_orbits"] > 0
    assert rep["symmetry"]["wave_distinct_fps"] > rep["symmetry"]["wave_distinct_orbits"]
    assert rep == jrep


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["plain", "weak"])
def test_cuda_symmetry_drain_matches_cpu_drain(cuda_device, route):
    """2pc-5 with ``.symmetry()`` through the captured drain on the card and
    the uncaptured drain of the CPU twin: 314 orbits, the same counts,
    depths, paths, drains and exits; with the weak hook the drains stop at
    "orbit fallback" exits on the card as on the CPU."""
    from stateright_tpu_torch.ops import hashset_kernel as hk

    spawn = dict(frontier_capacity=64, table_capacity=1 << 14)
    hk.launches = 0
    card = PORT_MODELS[route](5).checker().symmetry().spawn_gpu_bfs(
        device=cuda_device, **spawn).join()
    assert hk.launches > 0
    cpu = PORT_MODELS[route](5).checker().symmetry().spawn_gpu_bfs(
        device="cpu", **spawn).join()
    assert card.worker_error() is None, card.worker_error()
    assert card.unique_state_count() == cpu.unique_state_count() == TWO_PC_5_ORBITS
    assert card.state_count() == cpu.state_count()
    assert card.max_depth() == cpu.max_depth()
    assert card.drains == cpu.drains and card.drain_exits == cpu.drain_exits
    assert card.graph_replays > 0
    assert (card.drain_exits.get("orbit fallback", 0) > 0) is (route == "weak")
    for name, path in cpu.discoveries().items():
        assert card.discoveries()[name].encode() == path.encode()


@pytest.mark.cuda
def test_cuda_insert_on_canonical_keys_matches_plain(cuda_device):
    """One 2pc-5 symmetry wave's sorted canonical keys through the insert
    kernel on the card and through its plain twin: the same table, fresh,
    found and pending."""
    from stateright_tpu_torch.ops.fused_wave import model_stage, sorted_dedup
    from stateright_tpu_torch.ops.hashset import hashset_new, u32_to_i32
    from stateright_tpu_torch.ops.hashset_kernel import (
        hashset_insert_sorted,
        hashset_insert_sorted_plain,
    )

    model = TwoPhaseSys(5)
    states = _packed(model, _reachable_2pc(5)[:512])
    from stateright_tpu_torch.ops.fused_wave import FusedWaveSpec

    fspec = FusedWaveSpec(expand=model.packed_expand,
                          within_boundary=model.packed_within_boundary,
                          conditions=(), expectations=(), ebit=(),
                          action_count=model.packed_action_count())
    _cond, cvalid, cand = model_stage(fspec, states, 512)
    keys = make_key_fn(model, model.packed_fingerprint, default_representative, "cpu")
    khi, klo = keys.keys(cand)
    shi, slo, _sidx, unique = sorted_dedup(khi, klo, cvalid)
    out = {}
    for dev, fn in ((cuda_device, hashset_insert_sorted), ("cpu", hashset_insert_sorted_plain)):
        table = hashset_new(1 << 14, dev)
        out[str(dev)] = [x.cpu() for x in fn(table, u32_to_i32(shi).to(dev),
                                             u32_to_i32(slo).to(dev), unique.to(dev))]
    for a, b in zip(out[str(cuda_device)], out["cpu"]):
        assert torch.equal(a, b)
    assert int(out["cpu"][1].sum()) > 0
