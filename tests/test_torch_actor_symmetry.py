"""Symmetry reduction of packed actor systems (``actor/packed.py``,
``models/raft.py``, ``actor/model_state.py``) against the JAX package's.

Raft over every network kind: the group action (``packed_apply_permutation``
through raft's ``rewrite_actor_row``) and the generic refinement
(``packed_refine_colors``, reverse references and envelope digests) lane for
lane against the JAX package's hooks on reachable states, with seeded
permutations; the refinement's equivariance; the packed group action
against the host ``ActorModelState._permuted`` at the fingerprint level;
whole symmetric checks (``spawn_gpu_bfs(device="cpu")`` against
``spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort", expand_fps=False)``)
with equal counts, depths, discoveries and paths, wave at a time and
drained, the host's brute-force orbit count, and the 464 orbits of the
lossy duplicating case; and the JAX package's refusals (an auxiliary
history, restricted flow pairs) by error type. Everything compared is an
integer: the tolerance is 0.
"""

from collections import deque
from itertools import permutations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.actor import Network as JaxNetwork
from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg
from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosModelCfg
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu_torch.actor.network import Network
from stateright_tpu_torch.interop import packed_states_from_numpy
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.utils.rewrite import RewritePlan

RAFT_DUP_LOSSY_ORBITS = 464
SPAWN = dict(frontier_capacity=256, table_capacity=1 << 14)
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}

# name: (network, lossy, max_crashes, orbits, states at max_term=1, 3 servers)
RAFT = {
    "lossy": ("nonduplicating", True, 0, 121, 665),
    "lossy_duplicating": ("duplicating", True, 0, RAFT_DUP_LOSSY_ORBITS, 2717),
    "lossless_duplicating": ("duplicating", False, 0, 12, 53),
    "ordered": ("ordered", False, 0, 65, 341),
    "lossy_one_crash": ("nonduplicating", True, 1, None, 2252),
}
NETWORKS = {"nonduplicating": "new_unordered_nonduplicating",
            "duplicating": "new_unordered_duplicating", "ordered": "new_ordered"}


def _raft(name, jax_side=False):
    net, lossy, crashes, _orbits, _n = RAFT[name]
    cfg, network = (JaxRaftModelCfg, JaxNetwork) if jax_side else (RaftModelCfg, Network)
    return cfg(server_count=3, max_term=1, lossy=lossy, max_crashes=crashes,
               network=getattr(network, NETWORKS[net])()).into_model()


def _reach(model, cap=None):
    init = model.init_states()
    seen, queue, out = set(init), deque(init), []
    while queue and (cap is None or len(out) < cap):
        s = queue.popleft()
        out.append(s)
        actions = []
        model.actions(s, actions)
        for a in actions:
            t = model.next_state(s, a)
            if t is not None and model.within_boundary(t) and t not in seen:
                seen.add(t)
                queue.append(t)
    return out


def _packed_np(model, host_states):
    packed = [model.pack_state(s) for s in host_states]
    return {k: np.stack([np.asarray(p[k]) for p in packed]).astype(np.uint32)
            for k in packed[0]}


@pytest.mark.parametrize("name", list(RAFT))
def test_group_action_and_refinement_match_jax(name):
    """Reachable raft states (every 5th of the first 400) under three seeded
    permutations each: the permuted packed state, and two rounds of the
    refinement from zero colors, leaf for leaf and lane for lane against the
    JAX package; and the refinement is equivariant."""
    jm, pm = _raft(name, jax_side=True), _raft(name)
    host = _reach(jm, cap=400)[::5]
    base = _packed_np(jm, host)
    n2o_all, o2n_all = pm.packed_symmetry()
    jn2o, jo2n = jm.packed_symmetry()
    assert (n2o_all == jn2o).all() and (o2n_all == jo2n).all()
    rng = np.random.default_rng(3)
    pick = rng.integers(0, n2o_all.shape[0], (len(host), 3)).reshape(-1)
    rep = {k: np.repeat(v, 3, axis=0) for k, v in base.items()}
    n2o, o2n = n2o_all[pick], o2n_all[pick]
    jst = {k: jnp.asarray(v) for k, v in rep.items()}
    want = jax.vmap(jm.packed_apply_permutation)(jst, jnp.asarray(n2o), jnp.asarray(o2n))
    states = packed_states_from_numpy(rep)
    got = pm.packed_apply_permutation(states, torch.from_numpy(n2o.astype(np.int64)),
                                      torch.from_numpy(o2n.astype(np.int64)))
    assert set(got) == set(want)
    for k in want:
        assert (got[k].numpy() == np.asarray(want[k]).astype(np.int64)).all(), k
    L, n = n2o.shape
    colors = torch.zeros((L, n), dtype=torch.int64)
    colors_p = torch.zeros((L, n), dtype=torch.int64)
    jcolors = jnp.zeros((L, n), jnp.uint32)
    refine = jax.jit(jax.vmap(jm.packed_refine_colors))
    for _ in range(2):
        jcolors = refine(jst, jcolors)
        colors = pm.packed_refine_colors(states, colors)
        colors_p = pm.packed_refine_colors(got, colors_p)
        assert (colors.numpy() == np.asarray(jcolors).astype(np.int64)).all()
        # refine(sigma(s), sigma(c)) == sigma(refine(s, c))
        assert torch.equal(colors_p, torch.gather(colors, 1, torch.from_numpy(
            n2o.astype(np.int64))))


@pytest.mark.parametrize("name", ["lossy", "ordered"])
def test_packed_group_action_matches_the_host(name):
    """Every 7th reachable state under every permutation: the fingerprint of
    the packed group action equals the fingerprint of the packed host
    ``_permuted`` state (the packed envelope table is left unsorted; the
    fingerprint digests it order-insensitively)."""
    model = _raft(name)
    states = _reach(model)[::7]
    n2o, o2n = model.packed_symmetry()
    perms = list(permutations(range(3)))
    assert [tuple(r) for r in n2o.tolist()] == perms
    packed = packed_states_from_numpy(_packed_np(model, states))
    for k, p in enumerate(perms):
        got = model.packed_fingerprint(model.packed_apply_permutation(
            packed, torch.from_numpy(n2o[k].astype(np.int64)),
            torch.from_numpy(o2n[k].astype(np.int64))))
        mapping = [0] * 3
        for new, old in enumerate(p):
            mapping[old] = new
        host = packed_states_from_numpy(_packed_np(
            model, [s._permuted(RewritePlan(mapping)) for s in states]))
        want = model.packed_fingerprint(host)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), p


def _runs(name, mode, **extra):
    ref = _raft(name, jax_side=True).checker().symmetry().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", expand_fps=False, **SPAWN,
        **MODES[mode]).join()
    port = _raft(name).checker().symmetry().spawn_gpu_bfs(
        device="cpu", **SPAWN, **MODES[mode], **extra).join()
    assert port.worker_error() is None, port.worker_error()
    assert not port._use_fps
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    assert set(port.discoveries()) == set(ref.discoveries())
    for prop, path in ref.discoveries().items():
        assert port.discoveries()[prop].encode() == path.encode(), prop
    got, want = np.concatenate(port._key_log), np.concatenate(ref._key_log)
    assert (np.sort(got) == np.sort(want)).all()
    return port, ref


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(RAFT))
def test_raft_orbit_counts_match_jax(name, mode):
    port, _ref = _runs(name, mode)
    orbits = RAFT[name][3]
    if orbits is not None:
        assert port.unique_state_count() == orbits
    assert set(port.discoveries()) == {"leader elected", "stable leader"}


def test_raft_device_orbits_equal_the_host_orbits():
    """The host's brute-force orbit count (every reachable state of the
    lossy configuration mapped to its least permuted state) equals the
    symmetric run's."""
    model = _raft("lossy")
    states = _reach(model)
    assert len(states) == RAFT["lossy"][4]
    orbits = {s.orbit_representative() for s in states}
    port = model.checker().symmetry().spawn_gpu_bfs(device="cpu", **SPAWN).join()
    assert port.unique_state_count() == len(orbits) == RAFT["lossy"][3]


@pytest.mark.parametrize("mode", list(MODES))
def test_raft_lossy_duplicating_gives_464_orbits(mode):
    """Raft, 3 servers, ``max_term=1``, lossy and duplicating: 464 orbits (the
    JAX package's pinned count, 2,208 states generated) with both
    discoveries replaying; drained, the waves whose refined keys fail
    stop their drains and the host finishes them."""
    model = RaftModelCfg(server_count=3, max_term=1, lossy=True,
                         network=Network.new_unordered_duplicating()).into_model()
    port = model.checker().symmetry().spawn_gpu_bfs(
        device="cpu", frontier_capacity=256, table_capacity=1 << 12, **MODES[mode]).join()
    assert port.worker_error() is None, port.worker_error()
    assert port.unique_state_count() == RAFT_DUP_LOSSY_ORBITS
    assert set(port.discoveries()) == {"leader elected", "stable leader"}
    for path in port.discoveries().values():
        assert len(path) >= 1
    if mode == "drain":
        assert port.drain_exits.get("orbit fallback", 0) == port._sym.fallback_waves > 0


def test_refusals_match_jax():
    """An auxiliary history (paxos, ABD) and restricted flow pairs refuse
    symmetry as in the JAX package: ``packed_symmetry`` raises
    ``NotImplementedError``, the checker ``TypeError``; raft passes, with
    the fingerprint-only wave resolved off and ``expand_fps=True`` refused."""
    def restricted(cfg, network):
        pairs = [(a, b) for a in range(3) for b in range(3) if a != b]
        return cfg(server_count=3, max_term=1, lossy=False,
                   network=network.new_ordered()).into_model().with_flow_pairs(pairs)

    cases = (
        (lambda: PaxosModelCfg(2, 2).into_model(),
         lambda: JaxPaxosModelCfg(2, 2).into_model(), "history"),
        (lambda: AbdModelCfg(2, 2).into_model(),
         lambda: JaxAbdModelCfg(2, 2).into_model(), "history"),
        (lambda: restricted(RaftModelCfg, Network),
         lambda: restricted(JaxRaftModelCfg, JaxNetwork), "flow_pairs"),
    )
    for make, make_jax, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            make().packed_symmetry()
        with pytest.raises(NotImplementedError, match=match):
            make_jax().packed_symmetry()
        with pytest.raises(TypeError, match=match):
            make().checker().symmetry().spawn_gpu_bfs(device="cpu")
        with pytest.raises(TypeError):
            make_jax().checker().symmetry().spawn_tpu_bfs()
    n2o, _o2n = _raft("ordered").packed_symmetry()
    assert n2o.shape == (6, 3)
    with pytest.raises(ValueError, match="expand_fps"):
        _raft("lossy").checker().symmetry().spawn_gpu_bfs(device="cpu", expand_fps=True)
    with pytest.raises(ValueError):
        _raft("lossy", jax_side=True).checker().symmetry().spawn_tpu_bfs(expand_fps=True)
