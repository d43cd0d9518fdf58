"""The port's component-hash fingerprints against the JAX package's.

``stateright_tpu_torch/ops/fingerprint.py`` carries the "comphash" half of
``FP_SCHEME``: ``multiset_row_pairs``, ``multiset_digest``,
``component_seeds``, ``lin_consts``, ``hash_rows``, ``pairs_acc``,
``acc_finalize``, ``combine_pairs`` and ``fp64_pairs``. Each must give the
JAX function's (hi, lo) bit for bit, on random rows with words at and above
2^31 (the products of two u32 values wrap int64), on one-row and 24-row
tables, and on empty and full multisets. Then the plain twin of the fused
wave's ``fw_comphash_keys`` (the port's torch ``packed_fingerprint`` and the
keys stage's masking) equals ``jax.vmap(model.packed_fingerprint)`` on every
reachable state of paxos with 2 clients and 2 servers, masked and past-cap
lanes going to the sentinel. On ordered networks each FIFO flow is a
component of its own: the pairs and fingerprints equal JAX's on random
ordered states (words at and above 2^31, empty and full flows) of the
identity flow layout and of a ``with_flow_pairs`` subset, and the keys
stage refuses an ordered layout whose flow leaves are missing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.actor.network import Network as JaxNetwork
from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg
from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosModelCfg
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.ops import fingerprint as jfp
from stateright_tpu_torch.actor.network import Network
from stateright_tpu_torch.interop import packed_states_from_numpy
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.ops import fingerprint as tfp
from stateright_tpu_torch.ops import fused_wave as fw

U32 = 0xFFFFFFFF


def _rows(seed, shape):
    """Random u32 rows, a third of them at or above 2^31, and the corner
    words 0, 2^31 and 2^32 - 1."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    high = rng.random(shape) < 0.33
    rows = np.where(high, rows | np.uint32(1 << 31), rows).astype(np.uint32)
    flat = rows.reshape(-1)
    flat[: min(3, flat.size)] = np.array([0, 1 << 31, U32], np.uint32)[: min(3, flat.size)]
    return rows


def _t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def _eq(jax_out, port_out):
    if isinstance(jax_out, (tuple, list)):
        assert len(jax_out) == len(port_out)
        for a, b in zip(jax_out, port_out):
            _eq(a, b)
        return
    a = np.asarray(jax_out).astype(np.int64)
    b = port_out.numpy() if isinstance(port_out, torch.Tensor) else np.asarray(port_out)
    assert a.shape == b.shape and (a == b.astype(np.int64)).all(), (a, b)


@pytest.mark.parametrize("width,salt", [(1, 0), (4, 0x48AC1 + 8), (12, 0x77A11 + 36),
                                        (36, 0x5B3D5 + 252)])
def test_lin_consts_match(width, salt):
    assert (tfp.lin_consts(width, salt) == jfp._lin_consts(width, salt)).all()
    assert tfp.lin_consts(width, salt).dtype == np.uint32


@pytest.mark.parametrize("E", [1, 24])
@pytest.mark.parametrize("W", [4, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_multiset_row_pairs_and_digest_match(E, W, seed):
    rows = _rows(seed, (E, W))
    _eq(jfp.multiset_row_pairs(jnp.asarray(rows)), tfp.multiset_row_pairs(_t(rows)))
    rng = np.random.default_rng(seed + 10)
    for active in (np.zeros(E, bool), np.ones(E, bool), rng.random(E) < 0.5):
        _eq(jfp.multiset_digest(jnp.asarray(rows), jnp.asarray(active)),
            tfp.multiset_digest(_t(rows), torch.from_numpy(active)))


def test_multiset_digest_ignores_slot_order():
    rows = _rows(3, (24, 12))
    active = np.random.default_rng(3).random(24) < 0.6
    perm = np.random.default_rng(4).permutation(24)
    a = tfp.multiset_digest(_t(rows), torch.from_numpy(active))
    b = tfp.multiset_digest(_t(rows[perm]), torch.from_numpy(active[perm]))
    assert torch.equal(a, b)


def test_multiset_digest_batched_equals_per_row():
    rows = _rows(5, (7, 24, 12))
    active = np.random.default_rng(5).random((7, 24)) < 0.5
    batched = tfp.multiset_digest(_t(rows), torch.from_numpy(active))
    for i in range(7):
        _eq(jfp.multiset_digest(jnp.asarray(rows[i]), jnp.asarray(active[i])), batched[i])


@pytest.mark.parametrize("tags", [[0], [0, 1, 2, 3, 4, 5], [6], [7, 1 << 31, U32]])
def test_component_seeds_match(tags):
    _eq(jfp.component_seeds(jnp.asarray(np.array(tags, np.uint32))),
        tfp.component_seeds(tags))


@pytest.mark.parametrize("R,W", [(1, 4), (6, 36), (1, 34), (3, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hash_rows_match(R, W, seed):
    rows = _rows(seed, (R, W))
    tags = list(range(seed, seed + R))
    j = jfp.hash_rows(jnp.asarray(rows), jnp.asarray(np.array(tags, np.uint32)))
    _eq(j, tfp.hash_rows(_t(rows), tags))
    _eq(j, tfp.hash_rows(_t(rows), torch.tensor(tags)))
    # Leading lane axes hash each lane's rows independently.
    batched = tfp.hash_rows(_t(np.stack([rows, rows[::-1]])), tags)
    _eq(j, (batched[0][0], batched[1][0]))


@pytest.mark.parametrize("C", [1, 8, 9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairs_acc_finalize_and_combine_match(C, seed):
    his, los = _rows(seed, (C,)), _rows(seed + 7, (C,))
    _eq(jfp.pairs_acc(jnp.asarray(his), jnp.asarray(los)), tfp.pairs_acc(_t(his), _t(los)))
    acc = _rows(seed + 3, (4,))
    _eq(jfp.acc_finalize(jnp.asarray(acc), C), tfp.acc_finalize(_t(acc), C))
    _eq(jfp.combine_pairs(jnp.asarray(his), jnp.asarray(los)),
        tfp.combine_pairs(_t(his), _t(los)))


def test_fp64_pairs_match():
    hi, lo = _rows(0, (16,)), _rows(1, (16,))
    assert (tfp.fp64_pairs(hi, lo) == jfp.fp64_pairs(hi, lo)).all()
    assert (tfp.fp64_pairs(_t(hi), _t(lo)) == jfp.fp64_pairs(hi, lo)).all()


@pytest.fixture(scope="module")
def paxos22():
    """Every reachable state of paxos 2c/2s, packed by each package (the two
    host models enumerate them in the same order)."""
    from collections import deque

    def reach(model):
        init = model.init_states()
        seen, queue, out = set(init), deque(init), []
        while queue:
            s = queue.popleft()
            out.append(s)
            actions = []
            model.actions(s, actions)
            for a in actions:
                n = model.next_state(s, a)
                if n is not None and n not in seen:
                    seen.add(n)
                    queue.append(n)
        return out

    jm, tm = JaxPaxosModelCfg(2, 2).into_model(), PaxosModelCfg(2, 2).into_model()
    js = [jm.pack_state(s) for s in reach(jm)]
    states = {k: np.stack([np.asarray(p[k]) for p in js]) for k in js[0]}
    return jm, tm, states


def test_fingerprint_matches_on_reachable_paxos22(paxos22):
    jm, tm, states = paxos22
    assert states["rows"].shape[0] == 111
    jhi, jlo = jax.vmap(jm.packed_fingerprint)(states)
    thi, tlo = tm.packed_fingerprint(packed_states_from_numpy(states))
    _eq((jhi, jlo), (thi, tlo))


def test_comphash_keys_plain_twin_matches_jax(paxos22):
    """The twin of ``fw_comphash_keys`` on lanes of the reachable states:
    valid lanes carry JAX's fingerprint, masked, invalid and past-cap lanes
    the sentinel, and the lane index is each lane's own."""
    jm, tm, states = paxos22
    N = states["rows"].shape[0]
    A = 3  # three candidate lanes a frontier lane
    jhi, jlo = (np.asarray(x).astype(np.int64) for x in jax.vmap(jm.packed_fingerprint)(states))
    rng = np.random.default_rng(0)
    F = -(-N // A)
    cand = packed_states_from_numpy(states)
    cvalid = torch.from_numpy(rng.random(N) < 0.8)
    pad = F * A - N
    cand = {k: torch.cat([v, v[:pad]]) for k, v in cand.items()}
    cvalid = torch.cat([cvalid, torch.zeros(pad, dtype=torch.bool)])
    depth = torch.from_numpy(rng.integers(1, 6, size=F))
    mask = torch.from_numpy(rng.random(F) < 0.7)
    chi, clo = tm.packed_fingerprint(cand)
    key, idx = fw.keys_plain(chi, clo, cvalid, depth, 4, A, mask)
    lane = np.arange(F * A)
    want_valid = cvalid.numpy() & mask.numpy()[lane // A] & (depth.numpy()[lane // A] < 4)
    src = lane % N
    want = np.where(want_valid, (jhi[src] << 32) | jlo[src], -1)
    assert (key.numpy() == want).all()
    assert (idx.numpy() == lane).all()
    assert 0 < want_valid.sum() < F * A


def test_comphash_tables_hold_the_hash_constants():
    """``comphash_tables`` lays out the same ``lin_consts`` and seeds that
    ``hash_rows`` and ``multiset_row_pairs`` use, in the kernel's order."""
    model = PaxosModelCfg(3, 3, envelope_capacity=24).into_model()
    lay = model.packed_comphash_layout()
    assert (lay["N"], lay["R"], lay["E"], lay["W"], lay["H"]) == (6, 35, 24, 9, 34)
    consts = fw.comphash_tables(lay, "cpu")["consts"].numpy()
    R1, M, H, C = 36, 12, 34, 8
    want = [jfp._lin_consts(R1, 0x48AC1 + 2 * R1), jfp._lin_consts(R1, 0x5B3D5 + 7 * R1),
            jfp._lin_consts(M, 0x77A11 + 3 * M), jfp._lin_consts(M, 0x19D3F + 11 * M),
            jfp._lin_consts(4, 0x48AC1 + 8), jfp._lin_consts(4, 0x5B3D5 + 28),
            jfp._lin_consts(H, 0x48AC1 + 2 * H), jfp._lin_consts(H, 0x5B3D5 + 7 * H)]
    want += [np.asarray(x) for x in jfp.component_seeds(jnp.arange(C, dtype=jnp.uint32))]
    assert (consts == np.concatenate(want).astype(np.int64)).all()


def test_scheme_is_shared():
    assert tfp.FP_SCHEME == jfp.FP_SCHEME == "linhash/comphash-v6"


# -- ordered networks: one component per FIFO flow ----------------------------

ORDERED_LAYOUTS = {
    # raft with 3 servers: the identity layout, all 9 pairs, Q = 8, no history.
    "identity": (
        lambda: JaxRaftModelCfg(3, 1, network=JaxNetwork.new_ordered()),
        lambda: RaftModelCfg(3, 1, network=Network.new_ordered()),
        (3, 9, 8),
    ),
    # ABD with 3 clients and 2 servers: the 14 pairs of register_flow_pairs,
    # Q = 2, with the history (abd3o's layout).
    "flow_pairs": (
        lambda: JaxAbdModelCfg(3, 2, network=JaxNetwork.new_ordered(), envelope_capacity=12,
                               flow_capacity=2),
        lambda: AbdModelCfg(3, 2, network=Network.new_ordered(), envelope_capacity=12,
                            flow_capacity=2),
        (5, 14, 2),
    ),
}


def _random_ordered_states(model, n, seed):
    """Random packed states of an ordered ``model``'s layout: words at and
    above 2^31 everywhere, flow lengths from 0 to Q, the first state's
    flows all empty and the second's all full."""
    N, P, Q = model._N, model._P, model._Q
    W, R, H = model.codec.msg_width, model.codec.state_width, model.codec.history_width
    rng = np.random.default_rng(seed)
    states = {
        "rows": _rows(seed, (n, N, R)),
        "timers": _rows(seed + 1, (n, N)),
        "flow_msg": _rows(seed + 2, (n, P, Q, W)),
        "flow_len": rng.integers(0, Q + 1, size=(n, P)).astype(np.uint32),
    }
    states["flow_len"][0] = 0
    states["flow_len"][1] = Q
    if H:
        states["hist"] = _rows(seed + 3, (n, H))
    return states


@pytest.mark.parametrize("layout", list(ORDERED_LAYOUTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_component_pairs_match(layout, seed):
    """Each flow is one component (queue ‖ length, tags N..N+P-1), the
    history takes tag N + P: the pairs and the combined fingerprint equal
    JAX's ``combine_pairs(*packed_component_pairs(s))`` bit for bit."""
    make_jax, make_port, (N, P, Q) = ORDERED_LAYOUTS[layout]
    jm, tm = make_jax().into_model(), make_port().into_model()
    assert (tm._N, tm._P, tm._Q) == (N, P, Q)
    states = _random_ordered_states(tm, 40, seed)
    jhis, jlos = jax.vmap(jm.packed_component_pairs)(states)
    this, tlos = tm.packed_component_pairs(packed_states_from_numpy(states))
    C = N + P + (1 if tm.codec.history_width else 0)
    assert tuple(this.shape) == (40, C)
    _eq((jhis, jlos), (this, tlos))
    want = jax.vmap(lambda h, l: jfp.combine_pairs(h, l))(jhis, jlos)
    _eq(want, tm.packed_fingerprint(packed_states_from_numpy(states)))
    _eq(jax.vmap(jm.packed_fingerprint)(states),
        tm.packed_fingerprint(packed_states_from_numpy(states)))


def test_ordered_comphash_tables_hold_the_hash_constants():
    """abd3o's layout: actor row ‖ timer, the flow row (Q·W + 1 words), the
    history, then the seeds of tags 0..N+P."""
    _make_jax, make_port, _ = ORDERED_LAYOUTS["flow_pairs"]
    model = make_port().into_model()
    lay = model.packed_comphash_layout()
    N, R, P, Q, W, H = (lay[k] for k in ("N", "R", "P", "Q", "W", "H"))
    assert (N, R, P, Q, W, lay["E"]) == (5, 17, 14, 2, 5, 0) and H > 0
    consts = fw.comphash_tables(lay, "cpu")["consts"].numpy()
    want = []
    for width in (R + 1, Q * W + 1, H):
        want += [jfp._lin_consts(width, 0x48AC1 + 2 * width),
                 jfp._lin_consts(width, 0x5B3D5 + 7 * width)]
    want += [np.asarray(x) for x in
             jfp.component_seeds(jnp.arange(N + P + 1, dtype=jnp.uint32))]
    assert (consts == np.concatenate(want).astype(np.int64)).all()


def test_comphash_keys_stage_refuses_missing_flow_leaves():
    """An ordered layout that reaches the kernel without its flow leaves
    raises before any launch; it does not fall back."""
    _make_jax, make_port, _ = ORDERED_LAYOUTS["flow_pairs"]
    model = make_port().into_model()
    tables = fw.comphash_tables(model.packed_comphash_layout(), "cpu")
    cand = {k: v.repeat(4, *([1] * (v.dim() - 1)))
            for k, v in model.packed_init_states().items()}
    cvalid = torch.ones(4, dtype=torch.bool)
    launches = fw.comphash_launches
    for drop in ("flow_msg", "flow_len"):
        partial = {k: v for k, v in cand.items() if k != drop}
        with pytest.raises(ValueError, match=drop):
            fw.comphash_keys_stage(tables, partial, cvalid)
    with pytest.raises(ValueError, match="flow_len"):
        fw.comphash_keys_stage(tables, dict(cand, flow_len=cand["flow_len"][:, :3]), cvalid)
    assert fw.comphash_launches == launches
