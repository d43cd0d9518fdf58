"""The port's actor path against the JAX package's.

The packed actor model (``actor/packed.py``), the register-protocol helpers
(``actor/packed_register.py``), the packed linearizability predicate
(``semantics/packed_linearizability.py``) and the paxos and single-copy
register codecs: on every reachable state of paxos with 2 clients and 2
servers and with 1 client and 3 servers, the packed arrays, the
``unpack_state`` round trips, ``packed_expand`` (candidates on the valid
lanes and the valid bits), ``packed_within_boundary`` and
``packed_conditions`` equal the JAX package's; the predicate equals JAX's
on random packed histories, linearizable or not.

Then whole checks: the port's host ``spawn_bfs`` and its
``spawn_gpu_bfs(device="cpu")`` with both wave engines, wave at a time and
drained, against the JAX package's ``spawn_bfs`` and
``spawn_tpu_bfs(hashset_impl="xla", wave_dedup="sort", expand_fps=False)``
at the same settings, the port's staged engine with its default (the
fingerprint-only wave) and with ``expand_fps=False``, and the port's
default staged engine against the JAX checker with its default
(``expand_fps`` on for both): unique and
generated counts, max depth, discoveries, the ``encode()`` of each
discovery path and the golden reporter lines. ``SingleCopyModelCfg(2, 2)``
is not linearizable, so its ``always`` counterexample path is replayed
through the host model on both sides.
"""

import io
import re
from collections import deque

import jax
import numpy as np
import pytest
import torch

from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosModelCfg
from stateright_tpu.actor.network import Network as JaxNetwork
from stateright_tpu.models.single_copy_register import (
    SingleCopyModelCfg as JaxSingleCopyModelCfg,
)
from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu.semantics.packed_linearizability import (
    PackedRegisterLinearizability as JaxLin,
)
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.actor.network import Network
from stateright_tpu_torch.actor.packed import PackedActorModel
from stateright_tpu_torch.interop import packed_states_from_numpy
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg


def _reach(model):
    """Every reachable host state, breadth first (both packages' host models
    enumerate them in the same order)."""
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


STATE_CASES = {
    "paxos_2c2s": (lambda: JaxPaxosModelCfg(2, 2), lambda: PaxosModelCfg(2, 2), 111),
    "paxos_1c3s": (lambda: JaxPaxosModelCfg(1, 3), lambda: PaxosModelCfg(1, 3), 265),
    # A duplicating network: delivered envelopes stay, sends dedup.
    "paxos_2c2s_dup": (
        lambda: JaxPaxosModelCfg(2, 2, network=JaxNetwork.new_unordered_duplicating(),
                                 envelope_capacity=24),
        lambda: PaxosModelCfg(2, 2, network=Network.new_unordered_duplicating(),
                              envelope_capacity=24),
        111,
    ),
}


@pytest.fixture(scope="module", params=list(STATE_CASES), ids=list(STATE_CASES))
def reachable(request):
    make_jax, make_port, n = STATE_CASES[request.param]
    jm, tm = make_jax().into_model(), make_port().into_model()
    jhost, thost = _reach(jm), _reach(tm)
    assert len(jhost) == len(thost) == n
    jp = [jm.pack_state(s) for s in jhost]
    jstates = {k: np.stack([np.asarray(p[k]) for p in jp]) for k in jp[0]}
    return jm, tm, jstates, thost


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.int64)


def test_packed_states_match(reachable):
    jm, tm, jstates, thost = reachable
    tp = [tm.pack_state(s) for s in thost]
    assert set(tp[0]) == set(jstates)
    for k, v in jstates.items():
        assert (np.stack([p[k].numpy() for p in tp]) == v.astype(np.int64)).all(), k
    init = tm.packed_init_states()
    jinit = jm.packed_init_states()
    for k in jinit:
        assert (init[k].numpy() == np.asarray(jinit[k]).astype(np.int64)).all(), k


def test_unpack_round_trips(reachable):
    _jm, tm, jstates, thost = reachable
    states = packed_states_from_numpy(jstates)
    for i, s in enumerate(thost):
        assert tm.unpack_state({k: v[i] for k, v in states.items()}) == s


def test_packed_expand_matches(reachable):
    jm, tm, jstates, _thost = reachable
    jcand, jvalid = jax.jit(jax.vmap(jm.packed_expand))(jstates)
    tcand, tvalid = tm.packed_expand(packed_states_from_numpy(jstates))
    jvalid = np.asarray(jvalid)
    assert tm.packed_action_count() == jm.packed_action_count() == jvalid.shape[1]
    assert (tvalid.numpy() == jvalid).all()
    assert 0 < jvalid.sum() < jvalid.size
    assert set(tcand) == set(jcand)
    for k in jcand:
        assert tuple(tcand[k].shape) == tuple(np.asarray(jcand[k]).shape), k
        assert (tcand[k].numpy()[jvalid] == _np(jcand[k])[jvalid]).all(), k


def test_boundary_and_conditions_match(reachable):
    jm, tm, jstates, _thost = reachable
    states = packed_states_from_numpy(jstates)
    jb = np.asarray(jax.vmap(jm.packed_within_boundary)(jstates))
    assert (tm.packed_within_boundary(states).numpy() == jb).all()
    jconds, tconds = jm.packed_conditions(), tm.packed_conditions()
    assert len(jconds) == len(tconds) == 2
    for jc, tc in zip(jconds, tconds):
        want = np.asarray(jax.vmap(jc)(jstates))
        assert (tc(states).numpy() == want).all()


def test_fingerprint_view_matches(reachable):
    jm, tm, jstates, _thost = reachable
    jview = jax.vmap(jm.packed_fingerprint_view)(jstates)
    tview = tm.packed_fingerprint_view(packed_states_from_numpy(jstates))
    assert set(tview) == set(jview)
    for k in jview:
        assert (tview[k].numpy() == _np(jview[k])).all(), k


def _random_histories(lin, n, seed):
    """Random packed histories of ``lin``'s layout: valid bits, counts,
    op kinds and values, and real-time constraints drawn so that many are
    linearizable and many are not."""
    rng = np.random.default_rng(seed)
    C, O = lin.C, lin.O
    out = np.zeros((n, lin.width), np.uint32)
    out[:, 0] = rng.random(n) < 0.9
    body = out[:, 1:].reshape(n, C, lin.TW)
    body[:, :, 0] = rng.integers(0, O + 1, size=(n, C))
    slots = body[:, :, 1:].reshape(n, C, O, 2 + C)
    slots[:, :, :, 0] = rng.integers(0, 3, size=(n, C, O))
    slots[:, :, :, 1] = rng.choice([0, ord("A"), ord("B"), ord("C")], size=(n, C, O))
    slots[:, :, :, 2:] = rng.integers(0, O + 1, size=(n, C, O, C)) * (
        rng.random((n, C, O, C)) < 0.4
    )
    body[:, :, 1:] = slots.reshape(n, C, -1)
    out[:, 1:] = body.reshape(n, -1)
    return out


@pytest.mark.parametrize("clients,ops", [(2, 2), (3, 2), (2, 3)])
@pytest.mark.parametrize("real_time", [True, False])
def test_linearizability_predicate_matches(clients, ops, real_time):
    from stateright_tpu_torch.semantics.packed_linearizability import (
        PackedRegisterLinearizability,
    )

    threads = range(3, 3 + clients)
    jl = JaxLin(threads, ops, "\x00")
    tl = PackedRegisterLinearizability(threads, ops, "\x00")
    assert tl.width == jl.width
    hists = _random_histories(jl, 400, clients * 10 + ops)
    th = torch.from_numpy(hists.astype(np.int64))
    want = np.asarray(jax.vmap(jl.predicate(real_time))(hists))
    got = tl.predicate(real_time)(th).numpy()
    assert (got == want).all()
    assert 0 < want.sum() < want.size  # linearizable and not
    lanes = np.asarray(jax.vmap(jl.predicate_lanes(real_time))(hists))
    assert (tl.predicate_lanes(real_time)(th).numpy() == lanes).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_history_hooks_match(seed):
    """``on_invoke`` and ``on_return`` on random histories, threads, values
    and active bits, lane for lane."""
    from stateright_tpu_torch.semantics.packed_linearizability import (
        PackedRegisterLinearizability,
    )

    jl = JaxLin(range(3, 6), 2, "\x00")
    tl = PackedRegisterLinearizability(range(3, 6), 2, "\x00")
    hists = _random_histories(jl, 300, seed)
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, size=300).astype(np.int32)
    kind = rng.integers(1, 3, size=300).astype(np.uint32)
    value = rng.choice([0, 65, 66], size=300).astype(np.uint32)
    active = rng.random(300) < 0.8
    t = lambda x: torch.from_numpy(np.asarray(x).astype(np.int64))  # noqa: E731
    want = np.asarray(jax.vmap(jl.on_invoke)(hists, c, kind, value, active))
    got = tl.on_invoke(t(hists), t(c), t(kind), t(value), torch.from_numpy(active))
    assert (got.numpy() == want.astype(np.int64)).all()
    want = np.asarray(jax.vmap(jl.on_return)(hists, c, value, active))
    got = tl.on_return(t(hists), t(c), t(value), torch.from_numpy(active))
    assert (got.numpy() == want.astype(np.int64)).all()


def test_packed_side_refuses_what_is_not_ported():
    """Symmetry is refused by name; lossy, ordered and crash configurations
    pack and expand."""
    from stateright_tpu_torch.actor.network import Network

    model = PaxosModelCfg(2, 2).into_model()
    with pytest.raises(ValueError, match="Queue 1 #6"):
        model.packed_symmetry()
    assert isinstance(model, PackedActorModel)
    lossy = PaxosModelCfg(2, 2).into_model().lossy_network(True)
    ordered = SingleCopyModelCfg(2, 1, network=Network.new_ordered()).into_model()
    crashes = PaxosModelCfg(2, 2).into_model().max_crashes(1)
    E = 16  # PaxosModelCfg's envelope_capacity
    for m, A, leaf in ((lossy, 2 * E, "net_cnt"), (ordered, ordered._P, "flow_len"),
                       (crashes, E + 4, "crashed")):
        states = m.packed_init_states()
        assert leaf in states
        cand, valid = m.packed_expand(states)
        assert m.packed_action_count() == A
        assert tuple(valid.shape) == (1, A) and valid.any()
        assert set(cand) == set(states)


# -- whole checks ------------------------------------------------------------------

# (JAX model, port model, host state count, discoveries). A run stops
# once every property has a discovery: the host oracle at that state, the
# device checker at the end of that wave, so the counts of the cases that
# are not linearizable differ between the two.
LINEARIZABLE = {"value chosen"}
NOT_LINEARIZABLE = {"linearizable", "value chosen"}
class _Lossy:
    """A configuration whose model runs on a lossy network."""

    def __init__(self, cfg):
        self.cfg = cfg

    def into_model(self):
        return self.cfg.into_model().lossy_network(True)


RUN_CASES = {
    "paxos_2c2s": (lambda: JaxPaxosModelCfg(2, 2), lambda: PaxosModelCfg(2, 2), 111,
                   LINEARIZABLE),
    # A lossy network: the drop class after the deliver class.
    "paxos_2c2s_lossy": (lambda: _Lossy(JaxPaxosModelCfg(2, 2)),
                         lambda: _Lossy(PaxosModelCfg(2, 2)), 488, LINEARIZABLE),
    # FIFO flows on the register_flow_pairs subset.
    "single_copy_2c1s_ordered": (
        lambda: JaxSingleCopyModelCfg(2, 1, network=JaxNetwork.new_ordered()),
        lambda: SingleCopyModelCfg(2, 1, network=Network.new_ordered()),
        93,
        LINEARIZABLE,
    ),
    "paxos_1c3s": (lambda: JaxPaxosModelCfg(1, 3), lambda: PaxosModelCfg(1, 3), 265,
                   LINEARIZABLE),
    "single_copy_2c1s": (lambda: JaxSingleCopyModelCfg(2, 1),
                         lambda: SingleCopyModelCfg(2, 1), 93, LINEARIZABLE),
    "single_copy_2c2s": (lambda: JaxSingleCopyModelCfg(2, 2),
                         lambda: SingleCopyModelCfg(2, 2), 26, NOT_LINEARIZABLE),
    # A duplicating network, where a redelivered Put can undo a later
    # write.
    "single_copy_2c1s_dup": (
        lambda: JaxSingleCopyModelCfg(2, 1, network=JaxNetwork.new_unordered_duplicating(),
                                      envelope_capacity=24),
        lambda: SingleCopyModelCfg(2, 1, network=Network.new_unordered_duplicating(),
                                   envelope_capacity=24),
        311,
        NOT_LINEARIZABLE,
    ),
}
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}
SPAWN = dict(frontier_capacity=64, table_capacity=4096)


@pytest.fixture(scope="module", params=list(RUN_CASES), ids=list(RUN_CASES))
def runs(request):
    make_jax, make_port, n, found = RUN_CASES[request.param]
    out = {"expected": n, "found": found}
    out["jax_host"] = make_jax().into_model().checker().spawn_bfs().join()
    out["host"] = make_port().into_model().checker().spawn_bfs().join()
    for mode, options in MODES.items():
        out[("jax", mode)] = make_jax().into_model().checker().spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", expand_fps=False, **SPAWN, **options
        ).join()
        out[("jax_fps", mode)] = make_jax().into_model().checker().spawn_tpu_bfs(
            hashset_impl="xla", wave_dedup="sort", **SPAWN, **options
        ).join()
        for engine in ("staged", "fused"):
            out[(engine, mode)] = make_port().into_model().checker().spawn_gpu_bfs(
                device="cpu", wave_kernel=engine, **SPAWN, **options
            ).join()
        out[("staged_materialize", mode)] = make_port().into_model().checker().spawn_gpu_bfs(
            device="cpu", expand_fps=False, **SPAWN, **options
        ).join()
    return out


def _golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


def _same_run(port, ref, port_reporter, ref_reporter):
    assert port.worker_error() is None
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    pd, rd = port.discoveries(), ref.discoveries()
    assert set(pd) == set(rd)
    for name in rd:
        assert pd[name].encode() == rd[name].encode(), name
    assert _golden(port, port_reporter) == _golden(ref, ref_reporter)


def test_host_oracle_matches_jax_host(runs):
    _same_run(runs["host"], runs["jax_host"], WriteReporter, JaxWriteReporter)


# The port's run and the JAX run it is held to: the JAX checker with
# expand_fps off, or (staged_vs_jax_fps) with its default, fps on.
ENGINES = {"staged": ("staged", "jax"), "fused": ("fused", "jax"),
           "staged_materialize": ("staged_materialize", "jax"),
           "staged_vs_jax_fps": ("staged", "jax_fps")}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("mode", list(MODES))
def test_gpu_checker_matches_jax(runs, engine, mode):
    port_key, jax_key = ENGINES[engine]
    port, ref = runs[(port_key, mode)], runs[(jax_key, mode)]
    assert port.keys_route == "comphash"
    assert port._use_fps is (port_key == "staged")
    assert ref._use_fps is (jax_key == "jax_fps")
    _same_run(port, ref, WriteReporter, JaxWriteReporter)
    if mode == "drain":
        assert port.drains > 0


def test_counts_and_verdicts(runs):
    assert runs["host"].unique_state_count() == runs["expected"]
    for key in (("fused", "drain"), ("staged", "wave"), "host"):
        assert set(runs[key].discoveries()) == runs["found"]
    if "linearizable" in runs["found"]:
        # The counterexample path ends in a history with no serialization.
        path = runs[("fused", "drain")].discoveries()["linearizable"]
        assert path.last_state().history.serialized_history() is None
        with pytest.raises(AssertionError):
            runs[("staged", "wave")].assert_properties()
    else:
        runs[("fused", "drain")].assert_properties()
        runs[("staged", "wave")].assert_properties()


def test_paxos_2c3s_drain_matches_jax():
    """Paxos with 2 clients and 3 servers (16,668 states, the reference's
    bench size) through the drain on both engines, against the JAX drain at
    the same settings, and through the port's host oracle."""
    spawn = dict(frontier_capacity=1024, table_capacity=1 << 15)
    jc = JaxPaxosModelCfg(2, 3).into_model().checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", expand_fps=False, **spawn
    ).join()
    assert jc.unique_state_count() == 16_668
    for engine in ("staged", "fused"):
        port = PaxosModelCfg(2, 3).into_model().checker().spawn_gpu_bfs(
            device="cpu", wave_kernel=engine, **spawn
        ).join()
        assert port.drains > 0
        _same_run(port, jc, WriteReporter, JaxWriteReporter)
    host = PaxosModelCfg(2, 3).into_model().checker().spawn_bfs().join()
    assert host.unique_state_count() == 16_668
    assert host.state_count() == jc.state_count()
