"""The port's timers, lossy networks and crash faults against the JAX
package's, on raft (``models/raft.py``).

Raft drives the three action classes that follow deliver: drop (a lossy
network: a duplicating one zeroes the slot, a counting one decrements it),
timeout (``on_timeout_branches``, the fired timer cleared before the
callback's timer commands, "renews only" pruned) and crash (the ``crashed``
leaf, left out of the fingerprint; timers cleared; delivery to a crashed
actor masked). On every reachable state of raft with 3 servers on a lossy
non-duplicating network, a lossy duplicating one, and a lossy one with
``max_crashes=1``, the packed arrays, the round trips, ``packed_expand``
lane for lane, the boundary (and its per-row form), the conditions, the
fingerprint view and the fingerprints equal the JAX package's.

Then whole checks, against the JAX package's counts: lossless duplicating
53 (depth 6), lossy duplicating 2,717, lossy 665, ordered lossless 341 and
lossy with one crash 2,252 — the last against the JAX device checker wave
at a time and drained, on both engines; the others against the JAX host
checker. Then the shape of the time-to-counterexample run: only ``stable
leader`` kept, so the check ends at the wave of its discovery, against the
JAX device checker in both modes (the count at the exit, paths, golden
lines). Every run discovers ``stable leader``, and its path ends in a
state with no live leader and no enabled action within the boundary.
"""

import jax
import numpy as np
import pytest

from stateright_tpu.actor.network import Network as JaxNetwork
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu_torch.actor.network import Network
from stateright_tpu_torch.interop import packed_states_from_numpy
from stateright_tpu_torch.models.raft import LEADER, RaftModelCfg

import torch_actor_parity as tp


def _cfgs(network, **kw):
    """(JAX cfg, port cfg) makers of raft with 3 servers and ``max_term=1``
    on ``network`` (``None``: the default non-duplicating network)."""
    def jax_cfg():
        net = {} if network is None else {"network": getattr(JaxNetwork, network)()}
        return JaxRaftModelCfg(3, 1, **net, **kw)

    def port_cfg():
        net = {} if network is None else {"network": getattr(Network, network)()}
        return RaftModelCfg(3, 1, **net, **kw)

    return jax_cfg, port_cfg


STATE_CASES = {
    "raft3_lossy": (*_cfgs(None, lossy=True), 665),
    "raft3_lossy_dup": (*_cfgs("new_unordered_duplicating", lossy=True), 2717),
    "raft3_lossy_crash": (*_cfgs(None, lossy=True, max_crashes=1), 2252),
}


@pytest.fixture(scope="module", params=list(STATE_CASES), ids=list(STATE_CASES))
def reachable(request):
    return tp.reachable_case(*STATE_CASES[request.param])


def test_packed_states_match(reachable):
    jm, tm, jstates, thost = reachable
    assert ("crashed" in jstates) == bool(tm._max_crashes)
    tp.check_packed_states(jm, tm, jstates, thost)


def test_unpack_round_trips(reachable):
    _jm, tm, jstates, thost = reachable
    tp.check_unpack_round_trips(tm, jstates, thost)


def test_packed_expand_matches(reachable):
    """Deliver, drop, timeout and (with crashes) crash lanes, in the JAX
    package's action-id order; each class has valid lanes."""
    jm, tm, jstates, _thost = reachable
    D, N = tm._E, tm._N
    assert tm.packed_action_count() == 2 * D + N + (N if tm._max_crashes else 0)
    jvalid = tp.check_expand(jm, tm, jstates)
    for lo, hi in ((0, D), (D, 2 * D), (2 * D, 2 * D + N), (2 * D + N, jvalid.shape[1])):
        if hi > lo:
            assert jvalid[:, lo:hi].any(), (lo, hi)


def test_boundary_and_conditions_match(reachable):
    jm, tm, jstates, _thost = reachable
    tp.check_boundary_and_conditions(jm, tm, jstates)
    # The per-row form of the boundary, on every row, and past the term cap.
    rows = jstates["rows"].reshape(-1, tm.codec.state_width).copy()
    rows[::7, 1] = 2
    want = np.asarray(jax.vmap(lambda r: jm.codec.packed_row_within_boundary(jm, r))(rows))
    got = tm.codec.packed_row_within_boundary(tm, packed_states_from_numpy({"r": rows})["r"])
    assert (got.numpy() == want).all() and not want.all()


def test_fingerprints_match(reachable):
    jm, tm, jstates, _thost = reachable
    tp.check_fingerprints(jm, tm, jstates)
    if tm._max_crashes:
        assert "crashed" not in tm.packed_fingerprint_view(packed_states_from_numpy(jstates))


class _Retain:
    """A configuration whose model keeps only the named properties."""

    def __init__(self, cfg, *names):
        self.cfg, self.names = cfg, names

    def into_model(self):
        return self.cfg.into_model().retain_properties(*self.names)


def _stable_leader_only():
    make_jax, make_port = _cfgs(None, lossy=True)
    return (lambda: _Retain(make_jax(), "stable leader"),
            lambda: _Retain(make_port(), "stable leader"))


BOTH = {"leader elected", "stable leader"}
RUN_CASES = {
    # (JAX cfg, port cfg, count (None: the run stops at its discovery),
    # depth or None, held to the JAX device checker, discoveries)
    "raft3_dup": (*_cfgs("new_unordered_duplicating", lossy=False), 53, 6, False, BOTH),
    "raft3_lossy_dup": (*_cfgs("new_unordered_duplicating", lossy=True), 2717, None, False,
                        BOTH),
    "raft3_lossy": (*_cfgs(None, lossy=True), 665, None, False, BOTH),
    "raft3_ordered": (*_cfgs("new_ordered", lossy=False), 341, None, False, BOTH),
    "raft3_lossy_crash": (*_cfgs(None, lossy=True, max_crashes=1), 2252, None, True, BOTH),
    # The time-to-counterexample run's shape (raft5 in chip_smoke.py): the
    # check ends at the wave of the discovery, so the count at the exit
    # depends on wave boundaries and is held to the JAX device checker.
    "raft3_stable_leader_only": (*_stable_leader_only(), None, None, True,
                                 {"stable leader"}),
}


@pytest.fixture(scope="module", params=list(RUN_CASES), ids=list(RUN_CASES))
def runs(request):
    make_jax, make_port, n, depth, against_device, found = RUN_CASES[request.param]
    out = tp.run_case(make_jax, make_port, against_device)
    out.update(expected=n, depth=depth, found=found, model=make_port().into_model())
    return out


def test_host_oracle_matches_jax_host(runs):
    tp.same_run(runs["host"], runs["jax_host"])
    if runs["expected"] is not None:
        assert runs["host"].unique_state_count() == runs["expected"]
    if runs["depth"] is not None:
        assert runs["host"].max_depth() == runs["depth"]


def _stuck_without_leader(model, path):
    """The eventually counterexample: the last state has no live leader and
    no action leads to a state within the boundary."""
    s = path.last_state()
    assert not any(a.role == LEADER and not c for a, c in zip(s.actor_states, s.crashed))
    actions = []
    model.actions(s, actions)
    for a in actions:
        n = model.next_state(s, a)
        assert n is None or not model.within_boundary(n)


@pytest.mark.parametrize("engine", ["staged", "fused"])
@pytest.mark.parametrize("mode", list(tp.MODES))
def test_gpu_checker_matches_jax(runs, engine, mode):
    tp.check_run(runs, engine, mode)
    port = runs[(engine, mode)]
    if runs["expected"] is not None:
        assert port.unique_state_count() == runs["expected"]
    assert set(port.discoveries()) == runs["found"]
    _stuck_without_leader(runs["model"], port.discoveries()["stable leader"])
