"""The port's ordered networks (FIFO flows) against the JAX package's.

``PackedActorModel`` over an ordered network keeps one FIFO queue per
directed flow (``flow_msg``, ``flow_len``; the head at index 0), on the
identity flow layout (all ``N²`` pairs) or a ``with_flow_pairs`` subset.
On every reachable state of ABD with 2 clients and 2 servers over ordered
flows (the ``register_flow_pairs`` subset), of the single-copy register
with 2 clients and 1 server over ordered flows, and of raft with 3 servers
over ordered flows seeded with two messages (the identity layout and a
non-empty initial network), the packed arrays, the ``unpack_state`` round
trips, ``packed_expand`` (candidates on the valid lanes and the valid bits),
``packed_within_boundary``, ``packed_conditions``, the fingerprint view
and the component-hash fingerprints equal the JAX package's.

Then whole checks of ABD (``models/linearizable_register.py``): 2 clients
and 2 servers over ordered flows (620 states) against the JAX device
checker wave at a time and drained, and on an unordered network (544)
against the JAX host checker and its count.
"""

import pytest

from stateright_tpu.actor.network import Envelope as JaxEnvelope
from stateright_tpu.actor.network import Network as JaxNetwork
from stateright_tpu.actor import packed_register as jpr
from stateright_tpu.models.linearizable_register import AbdModelCfg as JaxAbdModelCfg
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.models.single_copy_register import (
    SingleCopyModelCfg as JaxSingleCopyModelCfg,
)
from stateright_tpu_torch.actor import packed_register as pr
from stateright_tpu_torch.actor.network import Envelope, Network
from stateright_tpu_torch.models.linearizable_register import AbdModelCfg
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg

import torch_actor_parity as tp


def _seeded(network_cls, envelope_cls):
    return network_cls.new_ordered([
        envelope_cls(src=0, dst=1, msg=("RequestVote", 1)),
        envelope_cls(src=2, dst=1, msg=("RequestVote", 1)),
    ])


STATE_CASES = {
    "abd_2c2s_ordered": (
        lambda: JaxAbdModelCfg(2, 2, network=JaxNetwork.new_ordered()),
        lambda: AbdModelCfg(2, 2, network=Network.new_ordered()),
        620,
    ),
    "single_copy_2c1s_ordered": (
        lambda: JaxSingleCopyModelCfg(2, 1, network=JaxNetwork.new_ordered()),
        lambda: SingleCopyModelCfg(2, 1, network=Network.new_ordered()),
        None,
    ),
    # The identity flow layout (all 9 pairs) and a non-empty initial network.
    "raft3_ordered_seeded": (
        lambda: JaxRaftModelCfg(3, 1, lossy=False,
                                network=_seeded(JaxNetwork, JaxEnvelope)),
        lambda: RaftModelCfg(3, 1, lossy=False, network=_seeded(Network, Envelope)),
        None,
    ),
}


@pytest.fixture(scope="module", params=list(STATE_CASES), ids=list(STATE_CASES))
def reachable(request):
    make_jax, make_port, n = STATE_CASES[request.param]
    if n is None:
        n = len(tp.reach(make_jax().into_model()))
    return tp.reachable_case(make_jax, make_port, n)


def test_packed_states_match(reachable):
    jm, tm, jstates, thost = reachable
    assert tm._ordered and "flow_msg" in jstates and "net_cnt" not in jstates
    tp.check_packed_states(jm, tm, jstates, thost)


def test_unpack_round_trips(reachable):
    _jm, tm, jstates, thost = reachable
    tp.check_unpack_round_trips(tm, jstates, thost)


def test_packed_expand_matches(reachable):
    jm, tm, jstates, _thost = reachable
    # Deliver from each flow head, then raft's timeouts.
    assert tm.packed_action_count() == tm._P + tm._N * tm._T
    tp.check_expand(jm, tm, jstates)


def test_boundary_and_conditions_match(reachable):
    jm, tm, jstates, _thost = reachable
    tp.check_boundary_and_conditions(jm, tm, jstates)


def test_fingerprints_match(reachable):
    jm, tm, jstates, _thost = reachable
    tp.check_fingerprints(jm, tm, jstates)


def test_flow_layouts_match():
    for clients, servers in ((2, 2), (3, 2), (2, 3)):
        assert pr.register_flow_pairs(clients, servers) == jpr.register_flow_pairs(
            clients, servers)
    model = AbdModelCfg(3, 2, network=Network.new_ordered(), envelope_capacity=12,
                        flow_capacity=2).into_model()
    jmodel = JaxAbdModelCfg(3, 2, network=JaxNetwork.new_ordered(), envelope_capacity=12,
                            flow_capacity=2).into_model()
    assert (model._P, model._Q) == (jmodel._P, jmodel._Q) == (14, 2)
    for a, b in zip(model._pair_tables(), jmodel._pair_tables()):
        assert (a == b).all()
    lay = model.packed_comphash_layout()
    assert (lay["ordered"], lay["P"], lay["Q"], lay["E"], lay["history_tag"]) == (
        True, 14, 2, 0, 5 + 14)
    assert model.packed_action_count() == 14


def test_sends_outside_the_flows_and_past_capacity_prune():
    """A send to a pair outside ``flow_pairs``, or onto a full flow,
    overflows: the lane is pruned, not written."""
    import torch

    model = AbdModelCfg(2, 2, network=Network.new_ordered()).into_model()
    states = model.packed_init_states()
    st = {k: v.repeat(3, *([1] * (v.dim() - 1))) for k, v in states.items()}
    src = torch.tensor([2, 2, 0])
    dst = torch.tensor([3, 0, 1])  # client->client is outside the flows
    msg = torch.ones(3, model.codec.msg_width, dtype=torch.int64)
    active = torch.tensor([True, True, True])
    out, ov = model._net_send(st, src, dst, msg, active)
    assert ov.tolist() == [True, False, False]
    assert (out["flow_len"][0] == st["flow_len"][0]).all()
    full = dict(st)
    full["flow_len"] = torch.full_like(st["flow_len"], model._Q)
    _out, ov = model._net_send(full, src, dst, msg, active)
    assert ov.tolist() == [True, True, True]


RUN_CASES = {
    # (JAX cfg, port cfg, count, held to the JAX device checker)
    "abd_2c2s_ordered": (
        lambda: JaxAbdModelCfg(2, 2, network=JaxNetwork.new_ordered()),
        lambda: AbdModelCfg(2, 2, network=Network.new_ordered()),
        620,
        True,
    ),
    "abd_2c2s": (lambda: JaxAbdModelCfg(2, 2), lambda: AbdModelCfg(2, 2), 544, False),
}


@pytest.fixture(scope="module", params=list(RUN_CASES), ids=list(RUN_CASES))
def runs(request):
    make_jax, make_port, n, against_device = RUN_CASES[request.param]
    out = tp.run_case(make_jax, make_port, against_device)
    out["expected"] = n
    return out


def test_host_oracle_matches_jax_host(runs):
    tp.same_run(runs["host"], runs["jax_host"])
    assert runs["host"].unique_state_count() == runs["expected"]


@pytest.mark.parametrize("engine", ["staged", "fused"])
@pytest.mark.parametrize("mode", list(tp.MODES))
def test_gpu_checker_matches_jax(runs, engine, mode):
    tp.check_run(runs, engine, mode)
    port = runs[(engine, mode)]
    assert port.unique_state_count() == runs["expected"]
    assert set(port.discoveries()) == {"value chosen"}
    port.assert_properties()
