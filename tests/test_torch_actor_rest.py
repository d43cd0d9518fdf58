"""The rest of the port's actor layer against the JAX package's: the
ordered reliable link, the write-once register (spec and client), the
timers example (``PingerModelCfg``), the JSON wire codec, and the UDP
runtime (``actor/spawn.py``) exchanging messages on loopback."""

import socket
import threading
from dataclasses import dataclass
from typing import Tuple

import pytest

from stateright_tpu.actor import Actor as JaxActor
from stateright_tpu.actor import ActorModel as JaxActorModel
from stateright_tpu.actor import Network as JaxNetwork
from stateright_tpu.actor import ordered_reliable_link as jax_orl
from stateright_tpu.actor import wire as jax_wire
from stateright_tpu.actor import write_once_register as jax_wor
from stateright_tpu.core.model import Expectation as JaxExpectation
from stateright_tpu.models.timers import PingerModelCfg as JaxPingerModelCfg
from stateright_tpu.semantics import LinearizabilityTester as JaxLinearizabilityTester
from stateright_tpu.semantics import WORegister as JaxWORegister
from stateright_tpu_torch.actor import Actor, ActorModel, Id, Network, Out
from stateright_tpu_torch.actor import ordered_reliable_link as orl
from stateright_tpu_torch.actor import wire
from stateright_tpu_torch.actor import write_once_register as wor
from stateright_tpu_torch.actor.register import Put, PutOk
from stateright_tpu_torch.actor.spawn import spawn
from stateright_tpu_torch.core.fingerprint import fingerprint
from stateright_tpu_torch.core.model import Expectation
from stateright_tpu_torch.models.timers import PingerModelCfg
from stateright_tpu_torch.semantics import (
    WO_READ,
    WO_WRITE_FAIL,
    WO_WRITE_OK,
    LinearizabilityTester,
    WORegister,
    WoReadOk,
    WoWrite,
)


def _same_check(port, ref):
    assert port.unique_state_count() == ref.unique_state_count() > 0
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    pd, rd = port.discoveries(), ref.discoveries()
    assert set(pd) == set(rd)
    for name in rd:
        assert [fingerprint(s) for s in pd[name].into_states()] == [
            fingerprint(s) for s in rd[name].into_states()], name


# -- the ordered reliable link ----------------------------------------------------


def _orl_model(actor_cls, model_cls, network_cls, expectation, wrapper):
    @dataclass(frozen=True)
    class SenderState:
        pass

    @dataclass(frozen=True)
    class ReceiverState:
        received: Tuple[str, ...]

    class Sender(actor_cls):
        def __init__(self, dst, values):
            self.dst, self.values = dst, values

        def on_start(self, id, o):
            for v in self.values:
                o.send(self.dst, v)
            return SenderState()

    class Receiver(actor_cls):
        def on_start(self, id, o):
            return ReceiverState(received=())

        def on_msg(self, id, state, src, msg, o):
            return ReceiverState(received=state.received + (msg,))

    model = model_cls(cfg=None, init_history=None)
    model.actor(wrapper(Sender(1, ("a", "b"))))
    model.actor(wrapper(Receiver()))
    order = {"a": 0, "b": 1}

    def received(state):
        return state.actor_states[1].wrapped_state.received

    return (
        model.init_network(network_cls.new_unordered_duplicating())
        .lossy_network(True)
        .within_boundary_fn(lambda _cfg, state: len(state.network) < 4)
        .property(expectation.ALWAYS, "no redelivery",
                  lambda _m, s: all(received(s).count(v) < 2 for v in ("a", "b")))
        .property(expectation.ALWAYS, "ordered",
                  lambda _m, s: [order[v] for v in received(s)]
                  == sorted(order[v] for v in received(s)))
        .property(expectation.SOMETIMES, "all delivered",
                  lambda _m, s: received(s) == ("a", "b"))
    )


@pytest.mark.parametrize("engine", ["spawn_bfs", "spawn_dfs"])
def test_orl_exactly_once_in_order_matches_jax(engine):
    port = getattr(_orl_model(Actor, ActorModel, Network, Expectation,
                              orl.ActorWrapper).checker(), engine)().join()
    ref = getattr(_orl_model(JaxActor, JaxActorModel, JaxNetwork, JaxExpectation,
                             jax_orl.ActorWrapper).checker(), engine)().join()
    assert "no redelivery" not in port.discoveries()
    assert "ordered" not in port.discoveries()
    assert "all delivered" in port.discoveries()
    _same_check(port, ref)


def _orl_steps(actor_cls, out_cls, id_cls, m):
    """on_start, the resend timer, an ack, and a deliver twice (acked both
    times, the second dropped): each step's returned state and commands."""

    class Receiver(actor_cls):
        def on_start(self, id, o):
            return ()

        def on_msg(self, id, state, src, msg, o):
            return state + (msg,)

    class Sender(actor_cls):
        def on_start(self, id, o):
            o.send(id_cls(1), "a")
            o.send(id_cls(1), "b")
            return ()

    steps = []

    def step(fn, *args):
        o = out_cls()
        ret = fn(*args, o)
        steps.append((ret, [(c.kind, c.args) for c in o]))
        return ret

    w = m.ActorWrapper(Sender())
    state = step(w.on_start, id_cls(0))
    step(w.on_timeout, id_cls(0), state, m.NETWORK_TIMER)
    step(w.on_msg, id_cls(0), state, id_cls(1), m.ack_msg(1))
    r = m.ActorWrapper(Receiver())
    rs = step(r.on_start, id_cls(1))
    rs2 = step(r.on_msg, id_cls(1), rs, id_cls(0), m.deliver_msg(1, "a"))
    step(r.on_msg, id_cls(1), rs2, id_cls(0), m.deliver_msg(1, "a"))
    return steps


def test_orl_wrapper_steps_match_jax():
    from stateright_tpu.actor import Id as JaxId
    from stateright_tpu.actor import Out as JaxOut

    steps = _orl_steps(Actor, Out, Id, orl)
    jsteps = _orl_steps(JaxActor, JaxOut, JaxId, jax_orl)
    assert repr(steps) == repr(jsteps)
    assert [fingerprint(st) for st, _ in steps] == [fingerprint(st) for st, _ in jsteps]
    (start, cmds), (resend, resent), (acked, _), _, (got, _), (dup, dup_cmds) = steps
    assert start.next_send_seq == 3
    assert start.msgs_pending_ack == ((1, Id(1), "a"), (2, Id(1), "b"))
    assert [k for k, _ in cmds] == ["SetTimer", "Send", "Send"]
    assert resend is None and [a for k, a in resent if k == "Send"] == [
        (Id(1), orl.deliver_msg(1, "a")), (Id(1), orl.deliver_msg(2, "b"))]
    assert acked.msgs_pending_ack == ((2, Id(1), "b"),)
    assert got.wrapped_state == ("a",)
    assert dup is None and [k for k, _ in dup_cmds] == ["Send"]


# -- the write-once register -------------------------------------------------------


def test_wo_register_spec_matches_jax():
    ops = [WO_READ, WoWrite("A"), WO_READ, WoWrite("B"), WoWrite("A"), WO_READ]
    spec, jspec = WORegister(), JaxWORegister()
    rets = []
    for op in ops:
        rets.append(spec.invoke(op))
        assert rets[-1] == jspec.invoke(op)
    assert rets == [WoReadOk(None), WO_WRITE_OK, WoReadOk(("Some", "A")),
                    WO_WRITE_FAIL, WO_WRITE_OK, WoReadOk(("Some", "A"))]
    assert fingerprint(spec) == fingerprint(jspec)
    assert spec.clone() == spec and hash(spec.clone()) == hash(spec)
    fresh = WORegister()
    assert fresh.is_valid_step(WoWrite("A"), WO_WRITE_OK)
    assert not fresh.is_valid_step(WoWrite("B"), WO_WRITE_OK)
    assert fresh.is_valid_step(WoWrite("B"), WO_WRITE_FAIL)


def _wo_model(pkg):
    if pkg == "port":
        A, M, N, E, T, W, m = (Actor, ActorModel, Network, Expectation,
                               LinearizabilityTester, WORegister, wor)
    else:
        A, M, N, E, T, W, m = (JaxActor, JaxActorModel, JaxNetwork, JaxExpectation,
                               JaxLinearizabilityTester, JaxWORegister, jax_wor)

    @dataclass(frozen=True)
    class ServerState:
        value: object

    class WOServer(A):
        def on_start(self, id, o):
            return ServerState(value=None)

        def on_msg(self, id, state, src, msg, o):
            if isinstance(msg, m.Put):
                if state.value is None:
                    o.send(src, m.PutOk(msg.request_id))
                    return ServerState(value=msg.value)
                o.send(src, (m.PutOk if state.value == msg.value else m.PutFail)(
                    msg.request_id))
                return None
            if isinstance(msg, m.Get):
                o.send(src, m.GetOk(msg.request_id, state.value))
            return None

    model = M(cfg=None, init_history=T(W()))
    model.actor(WOServer())
    model.actor(m.WORegisterClient(put_count=1, server_count=1))
    model.actor(m.WORegisterClient(put_count=1, server_count=1))
    return (
        model.init_network(N.new_unordered_nonduplicating())
        .property(E.ALWAYS, "linearizable",
                  lambda _, state: state.history.serialized_history() is not None)
        .property(E.SOMETIMES, "value chosen",
                  lambda _, state: state.actor_states[0].value is not None)
        .record_msg_in(m.record_returns)
        .record_msg_out(m.record_invocations)
    )


def test_wo_register_client_round_trip_matches_jax():
    port = _wo_model("port").checker().spawn_bfs().join()
    ref = _wo_model("jax").checker().spawn_bfs().join()
    port.assert_properties()
    _same_check(port, ref)


# -- the timers example ------------------------------------------------------------


def test_pinger_bounded_to_depth_5_matches_jax():
    port = (PingerModelCfg(server_count=3, network=Network.new_unordered_nonduplicating())
            .into_model().checker().target_max_depth(5).spawn_bfs().join())
    ref = (JaxPingerModelCfg(server_count=3,
                             network=JaxNetwork.new_unordered_nonduplicating())
           .into_model().checker().target_max_depth(5).spawn_bfs().join())
    assert port.unique_state_count() > 10
    assert port.max_depth() == 5
    _same_check(port, ref)


# -- the wire codec and the UDP runtime ---------------------------------------------


def _wire_msgs(reg):
    return [reg.Put(1, "X"), reg.Get(2), reg.PutOk(1), reg.GetOk(2, "X"),
            reg.GetOk(3, ("a", (1, 2))), reg.Internal(("prepare", 4)), "plain",
            ("t", (1, 2))]


@pytest.mark.parametrize("i", range(8))
def test_wire_round_trip_matches_jax(i):
    """Each message encodes to the JAX codec's bytes and decodes back to
    itself (tuples stay tuples), as the JAX decoder does."""
    from stateright_tpu.actor import register as jax_register
    from stateright_tpu_torch.actor import register

    msg, jmsg = _wire_msgs(register)[i], _wire_msgs(jax_register)[i]
    data = wire.register_msg_to_wire(msg)
    assert data == jax_wire.register_msg_to_wire(jmsg)
    assert wire.register_msg_from_wire(data) == msg
    assert repr(wire.register_msg_from_wire(data)) == repr(
        jax_wire.register_msg_from_wire(data))


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_spawn_exchanges_messages_on_loopback():
    """A client and a server actor on UDP sockets at 127.0.0.1: the client
    puts a value (resending on a timer until acknowledged), the server
    answers ``PutOk``; the runtime stops within a few seconds."""
    server_id = Id.from_socket_addr("127.0.0.1", _free_udp_port())
    client_id = Id.from_socket_addr("127.0.0.1", _free_udp_port())
    got = threading.Event()
    seen = []

    class Server(Actor):
        def on_start(self, id, o):
            return None

        def on_msg(self, id, state, src, msg, o):
            if isinstance(msg, Put):
                seen.append(msg)
                o.send(src, PutOk(msg.request_id))
                return msg.value
            return None

    class Client(Actor):
        def on_start(self, id, o):
            o.send(server_id, Put(7, "X"))
            o.set_timer("resend", (0.1, 0.1))
            return "waiting"

        def on_timeout(self, id, state, timer, o):
            if state == "waiting":
                o.send(server_id, Put(7, "X"))
                o.set_timer("resend", (0.1, 0.1))
            return None

        def on_msg(self, id, state, src, msg, o):
            if isinstance(msg, PutOk) and msg.request_id == 7 and src == server_id:
                got.set()
                o.cancel_timer("resend")
                return "done"
            return None

    handle = spawn(wire.register_msg_to_wire, wire.register_msg_from_wire,
                   [(server_id, Server()), (client_id, Client())], background=True)
    try:
        assert got.wait(5.0), "no PutOk came back over loopback"
        assert seen and seen[0] == Put(7, "X")
    finally:
        handle.stop()
        handle.join(timeout=3.0)
    assert not any(t.is_alive() for t in handle._threads), "actor threads still running"
