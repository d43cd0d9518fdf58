"""The port's Explorer against the JAX package's: the route handlers called
directly on the same models (equal views, fingerprints included), one HTTP
round trip over 2pc-3 to its 288 states, and the monitor routes the port
does not serve yet (404)."""

import json
import urllib.error
import urllib.request

import pytest

import fixtures as jf
import torch_host_fixtures as tf
from stateright_tpu.checker import explorer as jax_explorer
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.checker.explorer import (
    Snapshot,
    start_server,
    states_view,
    status_view,
    ui_asset,
)
from stateright_tpu_torch.core.fingerprint import fingerprint
from stateright_tpu_torch.core.path import Path
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

JOIN_TIMEOUT_S = 60


def _joined(checker):
    handles = checker.handles()
    for h in handles:
        h.join(JOIN_TIMEOUT_S)
    assert not any(h.is_alive() for h in handles), "on-demand workers still running"
    return checker


def _pair(port_model, jax_model):
    return port_model.checker().spawn_on_demand(), jax_model.checker().spawn_on_demand()


def test_init_states_view_matches_jax():
    port, ref = _pair(tf.BinaryClock(), jf.BinaryClock())
    view = states_view(port, [])
    assert view == jax_explorer.states_view(ref, [])
    assert {s["outcome"] for s in view["next_steps"]} == {"0", "1"}
    assert all(s["properties"][0]["status"] == "ok" for s in view["next_steps"])


def test_states_view_follows_fingerprints_like_jax():
    port, ref = _pair(tf.BinaryClock(), jf.BinaryClock())
    view = states_view(port, [fingerprint(0)])
    assert view == jax_explorer.states_view(ref, [fingerprint(0)])
    (step,) = view["next_steps"]
    assert step["action"] == "'GoHigh'" and step["fingerprint"] == str(fingerprint(1))
    with pytest.raises(KeyError):
        states_view(port, [123456789])


def test_2pc3_views_walk_like_jax():
    """Three steps into 2pc-3 along the first next step each time: the same
    views, fingerprints, steps and outcomes in both packages."""
    port, ref = _pair(TwoPhaseSys(3), JaxTwoPhaseSys(3))
    fps = []
    for _ in range(4):
        view = states_view(port, fps)
        assert view == jax_explorer.states_view(ref, fps)
        fps.append(int(view["next_steps"][0]["fingerprint"]))


def test_status_view_matches_jax_after_completion():
    port, ref = _pair(TwoPhaseSys(3), JaxTwoPhaseSys(3))
    port.run_to_completion()
    ref.run_to_completion()
    _joined(port)
    _joined(ref)
    view = status_view(port)
    assert view == jax_explorer.status_view(ref)
    assert view["done"] and view["unique_state_count"] == 288
    assert view["progress"] is None
    by_name = {p["name"]: p for p in view["properties"]}
    assert by_name["consistent"]["discovery"] is None
    assert by_name["commit agreement"]["discovery"]["fingerprints"].count("/") >= 1


def test_snapshot_keeps_first_path_per_window():
    snap = Snapshot(reset_seconds=3600)
    p1 = Path([(0, "GoHigh"), (1, None)])
    snap.visit(None, p1)
    snap.visit(None, Path([(1, "GoLow"), (0, None)]))
    assert snap.recent_path() is p1


def test_ui_assets_are_the_ports_own_copy():
    ctype, body = ui_asset("/")
    assert ctype == "text/html" and b"stateright_tpu_torch explorer" in body
    assert ui_asset("/app.js")[0] == "application/javascript"
    assert ui_asset("/../__init__.py") is None
    assert ui_asset("/missing.css") is None


def test_http_round_trip_2pc3():
    server, checker = start_server(TwoPhaseSys(3).checker(), ("localhost", 0))
    ref = JaxTwoPhaseSys(3).checker().spawn_on_demand()
    try:
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, json.loads(r.read())

        code, status = get("/.status")
        assert code == 200 and status["progress"] is None
        assert {p["name"] for p in status["properties"]} == {
            "abort agreement", "commit agreement", "consistent"}
        code, init = get("/.states")
        assert code == 200
        assert init == json.loads(json.dumps(jax_explorer.states_view(ref, [])))
        (init_step,) = init["next_steps"]
        code, after = get("/.states/" + init_step["fingerprint"])
        assert code == 200 and len(after["next_steps"]) > 0
        want = jax_explorer.states_view(ref, [int(init_step["fingerprint"])])
        assert after == json.loads(json.dumps(want))
        req = urllib.request.Request(base + "/.runtocompletion", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["ok"]
        _joined(checker)
        code, done = get("/.status")
        assert done["done"] and done["unique_state_count"] == 288
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert r.status == 200 and b"stateright_tpu_torch explorer" in r.read()
        for path in ("/metrics", "/status", "/events", "/.states/x"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=10)
            assert e.value.code == (400 if path == "/.states/x" else 404)
    finally:
        server.shutdown()
        server.server_close()
