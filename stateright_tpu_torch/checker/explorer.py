"""Explorer: interactive web UI over the on-demand checker.

``CheckerBuilder.serve(address)`` starts an HTTP service backed by
``OnDemandChecker`` — states are computed lazily as the user browses, and
browsing a state nudges the checker to explore it (so properties get
verified along the user's path of interest).

HTTP surface (reference: ``src/checker/explorer.rs``):

- ``GET /.status`` → ``StatusView`` JSON: progress counters, per-property
  discovery paths, a recently sampled path, and ``progress: null`` (the
  JAX package fills it from its live monitor, which the port has not
  taken on yet);
- ``GET /.states/fp1/fp2/...`` → ``StateView`` JSON: replays the
  fingerprint path through the model, evaluates properties at the final
  state, renders the model's SVG hook, and enumerates next steps;
- ``POST /.runtocompletion`` → unblocks the checker to exhaust the space.

The port's copy of the JAX package's ``checker/explorer.py`` without the
live monitor: ``/metrics``, ``/status`` and ``/events`` answer 404, and the
UI's monitor panel stays hidden. The UI (``stateright_tpu_torch/ui/``, a
copy of the JAX package's) is a small hand-written vanilla-JS page (the
reference uses KnockoutJS; nothing is shared)."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path as FsPath
from typing import List, Optional

from ..core.fingerprint import fingerprint
from ..core.model import Expectation
from ..core.path import Path
from ..core.visitor import CheckerVisitor

_UI_DIR = FsPath(__file__).resolve().parent.parent / "ui"
_SNAPSHOT_RESET_SECONDS = 4.0


class Snapshot(CheckerVisitor):
    """Samples a recent path: keeps the first path seen in each window so the
    status view can show what the checker is working on."""

    def __init__(self, reset_seconds: float = _SNAPSHOT_RESET_SECONDS):
        self._lock = threading.Lock()
        self._path: Optional[Path] = None
        self._stale_at = 0.0
        self._reset_seconds = reset_seconds

    def visit(self, model, path: Path) -> None:
        now = time.monotonic()
        with self._lock:
            if self._path is None or now >= self._stale_at:
                self._path = path
                self._stale_at = now + self._reset_seconds

    def recent_path(self) -> Optional[Path]:
        with self._lock:
            return self._path


# -- view builders (route handlers minus HTTP, exercised directly by tests) --


def status_view(checker, snapshot: Optional[Snapshot] = None) -> dict:
    model = checker.model()
    properties = []
    discoveries = checker.discoveries()
    for prop in model.properties():
        found = discoveries.get(prop.name)
        properties.append(
            {
                "name": prop.name,
                "expectation": prop.expectation.value
                if hasattr(prop.expectation, "value")
                else str(prop.expectation),
                "discovery": _encode_path(model, found) if found else None,
            }
        )
    recent = snapshot.recent_path() if snapshot else None
    return {
        "done": checker.is_done(),
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "properties": properties,
        "recent_path": _encode_path(model, recent) if recent else None,
        # The live-monitor progress estimate of the JAX package; the port
        # has no monitor, so it is null, as a bare view call is there.
        "progress": None,
    }


def _encode_path(model, path: Path) -> dict:
    return {
        "fingerprints": path.encode(),
        "actions": [model.format_action(a) for a in path.into_actions()],
    }


def states_view(checker, fp_path: List[int]) -> dict:
    """The view for ``GET /.states/fp1/fp2/...`` (empty path = init states).

    Raises ``KeyError`` if the path does not replay through the model."""
    model = checker.model()
    if not fp_path:
        states = []
        for state in model.init_states():
            fp = fingerprint(state)
            checker.check_fingerprint(fp)
            states.append(
                {
                    "action": None,
                    "outcome": str(state),
                    "fingerprint": str(fp),
                    "properties": _properties_at(model, state),
                }
            )
        return {"path": "", "svg": None, "next_steps": states}

    replayed = _replay(model, fp_path)
    state = (
        replayed.last_state()
        if replayed is not None
        else Path.final_state(model, fp_path)
    )
    if state is None:
        raise KeyError(
            f"no state matches fingerprint path {'/'.join(map(str, fp_path))}"
        )
    steps = []
    for action, next_state in model.next_steps(state):
        fp = fingerprint(next_state)
        checker.check_fingerprint(fp)
        steps.append(
            {
                "action": model.format_action(action),
                "step": model.format_step(state, action),
                "outcome": str(next_state),
                "fingerprint": str(fp),
                "properties": _properties_at(model, next_state),
            }
        )
    svg = model.as_svg(replayed) if replayed is not None else None
    return {
        "path": "/".join(str(fp) for fp in fp_path),
        "state": str(state),
        "properties": _properties_at(model, state),
        "svg": svg,
        "next_steps": steps,
    }


def _replay(model, fp_path: List[int]) -> Optional[Path]:
    try:
        return Path.from_fingerprints(model, fp_path)
    except RuntimeError:
        return None


def _properties_at(model, state) -> List[dict]:
    out = []
    for prop in model.properties():
        holds = bool(prop.condition(model, state))
        # For an "always" property a False here is a violation; for
        # "sometimes"/"eventually" a True is a witness.
        if prop.expectation == Expectation.ALWAYS:
            status = "ok" if holds else "violated"
        else:
            status = "witnessed" if holds else "pending"
        out.append({"name": prop.name, "holds": holds, "status": status})
    return out


# -- HTTP plumbing -----------------------------------------------------------


def _parse_address(address) -> tuple:
    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        return (host or "localhost", int(port))
    return tuple(address)


_CONTENT_TYPES = {
    ".html": "text/html",
    ".htm": "text/html",
    ".js": "application/javascript",
    ".css": "text/css",
}


def ui_asset(path: str):
    """Resolves a request path against the bundled UI directory:
    ``(content_type, bytes)`` or None (missing file, or a traversal
    attempt outside the UI dir)."""
    name = "index.html" if path in ("/", "") else path.lstrip("/")
    file = (_UI_DIR / name).resolve()
    try:
        inside = file.is_relative_to(_UI_DIR)
    except AttributeError:  # Python < 3.9
        import os

        inside = str(file).startswith(str(_UI_DIR) + os.sep)
    if not inside or not file.is_file():
        return None
    return (
        _CONTENT_TYPES.get(file.suffix, "text/plain"),
        file.read_bytes(),
    )


class _Handler(BaseHTTPRequestHandler):
    checker = None
    snapshot = None

    def log_message(self, *args):  # quiet by default
        pass

    def _json(self, payload, code=200):
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        try:
            if self.path == "/.status":
                self._json(status_view(self.checker, self.snapshot))
            elif self.path.startswith("/.states"):
                raw = [p for p in self.path[len("/.states") :].split("/") if p]
                try:
                    fps = [int(p) for p in raw]
                except ValueError:
                    self._json({"error": "fingerprints must be integers"}, 400)
                    return
                try:
                    self._json(states_view(self.checker, fps))
                except KeyError as e:
                    self._json({"error": str(e)}, 404)
            else:
                self._static(self.path)
        except ConnectionError:
            # Routine client disconnect mid-response (scraper timeout,
            # closed browser tab) must not traceback-spam the server —
            # but only disconnects: a filesystem error in _static must
            # still surface.
            pass

    def do_POST(self):
        if self.path == "/.runtocompletion":
            self.checker.run_to_completion()
            self._json({"ok": True})
        else:
            self._json({"error": "not found"}, 404)

    def _static(self, path: str):
        asset = ui_asset(path)
        if asset is None:
            self._json({"error": "not found"}, 404)
            return
        content_type, body = asset
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def start_server(builder, address) -> tuple:
    """Spawns the on-demand checker + HTTP server; returns
    ``(server, checker)`` without blocking (used by tests and ``serve``)."""
    snapshot = Snapshot()
    checker = builder.visitor(snapshot).spawn_on_demand()
    handler = type(
        "Handler", (_Handler,), {"checker": checker, "snapshot": snapshot}
    )
    server = ThreadingHTTPServer(_parse_address(address), handler)
    server.daemon_threads = True
    thread = threading.Thread(
        target=server.serve_forever, name="explorer-http", daemon=True
    )
    thread.start()
    return server, checker


def serve(builder, address):
    """Blocking entry point used by ``CheckerBuilder.serve``."""
    server, _checker = start_server(builder, address)
    host, port = server.server_address[:2]
    print(f"Exploring state space at http://{host}:{port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
