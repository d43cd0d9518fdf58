"""The real-world actor runtime: runs the same ``Actor`` implementations over
UDP sockets with user-supplied serialization (JSON in the examples).

One OS thread per actor; each binds a UDP socket at its Id's encoded address.
The loop computes the earliest timer deadline, uses it as the socket read
timeout, dispatches ``on_msg``/``on_timeout``, and executes output commands
(sends are fire-and-forget datagrams; reliability is added only by the
ordered-reliable-link wrapper).

Reference: ``spawn()`` at ``src/actor/spawn.rs:36-206``.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import Callable, List, Optional, Tuple

from .actor import (
    CANCEL_TIMER,
    SEND,
    SET_TIMER,
    Actor,
    Id,
    Out,
)

# Timers canceled or unset use a far-future deadline sentinel.
_PRACTICALLY_NEVER = 1e18

MAX_DATAGRAM = 65_507  # UDP payload limit


class SpawnHandle:
    """Handle for a spawned actor system; ``join()`` blocks forever (the
    runtime has no shutdown signal, like the reference's crossbeam scope)."""

    def __init__(self, threads: List[threading.Thread], stop: threading.Event):
        self._threads = threads
        self._stop = stop

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout)

    def stop(self) -> None:
        """Extension over the reference: signal actor loops to exit (checked
        between socket timeouts) so tests can shut the system down."""
        self._stop.set()


def spawn(
    serialize: Callable[[object], bytes],
    deserialize: Callable[[bytes], object],
    actors: List[Tuple[Id, Actor]],
    background: bool = False,
) -> SpawnHandle:
    """Runs actors on UDP sockets at their Id-encoded addresses.

    ``serialize(msg) -> bytes`` and ``deserialize(bytes) -> msg`` define the
    wire format. Returns a handle; with ``background=False`` this blocks until
    interrupted (matching the reference's blocking spawn)."""
    stop = threading.Event()
    threads = []
    for id, actor in actors:
        t = threading.Thread(
            target=_run_actor,
            args=(id, actor, serialize, deserialize, stop),
            name=f"actor-{int(id)}",
            daemon=True,
        )
        t.start()
        threads.append(t)
    handle = SpawnHandle(threads, stop)
    if not background:
        try:
            handle.join()
        except KeyboardInterrupt:
            stop.set()
    return handle


def _run_actor(id: Id, actor: Actor, serialize, deserialize, stop):
    addr = id.socket_addr()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(addr)

    # timer -> absolute deadline (seconds); canceled = _PRACTICALLY_NEVER
    timer_deadlines = {}

    def on_command(c):
        if c.kind == SEND:
            dst, msg = c.args
            data = serialize(msg)
            if len(data) > MAX_DATAGRAM:
                return
            try:
                sock.sendto(data, Id(dst).socket_addr())
            except OSError:
                pass
        elif c.kind == SET_TIMER:
            timer, duration_range = c.args
            lo, hi = duration_range if duration_range else (0.0, 0.0)
            duration = random.uniform(lo, hi) if hi > lo else lo
            timer_deadlines[timer] = time.monotonic() + duration
        elif c.kind == CANCEL_TIMER:
            (timer,) = c.args
            timer_deadlines[timer] = _PRACTICALLY_NEVER

    out = Out()
    state = actor.on_start(id, out)
    for c in out.commands:
        on_command(c)

    while not stop.is_set():
        # Wait until the next timer deadline (or a short poll interval so the
        # stop flag is observed).
        now = time.monotonic()
        deadline = min(timer_deadlines.values(), default=_PRACTICALLY_NEVER)
        wait = max(0.0, min(deadline - now, 0.5))
        sock.settimeout(wait if wait > 0 else 0.000001)
        try:
            data, src_addr = sock.recvfrom(MAX_DATAGRAM)
        except socket.timeout:
            data = None
        except OSError:
            break
        if data is not None:
            try:
                msg = deserialize(data)
            except Exception:
                msg = None
            if msg is not None:
                src = Id.from_socket_addr(src_addr[0], src_addr[1])
                out = Out()
                returned = actor.on_msg(id, state, src, msg, out)
                if returned is not None:
                    state = returned
                for c in out.commands:
                    on_command(c)
        # Fire any expired timers. Re-read the live deadline per timer: an
        # earlier handler in this pass may have canceled or re-set it.
        now = time.monotonic()
        for timer in list(timer_deadlines):
            t_deadline = timer_deadlines.get(timer, _PRACTICALLY_NEVER)
            if t_deadline <= now:
                timer_deadlines[timer] = _PRACTICALLY_NEVER
                out = Out()
                returned = actor.on_timeout(id, state, timer, out)
                if returned is not None:
                    state = returned
                for c in out.commands:
                    on_command(c)
    sock.close()
