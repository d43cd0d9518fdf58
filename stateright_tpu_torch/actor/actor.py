"""The event-driven actor abstraction.

Reference: ``Actor`` trait at ``src/actor.rs:270-341``, ``Id``
at ``:108-156``, ``Out``/``Command`` at ``:159-243``.

Python adaptation of the reference's copy-on-write no-op detection: callbacks
*return* the next actor state (or ``None`` for "unchanged"). Returning a state
object — even one equal to the previous state — counts as a write, exactly
like the reference's ``Cow::Owned``; this distinction is load-bearing for
state-count parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, List, Optional, Tuple, TypeVar

Msg = TypeVar("Msg")
Timer = TypeVar("Timer")
State = TypeVar("State")


class Id(int):
    """Uniquely identifies an actor. An index for model-checked actors; encodes
    a socket address for spawned actors (see ``actor/spawn.py``)."""

    def __repr__(self) -> str:
        return f"Id({int(self)})"

    @staticmethod
    def vec_from(ids) -> List["Id"]:
        return [Id(i) for i in ids]

    @staticmethod
    def from_socket_addr(ip: str, port: int) -> "Id":
        """Encodes an IPv4 address + port: IP in bytes 2-5, port in bytes 6-7
        (reference: ``src/actor/spawn.rs:10-34``)."""
        octets = [int(o) for o in ip.split(".")]
        value = 0
        for o in octets:
            value = (value << 8) | o
        return Id((value << 16) | port)

    def socket_addr(self) -> Tuple[str, int]:
        port = int(self) & 0xFFFF
        ip_bits = (int(self) >> 16) & 0xFFFFFFFF
        ip = ".".join(str((ip_bits >> shift) & 0xFF) for shift in (24, 16, 8, 0))
        return ip, port


# Command kinds (reference: Command enum at src/actor.rs:159-167)
SEND = "Send"
SET_TIMER = "SetTimer"
CANCEL_TIMER = "CancelTimer"


@dataclass(frozen=True)
class Command:
    kind: str
    # Send: (dst, msg); SetTimer: (timer, duration_range); CancelTimer: (timer,)
    args: tuple

    @staticmethod
    def send(dst: Id, msg) -> "Command":
        return Command(SEND, (dst, msg))

    @staticmethod
    def set_timer(timer, duration_range) -> "Command":
        return Command(SET_TIMER, (timer, duration_range))

    @staticmethod
    def cancel_timer(timer) -> "Command":
        return Command(CANCEL_TIMER, (timer,))


class Out(Generic[Msg, Timer]):
    """Holds commands output by an actor callback."""

    def __init__(self):
        self.commands: List[Command] = []

    def send(self, recipient: Id, msg) -> None:
        self.commands.append(Command.send(recipient, msg))

    def broadcast(self, recipients, msg) -> None:
        for recipient in recipients:
            self.send(recipient, msg)

    def set_timer(self, timer, duration_range=None) -> None:
        """Set/reset a named timer. ``duration_range`` is a (lo, hi) seconds
        tuple for the spawned runtime; irrelevant under model checking (use
        ``model_timeout()``)."""
        self.commands.append(Command.set_timer(timer, duration_range))

    def cancel_timer(self, timer) -> None:
        self.commands.append(Command.cancel_timer(timer))

    def append(self, other: "Out") -> None:
        self.commands.extend(other.commands)
        other.commands.clear()

    def __len__(self) -> int:
        return len(self.commands)

    def __iter__(self):
        return iter(self.commands)

    def __repr__(self) -> str:
        return repr(self.commands)


def is_no_op(returned_state, out: Out) -> bool:
    """True iff the actor neither returned a new state nor output commands."""
    return returned_state is None and not out.commands


def is_no_op_with_timer(returned_state, out: Out, timer) -> bool:
    """True iff the actor only renewed the same timer (and didn't change
    state or output anything else)."""
    keep_timer = any(
        c.kind == SET_TIMER and c.args[0] == timer for c in out.commands
    )
    unmodified_out = len(out.commands) == 1 and keep_timer
    return returned_state is None and unmodified_out


class Actor(Generic[Msg, Timer, State]):
    """An actor initializes internal state (optionally emitting commands), then
    waits for incoming events, responding by returning an updated state and/or
    emitting commands.

    Callbacks return the next actor state or ``None`` for "no change"."""

    def on_start(self, id: Id, o: Out) -> State:
        """Returns the initial state; may emit commands via ``o``."""
        raise NotImplementedError

    def on_msg(self, id: Id, state: State, src: Id, msg, o: Out) -> Optional[State]:
        """Handles a message. Returns the next state, or None if unchanged."""
        return None

    def on_timeout(self, id: Id, state: State, timer, o: Out) -> Optional[State]:
        """Handles a timeout. Returns the next state, or None if unchanged."""
        return None

    def name(self) -> str:
        return ""
