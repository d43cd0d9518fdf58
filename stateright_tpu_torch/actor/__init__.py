"""Actor framework: event-driven actors checked exhaustively (ActorModel) or
run over real UDP (spawn)."""

from .actor import (
    Actor,
    Command,
    Id,
    Out,
    is_no_op,
    is_no_op_with_timer,
)
from .model import (
    ActorModel,
    CrashAction,
    DeliverAction,
    DropAction,
    LOSSLESS,
    LOSSY,
    TimeoutAction,
    model_peers,
    model_timeout,
)
from .model_state import ActorModelState
from .network import Envelope, Network
from .timers import Timers

__all__ = [
    "Actor",
    "ActorModel",
    "ActorModelState",
    "Command",
    "CrashAction",
    "DeliverAction",
    "DropAction",
    "Envelope",
    "Id",
    "LOSSLESS",
    "LOSSY",
    "Network",
    "Out",
    "TimeoutAction",
    "Timers",
    "is_no_op",
    "is_no_op_with_timer",
    "model_peers",
    "model_timeout",
]
