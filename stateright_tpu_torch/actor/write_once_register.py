"""Write-once-register protocol adapter: message interface + checking client.

Like the register adapter (``actor/register.py``) but for
write-once semantics: a ``PutFail`` response signals a rejected second write,
and the history hooks record ``WriteFail`` returns for the
``WORegister`` sequential spec.

Reference: ``src/actor/write_once_register.rs``. The
reference wraps servers in a ``WORegisterActor::Server`` variant purely for
Rust type unification; Python servers implement the message interface
directly, so only the client actor and history hooks are needed. Symmetry:
all message/state types here are plain dataclasses/tuples, which the
rewriter traverses structurally (the reference needs explicit ``Rewrite``
impls, ``:290-331``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..semantics.write_once_register import (
    WO_READ,
    WO_WRITE_OK,
    WO_WRITE_FAIL,
    WoReadOk,
    WoWrite,
)
from .network import Envelope
from .register import (  # shared message shapes + client base
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
)


@dataclass(frozen=True)
class PutFail:
    """Indicates an unsuccessful ``Put`` (the register was already written)."""

    request_id: int

    def __repr__(self):
        return f"PutFail({self.request_id!r})"


# -- history hooks -----------------------------------------------------------


def record_invocations(_cfg, history, env: Envelope):
    """Pass to ``ActorModel.record_msg_out``: Read on Get, Write on Put."""
    if isinstance(env.msg, Get):
        h = history.clone()
        try:
            h.on_invoke(env.src, WO_READ)
        except ValueError:
            pass
        return h
    if isinstance(env.msg, Put):
        h = history.clone()
        try:
            h.on_invoke(env.src, WoWrite(env.msg.value))
        except ValueError:
            pass
        return h
    return None


def record_returns(_cfg, history, env: Envelope):
    """Pass to ``ActorModel.record_msg_in``: ReadOk on GetOk, WriteOk on
    PutOk, WriteFail on PutFail."""
    if isinstance(env.msg, GetOk):
        h = history.clone()
        # The spec's read result is an option: None (unset) | ("Some", v).
        option = None if env.msg.value is None else ("Some", env.msg.value)
        try:
            h.on_return(env.dst, WoReadOk(option))
        except ValueError:
            pass
        return h
    if isinstance(env.msg, PutOk):
        h = history.clone()
        try:
            h.on_return(env.dst, WO_WRITE_OK)
        except ValueError:
            pass
        return h
    if isinstance(env.msg, PutFail):
        h = history.clone()
        try:
            h.on_return(env.dst, WO_WRITE_FAIL)
        except ValueError:
            pass
        return h
    return None


# -- the model-checking client actor -----------------------------------------


class WORegisterClient(RegisterClient):
    """A ``RegisterClient`` whose Puts also complete on ``PutFail`` — a
    rejected write-once write still finishes the operation."""

    def name(self) -> str:
        return "WOClient"

    def _completes_put(self, msg) -> bool:
        return isinstance(msg, (PutOk, PutFail))


__all__ = [
    "Get",
    "GetOk",
    "Internal",
    "Put",
    "PutFail",
    "PutOk",
    "WORegisterClient",
    "record_invocations",
    "record_returns",
]
