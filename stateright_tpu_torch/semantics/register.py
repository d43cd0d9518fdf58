"""Read/write register reference semantics.

Reference: ``Register`` at ``src/semantics/register.rs``.
"""

from __future__ import annotations

from .base import SequentialSpec


def Write(value):
    return ("Write", value)


READ = ("Read",)
WRITE_OK = ("WriteOk",)


def ReadOk(value):
    return ("ReadOk", value)


class Register(SequentialSpec):
    """A simple register: Write(v) -> WriteOk; Read -> ReadOk(current)."""

    def __init__(self, value):
        self.value = value

    def invoke(self, op):
        if op[0] == "Write":
            self.value = op[1]
            return WRITE_OK
        if op == READ:
            return ReadOk(self.value)
        raise ValueError(f"unknown register op: {op!r}")

    def is_valid_step(self, op, ret) -> bool:
        if op[0] == "Write" and ret == WRITE_OK:
            self.value = op[1]
            return True
        if op == READ and ret[0] == "ReadOk":
            return self.value == ret[1]
        return False

    def clone(self) -> "Register":
        return Register(self.value)

    def __stable_fields__(self):
        return ("Register", self.value)

    def __eq__(self, other):
        return isinstance(other, Register) and self.value == other.value

    def __hash__(self):
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self):
        return f"Register({self.value!r})"
