"""Write-once register reference semantics (second distinct write fails).

Reference: ``WORegister`` at
``src/semantics/write_once_register.rs``.
"""

from __future__ import annotations

from .base import SequentialSpec


def WoWrite(value):
    return ("Write", value)


WO_READ = ("Read",)
WO_WRITE_OK = ("WriteOk",)
WO_WRITE_FAIL = ("WriteFail",)

_UNSET = ("Unset",)


def WoReadOk(value_option):
    """``value_option`` is None (unset) or ("Some", value)."""
    return ("ReadOk", value_option)


class WORegister(SequentialSpec):
    """Write succeeds when unset or equal to the current value; a second
    distinct write fails. Read returns None or ("Some", value)."""

    def __init__(self, value_option=None):
        # None or ("Some", value)
        self.value_option = value_option

    def invoke(self, op):
        if op[0] == "Write":
            if self.value_option is None or self.value_option == ("Some", op[1]):
                self.value_option = ("Some", op[1])
                return WO_WRITE_OK
            return WO_WRITE_FAIL
        if op == WO_READ:
            return WoReadOk(self.value_option)
        raise ValueError(f"unknown WO-register op: {op!r}")

    def is_valid_step(self, op, ret) -> bool:
        if op[0] == "Write":
            if ret == WO_WRITE_OK:
                if self.value_option is None:
                    self.value_option = ("Some", op[1])
                    return True
                return self.value_option == ("Some", op[1])
            if ret == WO_WRITE_FAIL:
                return (
                    self.value_option is not None
                    and self.value_option != ("Some", op[1])
                )
            return False
        if op == WO_READ and ret[0] == "ReadOk":
            return self.value_option == ret[1]
        return False

    def clone(self) -> "WORegister":
        return WORegister(self.value_option)

    def __stable_fields__(self):
        return ("WORegister", self.value_option)

    def __eq__(self, other):
        return (
            isinstance(other, WORegister)
            and self.value_option == other.value_option
        )

    def __hash__(self):
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self):
        return f"WORegister({self.value_option!r})"
