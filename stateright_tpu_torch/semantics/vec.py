"""Stack (Vec) reference semantics: Push/Pop/Len.

Reference: ``src/semantics/vec.rs``.
"""

from __future__ import annotations

from .base import SequentialSpec


def Push(value):
    return ("Push", value)


POP = ("Pop",)
LEN = ("Len",)
PUSH_OK = ("PushOk",)


def PopOk(value_option):
    return ("PopOk", value_option)


def LenOk(length):
    return ("LenOk", length)


class VecSpec(SequentialSpec):
    """A stack: Push(v) -> PushOk; Pop -> PopOk(None | ("Some", v));
    Len -> LenOk(n)."""

    def __init__(self, items=()):
        self.items = list(items)

    def invoke(self, op):
        if op[0] == "Push":
            self.items.append(op[1])
            return PUSH_OK
        if op == POP:
            if self.items:
                return PopOk(("Some", self.items.pop()))
            return PopOk(None)
        if op == LEN:
            return LenOk(len(self.items))
        raise ValueError(f"unknown vec op: {op!r}")

    def clone(self) -> "VecSpec":
        return VecSpec(self.items)

    def __stable_fields__(self):
        return ("VecSpec", tuple(self.items))

    def __eq__(self, other):
        return isinstance(other, VecSpec) and self.items == other.items

    def __hash__(self):
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self):
        return f"VecSpec({self.items!r})"
