"""Pluggable modeled-network semantics — the key state-space knob.

Three semantics (reference: ``Network`` at
``src/actor/network.rs:46-68``):

- ``unordered_duplicating``: messages race and can be redelivered (delivery is
  a no-op removal; only Drop removes forever). State: a set of envelopes.
- ``unordered_nonduplicating``: messages race, delivered at most once. State:
  a multiset (envelope -> count).
- ``ordered``: per directed actor pair, FIFO flows. State: (src, dst) -> queue.

In the packed representation (``actor/packed.py``) unordered networks become
fixed-capacity envelope tables with count columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

from .actor import Id

ORDERED = "ordered"
UNORDERED_DUPLICATING = "unordered_duplicating"
UNORDERED_NONDUPLICATING = "unordered_nonduplicating"


@dataclass(frozen=True)
class Envelope:
    """The source and destination for a message."""

    src: Id
    dst: Id
    msg: object

    def __repr__(self) -> str:
        return f"Envelope {{ src: {self.src!r}, dst: {self.dst!r}, msg: {self.msg!r} }}"


class Network:
    """A network of in-flight messages with selectable semantics."""

    def __init__(self, kind: str, data=None):
        self.kind = kind
        if data is not None:
            self.data = data
        elif kind == ORDERED:
            # (src, dst) -> list of msgs (FIFO). Iterated in sorted key order
            # (the reference uses a BTreeMap).
            self.data: Dict = {}
        else:
            # Envelope -> count. For duplicating networks counts are always 1
            # (set semantics); insertion order gives deterministic iteration.
            self.data = {}

    # -- constructors --------------------------------------------------------

    @staticmethod
    def new_ordered(envelopes=()) -> "Network":
        net = Network(ORDERED)
        for env in envelopes:
            net.send(env)
        return net

    @staticmethod
    def new_unordered_duplicating(envelopes=()) -> "Network":
        net = Network(UNORDERED_DUPLICATING)
        for env in envelopes:
            net.send(env)
        return net

    @staticmethod
    def new_unordered_nonduplicating(envelopes=()) -> "Network":
        net = Network(UNORDERED_NONDUPLICATING)
        for env in envelopes:
            net.send(env)
        return net

    @staticmethod
    def names() -> List[str]:
        return [ORDERED, UNORDERED_DUPLICATING, UNORDERED_NONDUPLICATING]

    @staticmethod
    def from_name(name: str) -> "Network":
        if name not in Network.names():
            raise ValueError(f"unable to parse network name: {name}")
        return Network(name)

    # -- queries -------------------------------------------------------------

    def iter_all(self) -> Iterator[Envelope]:
        """All envelopes, with multiplicity."""
        if self.kind == ORDERED:
            for (src, dst) in sorted(self.data):
                for msg in self.data[(src, dst)]:
                    yield Envelope(src, dst, msg)
        elif self.kind == UNORDERED_NONDUPLICATING:
            for env, count in self.data.items():
                for _ in range(count):
                    yield env
        else:
            yield from self.data

    def iter_deliverable(self) -> Iterator[Envelope]:
        """All distinct deliverable envelopes (flow heads for ordered)."""
        if self.kind == ORDERED:
            for (src, dst) in sorted(self.data):
                yield Envelope(src, dst, self.data[(src, dst)][0])
        else:
            yield from self.data

    def __len__(self) -> int:
        if self.kind == ORDERED:
            return sum(len(q) for q in self.data.values())
        if self.kind == UNORDERED_NONDUPLICATING:
            return sum(self.data.values())
        return len(self.data)

    # -- mutations (on freshly copied states only) ---------------------------

    def send(self, envelope: Envelope) -> None:
        if self.kind == ORDERED:
            self.data.setdefault((envelope.src, envelope.dst), []).append(
                envelope.msg
            )
        elif self.kind == UNORDERED_NONDUPLICATING:
            self.data[envelope] = self.data.get(envelope, 0) + 1
        else:
            self.data.setdefault(envelope, True)

    def on_deliver(self, envelope: Envelope) -> None:
        if self.kind == UNORDERED_DUPLICATING:
            return  # no-op: the message can be redelivered
        self._remove(envelope)

    def on_drop(self, envelope: Envelope) -> None:
        if self.kind == UNORDERED_DUPLICATING:
            self.data.pop(envelope, None)
            return
        self._remove(envelope)

    def _remove(self, envelope: Envelope) -> None:
        if self.kind == ORDERED:
            key = (envelope.src, envelope.dst)
            flow = self.data.get(key)
            if flow is None:
                raise KeyError(
                    f"flow not found. src={envelope.src!r}, dst={envelope.dst!r}"
                )
            flow.remove(envelope.msg)  # raises ValueError if missing
            if not flow:
                del self.data[key]  # canonical: no empty flows
        else:
            count = self.data.get(envelope)
            if count is None:
                raise KeyError("envelope not found")
            if count == 1:
                del self.data[envelope]
            else:
                self.data[envelope] = count - 1

    # -- value semantics -----------------------------------------------------

    def copy(self) -> "Network":
        if self.kind == ORDERED:
            return Network(self.kind, {k: list(v) for k, v in self.data.items()})
        return Network(self.kind, dict(self.data))

    def __stable_fields__(self):
        if self.kind == ORDERED:
            return (
                self.kind,
                tuple(
                    (k, tuple(v)) for k, v in sorted(self.data.items())
                ),
            )
        # Order-insensitive: hash as a dict (envelope -> count / True).
        return (self.kind, dict(self.data))

    def __eq__(self, other) -> bool:
        if not isinstance(other, Network) or self.kind != other.kind:
            return False
        return self.data == other.data

    def __hash__(self) -> int:
        from ..core.fingerprint import stable_hash

        return stable_hash(self.__stable_fields__())

    def __repr__(self) -> str:
        return f"Network::{self.kind}({list(self.iter_all())!r})"
