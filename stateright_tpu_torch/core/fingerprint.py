"""Stable 64-bit state fingerprinting.

The reference derives a stable 64-bit digest per state via a fixed-seed hasher
(``src/lib.rs:329-375``) so fingerprints are reproducible across
runs — a requirement for path-by-fingerprint reconstruction and golden tests.

This implementation hashes a canonical byte encoding of the state with
blake2b(digest_size=8). Unordered containers (set/frozenset/dict) are hashed
order-insensitively by hashing each entry to a u64, sorting the u64s, and
feeding them to the outer hasher — mirroring the reference's
``HashableHashSet``/``HashableHashMap`` strategy (``src/util.rs:137-159``).

The same canonical u64 is computed on-device for packed states by
``stateright_tpu_torch.ops.fingerprint`` (a different hash function — device
fingerprints only need to be stable *within* the device backend).
"""

from __future__ import annotations

import dataclasses
from hashlib import blake2b
from typing import Any

__all__ = ["fingerprint", "stable_encode", "stable_hash", "Fingerprint"]

# A fingerprint is a nonzero unsigned 64-bit int (reference: NonZeroU64).
Fingerprint = int

_MASK64 = (1 << 64) - 1

# Type tags keep the encoding prefix-free across types so e.g. (1, 2) and
# ((1,), 2) cannot collide byte-wise.
_T_NONE = b"\x00"
_T_BOOL = b"\x01"
_T_INT = b"\x02"
_T_BIGINT = b"\x03"
_T_STR = b"\x04"
_T_BYTES = b"\x05"
_T_SEQ = b"\x06"
_T_SET = b"\x07"
_T_MAP = b"\x08"
_T_OBJ = b"\x09"
_T_FLOAT = b"\x0a"


def _encode(value: Any, out: bytearray) -> None:
    """Append the canonical encoding of ``value`` to ``out``."""
    if value is None:
        out += _T_NONE
    elif value is True:
        out += _T_BOOL
        out += b"\x01"
    elif value is False:
        out += _T_BOOL
        out += b"\x00"
    elif type(value) is int:
        if -(1 << 63) <= value < (1 << 63):
            out += _T_INT
            out += value.to_bytes(8, "little", signed=True)
        else:
            b = value.to_bytes((value.bit_length() + 8) // 8, "little", signed=True)
            out += _T_BIGINT
            out += len(b).to_bytes(4, "little")
            out += b
    elif type(value) is str:
        b = value.encode()
        out += _T_STR
        out += len(b).to_bytes(4, "little")
        out += b
    elif type(value) is bytes:
        out += _T_BYTES
        out += len(value).to_bytes(4, "little")
        out += value
    elif type(value) is float:
        out += _T_FLOAT
        out += value.hex().encode()
    elif type(value) is tuple or type(value) is list:
        out += _T_SEQ
        out += len(value).to_bytes(4, "little")
        for item in value:
            _encode(item, out)
    elif type(value) is frozenset or type(value) is set:
        # Order-insensitive: sorted per-element digests.
        out += _T_SET
        out += len(value).to_bytes(4, "little")
        for h in sorted(stable_hash(item) for item in value):
            out += h.to_bytes(8, "little")
    elif type(value) is dict:
        out += _T_MAP
        out += len(value).to_bytes(4, "little")
        for h in sorted(stable_hash((k, v)) for k, v in value.items()):
            out += h.to_bytes(8, "little")
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        out += _T_OBJ
        name = type(value).__qualname__.encode()
        out += len(name).to_bytes(2, "little")
        out += name
        for f in dataclasses.fields(value):
            _encode(getattr(value, f.name), out)
    elif isinstance(value, int):
        # IntEnum and other int subclasses (incl. Id) hash as plain ints so that
        # e.g. an Id inside a message matches an Id constructed elsewhere.
        _encode(int(value), out)
    elif isinstance(value, str):
        _encode(str(value), out)
    elif hasattr(value, "__stable_fields__"):
        out += _T_OBJ
        name = type(value).__qualname__.encode()
        out += len(name).to_bytes(2, "little")
        out += name
        for field_value in value.__stable_fields__():
            _encode(field_value, out)
    elif isinstance(value, (tuple, list)):
        _encode(tuple(value), out)
    else:
        raise TypeError(
            f"Cannot stably hash value of type {type(value).__name__}: {value!r}. "
            "Use ints/strs/bytes/tuples/lists/sets/dicts/dataclasses, or define "
            "__stable_fields__() returning the hashable field values."
        )


def stable_encode(value: Any) -> bytes:
    """The canonical byte encoding of ``value``. Byte-wise comparison of
    encodings is a deterministic total order on stable-hashable values
    (used by symmetry reduction's representative sort)."""
    buf = bytearray()
    _encode(value, buf)
    return bytes(buf)


def stable_hash(value: Any) -> int:
    """Canonical stable 64-bit hash of ``value`` (may be zero)."""
    buf = bytearray()
    _encode(value, buf)
    return int.from_bytes(blake2b(bytes(buf), digest_size=8).digest(), "little")


def fingerprint(value: Any) -> Fingerprint:
    """Stable nonzero 64-bit fingerprint of a state.

    Reference: ``fingerprint()`` at ``src/lib.rs:332-337``.
    """
    h = stable_hash(value) & _MASK64
    return h if h != 0 else 1
