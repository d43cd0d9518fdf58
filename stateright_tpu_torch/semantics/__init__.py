"""Consistency semantics: sequential reference objects ("specs") and testers
that validate concurrent histories against a consistency model.

Reference: ``src/semantics.rs`` and submodules. The port carries the
register and write-once register specs and the linearizability tester,
which the register-protocol models (paxos, single-copy register) and the
write-once register actors check against.
"""

from .base import ConsistencyTester, SequentialSpec
from .register import READ, Register, ReadOk, Write, WRITE_OK
from .write_once_register import (
    WORegister,
    WO_READ,
    WO_WRITE_FAIL,
    WO_WRITE_OK,
    WoReadOk,
    WoWrite,
)
from .linearizability import LinearizabilityTester

__all__ = [
    "ConsistencyTester",
    "LinearizabilityTester",
    "READ",
    "ReadOk",
    "Register",
    "SequentialSpec",
    "WORegister",
    "WO_READ",
    "WO_WRITE_FAIL",
    "WO_WRITE_OK",
    "WRITE_OK",
    "WoReadOk",
    "WoWrite",
    "Write",
]
