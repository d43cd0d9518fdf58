"""Consistency semantics: sequential reference objects ("specs") and testers
that validate concurrent histories against a consistency model.

Reference: ``src/semantics.rs`` and submodules. The port carries the
register, write-once register and stack (``VecSpec``) specs, and the
linearizability and sequential-consistency testers: the register-protocol
models (paxos, single-copy register) and the write-once register actors
check against them, and the conformance plane (``conformance/``) audits
uploaded histories with them.
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
from .vec import VecSpec, Push, POP, LEN, PUSH_OK, PopOk, LenOk
from .linearizability import LinearizabilityTester
from .sequential_consistency import SequentialConsistencyTester

__all__ = [
    "ConsistencyTester",
    "LinearizabilityTester",
    "READ",
    "ReadOk",
    "Register",
    "SequentialConsistencyTester",
    "SequentialSpec",
    "VecSpec",
    "WORegister",
    "WO_READ",
    "WO_WRITE_FAIL",
    "WO_WRITE_OK",
    "WRITE_OK",
    "WoReadOk",
    "WoWrite",
    "Write",
    "Push",
    "POP",
    "LEN",
    "PUSH_OK",
    "PopOk",
    "LenOk",
]
