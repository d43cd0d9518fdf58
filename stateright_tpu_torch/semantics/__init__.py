"""Consistency semantics: sequential reference objects ("specs") and testers
that validate concurrent histories against a consistency model.

Reference: ``src/semantics.rs`` and submodules. The port carries the
register spec and the linearizability tester, which the register-protocol
models (paxos, single-copy register) check against.
"""

from .base import ConsistencyTester, SequentialSpec
from .register import READ, Register, ReadOk, Write, WRITE_OK
from .linearizability import LinearizabilityTester

__all__ = [
    "ConsistencyTester",
    "LinearizabilityTester",
    "READ",
    "ReadOk",
    "Register",
    "SequentialSpec",
    "WRITE_OK",
    "Write",
]
