"""The port's models. The counter models are exported here; the others are
imported from their modules (``models.two_phase_commit``, ``models.paxos``,
``models.raft``, ...)."""

from .increment import Increment, IncrementLock

__all__ = ["Increment", "IncrementLock"]
