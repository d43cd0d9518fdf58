"""Host-side helpers of the port, and the reference's L0 utility types
(``DenseNatMap``, ``VectorClock``; the JAX package's ``utils`` exports
both)."""

from .dense_nat_map import DenseNatMap
from .vector_clock import VectorClock

__all__ = ["DenseNatMap", "VectorClock"]
