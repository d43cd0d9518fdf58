"""Host-side helpers of the port, and the reference's L0 utility types
(``DenseNatMap``, ``VectorClock``), the fault injection layer and the
card's artifact cache (``compile_cache.py``): what the JAX package's
``utils`` exports."""

from .dense_nat_map import DenseNatMap
from .faults import (
    FaultInjector,
    FaultSpec,
    classify_fault,
    fault_point,
    inject,
    seeded_specs,
)
from .vector_clock import VectorClock

__all__ = [
    "DenseNatMap",
    "FaultInjector",
    "FaultSpec",
    "VectorClock",
    "classify_fault",
    "fault_point",
    "inject",
    "seeded_specs",
]
