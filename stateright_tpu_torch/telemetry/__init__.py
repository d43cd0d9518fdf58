"""Observability of the port's checker: the metrics registry, trace
events and the coverage ledger.

The port's copies of the JAX package's ``telemetry`` modules that it uses
(``metrics``, ``trace`` without its ``jax.profiler`` bridge, and
``coverage`` with its device reduction rewritten in torch). Nothing here
imports JAX or the JAX package.
"""

from .coverage import (
    DEPTH_BINS,
    CoverageLedger,
    DeviceCoverage,
    coverage_action_labels,
    sanitize_component,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, metrics_registry
from .trace import JsonlSink, Tracer, get_tracer, instant, span

__all__ = [
    "DEPTH_BINS",
    "Counter",
    "CoverageLedger",
    "DeviceCoverage",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "Tracer",
    "coverage_action_labels",
    "get_tracer",
    "instant",
    "metrics_registry",
    "sanitize_component",
    "span",
]
