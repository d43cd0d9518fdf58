"""Observability of the port's checker: the metrics registry, trace
events, the coverage ledger and the wave-timeline attribution.

The port's copies of the JAX package's ``telemetry`` modules that it uses
(``metrics``, ``trace`` without its ``jax.profiler`` bridge,
``coverage`` with its device reduction rewritten in torch,
``instruments``, ``attribution`` with its fence and profiler window
rewritten in torch, and of ``server`` the registry lint
(``sanitize_metric_name``, ``registry_hygiene_problems``) and the service's
``StallWatchdog``). Nothing here imports JAX or the JAX package.
"""

from .attribution import (
    DEFAULT_TOLERANCE,
    DEVICE_PHASES,
    HOST_OVERLAPPABLE_PHASES,
    PHASES,
    WaveAttribution,
    parse_profile_device_busy,
)
from .coverage import (
    DEPTH_BINS,
    BlockCoverage,
    CoverageLedger,
    DeviceCoverage,
    coverage_action_labels,
    sanitize_component,
)
from .instruments import (
    BlockInstruments,
    CommsInstruments,
    TenantInstruments,
    WaveInstruments,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    discard_run_registry,
    metrics_registry,
    run_registries,
)
from .server import StallWatchdog, registry_hygiene_problems, sanitize_metric_name
from .trace import JsonlSink, RunScopedTracer, Tracer, get_tracer, instant, span

__all__ = [
    "DEFAULT_TOLERANCE",
    "DEPTH_BINS",
    "DEVICE_PHASES",
    "HOST_OVERLAPPABLE_PHASES",
    "PHASES",
    "WaveAttribution",
    "parse_profile_device_busy",
    "BlockCoverage",
    "BlockInstruments",
    "CommsInstruments",
    "Counter",
    "CoverageLedger",
    "DeviceCoverage",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "RunScopedTracer",
    "StallWatchdog",
    "TenantInstruments",
    "Tracer",
    "WaveInstruments",
    "coverage_action_labels",
    "discard_run_registry",
    "get_tracer",
    "instant",
    "metrics_registry",
    "registry_hygiene_problems",
    "run_registries",
    "sanitize_component",
    "sanitize_metric_name",
    "span",
]
