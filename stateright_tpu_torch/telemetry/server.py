"""The metric-registry lint of the live monitor: Prometheus names.

The port's copy of the naming part of the JAX package's
``telemetry/server.py`` (``sanitize_metric_name`` and
``registry_hygiene_problems``): every dotted registry name must map to one
Prometheus family of its own. The conformance plane's seed-corpus gate
reads the lint; the monitor server itself (``MonitorCore``,
``prometheus_text``, the stall watchdog and the flight recorder) waits for
the port of the service.
"""

from __future__ import annotations

import re
from typing import Dict, List

from .metrics import Counter, MetricsRegistry, metrics_registry

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str, prefix: str = "stateright") -> str:
    """Dotted registry names to the Prometheus grammar: illegal chars
    become ``_``, a namespace prefix keeps them collision-free, and a
    leading digit (impossible after the prefix, kept for prefix="")
    gets an underscore."""
    out = _NAME_SANITIZE.sub("_", name)
    if prefix:
        out = f"{prefix}_{out}"
    if out and out[0].isdigit():
        out = "_" + out
    return out


def registry_hygiene_problems(registry: MetricsRegistry = None,
                              prefix: str = "stateright") -> List[str]:
    """The metric-registry lint: every registered name must survive the
    Prometheus sanitizer without colliding with a different registered
    name — two dotted names mapping to one exposition family would
    silently merge unrelated series. Counters are checked at their
    exported ``_total`` spelling, so a counter ``x.y`` and a gauge
    ``x.y_total`` collide too. Returns human-readable problem strings
    (empty == clean)."""
    reg = registry if registry is not None else metrics_registry()
    seen: Dict[str, str] = {}
    problems: List[str] = []
    for name, inst in reg.instruments():
        exported = sanitize_metric_name(name, prefix)
        if isinstance(inst, Counter):
            exported += "_total"
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", exported):
            problems.append(
                f"{name!r} sanitizes to non-Prometheus name {exported!r}"
            )
            continue
        other = seen.get(exported)
        if other is not None and other != name:
            problems.append(
                f"{name!r} and {other!r} both export as {exported!r}"
            )
        seen[exported] = name
    return problems
