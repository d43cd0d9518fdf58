"""Per-backend instrument bundles.

The port's copy of the JAX package's ``telemetry/instruments.py``, so far
with its host engines' bundle only: every host engine records the same
quantities per block, and this bundle is the one place that shape lives.
"""

from __future__ import annotations

from .metrics import MetricsRegistry, metrics_registry


class BlockInstruments:
    """Counters/histogram for a host engine's per-block loop
    (``bfs.block`` / ``dfs.block`` / ``on_demand.block``)."""

    def __init__(self, prefix: str, registry: MetricsRegistry = None):
        reg = registry if registry is not None else metrics_registry()
        self.blocks = reg.counter(f"{prefix}.blocks")
        self.evaluated = reg.counter(f"{prefix}.states_evaluated")
        self.generated = reg.counter(f"{prefix}.states_generated")
        self.block_width = reg.histogram(f"{prefix}.block_states")

    def record(
        self, span, *, evaluated: int, generated: int, max_depth: int,
        unique_total: int, pending: int = None,
    ) -> None:
        """Closes out one block: registry updates + the block span's
        late-bound args (the span is entered by the caller around the
        block body and exited here). ``pending`` is the worker's live
        outstanding-work count — the monitor's frontier fit reads it
        (``evaluated`` is a block-width constant, useless for ETA)."""
        self.blocks.inc()
        self.evaluated.inc(evaluated)
        self.generated.inc(generated)
        self.block_width.observe(evaluated)
        extra = {} if pending is None else {"pending": pending}
        span.set(
            evaluated=evaluated,
            generated=generated,
            max_depth=max_depth,
            unique_total=unique_total,
            **extra,
        ).__exit__(None, None, None)
