"""Per-backend instrument bundles.

The port's copy of the JAX package's ``telemetry/instruments.py``: the
device wave loop's bundle (``WaveInstruments``, which the tenant-packed
engine records its shared waves into), the packed tenants' own
(``TenantInstruments``), the host engines' (``BlockInstruments``) and the
sharded checker's exchange ledger (``CommsInstruments``). Each bundle is
the one place its names and shape live.
"""

from __future__ import annotations

from .metrics import MetricsRegistry, metrics_registry


class WaveInstruments:
    """Counters/gauges/histogram for a device checker's wave loop, named
    ``<prefix>.waves`` etc., plus the canonical per-wave recording."""

    def __init__(self, prefix: str, registry: MetricsRegistry = None):
        reg = registry if registry is not None else metrics_registry()
        self._prefix = prefix
        self._registry = reg
        self.waves = reg.counter(f"{prefix}.waves")
        self.drains = reg.counter(f"{prefix}.drains")
        self.generated = reg.counter(f"{prefix}.states_generated")
        self.unique = reg.counter(f"{prefix}.states_unique")
        self.table_grows = reg.counter(f"{prefix}.table_grows")
        self.occupancy = reg.gauge(f"{prefix}.hashset_occupancy")
        self.capacity = reg.gauge(f"{prefix}.hashset_capacity")
        self.depth = reg.gauge(f"{prefix}.max_depth")
        self.warmup = reg.gauge(f"{prefix}.warmup_seconds")
        self.wave_new = reg.histogram(f"{prefix}.wave_new_unique")
        # Occupancy-adaptive dispatch: the bucket width the last wave ran
        # at, the live-lane fraction of that bucket (compaction ratio),
        # and the live fraction of the configured F_max (frontier fill).
        self.bucket = reg.gauge(f"{prefix}.wave_bucket")
        self.compaction = reg.gauge(f"{prefix}.compaction_ratio")
        self.frontier_fill = reg.gauge(f"{prefix}.frontier_fill")
        # Per-bucket dispatch counters, created lazily per width so the
        # registry only carries the ladder rungs a run actually used.
        self._bucket_counters = {}

    def bucket_dispatch(self, width: int, n: int = 1) -> None:
        """Counts ``n`` wave dispatches at ``width`` lanes (one counter
        per ladder rung: ``<prefix>.bucket_dispatch.<width>``)."""
        c = self._bucket_counters.get(width)
        if c is None:
            c = self._registry.counter(
                f"{self._prefix}.bucket_dispatch.{width}"
            )
            self._bucket_counters[width] = c
        c.inc(n)

    def record(
        self,
        span,
        *,
        frontier: int,
        generated: int,
        n_new: int,
        occupancy: float,
        capacity: int,
        max_depth: int,
        count_wave: bool = True,
        observe: bool = True,
        phase: str = None,
        bucket: int = None,
        compaction_ratio: float = None,
        **extra,
    ) -> None:
        """One wave's (or drain-aggregate's) telemetry: registry updates
        plus — when the caller holds a span open over it — the per-wave
        args. Drain aggregates pass ``count_wave=False``/``observe=False``
        and account their wave tally separately (the final unconsumed
        wave is consumed, and counted, host-side). ``bucket`` /
        ``compaction_ratio`` ride the span when the backend dispatched
        through the occupancy-adaptive bucket ladder."""
        if count_wave:
            self.waves.inc()
        self.generated.inc(generated)
        self.unique.inc(n_new)
        if observe:
            self.wave_new.observe(n_new)
        self.occupancy.set(occupancy)
        self.capacity.set(capacity)
        self.depth.set(max_depth)
        if span is not None:
            if phase is not None:
                extra["phase"] = phase
            if bucket is not None:
                extra["bucket"] = bucket
            if compaction_ratio is not None:
                extra["compaction_ratio"] = compaction_ratio
            span.set(
                frontier=frontier,
                generated=generated,
                new_unique=n_new,
                dedup_hit_rate=(
                    (generated - n_new) / generated if generated else 0.0
                ),
                occupancy=occupancy,
                capacity=capacity,
                max_depth=max_depth,
                **extra,
            )


class CommsInstruments:
    """The sharded checker's cross-shard exchange ledger, named
    ``<prefix>.comms.*`` (the JAX package's names): lanes that entered the
    router and lanes the receipt cache dropped, the Bloom filter's probes
    and counted false positives, the lanes and bytes the exchange shipped,
    exchanges by rung width, and the bytes an eviction exchange put on the
    wire. Fed from each wave's comms vector, so it counts what the
    exchange shipped."""

    # Wire cost of a shipped lane: 8 key bytes out, 1 flag byte back.
    LANE_BYTES = 9

    def __init__(self, prefix: str, registry: MetricsRegistry = None):
        reg = registry if registry is not None else metrics_registry()
        p = f"{prefix}.comms"
        self._prefix = p
        self._registry = reg
        self.sieve_probes = reg.counter(f"{p}.sieve.probes")
        self.sieve_killed = reg.counter(f"{p}.sieve.killed")
        self.bloom_probes = reg.counter(f"{p}.sieve.bloom_probe_total")
        self.bloom_fps = reg.counter(f"{p}.sieve.bloom_fp_total")
        self.lanes_shipped = reg.counter(f"{p}.lanes_shipped")
        self.bytes_shipped = reg.counter(f"{p}.bytes_shipped")
        self.evict_wire_bytes = reg.counter(f"{p}.evict_wire_bytes")
        self.kill_rate = reg.gauge(f"{p}.sieve.kill_rate")
        self.fp_rate = reg.gauge(f"{p}.sieve.bloom_fp_rate")
        self._rung_counters = {}

    def rung_dispatch(self, width: int, n: int = 1) -> None:
        """Counts ``n`` exchanges at rung ``width`` lanes a destination
        (``<prefix>.comms.rung_dispatch.<width>``)."""
        c = self._rung_counters.get(width)
        if c is None:
            c = self._registry.counter(f"{self._prefix}.rung_dispatch.{width}")
            self._rung_counters[width] = c
        c.inc(n)

    def record(self, *, probes: int, killed: int, bloom_probes: int, bloom_hits: int,
               bloom_fps: int, lanes: int) -> dict:
        """One wave's (or a drain's) exchange totals; returns the span
        arguments they ride on."""
        self.sieve_probes.inc(probes)
        self.sieve_killed.inc(killed)
        self.bloom_probes.inc(bloom_probes)
        self.bloom_fps.inc(bloom_fps)
        self.lanes_shipped.inc(lanes)
        self.bytes_shipped.inc(lanes * self.LANE_BYTES)
        if probes:
            self.kill_rate.set(killed / probes)
        if bloom_probes:
            self.fp_rate.set(bloom_fps / bloom_probes)
        return {
            "comms_probes": probes,
            "comms_killed": killed,
            "comms_bloom_probes": bloom_probes,
            "comms_bloom_hits": bloom_hits,
            "comms_bloom_fps": bloom_fps,
            "comms_lanes": lanes,
            "comms_bytes": lanes * self.LANE_BYTES,
        }


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


class TenantInstruments:
    """Per-tenant counters/gauges for the tenant-packed wave engine
    (``checker/packed_tenancy.py``), named ``<prefix>.tenant.*`` and
    recorded into the tenant's run-scoped registry, so a packed run's
    metrics carry its own lane accounting though the waves are shared. One
    bundle per admitted tenant; the engine-wide quantities of the shared
    waves ride a ``WaveInstruments`` bundle in the engine's registry."""

    def __init__(self, prefix: str, registry: MetricsRegistry = None):
        reg = registry if registry is not None else metrics_registry()
        p = f"{prefix}.tenant"
        self.joins = reg.counter(f"{p}.joins")
        self.waves = reg.counter(f"{p}.waves")
        self.lanes = reg.counter(f"{p}.lanes_dispatched")
        self.generated = reg.counter(f"{p}.states_generated")
        self.unique = reg.counter(f"{p}.states_unique")
        self.stale = reg.counter(f"{p}.storage_stale")
        self.lane_drops = reg.counter(f"{p}.preempt_lane_drops")
        self.lane_share = reg.gauge(f"{p}.lane_share")
        self.pending = reg.gauge(f"{p}.pending_lanes")
        self.depth = reg.gauge(f"{p}.max_depth")

    def record_wave(self, *, lanes: int, width: int, generated: int,
                    n_new: int, pending: int, max_depth: int) -> None:
        """One packed wave's slice of this tenant's accounting (only
        called for waves the tenant had lanes in)."""
        self.waves.inc()
        self.lanes.inc(lanes)
        self.generated.inc(generated)
        self.unique.inc(n_new)
        self.lane_share.set(lanes / width if width else 0.0)
        self.pending.set(pending)
        self.depth.set(max_depth)
