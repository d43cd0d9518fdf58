"""Out-of-core tiered visited-fingerprint store.

The port's copy of the tiering surface of the JAX package's ``storage``
package: the GPU checker's visited set grows by doubling + rehash until the
table would pass ``hbm_budget_mib``; past it the layout has three tiers
behind a batched probe/evict API:

- **L0** — the device hash table, capped by the checker's
  ``hbm_budget_mib``: when growth would exceed the budget, the full table
  drains to the host and resets, keeping only the working set on device.
- **L1** — evicted fingerprints as host-resident, delta-compressed sorted
  runs (``runs.py``) fronted by a per-run Bloom filter (``bloom.py``, <1%
  false positives). Runs merge LSM-style when their count passes a
  threshold.
- **L2** — merged runs spill to files under ``spill_dir`` when host bytes
  pass ``host_budget_mib``, in the same format, so probes are uniform.

Wave dedup becomes a two-phase probe: the device table filters first, then
the L0-fresh keys of each wave batch-probe L1/L2 on the host. The union of
the tiers is exactly the visited set, so a key reports fresh iff it was
never seen, and results are bit-identical to the single-tier run.

``edge_log.py`` is the host tier of the device liveness edge log
(``LivenessEdgeStore``: the condition-false edges, deduped, spilled past
``host_budget_mib``, with the roots and terminals). ``TenantPartitions``
keeps one tiered store for each tenant of the tenant-packed engine.
``corpus.py`` is the named conformance-corpus store (``CorpusStore``: one
JSONL file of wire frames a validated name). ``persist.py`` is the check
service's warm-start plane: the fenced disk record of a namespace's kernels
(``AotDiskStore``) and the finished-run seeds
(``SeedStore``, keyed on ``model_structure_signature``). Nothing here
imports JAX or the JAX package.
"""

from .bloom import BloomFilter
from .corpus import CorpusStore, validate_corpus_name
from .edge_log import LivenessEdgeStore, LivenessInstruments
from .persist import (
    AotDiskBinding,
    AotDiskStore,
    SeedStore,
    adapt_seed_checkpoint,
    aot_fence,
    build_seed_artifact,
    model_structure_signature,
    seed_compatibility,
)
from .runs import (
    RUN_BLOCK,
    FingerprintRun,
    decode_sorted_fps,
    decode_varint_u64,
    encode_sorted_fps,
    encode_varint_u64,
)
from .tiered import (
    StorageInstruments,
    TenantPartitions,
    TieredVisitedStore,
    max_table_rows_for_budget,
    table_budget_mib,
    validate_budget_knobs,
)

__all__ = [
    "AotDiskBinding",
    "AotDiskStore",
    "BloomFilter",
    "CorpusStore",
    "FingerprintRun",
    "SeedStore",
    "adapt_seed_checkpoint",
    "aot_fence",
    "build_seed_artifact",
    "model_structure_signature",
    "seed_compatibility",
    "LivenessEdgeStore",
    "LivenessInstruments",
    "RUN_BLOCK",
    "StorageInstruments",
    "TenantPartitions",
    "TieredVisitedStore",
    "decode_sorted_fps",
    "decode_varint_u64",
    "encode_sorted_fps",
    "encode_varint_u64",
    "max_table_rows_for_budget",
    "table_budget_mib",
    "validate_budget_knobs",
    "validate_corpus_name",
]
