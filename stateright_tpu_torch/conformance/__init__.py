"""Conformance plane: device-batched trace replay + consistency
auditing as a traffic class, on the card.

The port of the JAX package's ``conformance`` package. Every entry point
runs on ``"cuda"`` unless ``device="cpu"`` is passed, and raises without
a CUDA device.

- ``wire`` — the versioned JSONL ingestion format (honest refusals,
  shape bucketing).
- ``replay`` — batched trace-conformance replay over the packed model
  (first-divergence verdicts; one CUDA Graph a shape on the card) + the
  host oracle.
- ``audit`` — batched device linearizability / sequential-consistency
  auditing (register DP, vec lane grid) + the host-tester oracle.
- ``checker`` — the ``Checker``-shaped worker for uploads.
- ``corpus`` — labeled corpus generators (clean/mutated traces,
  clean/random/invalid histories) for benches and parity suites.
"""

from .audit import (
    MAX_VEC_LANES,
    PackedVecHistory,
    audit_batch,
    audit_kernel,
    clear_audit_kernels,
    host_is_consistent,
    pack_history,
)
from .checker import ConformanceChecker, bucket_label
from .corpus import (
    generate_corpus,
    mutate_trace,
    random_history,
    random_walk_trace,
)
from .replay import (
    clear_replay_kernels,
    replay_batch,
    replay_host,
    replay_kernel,
    validate_trace,
)
from .wire import (
    WIRE_VERSION,
    WireRefusal,
    bucket_key,
    bucket_records,
    decode_frame,
    decode_lines,
    encode_record,
    history_shape,
)

__all__ = [
    "MAX_VEC_LANES",
    "PackedVecHistory",
    "WIRE_VERSION",
    "WireRefusal",
    "ConformanceChecker",
    "audit_batch",
    "audit_kernel",
    "bucket_key",
    "bucket_label",
    "bucket_records",
    "clear_audit_kernels",
    "clear_replay_kernels",
    "decode_frame",
    "decode_lines",
    "encode_record",
    "generate_corpus",
    "history_shape",
    "host_is_consistent",
    "mutate_trace",
    "pack_history",
    "random_history",
    "random_walk_trace",
    "replay_batch",
    "replay_host",
    "replay_kernel",
    "validate_trace",
]
