"""Shared runs of the sharded checkers: the port's
``spawn_sharded_gpu_bfs`` on a mesh of ``n`` shards in this process, on the
CPU, and the JAX package's ``spawn_sharded_tpu_bfs`` on a mesh of the first
``n`` virtual CPU devices (``tests/conftest.py``), at the same knobs.

``summary`` gives what the two must share: counts, depth, each discovery's
fingerprint and its path's fingerprints (the parent map's chain), and the
exchange's lanes shipped and rungs dispatched from the run's own registry.
Every run here takes a run id starting ``tsh-``, so the modules that use
them drop both packages' run registries at their end (``discard``).
"""

import itertools

import jax
import numpy as np
from jax.sharding import Mesh

from stateright_tpu.telemetry import discard_run_registry as jax_discard_run_registry
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu.telemetry import run_registries as jax_run_registries
from stateright_tpu_torch.parallel import default_mesh
from stateright_tpu_torch.telemetry import discard_run_registry, run_registries

_ids = itertools.count()
_RUNG = "sharded_bfs.comms.rung_dispatch."


def summary(checker, registry) -> dict:
    """Counts, depth, discoveries by fingerprint, each discovery's path as
    fingerprints, and the comms ledger of ``registry``."""
    checker._ingest_wave_log()
    snap = registry.snapshot()
    return {
        "unique": checker.unique_state_count(),
        "states": checker.state_count(),
        "depth": checker.max_depth(),
        "discoveries": dict(sorted(checker._discoveries_fp.items())),
        "paths": {k: [int(x) for x in checker._store.chain(fp)]
                  for k, fp in sorted(checker._discoveries_fp.items())},
        "lanes_shipped": snap.get("sharded_bfs.comms.lanes_shipped", 0),
        "killed": snap.get("sharded_bfs.comms.sieve.killed", 0),
        "rungs": {int(k[len(_RUNG):]): v for k, v in sorted(snap.items())
                  if k.startswith(_RUNG)},
    }


def jax_run(builder, n, **kw):
    """``builder.spawn_sharded_tpu_bfs`` on the first ``n`` virtual devices,
    joined; returns ``(checker, summary)``."""
    run_id = f"tsh-jax-{next(_ids)}"
    mesh = Mesh(np.array(jax.devices()[:n]), ("fp",))
    checker = builder.spawn_sharded_tpu_bfs(mesh=mesh, run_id=run_id, **kw).join()
    assert checker.worker_error() is None
    return checker, summary(checker, jax_metrics_registry(run_id))


def port_run(builder, n, **kw):
    """``builder.spawn_sharded_gpu_bfs`` with ``n`` shards on the CPU, joined;
    returns ``(checker, summary)``."""
    run_id = f"tsh-port-{next(_ids)}"
    checker = builder.spawn_sharded_gpu_bfs(mesh=default_mesh(n, device="cpu"),
                                            run_id=run_id, **kw).join()
    assert checker.worker_error() is None
    return checker, summary(checker, checker.metrics())


def paths_replay(checker):
    """Every discovery's path replays through the host model."""
    for path in checker.discoveries().values():
        assert path.into_states()


def discard():
    """Drops both packages' ``tsh-`` run registries."""
    for run_id in list(jax_run_registries()):
        if run_id.startswith("tsh-"):
            jax_discard_run_registry(run_id)
    for run_id in list(run_registries()):
        if run_id.startswith("tsh-"):
            discard_run_registry(run_id)
