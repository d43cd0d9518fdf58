"""The registered model zoo: the names a conformance upload (and, with the
service, a job) may ask for.

The port's copy of the JAX package's ``service/zoo.py``. Each entry is a
factory taking JSON-friendly kwargs and returning one of the port's
``BatchableModel``s. The zoo doubles as the cache namespace: two uploads
naming the same zoo entry with the same args share the process-global
replay graphs (``conformance/replay.py``), so a resident process replays a
hot shape without capturing it again.
"""

from __future__ import annotations

from typing import Callable, Dict


def _two_phase(rm_count=5, **kw):
    from ..models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(int(rm_count), **kw)


def _abd(clients=2, servers=2, ordered=False, **kw):
    from ..models.linearizable_register import AbdModelCfg

    if ordered:
        from ..actor import Network

        kw.setdefault("network", Network.new_ordered())
    return AbdModelCfg(int(clients), int(servers), **kw).into_model()


def _paxos(clients=2, servers=3, **kw):
    from ..models.paxos import PaxosModelCfg

    return PaxosModelCfg(int(clients), int(servers), **kw).into_model()


def _increment_lock(threads=4, **kw):
    from ..models.increment import IncrementLock

    return IncrementLock(int(threads), **kw)


def _raft(server_count=5, max_term=1, lossy=True, retain=None, **kw):
    from ..models.raft import RaftModelCfg

    model = RaftModelCfg(
        server_count=int(server_count), max_term=int(max_term),
        lossy=bool(lossy), **kw
    ).into_model()
    if retain:
        model = model.retain_properties(
            *(retain if isinstance(retain, (list, tuple)) else [retain])
        )
    return model


def _single_copy(clients=4, servers=1, **kw):
    from ..models.single_copy_register import SingleCopyModelCfg

    return SingleCopyModelCfg(int(clients), int(servers), **kw).into_model()


def _sharded_kv(shards=2, keys=2, max_version=1, guarded=False, **kw):
    from ..models.sharded_kv import ShardedKv

    return ShardedKv(
        int(shards), int(keys), int(max_version), guarded=bool(guarded),
        **kw,
    )


def default_zoo() -> Dict[str, Callable]:
    """Name -> model factory (the JAX bench legs' model set).
    Import-light: factories import their model lazily."""
    return {
        "2pc": _two_phase,
        "two_phase_commit": _two_phase,
        "abd": _abd,
        "linearizable_register": _abd,
        "paxos": _paxos,
        "increment_lock": _increment_lock,
        "raft": _raft,
        "single_copy_register": _single_copy,
        # The too-big-to-enumerate swarm workload (S=4, keys=8 is ~10^14
        # states; the default config is the exhaustively-checkable parity
        # size).
        "sharded_kv": _sharded_kv,
    }


def warm_shapes():
    """The ``(name, args)`` pairs a warm pool prepares at start: the
    default configurations of the zoo's small always-checkable workloads.
    Kept deliberately short."""
    return [
        ("2pc", {}),
        ("abd", {}),
        ("increment_lock", {}),
    ]


def aot_namespace(model_name: str, model_args: dict) -> str:
    """Deterministic cache namespace for one zoo configuration: the name
    plus the sorted args. Runs sharing it assert their models are
    configured identically, which the zoo guarantees — same factory, same
    args."""
    args = ",".join(f"{k}={model_args[k]!r}" for k in sorted(model_args))
    return f"zoo:{model_name}({args})"
