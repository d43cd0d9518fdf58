"""Warm-start persistence: the disk record of a namespace's kernels and the
finished-run seed store.

The port's counterpart of the JAX package's ``storage/persist.py``. Two
planes share this module because they share one discipline: **refuse,
never mis-execute**.

- **``AotDiskStore``**: content-addressed records under
  ``CheckService(service_dir=)/aot/``, keyed on a checker's cache namespace
  (``aot_cache``), its configuration signature and a per-record key. The JAX
  package stores serialized XLA executables here; the port has none to
  store. A captured CUDA Graph binds the addresses of one checker's buffers,
  so no graph outlives its run, and the kernels are libraries that
  ``ops/_build.py`` builds once per source in the checkout. A record holds
  what a namespace's runs need on the card: the kernels they launch, with
  their build digests. A hit lets a process load those kernels before its
  first wave (through ``ops/_build.load``, under the build cache's lock). Every
  record carries a *fence* (torch's version, the CUDA runtime's, the card's
  name, capability and count, a digest of ``csrc/``), checked on load: a
  fence mismatch or a torn pickle is counted (``aot_cache.refused_stale``,
  ``aot_cache.refused_corrupt``) and treated as a miss.

- **``SeedStore``**: finished-run seeds under ``service_dir/seeds/``: the
  run's completion checkpoint with its visited keys rewritten as one sorted
  ``FingerprintRun`` (with its Bloom filter), keyed by a model-structure
  signature. On resubmission of a compatible model the service attaches
  the seed as ``resume_from=``: the tiered store's L1 loads from the run
  (CRC-checked, the O(verify) cost), the table and the frontier are empty,
  and the run completes without exploring.

The signature is structural, never behavioural (``model_structure_signature``):
a digest of the code objects (bytecode, constants, names, closure cell
values) of the model's methods and of every function, class and object
they reach: module-level names, directly or through a module alias
(``pr.f``), and the objects the model holds with their classes' members
(an actor model's transitions run through ``self.codec``); of the model's
instance attributes; and of the init batch's values. The
JAX package digests each action's traced jaxpr; the port's models expand
every action in one ``packed_expand``, so no action can be isolated and
every action's digest is the whole transition's. Any edit of the
transition then changes every action's digest and lands on the full
recheck, which is the sound side: the JAX package's one admitted edit
class beyond identity (removing a provably dead action) falls back to a
full recheck here.
"""

from __future__ import annotations

import enum
import functools
import hashlib
import os
import pickle
import tempfile
import types
from typing import List, Optional, Tuple

import numpy as np

from ..telemetry.metrics import metrics_registry
from ..utils.faults import fault_point
from .runs import FingerprintRun

__all__ = [
    "AotDiskStore",
    "AotDiskBinding",
    "aot_fence",
    "SeedStore",
    "model_structure_signature",
    "build_seed_artifact",
    "seed_compatibility",
    "adapt_seed_checkpoint",
]

AOT_FORMAT = "stateright-torch-aot-v1"
SEED_FORMAT = "stateright-warmstart-seed-v1"


def _digest(*parts) -> str:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x1f")
    return h.hexdigest()


def _atomic_write_bytes(path: str, blob: bytes) -> None:
    """tmp + rename in the artifact's directory: a torn write leaves a
    stray tmp file, never a half-length artifact under the final name."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# Disk record store
# ---------------------------------------------------------------------------


def csrc_digest() -> str:
    """Digest of every kernel source and header under ``csrc/``."""
    from ..ops._build import CSRC

    h = hashlib.blake2b(digest_size=16)
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()


def aot_fence() -> dict:
    """The environment a record is only valid under: torch's version, the
    CUDA runtime's, the card (name, capability, count; ``"cpu"`` without
    one) and the kernels' sources. A mismatch refuses the record."""
    import torch

    from ..utils.compile_cache import _target_tag

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        capability = f"sm_{major}{minor}"
        count = torch.cuda.device_count()
    else:
        kind, capability, count = "cpu", None, 0
    return {
        "format": AOT_FORMAT,
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "device_kind": kind,
        "capability": capability,
        "device_count": count,
        "target": _target_tag(),
        "csrc": csrc_digest(),
    }


class AotDiskStore:
    """Content-addressed record files under ``root``. The store itself is
    namespace- and signature-agnostic; checkers attach through
    :meth:`binding`, which closes over their namespace and signature and
    counts hits, misses and refusals into the run's registry (the
    ``aot_cache.*`` family)."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._fence = None

    def fence(self) -> dict:
        if self._fence is None:
            self._fence = aot_fence()
        return self._fence

    def entry_path(self, namespace, signature, kind: str, key) -> str:
        return os.path.join(self.root, f"{_digest(namespace, signature, kind, key)}.aotx")

    def load_entry(self, namespace, signature, kind: str, key) -> Tuple[Optional[dict], str]:
        """``(record, outcome)``, outcome one of ``"hit"``, ``"miss"``,
        ``"stale"``, ``"corrupt"``. Anything but a checked fence match is a
        miss of some kind; the record is never used on doubt."""
        path = self.entry_path(namespace, signature, kind, key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None, "miss"
        try:
            entry = pickle.loads(blob)
            if not isinstance(entry, dict) or entry.get("format") != AOT_FORMAT:
                return None, "corrupt"
            record = entry["record"]
            if not isinstance(record, dict):
                return None, "corrupt"
        except Exception:
            return None, "corrupt"
        if entry.get("fence") != self.fence():
            return None, "stale"
        return record, "hit"

    def save_entry(self, namespace, signature, kind: str, key, record: dict) -> bool:
        """Best-effort persist (a full disk never fails a run). The blob is
        read back before it is written: a record that does not round-trip
        is refused, so the store holds only loadable entries."""
        try:
            blob = pickle.dumps(
                {
                    "format": AOT_FORMAT,
                    "fence": self.fence(),
                    "namespace": namespace,
                    "kind": kind,
                    "record": record,
                },
                protocol=pickle.HIGHEST_PROTOCOL,
            )
            if pickle.loads(blob)["record"] != record:
                return False
            _atomic_write_bytes(self.entry_path(namespace, signature, kind, key), blob)
            return True
        except Exception:
            return False

    def binding(self, namespace, signature, registry=None) -> "AotDiskBinding":
        return AotDiskBinding(self, namespace, signature, registry=registry)


class AotDiskBinding:
    """One checker's view of the store: namespace and signature fixed,
    one counter an outcome in the run's registry."""

    def __init__(self, store: AotDiskStore, namespace, signature, registry=None):
        reg = registry if registry is not None else metrics_registry()
        self._store = store
        self._namespace = namespace
        self._signature = signature
        self.disk_hit = reg.counter("aot_cache.disk_hit")
        self.disk_miss = reg.counter("aot_cache.disk_miss")
        self.refused_stale = reg.counter("aot_cache.refused_stale")
        self.refused_corrupt = reg.counter("aot_cache.refused_corrupt")
        self.saved = reg.counter("aot_cache.saved")
        self.save_refused = reg.counter("aot_cache.save_refused")
        self._known = set()  # keys confirmed present on disk

    def ensure(self, kind: str, key, record: dict) -> None:
        """Writes the record unless one is already on disk (one existence
        check a key a binding, no counter churn when it is)."""
        k = (kind, key)
        if k in self._known:
            return
        self._known.add(k)
        if os.path.exists(self._store.entry_path(self._namespace, self._signature, kind, key)):
            return
        self.save(kind, key, record)

    def load(self, kind: str, key) -> Optional[dict]:
        record, outcome = self._store.load_entry(self._namespace, self._signature, kind, key)
        if outcome == "hit":
            self.disk_hit.inc()
            self._known.add((kind, key))
        elif outcome == "stale":
            self.refused_stale.inc()
        elif outcome == "corrupt":
            self.refused_corrupt.inc()
        else:
            self.disk_miss.inc()
        return record

    def save(self, kind: str, key, record: dict) -> bool:
        ok = self._store.save_entry(self._namespace, self._signature, kind, key, record)
        if ok:
            self.saved.inc()
            self._known.add((kind, key))
        else:
            self.save_refused.inc()
        return ok


# ---------------------------------------------------------------------------
# Model-structure signature (the seed key and the diff's evidence)
# ---------------------------------------------------------------------------

# Modules whose functions are the library's, not the model's: their code is
# not part of a model's structure (torch's and numpy's, Python's own).
_LIBRARY_PREFIXES = ("torch", "numpy", "builtins", "typing", "functools", "collections",
                     "itertools", "math", "operator", "enum", "abc", "dataclasses",
                     "logging", "threading", "weakref", "contextlib", "types")

# Module-level values a model's code may read by name and that are data.
_PLAIN = (type(None), bool, int, float, complex, str, bytes, tuple, list, dict, set,
          frozenset, enum.Enum, np.ndarray, np.generic)


def _is_library(obj) -> bool:
    if isinstance(obj, types.ModuleType):
        mod = obj.__name__
    else:
        mod = getattr(obj, "__module__", None) or ""
    return mod.split(".")[0] in _LIBRARY_PREFIXES


class _StructureHasher:
    """A deterministic digest of code and values: the same model
    definition gives the same bytes in any process (no ids, no addresses,
    no hash-seeded set order).

    Every function, class and object it reaches is digested whole, once:
    a function's code with the module-level functions, classes and data it
    reads by name (directly or through a module alias, ``pr.f``); a class's
    members (``_class_members``); an object's instance attributes and its
    class's members, so a helper the model calls through an attribute
    (``self.codec.on_msg_branches``) is part of the digest. Library code
    (``_LIBRARY_PREFIXES``) is digested by its name, and a module-level
    dict, list or set named as a cache is left out. A structure deeper
    than ``_MAX_DEPTH`` raises rather than digesting a part of it: the
    caller then seeds nothing."""

    _MAX_DEPTH = 150

    def __init__(self):
        self.h = hashlib.blake2b(digest_size=16)
        self._seen = set()

    def _tag(self, *parts) -> None:
        for p in parts:
            self.h.update(str(p).encode())
            self.h.update(b"\x1f")

    def _first_visit(self, obj, kind: str, name: str) -> bool:
        """False (and a back-reference tag) when ``obj`` was digested
        already; the guard that ends cycles."""
        if id(obj) in self._seen:
            self._tag("seen-" + kind, name)
            return False
        self._seen.add(id(obj))
        return True

    def code(self, co: types.CodeType, globals_=None, depth=0) -> None:
        self._tag("code", co.co_name, co.co_argcount, co.co_kwonlyargcount, co.co_flags)
        self.h.update(co.co_code)
        self._tag("names", co.co_names, co.co_varnames, co.co_freevars, co.co_cellvars)
        for c in co.co_consts:
            if isinstance(c, types.CodeType):
                self.code(c, globals_, depth + 1)
            else:
                self.value(c, depth + 1)
        if globals_ is not None:
            self._globals(co.co_names, globals_, depth + 1)

    def _globals(self, names, globals_, depth) -> None:
        """What ``names`` resolve to in the code's module, and in the
        non-library modules reached from it by attribute (``pr.f``,
        ``a.b.f``): functions, classes, data and objects of the model's own
        classes."""
        scopes = [("", globals_)]
        modules = []
        for _, scope in scopes:
            for name in names:
                v = scope.get(name)
                if (isinstance(v, types.ModuleType) and not _is_library(v)
                        and all(v is not m for m in modules)):
                    modules.append(v)
                    scopes.append((v.__name__ + ".", vars(v)))
        for prefix, scope in scopes:
            for name in names:
                if name not in scope:
                    continue
                v = scope[name]
                if isinstance(v, types.ModuleType) or (
                        isinstance(v, (dict, list, set)) and "cache" in name.lower()):
                    # A module-level memo table (``_CONST_CACHE``) fills as
                    # runs go; the code that fills it is digested.
                    continue
                if isinstance(v, (types.FunctionType, type, functools.partial) + _PLAIN) or (
                        hasattr(v, "__dict__") and not _is_library(type(v))):
                    self._tag("global", prefix + name)
                    self.value(v, depth)

    def function(self, fn, depth=0) -> None:
        if not self._first_visit(fn, "fn", fn.__qualname__):
            return
        self._tag("fn", fn.__qualname__)
        self.code(fn.__code__, fn.__globals__, depth)
        self.value(fn.__defaults__, depth + 1)
        self.value(fn.__kwdefaults__, depth + 1)
        for cell in fn.__closure__ or ():
            try:
                v = cell.cell_contents
            except ValueError:  # an empty cell
                self._tag("empty-cell")
                continue
            self.value(v, depth + 1)

    def members(self, cls, depth=0) -> None:
        """A non-library class's members, its bases' included."""
        if not self._first_visit(cls, "type", cls.__qualname__):
            return
        self._tag("type", cls.__module__, cls.__qualname__)
        for owner, name, attr in _class_members(cls):
            self._tag("member", owner, name)
            self.value(attr, depth + 1)

    def value(self, v, depth=0) -> None:
        import torch

        if depth > self._MAX_DEPTH:
            raise ValueError(f"structure deeper than {self._MAX_DEPTH} levels "
                             f"at {type(v).__qualname__}")
        if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
            self._tag(type(v).__name__, repr(v))
        elif isinstance(v, enum.Enum):
            self._tag("enum", type(v).__qualname__, v.name)
        elif isinstance(v, torch.Tensor):
            arr = v.detach().cpu().numpy()
            self._tag("tensor", arr.shape, arr.dtype)
            self.h.update(arr.tobytes())
        elif isinstance(v, np.ndarray) or isinstance(v, np.generic):
            arr = np.asarray(v)
            self._tag("ndarray", arr.shape, arr.dtype)
            self.h.update(arr.tobytes())
        elif isinstance(v, (tuple, list)):
            self._tag(type(v).__name__, len(v))
            for x in v:
                self.value(x, depth + 1)
        elif isinstance(v, (set, frozenset)):
            items = sorted(v, key=repr)
            self._tag(type(v).__name__, len(items))
            for x in items:
                self.value(x, depth + 1)
        elif isinstance(v, dict):
            items = sorted(v.items(), key=lambda kv: repr(kv[0]))
            self._tag("dict", len(items))
            for k, x in items:
                self.value(k, depth + 1)
                self.value(x, depth + 1)
        elif isinstance(v, types.FunctionType):
            if _is_library(v):
                self._tag("libfn", v.__module__, v.__qualname__)
            else:
                self.function(v, depth + 1)
        elif isinstance(v, functools.partial):
            self._tag("partial")
            self.value(v.func, depth + 1)
            self.value(v.args, depth + 1)
            self.value(v.keywords, depth + 1)
        elif isinstance(v, types.MethodType):
            # The receiver's attributes are the model's, digested with its
            # transition.
            self._tag("method", type(v.__self__).__qualname__)
            self.value(v.__func__, depth + 1)
        elif isinstance(v, type):
            if _is_library(v):
                self._tag("libtype", v.__module__, v.__qualname__)
            else:
                self.members(v, depth + 1)
        elif isinstance(v, types.CodeType):
            self.code(v, None, depth + 1)
        elif isinstance(v, types.ModuleType):
            self._tag("module", v.__name__)
        elif _is_library(type(v)) and not hasattr(v, "__dict__"):
            # Builtins, library callables and values (``torch.int32``): their
            # identity, or their repr where it holds no address.
            r = repr(v)
            self._tag("lib", type(v).__qualname__, getattr(v, "__module__", ""),
                      getattr(v, "__qualname__", ""), "" if " at 0x" in r else r)
        else:
            if not self._first_visit(v, "obj", type(v).__qualname__):
                return
            self._tag("obj", type(v).__module__, type(v).__qualname__)
            if not _is_library(type(v)):
                self.members(type(v), depth + 1)
            if hasattr(v, "__dict__"):
                self.value(dict(vars(v)), depth + 1)
            for klass in type(v).__mro__:
                for slot in _slot_names(klass):
                    self._tag("slot", slot)
                    self.value(getattr(v, slot, None), depth + 1)

    def hexdigest(self) -> str:
        return self.h.hexdigest()


def _slot_names(klass):
    slots = vars(klass).get("__slots__", ())
    if isinstance(slots, str):
        slots = (slots,)
    return [s for s in slots if s not in ("__dict__", "__weakref__")]


def _class_members(cls):
    """``(owner qualname, name, value)`` for every member defined on the
    model's classes (its MRO, library classes left out), in a fixed order:
    functions, static and class methods and property getters as their
    functions, other class attributes as values. Dunders count only as
    code (``__init__``, ``__call__``): their data (``__doc__``,
    ``__module__``) is not behaviour."""
    out = []
    for klass in cls.__mro__:
        if klass is object or _is_library(klass):
            continue
        for name in sorted(vars(klass)):
            attr = vars(klass)[name]
            if isinstance(attr, (staticmethod, classmethod)):
                attr = attr.__func__
            elif isinstance(attr, property):
                attr = (attr.fget, attr.fset, attr.fdel)
            if (name.startswith("__") and name.endswith("__")
                    and not isinstance(attr, (types.FunctionType, tuple))):
                continue
            out.append((klass.__qualname__, name, attr))
    return out


def _structure_digest(obj) -> str:
    """The digest of one object's structure: for the model, the code of
    its methods and of everything they reach, its class attributes and its
    instance attributes; for a callable, its code and what it closes over."""
    h = _StructureHasher()
    h.value(obj)
    return h.hexdigest()


def _init_digest(model) -> str:
    """Digest of the init batch's values, leaf by leaf (the params half of
    the signature: two configurations with one transition structure but
    other initial contents never share seeds)."""
    from ..core.batch import leaves

    h = hashlib.blake2b(digest_size=16)
    for leaf in leaves(model.packed_init_states("cpu")):
        arr = leaf.detach().cpu().numpy()
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def model_structure_signature(model) -> dict:
    """The ``(model structure, params)`` signature incremental re-checking
    keys on, in the JAX package's fields. ``actions`` holds one digest an
    action; the port's models expand every action in one call, so each is
    the whole transition's digest (module docstring)."""
    from ..ops.fingerprint import FP_SCHEME
    from ..telemetry.coverage import coverage_action_labels

    A = int(model.packed_action_count())
    transition = _structure_digest(model)
    conditions = model.packed_conditions()
    properties = [
        [p.name, str(p.expectation), _structure_digest(cond)]
        for p, cond in zip(model.properties(), conditions)
    ]
    sig = {
        "format": 1,
        "fp_scheme": FP_SCHEME,
        "model": type(model).__name__,
        "action_count": A,
        "labels": coverage_action_labels(model, A),
        "init": _init_digest(model),
        "actions": [transition] * A,
        "properties": properties,
        "boundary": _structure_digest(model.packed_within_boundary),
        "fingerprint": _structure_digest(model.packed_fingerprint),
    }
    sig["digest"] = _digest(
        sig["fp_scheme"], sig["model"], sig["init"], sig["actions"],
        sig["properties"], sig["boundary"], sig["fingerprint"],
    )
    # The lookup key must survive the edits the diff can judge, so it
    # leaves out actions and properties: same class, same init, same
    # fingerprint scheme, same seed file.
    sig["family"] = _digest(sig["fp_scheme"], sig["model"], sig["init"])
    return sig


# ---------------------------------------------------------------------------
# Seed build / compatibility / adaptation (the JAX package's, unchanged)
# ---------------------------------------------------------------------------


def build_seed_artifact(structure: dict, payload: dict,
                        coverage: Optional[dict] = None,
                        spawn_sig: Optional[str] = None) -> dict:
    """A finished run's checkpoint payload rewritten for reseeding: all
    visited keys (the table's and any evicted tiers') merged into one
    sorted ``FingerprintRun`` riding the payload's ``storage`` slot, so a
    restore probes the run (Bloom + CRC, O(verify)) and inserts nothing,
    and the empty ``chunks`` queue completes at once."""
    if payload.get("chunks"):
        raise ValueError(
            "seed artifacts require a completed run (non-empty frontier "
            "queue means the verdict is not final)"
        )
    keys = payload["keys"] if payload.get("symmetry") else payload["children"]
    parts = [np.asarray(keys, np.uint64).ravel()]
    storage = payload.get("storage") or {}
    for st in list(storage.get("l1", ())) + list(storage.get("l2", ())):
        parts.append(FingerprintRun.from_state(st).decode_all())
    merged = np.unique(np.concatenate(parts))
    ckpt = dict(payload)
    ckpt["chunks"] = []
    ckpt["storage"] = {
        "seq": 0,
        "l1": [FingerprintRun.build(merged).to_state()] if len(merged) else [],
        "l2": [],
    }
    actions_meta = None
    table = ((coverage or {}).get("actions") or {}).get("table")
    if table is not None:
        actions_meta = [
            {
                "label": label,
                "fired": int((table.get(label) or {}).get("fired", 0)),
                "fresh": int((table.get(label) or {}).get("fresh", 0)),
            }
            for label in structure.get("labels", [])
        ]
    return {
        "format": SEED_FORMAT,
        "structure": structure,
        "spawn_sig": spawn_sig,
        "actions_meta": actions_meta,
        "checkpoint": ckpt,
        "counts": {
            "unique": int(payload.get("unique_count", 0)),
            "states": int(payload.get("state_count", 0)),
            "max_depth": int(payload.get("max_depth", 0)),
            "runs": len(ckpt["storage"]["l1"]),
            "keys": int(len(merged)),
        },
    }


def seed_compatibility(artifact: dict, structure: dict) -> dict:
    """Judges whether ``artifact`` (a stored seed) may seed a run of the
    model described by ``structure``. Returns ``{compatible, mode,
    reason, invalidated_uniques, removed}``.

    Admitted modes: ``exact`` (identical structure digests: the unchanged
    model resubmitted) and ``dead_action_removal`` (the new action list is
    the old one with some actions deleted, every survivor's digest
    unchanged in order, properties, boundary, fingerprint and init
    unchanged, and every deleted action with ``fired == 0`` in the seeding
    run's coverage). With the port's whole-transition action digests a
    removal changes every survivor's digest, so only ``exact`` is reached
    from a port signature. Everything else is ``compatible: False`` with
    the reason; the caller falls back to a full recheck.
    """
    old = artifact.get("structure") or {}
    if old.get("format") != structure.get("format"):
        return _verdict(False, "format", "signature format mismatch")
    if old.get("digest") == structure.get("digest"):
        return _verdict(True, "exact", None)
    for field in ("fp_scheme", "model", "init", "boundary", "fingerprint"):
        if old.get(field) != structure.get(field):
            return _verdict(False, "full", f"{field} changed; no sound incremental reuse")
    if old.get("properties") != structure.get("properties"):
        return _verdict(False, "full", "property set changed; prior verdicts do not transfer")
    meta = artifact.get("actions_meta")
    if not meta:
        return _verdict(
            False, "full",
            "seeding run recorded no coverage; cannot prove removed "
            "actions dead (resubmit with coverage to enable the "
            "action-diff path)",
        )
    old_actions = list(old.get("actions", ()))
    new_actions = list(structure.get("actions", ()))
    if len(new_actions) > len(old_actions):
        return _verdict(
            False, "full", "actions added; new transitions may reach "
            "states the seed never explored",
        )
    # Align: each old action either matches the next new digest or was
    # removed. Any digest drift: not provable, full recheck.
    removed: List[int] = []
    j = 0
    for i, d in enumerate(old_actions):
        if j < len(new_actions) and new_actions[j] == d:
            j += 1
        else:
            removed.append(i)
    if j != len(new_actions):
        return _verdict(
            False, "full",
            "action bodies changed; the edit is not a pure removal of "
            "unchanged actions",
        )
    for i in removed:
        row = meta[i] if i < len(meta) else None
        if row is None:
            return _verdict(False, "full", f"removed action {i} has no coverage row")
        if row.get("fired", 1) != 0:
            # The inverted attribution: this action's uniques (and their
            # descendants) are the affected states; not provably dead.
            return _verdict(
                False, "full",
                f"removed action {i} ({row.get('label')}) fired "
                f"{row.get('fired')} times in the seeding run "
                f"({row.get('fresh')} uniques attributed); removal is "
                "not provably dead",
                invalidated=int(row.get("fresh", 0)), removed=removed,
            )
    return _verdict(True, "dead_action_removal", None, invalidated=0, removed=removed)


def _verdict(compatible, mode, reason, invalidated=0, removed=()):
    return {
        "compatible": bool(compatible),
        "mode": mode,
        "reason": reason,
        "invalidated_uniques": int(invalidated),
        "removed": list(removed),
    }


def adapt_seed_checkpoint(artifact: dict, model) -> dict:
    """The seed's checkpoint payload re-headered for ``model`` (the
    packed-model digest carries the action count, which a licensed
    removal changes). Only call after ``seed_compatibility`` admitted the
    pair."""
    from ..checker.gpu import packed_model_digest

    ckpt = dict(artifact["checkpoint"])
    ckpt["model"] = type(model).__name__
    ckpt["model_digest"] = packed_model_digest(model, int(model.packed_action_count()))
    return ckpt


# ---------------------------------------------------------------------------
# Seed store
# ---------------------------------------------------------------------------


class SeedStore:
    """Finished-run seeds under ``root`` (``service_dir/seeds/``), one file
    a model family, atomically replaced on each completed run. ``load``
    checks everything it hands to a restore (format, pickle integrity,
    every run's CRC) and refuses with a reason rather than let a torn
    artifact reach the checker."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def path_for(self, family: str) -> str:
        return os.path.join(self.root, f"{family}.seed")

    def save(self, artifact: dict) -> Optional[str]:
        family = (artifact.get("structure") or {}).get("family")
        if not family:
            return None
        path = self.path_for(family)
        try:
            _atomic_write_bytes(path, pickle.dumps(artifact, protocol=pickle.HIGHEST_PROTOCOL))
        except OSError:
            return None
        return path

    def load(self, family: str) -> Tuple[Optional[dict], Optional[str]]:
        """``(artifact, refusal_reason)``: exactly one is None."""
        path = self.path_for(family)
        if not os.path.exists(path):
            return None, "no seed for this model family"
        try:
            # Injection seam: a torn read or a failing disk surfaces here,
            # before any artifact content is trusted.
            fault_point("warmstart.seed_load")
            with open(path, "rb") as f:
                artifact = pickle.load(f)
            if not isinstance(artifact, dict) or artifact.get("format") != SEED_FORMAT:
                return None, "unrecognized seed format"
            storage = (artifact.get("checkpoint") or {}).get("storage") or {}
            for st in list(storage.get("l1", ())) + list(storage.get("l2", ())):
                # The O(verify) half: every run's structure and CRC are
                # checked here; corruption refuses the seed, never a wrong
                # visited set.
                FingerprintRun.from_state(st)
            return artifact, None
        except Exception as e:
            return None, f"seed artifact refused: {type(e).__name__}: {e}"
