"""Native host-runtime components (C++ via ctypes).

The compute path is PyTorch and CUDA; the host runtime around it is native
where the reference's is (its checker bookkeeping lives in native
concurrent maps, ``src/checker/bfs.rs:28-29``). Currently: ``fp_store``,
the parent-pointer bookkeeping the GPU checker uses for path
reconstruction.

The shared library builds on first use with the toolchain's ``g++`` into
``native/_build/`` (no packaging step) and falls back to a pure-Python
store if compilation is impossible. This is host code: the fallback
concerns no device and no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "fp_store.cc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    """Artifact path keyed on a content hash of the source (advisor,
    round 4): mtime comparisons are meaningless after a git clone (git
    does not preserve mtimes), and a content key means an edited .cc can
    never silently load a stale binary."""
    digest = hashlib.blake2b(_SRC.read_bytes(), digest_size=8).hexdigest()
    return _DIR / "_build" / f"libfp_store-{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib_file = _lib_path()
            if not lib_file.exists():
                lib_file.parent.mkdir(exist_ok=True)
                subprocess.run(
                    [
                        "g++",
                        "-O3",
                        "-shared",
                        "-fPIC",
                        "-std=c++17",
                        str(_SRC),
                        "-o",
                        str(lib_file),
                    ],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(str(lib_file))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        u64 = ctypes.c_uint64
        p64 = ctypes.POINTER(u64)
        lib.fps_new.restype = ctypes.c_void_p
        lib.fps_new.argtypes = [u64]
        lib.fps_free.argtypes = [ctypes.c_void_p]
        lib.fps_size.restype = u64
        lib.fps_size.argtypes = [ctypes.c_void_p]
        lib.fps_insert_batch.restype = u64
        lib.fps_insert_batch.argtypes = [ctypes.c_void_p, p64, p64, u64]
        lib.fps_contains.restype = ctypes.c_int
        lib.fps_contains.argtypes = [ctypes.c_void_p, u64]
        lib.fps_get_parent.restype = u64
        lib.fps_get_parent.argtypes = [ctypes.c_void_p, u64]
        lib.fps_chain.restype = ctypes.c_int64
        lib.fps_chain.argtypes = [ctypes.c_void_p, u64, p64, u64]
        lib.fps_export.restype = u64
        lib.fps_export.argtypes = [ctypes.c_void_p, p64, p64, u64]
        _lib = lib
        return _lib


def _as_u64_buf(arr: np.ndarray):
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class NativeFingerprintStore:
    """u64 fingerprint → parent fingerprint map (0 parent = root).

    Batch inserts are first-writer-wins, matching BFS shortest-path parent
    recording. All operations serialize on an internal lock: ctypes calls
    release the GIL, and a concurrent ``insert_batch`` growth would free
    the buffers a reader is probing."""

    def __init__(self, capacity_hint: int = 1 << 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("native fp_store unavailable")
        self._lib = lib
        self._ptr = lib.fps_new(ctypes.c_uint64(capacity_hint))
        if not self._ptr:
            raise MemoryError("fps_new: allocation failed")
        self._oplock = threading.Lock()

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.fps_free(ptr)
            self._ptr = None

    def __len__(self) -> int:
        with self._oplock:
            return int(self._lib.fps_size(self._ptr))

    def insert_batch(self, children: np.ndarray, parents: np.ndarray) -> int:
        children, cbuf = _as_u64_buf(children)
        parents, pbuf = _as_u64_buf(parents)
        assert children.shape == parents.shape
        with self._oplock:
            fresh = int(
                self._lib.fps_insert_batch(
                    self._ptr, cbuf, pbuf, ctypes.c_uint64(children.shape[0])
                )
            )
        if fresh == 0xFFFFFFFFFFFFFFFF:
            raise MemoryError("fp_store: table growth allocation failed")
        return fresh

    def __contains__(self, fp: int) -> bool:
        with self._oplock:
            return bool(self._lib.fps_contains(self._ptr, ctypes.c_uint64(fp)))

    def parent(self, fp: int) -> Optional[int]:
        with self._oplock:
            p = int(self._lib.fps_get_parent(self._ptr, ctypes.c_uint64(fp)))
        return p or None

    def chain(self, fp: int) -> list:
        """Root-first fingerprint chain ending at ``fp``; raises KeyError
        for unknown fingerprints."""
        cap = 1 << 10
        while True:
            out = np.empty((cap,), np.uint64)
            _, obuf = _as_u64_buf(out)
            with self._oplock:
                n = int(
                    self._lib.fps_chain(
                        self._ptr,
                        ctypes.c_uint64(fp),
                        obuf,
                        ctypes.c_uint64(cap),
                    )
                )
            if n == -1:
                raise KeyError(fp)
            if n == -2:
                cap *= 16
                continue
            return out[:n].tolist()

    def export(self):
        """All (children, parents) pairs as two u64 arrays."""
        with self._oplock:
            n = int(self._lib.fps_size(self._ptr))
            children = np.empty((n,), np.uint64)
            parents = np.empty((n,), np.uint64)
            _, cbuf = _as_u64_buf(children)
            _, pbuf = _as_u64_buf(parents)
            wrote = int(
                self._lib.fps_export(self._ptr, cbuf, pbuf, ctypes.c_uint64(n))
            )
        return children[:wrote], parents[:wrote]


class PyFingerprintStore:
    """Pure-Python fallback with the same surface."""

    def __init__(self, capacity_hint: int = 0):
        self._map = {}

    def __len__(self) -> int:
        return len(self._map)

    def insert_batch(self, children, parents) -> int:
        fresh = 0
        m = self._map
        for c, p in zip(
            np.asarray(children, np.uint64).tolist(),
            np.asarray(parents, np.uint64).tolist(),
        ):
            if c and c not in m:
                m[c] = p
                fresh += 1
        return fresh

    def __contains__(self, fp: int) -> bool:
        return fp in self._map

    def parent(self, fp: int):
        return self._map.get(fp) or None

    def chain(self, fp: int) -> list:
        if fp not in self._map:
            raise KeyError(fp)
        out = []
        cur = fp
        while cur:
            out.append(cur)
            cur = self._map.get(cur, 0)
        return out[::-1]

    def export(self):
        children = np.fromiter(self._map.keys(), np.uint64, len(self._map))
        parents = np.fromiter(self._map.values(), np.uint64, len(self._map))
        return children, parents


def make_fingerprint_store(capacity_hint: int = 1 << 16):
    """The native store when buildable, else the Python fallback."""
    try:
        return NativeFingerprintStore(capacity_hint)
    except RuntimeError:
        return PyFingerprintStore(capacity_hint)


__all__ = [
    "NativeFingerprintStore",
    "PyFingerprintStore",
    "make_fingerprint_store",
]
