"""Builds and loads the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on first use with ``nvcc`` into a shared library with
a plain C interface, under ``stateright_tpu_torch/_build/`` (listed in
``.gitignore``), and is loaded with ``ctypes``. The artifact is keyed on a
content hash of the source and of every ``csrc`` header it includes
(``#include "x.cuh"``, followed through headers), so an edited kernel or
header never loads a stale binary. ``build_all`` compiles several sources
at once, one ``nvcc`` process each, into the directory
``utils/compile_cache.py`` secures (mode 0700, owned by this user). Nothing here runs at import time: the
CPU tests import every module of the port on a machine with no ``nvcc``.

A failed build raises. There is no fallback: a caller that asked for the
kernel gets the kernel or an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

# Held over every build and load: two threads never compile one source
# into the same temporary file, nor load a library half written.
_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
# ``nvcc`` processes each thread has started (a checker reports the ones its
# run started: none once a namespace's kernels are built).
_counts = threading.local()


def thread_builds() -> int:
    """The ``nvcc`` processes the calling thread has started."""
    return getattr(_counts, "builds", 0)


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, then ``/usr/local/cuda``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "stateright_tpu_torch build from csrc/ at first use"
        )
    return found


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` file it includes with quotes,
    directly or through another header, in first-include order."""
    out: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            todo.append(CSRC / inc)
    return out


def library_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=8)
    for src in sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def build_all(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compiles each ``csrc/<name>.cu`` whose artifact does not exist, all
    ``nvcc`` processes started together; returns the library paths.
    ``verbose`` adds ``-Xptxas -v`` and prints its report (registers,
    shared memory, spills)."""
    from ..utils.compile_cache import enable_persistent_cache

    with _lock:
        if enable_persistent_cache() is None:
            # Another user's directory could hold a planted library.
            raise RuntimeError(f"the kernel build directory {BUILD_DIR} cannot be secured")
        outs = {name: library_path(name) for name in names}
        jobs = {}
        for name, out in outs.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
            _counts.builds = thread_builds() + 1
        failed = []
        for name, (tmp, proc) in jobs.items():
            try:
                log, _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
                continue
            if verbose:
                print(f"-- {name}.cu\n{log}", flush=True)
            os.replace(tmp, outs[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        return outs


def build(name: str, verbose: bool = False) -> Path:
    """Compiles ``csrc/<name>.cu`` unless its artifact exists; returns the
    library path."""
    return build_all([name], verbose)[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
