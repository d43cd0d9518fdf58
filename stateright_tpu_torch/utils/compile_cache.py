"""The card's artifact cache: where the port's CUDA kernels are built.

The port's counterpart of the JAX package's ``utils/compile_cache.py``. The
JAX package points XLA's persistent compilation cache at a directory keyed
on the host's CPU features and the JAX platforms; the port compiles no
executable per configuration. What it caches is the ``nvcc`` build of each
``csrc/*.cu`` (``ops/_build.py``), keyed there on the source and every
header it includes, so an edited kernel never loads a stale library. This
module names that one directory (``cache_dir()``; there is no second build
path) and the target it holds artifacts for (``_target_tag()``: the card's
name and compute capability, torch's version and its CUDA runtime's), which
``storage/persist.py``'s fence records beside every warm-start entry.

Two hazards shape the location, as in the JAX package:

- **Target mismatch.** A library built for one card must not load on
  another: the build flags pin ``sm_90a`` and the fence carries the tag,
  so an entry written on another target is refused, never used.
- **Cache poisoning.** A directory that another local user could pre-create
  would let them plant a library the checker loads. ``enable_persistent_cache``
  makes it with mode 0700, and a directory the user does not own stops every
  build and load.
"""

from __future__ import annotations

import hashlib
import os
import sys
from typing import Optional


def _target_tag(device=None) -> str:
    """Fingerprint of (card name, compute capability, torch version, CUDA
    runtime version). Stable across runs on one machine; ``"cpu"`` stands
    for the card when none is present (the plain twins need no build)."""
    import torch

    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        name = torch.cuda.get_device_name(device)
        major, minor = torch.cuda.get_device_capability(device)
        card = f"{name}|sm_{major}{minor}"
    else:
        card = "cpu"
    key = f"{card}|torch {torch.__version__}|cuda {torch.version.cuda}"
    return hashlib.blake2s(key.encode(), digest_size=8).hexdigest()


def cache_dir() -> str:
    """The directory the kernels build into (``ops/_build.BUILD_DIR``)."""
    from ..ops._build import BUILD_DIR

    return str(BUILD_DIR)


def enable_persistent_cache() -> Optional[str]:
    """Makes the build directory (mode 0700) and checks that this user owns
    it; returns its path, or None (with a note on stderr) when it cannot be
    secured: ``ops/_build.py`` then refuses to build or load a kernel."""
    d = cache_dir()
    try:
        os.makedirs(d, mode=0o700, exist_ok=True)
        os.chmod(d, 0o700)
        owned = os.stat(d).st_uid == os.getuid()
    except OSError as e:
        print(f"compile_cache: cannot secure {d} ({e}); artifact cache DISABLED",
              file=sys.stderr)
        return None
    if not owned:
        print(f"compile_cache: {d} not owned by uid {os.getuid()}; artifact cache DISABLED",
              file=sys.stderr)
        return None
    return d
