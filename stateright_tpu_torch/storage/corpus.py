"""Named conformance-corpus persistence (``service_dir/corpus``).

The port's copy of the JAX package's ``storage/corpus.py``.

One corpus = one JSONL file of wire frames (``conformance/wire.py``)
under a validated NAME — never a client-chosen path. The HTTP layer
accepts ``{"corpus": "<name>"}`` precisely because names resolve inside
this store's root; accepting paths would hand remote clients arbitrary
server-side reads (the same reasoning that keeps ``resume_from`` off
the HTTP spawn surface).

Writes are atomic (tmp + rename in-directory): a killed writer leaves a
stray ``.tmp``, never a half-length corpus that would decode as a torn
frame on the next audit.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import List, Sequence

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")
_SUFFIX = ".jsonl"


def validate_corpus_name(name: str) -> str:
    """A corpus name, or ValueError: one path segment, no separators,
    no leading dot (a name is an identifier, not a location)."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"invalid corpus name {name!r}: one path segment of "
            "[A-Za-z0-9._-], not starting with '.', max 128 chars"
        )
    return name


class CorpusStore:
    """Named JSONL corpora under one root directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.root, validate_corpus_name(name) + _SUFFIX)

    def save(self, name: str, lines: Sequence[str]) -> str:
        """Atomically writes one corpus (wire lines, one frame per
        line); returns its path."""
        path = self.path(name)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                for line in lines:
                    f.write(line.rstrip("\n") + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path

    def load(self, name: str) -> List[str]:
        """The corpus's wire lines; FileNotFoundError when absent (the
        HTTP layer maps it to a 400 naming the store's contents)."""
        with open(self.path(name), encoding="utf-8") as f:
            return [ln.rstrip("\n") for ln in f if ln.strip()]

    def list(self) -> List[str]:
        out = []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return out
        for fn in entries:
            if fn.endswith(_SUFFIX):
                out.append(fn[: -len(_SUFFIX)])
        return sorted(out)
