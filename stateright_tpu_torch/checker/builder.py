"""Checker builder: configuration + spawn entry points.

Reference: ``CheckerBuilder`` at ``src/checker.rs:64-267``. The port's
builder carries the options its two backends read: ``spawn_bfs`` (the
host oracle) and ``spawn_gpu_bfs`` (the breadth-first search on the GPU).
"""

from __future__ import annotations

from typing import Optional

from ..core.visitor import CheckerVisitor, FnVisitor


class CheckerBuilder:
    def __init__(self, model):
        self.model = model
        self._target_state_count: Optional[int] = None
        self._target_max_depth: Optional[int] = None
        self._visitor: Optional[CheckerVisitor] = None

    # -- configuration -----------------------------------------------------

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """The checker may exceed this number, but will never generate fewer
        states if more exist."""
        self._target_state_count = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self._target_max_depth = depth if depth > 0 else None
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        """A function or CheckerVisitor run on each evaluated state's path."""
        if not isinstance(visitor, CheckerVisitor):
            visitor = FnVisitor(visitor)
        self._visitor = visitor
        return self

    # -- spawns ------------------------------------------------------------

    def spawn_bfs(self):
        """Breadth-first host checker (one worker thread): the exact oracle
        the GPU checker is held against."""
        from .bfs import BfsChecker

        return BfsChecker(self)

    def spawn_gpu_bfs(self, **kwargs):
        """Breadth-first search on the GPU. Requires the model to implement
        ``BatchableModel``. ``wave_kernel="staged"`` (the default) expands,
        fingerprints, sorts and compacts each wave in torch and inserts
        through a hand-written CUDA kernel; ``wave_kernel="fused"`` runs
        only the model's own code in torch and every other stage of the
        wave in hand-written CUDA kernels. Runs on ``cuda`` unless
        ``device="cpu"`` is passed, which selects the plain torch twin of
        every kernel; with no CUDA device and no ``device="cpu"`` it
        raises. ``coverage=True`` records the coverage ledger
        (``coverage_report()``). See ``checker/gpu.py`` for the knobs."""
        from .gpu import GpuBfsChecker

        return GpuBfsChecker(self, **kwargs)
