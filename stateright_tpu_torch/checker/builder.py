"""Checker builder: configuration + spawn entry points.

Reference: ``CheckerBuilder`` at ``src/checker.rs:64-267``. The port's
builder carries the options its backends read: the host engines
``spawn_bfs``, ``spawn_dfs``, ``spawn_on_demand`` and ``spawn_simulation``
(the JAX package's, copied), the Explorer (``serve``), and
``spawn_gpu_bfs`` (the breadth-first search on the GPU).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.visitor import CheckerVisitor, FnVisitor


def default_representative(state):
    """The ``symmetry()`` default. A named sentinel so the GPU checker can
    tell it apart from a user-supplied ``symmetry_fn``, whose custom
    equivalence it honors only through the model's
    ``packed_representative``."""
    return state.representative()


class CheckerBuilder:
    def __init__(self, model):
        self.model = model
        self._symmetry: Optional[Callable] = None
        self._target_state_count: Optional[int] = None
        self._target_max_depth: Optional[int] = None
        self._thread_count: int = 1
        self._visitor: Optional[CheckerVisitor] = None
        self._complete_liveness: bool = False
        self._liveness_budget_states: Optional[int] = None
        self._liveness_deadline_s: Optional[float] = None

    # -- configuration -----------------------------------------------------

    def symmetry(self) -> "CheckerBuilder":
        """Enables symmetry reduction: the GPU checker keys its visited set
        on orbit-proper canonical fingerprints (``checker/symmetry.py``);
        ``spawn_dfs`` and ``spawn_simulation`` dedup on
        ``state.representative()`` (the reference's heuristic: 2pc-5 gives
        665 there, 314 orbits on the GPU). ``spawn_bfs`` ignores it, as the
        JAX package's host BFS does."""
        return self.symmetry_fn(default_representative)

    def symmetry_fn(self, representative: Callable) -> "CheckerBuilder":
        """Symmetry reduction by a custom representative: the GPU checker
        keys on ``packed_representative`` and refuses a model without it."""
        self._symmetry = representative
        return self

    def complete_liveness(self, budget_states: Optional[int] = None,
                          deadline_s: Optional[float] = None,
                          ) -> "CheckerBuilder":
        """Opt-in cycle-aware ``eventually`` checking (beyond the
        reference, whose semantics miss counterexamples that loop —
        documented FIXMEs at ``src/checker/bfs.rs:285-305``): after
        exploration, every undiscovered ``eventually`` property gets a
        host-side lasso search over the condition-false region
        (``checker/liveness.py``), run on the model's host ``actions`` and
        ``next_state``. Costs O(|condition-false region|) host
        time/memory, hence opt-in; the default semantics stay
        reference-exact. Honored by the exhaustive checkers (``spawn_bfs``,
        ``spawn_dfs``, ``spawn_gpu_bfs``), which refuse capped runs
        (``target_state_count``/``target_max_depth``) under this flag —
        the lasso search cannot honor caps.

        ``budget_states`` / ``deadline_s`` bound the pass: properties it
        cannot certify within the budget report an honest
        ``inconclusive`` outcome (reporter line, ``liveness.inconclusive``
        metric, ``liveness_report()``) instead of stalling
        ``discoveries()`` for unbounded host minutes."""
        self._complete_liveness = True
        self._liveness_budget_states = budget_states
        self._liveness_deadline_s = deadline_s
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """The checker may exceed this number, but will never generate fewer
        states if more exist."""
        self._target_state_count = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self._target_max_depth = depth if depth > 0 else None
        return self

    def threads(self, thread_count: int) -> "CheckerBuilder":
        """Worker threads of the host engines (``spawn_bfs``, ``spawn_dfs``,
        ``spawn_on_demand``, ``spawn_simulation``); the GPU checker ignores
        it."""
        self._thread_count = thread_count
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        """A function or CheckerVisitor run on each evaluated state's path."""
        if not isinstance(visitor, CheckerVisitor):
            visitor = FnVisitor(visitor)
        self._visitor = visitor
        return self

    # -- spawns ------------------------------------------------------------

    def spawn_bfs(self):
        """Breadth-first host checker; shortest paths when single-threaded,
        and then the exact oracle the GPU checker is held against."""
        from .bfs import BfsChecker

        return BfsChecker(self)

    def spawn_dfs(self):
        """Depth-first host checker; dramatically less memory than BFS."""
        from .dfs import DfsChecker

        return DfsChecker(self)

    def spawn_on_demand(self):
        """Lazy checker that only computes states when asked (Explorer)."""
        from .on_demand import OnDemandChecker

        return OnDemandChecker(self)

    def spawn_simulation(self, seed: int, chooser=None):
        """Random-walk checking for state spaces too large to exhaust."""
        from .simulation import SimulationChecker, UniformChooser

        return SimulationChecker(self, seed, chooser or UniformChooser())

    def spawn_gpu_bfs(self, **kwargs):
        """Breadth-first search on the GPU. Requires the model to implement
        ``BatchableModel``. ``wave_kernel="fused"`` runs only the model's
        own code in torch and every other stage of the wave in hand-written
        CUDA kernels; ``wave_kernel="staged"`` expands, fingerprints, sorts
        and compacts each wave in torch and inserts through a hand-written
        CUDA kernel. The default (``wave_kernel=None``) is the fused engine,
        or the staged one under symmetry or ``expand_fps=True``, which the
        fused wave refuses (the JAX package defaults to staged). Runs on
        ``cuda`` unless ``device="cpu"`` is passed, which selects the plain
        torch twin of every kernel; with no CUDA device and no
        ``device="cpu"`` it raises. ``coverage=True`` records the coverage ledger
        (``coverage_report()``). With ``symmetry()`` or ``symmetry_fn()``
        the visited set is keyed on canonical fingerprints of the orbits;
        that runs on the staged engine only (``wave_kernel="fused"`` raises,
        as in the JAX package). ``complete_liveness()`` adds the host lasso
        pass over the model's host transitions after the device run. See
        ``checker/gpu.py`` for the knobs."""
        from .gpu import GpuBfsChecker

        return GpuBfsChecker(self, **kwargs)

    def serve(self, address):
        """Starts the interactive Explorer web service (blocks)."""
        from .explorer import serve

        return serve(self, address)
