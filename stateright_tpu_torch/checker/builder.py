"""Checker builder: configuration + spawn entry points.

Reference: ``CheckerBuilder`` at ``src/checker.rs:64-267``. The port's
builder carries the options its backends read: the host engines
``spawn_bfs``, ``spawn_dfs``, ``spawn_on_demand`` and ``spawn_simulation``
(the JAX package's, copied), the Explorer (``serve``), ``spawn_gpu_bfs``
(the breadth-first search on the GPU), and the device random walks
``spawn_gpu_simulation`` and ``spawn_swarm``.
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
        pass over the model's host transitions after the device run.
        ``checkpoint_path``, ``checkpoint_every_chunks`` (32),
        ``checkpoint_min_interval_s`` (0.0) and ``resume_from`` (a path or
        a ``preempt_payload()``) checkpoint and resume the run;
        ``request_preempt()`` on the returned checker stops it at the next
        wave or drain boundary with a resumable payload. ``hbm_budget_mib``
        caps the device table and evicts it to host runs past the cap,
        ``host_budget_mib`` with ``spill_dir`` spills those runs to disk;
        results stay bit-identical. ``attribution=True`` (or a
        ``telemetry.WaveAttribution`` built by the caller, for an injected
        clock or a ``profile_dir`` that runs ``torch.profiler`` over the
        first waves) records the wave-timeline ledger: each wave and drain
        window's wall split into the device phase (``wave_kernel`` fused,
        ``device`` staged), ``host_probe``, ``evict``, ``table_grow``,
        ``checkpoint``, ``compile`` (graph captures) and the residual
        ``gap``, read with ``attribution_report()`` and emitted as
        ``gpu_bfs.*`` spans that ``scripts/gap_report.py`` and
        ``scripts/trace_summary.py`` render; results stay bit-identical.
        ``liveness="device"`` (with ``edge_log_capacity``, rows of the device
        edge log) decides the ``eventually`` properties soundly: the staged
        waves log their condition-false edges on the device and the trim and
        reach decide each property at run end, with a certificate
        (``liveness_report()``); it runs the staged wave and refuses
        ``wave_kernel="fused"``, ``expand_fps=True``, symmetry and a capped
        run. See ``checker/gpu.py`` for the knobs."""
        from .gpu import GpuBfsChecker

        return GpuBfsChecker(self, **kwargs)

    def spawn_sharded_gpu_bfs(self, mesh=None, device=None, **kwargs):
        """Fingerprint-sharded breadth-first search over a mesh of shards
        (``parallel/base_mesh.py::ShardMesh``): each shard owns the visited
        keys with ``hi % n`` equal to its index and a slice of every wave;
        candidate keys go to their owners and back by an all-to-all (a
        permutation on the device in one process, ``torch.distributed``
        collectives across processes), and each owner inserts through the
        hand-written insert kernel. ``mesh=None`` takes ``default_mesh``:
        one process, on ``cuda`` unless ``device="cpu"``, raising without
        CUDA. The JAX package's ``spawn_sharded_tpu_bfs`` knobs and defaults
        (``frontier_per_device``, ``table_capacity_per_device``, the deep
        drain's, the checkpoint's, ``sieve``, ...). See
        ``parallel/sharded.py``."""
        from ..parallel.sharded import ShardedGpuBfsChecker

        return ShardedGpuBfsChecker(self, mesh=mesh, device=device, **kwargs)

    def spawn_gpu_simulation(self, seed: int, lanes: int = 1024, steps_per_call: int = 64,
                             max_trace_len: Optional[int] = None, device=None):
        """Random walks on the GPU: ``lanes`` walks in lockstep, the host
        reading their stats every ``steps_per_call`` steps (one captured
        CUDA Graph of a step, replayed). The walks are the JAX package's
        ``spawn_tpu_simulation`` walks for the same seed and knobs. Runs on
        ``cuda`` unless ``device="cpu"`` is passed; with no CUDA device and
        no ``device="cpu"`` it raises. See ``checker/gpu_simulation.py``."""
        from .gpu_simulation import GpuSimulationChecker

        return GpuSimulationChecker(self, seed, lanes, steps_per_call, max_trace_len,
                                    device=device)

    def spawn_swarm(self, seed: int, **kwargs):
        """Swarm verification on the GPU: the whole walk loop stays on the
        device for ``wave_steps`` steps at a time (per-walk threefry streams,
        restarts, boundary, depth and terminal exits, the properties and the
        discovery capture), with a sample of the walks' fingerprints in a
        device hash table inserted through the hand-written insert kernel.
        The JAX package's knobs and defaults: ``lanes`` (1024),
        ``wave_steps`` (1024), ``max_trace_len`` (the depth target, else
        512), ``sample_capacity`` (1 << 15), ``sample_stride`` (1), ``seeds``
        (a packed-state pool, or a preempted ``spawn_gpu_bfs`` payload for
        the frontier-seeded hybrid), ``resume_from`` (a ``preempt_payload()``),
        ``coverage`` and ``aot_cache``; plus ``device`` (``cuda`` unless
        ``"cpu"``). The walks are the JAX package's ``spawn_swarm`` walks for
        the same seed and knobs. Reference simulation semantics: the run
        ends when every property has a discovery or ``target_state_count``
        walk steps are reached (below 2^31). See ``checker/swarm.py``."""
        from .swarm import SwarmChecker

        return SwarmChecker(self, seed, **kwargs)

    def serve(self, address):
        """Starts the interactive Explorer web service (blocks)."""
        from .explorer import serve

        return serve(self, address)
