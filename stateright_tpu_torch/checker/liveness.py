"""Complete (cycle-aware) ``eventually`` checking — opt-in, beyond the
reference.

The reference's BFS/DFS only flag an ``eventually`` counterexample at a
TERMINAL state with the condition still unmet; paths that diverge into a
cycle (or rejoin previously-visited states) are documented false negatives
(FIXMEs at ``src/checker/bfs.rs:285-305``, test
``src/checker.rs:642-659``). The default checkers here reproduce those
semantics bit-for-bit — counts and verdicts must not silently diverge from
the reference. This is the port's copy of the JAX package's
``checker/liveness.py``; ``tests/test_torch_liveness.py`` holds its paths
and outcomes on ``spawn_bfs``, ``spawn_dfs`` and ``spawn_gpu_bfs`` to the
JAX package's, the known-wrong terminal-state merge at DAG joins
included (the default semantics miss it and this post-pass finds it).

``CheckerBuilder.complete_liveness()`` adds the missing half as a
post-pass: for every ``eventually`` property still without a discovery,
search the condition-false region for a maximal path that never satisfies
the condition. In a finite space such a path is either a **lasso** — a
condition-false path from an initial state that closes a cycle — or a
condition-false path ending at a **terminal** state (no within-boundary
successors at all). The second shape matters even though the default
checkers nominally handle terminal states: their eventually-bits are
merged at DAG joins (the first reference FIXME), so a terminal
counterexample reached second via a join is masked; the post-pass
re-derives it from scratch. Any path that touches a satisfying state is
no counterexample, so the search runs entirely inside the
condition-false region: a host DFS from condition-false initial states,
following only condition-false successors, returning on a back edge to a
state on the current DFS path (gray) — the lasso certificate, a concrete
path whose final state revisits an earlier one — or on reaching a state
with no successors in the full model — the maximal-path certificate.
Together the two shapes are exhaustive, so the pass is exact: it finds a
counterexample iff one exists within the boundary.

The pass is self-contained (it re-expands on the host model; it does not
need the checker's visited set), exact for finite boundaries, and costs
O(size of the reachable condition-false region) in host time and memory —
which is why it is opt-in rather than always-on.

**Practical scale ceiling.** The O(region) bound is the *certify-absence*
cost: when no counterexample exists the DFS must exhaust the region, at
one host ``actions``+``next_state`` expansion per false state (about the
host ``BfsChecker``'s per-state cost). When a counterexample EXISTS,
depth-first order typically finds a certificate after a tiny fraction of
the region: raft-3 (lossy) yields its stable-leader lasso after a few
expansions. Budget for the region-exhaust case when opting in at raft-5
scale; the GPU checker's parent-pointer store cannot shortcut this — it
records tree edges only, and cycle detection needs the full edge relation.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..core.model import Expectation, Property
from ..core.path import Path

__all__ = [
    "INCONCLUSIVE",
    "find_eventually_lasso",
    "lasso_discoveries",
    "lasso_discoveries_ex",
    "checker_lasso_pass",
]


class _Inconclusive:
    """Sentinel: the pass ran out of its state budget or deadline before
    it could certify either way. Distinct from None (= absence
    certified) because conflating them would turn an aborted search
    into a silent 'property holds'."""

    def __repr__(self):  # pragma: no cover - debugging nicety
        return "INCONCLUSIVE"


INCONCLUSIVE = _Inconclusive()


def find_eventually_lasso(model, prop: Property, budget_states=None,
                          deadline_s=None) -> Optional[Path]:
    """A counterexample for one ``eventually`` property, or None.

    Iterative DFS over the condition-false region with white/gray/black
    coloring. Two certificate shapes, exhaustive for finite boundaries:
    a successor that is gray closes a cycle (lasso), and a visited state
    with no within-boundary successors in the FULL model ends a maximal
    path (the terminal case the default checkers can mask via their
    eventually-bit merge at DAG joins — ``bfs.py``'s parity NOTE). A
    state whose successors all satisfy the condition is neither: every
    maximal path through it satisfies the property. States must be
    hashable (the host checkers' standing requirement).

    ``budget_states`` / ``deadline_s`` bound the search: when either is
    exhausted before a certificate or a full region exhaust, the pass
    returns :data:`INCONCLUSIVE` — an HONEST third outcome, never
    conflated with "no counterexample" (None). This is what keeps an
    opted-in raft-5-scale run from stalling ``discoveries()`` for
    unbounded host minutes.
    """
    cond = prop.condition
    deadline_t = (
        time.monotonic() + deadline_s if deadline_s is not None else None
    )
    expanded = 0
    # Deadline polls are batched (every 256 expansions) so the budget
    # machinery costs nothing against the per-state model expansion.
    _POLL = 256

    def over_budget() -> bool:
        nonlocal expanded
        expanded += 1
        if budget_states is not None and expanded > budget_states:
            return True
        return (
            deadline_t is not None
            and expanded % _POLL == 0
            and time.monotonic() > deadline_t
        )

    def expand(state):
        """(had_any_successor, condition-false successors). The first
        component uses the full successor set — terminality must match
        the host BFS's notion (``bfs.py``: any action yielding a
        non-None, within-boundary next state), not the false region's."""
        acts: List = []
        model.actions(state, acts)
        any_within = False
        false_succs: List = []
        for a in acts:
            ns = model.next_state(state, a)
            if ns is None or not model.within_boundary(ns):
                continue
            any_within = True
            if not cond(model, ns):
                false_succs.append((a, ns))
        return any_within, false_succs

    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict = {}
    for init in model.init_states():
        if not model.within_boundary(init) or cond(model, init):
            continue
        if color.get(init, WHITE) != WHITE:
            continue
        color[init] = GRAY
        if over_budget():
            return INCONCLUSIVE
        any_within, succs = expand(init)
        if not any_within:
            # Terminal condition-false init: a one-state maximal path.
            return Path([(init, None)])
        stack = [(init, iter(succs))]
        trail: List = [init]  # states on the current DFS path
        actions: List = []  # actions between them (len == len(trail) - 1)
        while stack:
            state, it = stack[-1]
            descended = False
            for action, nxt in it:
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    # Cycle: trail + the closing edge revisits `nxt`.
                    steps = [
                        (s, a) for s, a in zip(trail, actions + [action])
                    ]
                    steps.append((nxt, None))
                    return Path(steps)
                if c == WHITE:
                    color[nxt] = GRAY
                    if over_budget():
                        return INCONCLUSIVE
                    any_within, nsuccs = expand(nxt)
                    if not any_within:
                        # Terminal condition-false state: trail + the
                        # closing edge is a maximal never-satisfying path.
                        steps = [
                            (s, a) for s, a in zip(trail, actions + [action])
                        ]
                        steps.append((nxt, None))
                        return Path(steps)
                    stack.append((nxt, iter(nsuccs)))
                    trail.append(nxt)
                    actions.append(action)
                    descended = True
                    break
            if not descended:
                color[state] = BLACK
                stack.pop()
                trail.pop()
                if actions:
                    actions.pop()
    return None


def checker_lasso_pass(checker, done: bool, have) -> Dict[str, Path]:
    """The lazy post-pass every checker's ``discoveries()`` shares.

    Runs once per checker (cached under ``checker._lasso_lock``) when the
    opt-in flag is set AND exploration finished cleanly — a crashed run
    must not launch an unbounded host DFS from ``discoveries()`` (callers
    often inspect a failed checker), nor report counterexamples for a run
    that never completed. A crashed run's skip is SIGNALED
    (``liveness.skipped_crashed_run`` counter + reporter warning via
    ``Checker._signal_liveness_skip``), never silent — ``{}`` from a
    crashed run must not read as "no counterexample exists". ``have`` is
    the checker's existing discovery-name collection (terminal-state
    counterexamples win). Budget knobs
    (``.complete_liveness(budget_states=, deadline_s=)``) bound the pass;
    properties it could not certify land in
    ``checker._lasso_inconclusive`` and the ``liveness.inconclusive``
    metric instead of stalling the caller for unbounded host minutes."""
    if not checker._complete_liveness or not done:
        return {}
    if checker.worker_error() is not None:
        checker._signal_liveness_skip()
        return {}
    with checker._lasso_lock:
        if checker._lassos is None:
            props = getattr(checker, "_properties", None)
            if props is None:
                props = checker._model.properties()
            paths, inconclusive = lasso_discoveries_ex(
                checker._model,
                props,
                set(have),
                budget_states=getattr(
                    checker, "_lasso_budget_states", None
                ),
                deadline_s=getattr(checker, "_lasso_deadline_s", None),
            )
            checker._lasso_inconclusive = inconclusive
            if inconclusive:
                try:
                    reg = checker.metrics()
                    reg.counter("liveness.inconclusive").inc(
                        len(inconclusive)
                    )
                except Exception:  # noqa: BLE001 - signal only
                    pass
            checker._lassos = paths
    return checker._lassos


def lasso_discoveries(model, properties, have, budget_states=None,
                      deadline_s=None) -> Dict[str, Path]:
    """Counterexamples (lasso or masked-terminal maximal path) for every
    undiscovered ``eventually`` property. ``have`` is the checker's
    existing discovery-name set (first-found wins; counterexamples the
    default semantics already reported stay as-is)."""
    return lasso_discoveries_ex(
        model, properties, have, budget_states=budget_states,
        deadline_s=deadline_s,
    )[0]


def lasso_discoveries_ex(model, properties, have, budget_states=None,
                         deadline_s=None,
                         ) -> Tuple[Dict[str, Path], List[str]]:
    """``lasso_discoveries`` plus the honest third outcome: the names
    the bounded pass could NOT certify (budget or deadline exhausted).
    The deadline is shared across properties — one runaway region must
    not starve the rest AND still overrun the caller's bound."""
    deadline_t = (
        time.monotonic() + deadline_s if deadline_s is not None else None
    )
    out: Dict[str, Path] = {}
    inconclusive: List[str] = []
    for prop in properties:
        if prop.expectation != Expectation.EVENTUALLY:
            continue
        if prop.name in have:
            continue
        remaining = (
            max(0.001, deadline_t - time.monotonic())
            if deadline_t is not None
            else None
        )
        path = find_eventually_lasso(
            model, prop, budget_states=budget_states,
            deadline_s=remaining,
        )
        if path is INCONCLUSIVE:
            inconclusive.append(prop.name)
        elif path is not None:
            out[prop.name] = path
    return out, inconclusive
