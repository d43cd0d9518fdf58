"""The port's copies of the tiny host-model fixtures of ``fixtures.py``
(``BinaryClock``, ``DGraph``, ``LinearEquation``, ``Panicker``), built on
``stateright_tpu_torch``'s ``Model``, and two small models with the packed
protocol in torch for the GPU checker's lasso pass (``Diamond``, and
``Cycler`` from ``stateright_tpu_torch.testing``, which ``chip_smoke.py``
drives too). The host engines' parity tests (``test_torch_host_engines.py``,
``test_torch_liveness.py``, ``test_torch_explorer.py``) run each of these
and its JAX twin side by side.
"""

from __future__ import annotations

from typing import Dict, List, Set

import torch

from stateright_tpu_torch import Model, Property
from stateright_tpu_torch.testing import Cycler, PackedScalar

__all__ = ["BinaryClock", "Cycler", "DGraph", "Diamond", "LinearEquation", "Panicker"]


class BinaryClock(Model):
    """A machine that cycles between two states."""

    GO_LOW = "GoLow"
    GO_HIGH = "GoHigh"

    def init_states(self):
        return [0, 1]

    def actions(self, state, actions):
        actions.append(self.GO_HIGH if state == 0 else self.GO_LOW)

    def next_state(self, state, action):
        return 1 if action == self.GO_HIGH else 0

    def properties(self):
        return [Property.always("in [0, 1]", lambda _, state: 0 <= state <= 1)]


class DGraph(Model):
    """A directed graph, specified via paths from initial states."""

    def __init__(self, prop: Property):
        self.inits: Set[int] = set()
        self.edges: Dict[int, Set[int]] = {}
        self.prop = prop

    @staticmethod
    def with_property(prop: Property) -> "DGraph":
        return DGraph(prop)

    def with_path(self, path: List[int]) -> "DGraph":
        src = path[0]
        self.inits.add(src)
        for dst in path[1:]:
            self.edges.setdefault(src, set()).add(dst)
            src = dst
        return self

    def init_states(self):
        return sorted(self.inits)

    def actions(self, state, actions):
        actions.extend(sorted(self.edges.get(state, ())))

    def next_state(self, state, action):
        return action

    def properties(self):
        return [self.prop]


class LinearEquation(Model):
    """Finds x, y in u8 such that a*x + b*y = c (mod 256)."""

    INCREASE_X = "IncreaseX"
    INCREASE_Y = "IncreaseY"

    def __init__(self, a: int, b: int, c: int):
        self.a, self.b, self.c = a, b, c

    def init_states(self):
        return [(0, 0)]

    def actions(self, state, actions):
        actions.append(self.INCREASE_X)
        actions.append(self.INCREASE_Y)

    def next_state(self, state, action):
        x, y = state
        if action == self.INCREASE_X:
            return ((x + 1) % 256, y)
        return (x, (y + 1) % 256)

    def properties(self):
        def solvable(model, solution):
            x, y = solution
            return (model.a * x + model.b * y) % 256 == model.c % 256

        return [Property.sometimes("solvable", solvable)]


class Panicker(Model):
    """A model that raises during checking (worker shutdown test)."""

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        actions.append(1)

    def next_state(self, last_state, action):
        if last_state == 5:
            raise RuntimeError("reached panic state")
        return last_state + action

    def properties(self):
        return [Property.always("true", lambda _m, _s: True)]


class Diamond(PackedScalar):
    """0 -> {1, 2} -> 4 (terminal): the DAG-join case of
    ``test_liveness.py::_Diamond``. Which parent of 4 a wave keeps decides
    whether the join masks the all-even maximal path 0 -> 2 -> 4; the
    sorted in-wave dedup keeps the lower lane, whose parent is 2."""

    _A0 = {0: 1, 1: 4, 2: 4}  # action 0; 4 is terminal
    _A1 = {0: 2}  # action 1

    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state in self._A0:
            actions.append("a0")
        if state in self._A1:
            actions.append("a1")

    def next_state(self, state, action):
        table = self._A0 if action == "a0" else self._A1
        return table.get(state)

    def properties(self):
        return [Property.eventually("odd", lambda _, s: s % 2 == 1)]

    def packed_action_count(self):
        return 2

    def packed_expand(self, states):
        s = states["s"]
        nxt = torch.stack([torch.where(s == 0, 1, 4), torch.full_like(s, 2)], 1)
        valid = torch.stack([s <= 2, s == 0], 1)
        return {"s": torch.where(valid, nxt, s[:, None])}, valid

    def packed_conditions(self):
        return [lambda st: st["s"] % 2 == 1]
