"""Test fixtures of the port, shared by its test files and later slices.

``Chain`` is the torch port of the JAX package's liveness-semantics
fixture (``tests/test_tpu_bfs.py``): 0 -> 1 -> ... -> n (terminal).
"""

from __future__ import annotations

import torch

from .core.batch import BatchableModel
from .core.model import Model, Property


class Chain(Model, BatchableModel):
    """0 -> 1 -> ... -> n (terminal).

    ``reach`` sets the eventually target; a target > n is unreachable and
    must produce a counterexample path ending at the terminal state.
    ``bound`` limits the space through ``within_boundary``.
    """

    def __init__(self, n, reach=None, bound=None):
        self.n = n
        self.reach = reach
        self.bound = bound

    # host side
    def init_states(self):
        return [0]

    def actions(self, state, actions):
        if state < self.n:
            actions.append("inc")

    def next_state(self, state, action):
        return state + 1

    def within_boundary(self, state):
        return self.bound is None or state <= self.bound

    def properties(self):
        props = []
        if self.reach is not None:
            props.append(
                Property.eventually("reach", lambda _m, s: s == self.reach)
            )
        props.append(Property.always("small", lambda _m, s: s <= self.n))
        return props

    # packed side: a state is one int64 lane carrying a u32 counter
    def packed_action_count(self):
        return 1

    def packed_init_states(self, device="cpu"):
        return torch.zeros((1,), dtype=torch.int64, device=device)

    def packed_expand(self, states):
        return (states + 1)[:, None], (states < self.n)[:, None]

    def packed_within_boundary(self, states):
        if self.bound is None:
            return torch.ones_like(states, dtype=torch.bool)
        return states <= self.bound

    def packed_conditions(self):
        conds = []
        if self.reach is not None:
            conds.append(lambda s: s == self.reach)
        conds.append(lambda s: s <= self.n)
        return conds

    def pack_state(self, host_state):
        return torch.tensor(host_state, dtype=torch.int64)

    def unpack_state(self, packed):
        return int(packed)
