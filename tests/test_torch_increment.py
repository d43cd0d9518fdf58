"""The counter models (``models/increment.py``) against the JAX package's.

``Increment`` (the lost-update race) and ``IncrementLock``: the host
models' actions and successors over every reachable state, the packed
expansion lane for lane (candidates and valid bits), the symmetry hooks
(group action over every permutation, refinement) on the packed states of
every reachable state and on seeded random colors, and whole checks
(``spawn_gpu_bfs(device="cpu")`` against ``spawn_tpu_bfs(hashset_impl="xla",
wave_dedup="sort")``) with and without ``.symmetry()``, wave at a time and
drained, at the sizes of the JAX package's own device tests
(``tests/test_examples.py::TestIncrementDevice``): counts, depths,
discoveries and paths equal. Everything compared is an integer: the
tolerance is 0.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu import Property as JaxProperty
from stateright_tpu.models.increment import Increment as JaxIncrement
from stateright_tpu.models.increment import IncrementLock as JaxIncrementLock
from stateright_tpu_torch import Property
from stateright_tpu_torch.interop import packed_states_from_numpy, packed_states_to_numpy
from stateright_tpu_torch.models import Increment, IncrementLock

MODELS = {"increment": (JaxIncrement, Increment), "lock": (JaxIncrementLock, IncrementLock)}
MODES = {"wave": dict(max_drain_waves=1), "drain": {}}


def _full(jax_cls, port_cls):
    """Both packages' model with one property that always holds (the JAX
    test's ``_full``): the run explores the whole space."""

    class JaxFull(jax_cls):
        def properties(self):
            return [JaxProperty.always("true", lambda _m, _s: True)]

        def packed_conditions(self):
            return [lambda st: jnp.bool_(True)]

    class Full(port_cls):
        def properties(self):
            return [Property.always("true", lambda _m, _s: True)]

        def packed_conditions(self):
            return [lambda st: torch.ones(st["i"].shape[0], dtype=torch.bool)]

    return JaxFull, Full


def _reach(model):
    init = model.init_states()
    seen, queue, out = set(init), deque(init), []
    while queue:
        s = queue.popleft()
        out.append(s)
        actions = []
        model.actions(s, actions)
        for a in actions:
            t = model.next_state(s, a)
            if t not in seen:
                seen.add(t)
                queue.append(t)
    return out


def _fields(state):
    return tuple(getattr(state, f) for f in state.__dataclass_fields__)


def _jax_packed(model, host_states):
    packed = [model.pack_state(s) for s in host_states]
    return {k: np.stack([np.asarray(p[k]) for p in packed]) for k in packed[0]}


@pytest.mark.parametrize("name", list(MODELS))
def test_host_models_match_jax(name):
    """Every reachable state of three threads: the same actions, successors,
    property verdicts and representatives."""
    jm, pm = (cls(3) for cls in MODELS[name])
    jstates, pstates = _reach(jm), _reach(pm)
    assert [_fields(s) for s in jstates] == [_fields(s) for s in pstates]
    for js, ps in zip(jstates, pstates):
        ja, pa = [], []
        jm.actions(js, ja)
        pm.actions(ps, pa)
        assert ja == pa
        assert [_fields(jm.next_state(js, a)) for a in ja] == [
            _fields(pm.next_state(ps, a)) for a in pa]
        for jp, pp in zip(jm.properties(), pm.properties()):
            assert jp.name == pp.name and jp.condition(jm, js) == pp.condition(pm, ps)
        assert _fields(js.representative()) == _fields(ps.representative())


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_expansion_and_hooks_match_jax(name):
    """The packed states of every reachable state of three threads: packing,
    the expansion (every candidate leaf and valid bit), the conditions, the
    group action under each of the 6 permutations and the refinement on
    seeded colors, lane for lane against the JAX package."""
    jm, pm = (cls(3) for cls in MODELS[name])
    host = _reach(pm)
    jstates = _jax_packed(jm, host)
    states = packed_states_from_numpy(jstates)
    for k, v in packed_states_to_numpy(
            {k: torch.stack([pm.pack_state(s)[k] for s in host]) for k in jstates}).items():
        assert (v == jstates[k]).all(), k
    jcand, jvalid = jax.vmap(jm.packed_expand)({k: jnp.asarray(v) for k, v in jstates.items()})
    cand, valid = pm.packed_expand(states)
    assert (valid.numpy() == np.asarray(jvalid)).all()
    for k in jcand:
        assert (cand[k].numpy() == np.asarray(jcand[k]).astype(np.int64)).all(), k
    jconds = [jax.vmap(c)({k: jnp.asarray(v) for k, v in jstates.items()})
              for c in jm.packed_conditions()]
    for c, jc in zip(pm.packed_conditions(), jconds):
        assert (c(states).numpy() == np.asarray(jc)).all()
    # The group action, every permutation.
    n2o, o2n = pm.packed_symmetry()
    jn2o, jo2n = jm.packed_symmetry()
    assert (n2o == jn2o).all() and (o2n == jo2n).all()
    jst = {k: jnp.asarray(v) for k, v in jstates.items()}
    for row in range(n2o.shape[0]):
        want = jax.vmap(lambda s: jm.packed_apply_permutation(
            s, jnp.asarray(n2o[row]), jnp.asarray(o2n[row])))(jst)
        got = pm.packed_apply_permutation(states, torch.from_numpy(n2o[row].astype(np.int64)),
                                          torch.from_numpy(o2n[row].astype(np.int64)))
        for k in want:
            assert (got[k].numpy() == np.asarray(want[k]).astype(np.int64)).all(), (row, k)
    rng = np.random.default_rng(31)
    colors = rng.integers(0, 1 << 32, (len(host), 3), dtype=np.uint64).astype(np.uint32)
    want = jax.vmap(jm.packed_refine_colors)(jst, jnp.asarray(colors))
    got = pm.packed_refine_colors(states, torch.from_numpy(colors.astype(np.int64)))
    assert (got.numpy() == np.asarray(want).astype(np.int64)).all()


def _runs(jax_model, port_model, symmetry, mode, frontier, table):
    jb, pb = jax_model.checker(), port_model.checker()
    if symmetry:
        jb, pb = jb.symmetry(), pb.symmetry()
    ref = jb.spawn_tpu_bfs(frontier_capacity=frontier, table_capacity=table,
                           hashset_impl="xla", wave_dedup="sort", **MODES[mode]).join()
    port = pb.spawn_gpu_bfs(frontier_capacity=frontier, table_capacity=max(table, 2048),
                            device="cpu", **MODES[mode]).join()
    assert port.worker_error() is None, port.worker_error()
    assert ref.worker_error() is None, ref.worker_error()
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    assert set(port.discoveries()) == set(ref.discoveries())
    for name, path in ref.discoveries().items():
        assert port.discoveries()[name].encode() == path.encode(), name
    return port, ref


# (model, threads, symmetry, frontier, table, unique states): the JAX
# package's device tests of the counter models, and symmetric runs of each.
COUNTS = {
    "increment_3": ("increment", 3, False, 64, 1 << 10, 84),
    "increment_2_symmetry": ("increment", 2, True, 32, 1 << 9, 8),
    "increment_3_symmetry": ("increment", 3, True, 32, 1 << 9, 22),
    "lock_2": ("lock", 2, False, 32, 1 << 10, 17),
    "lock_3_symmetry": ("lock", 3, True, 32, 1 << 10, 13),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(COUNTS))
def test_counts_match_jax(case, mode):
    """Whole checks of the full space (a property that always holds), with
    and without symmetry: symmetric ``Increment(2)`` has 8 orbits."""
    name, n, symmetry, frontier, table, unique = COUNTS[case]
    jax_full, port_full = _full(*MODELS[name])
    port, _ref = _runs(jax_full(n), port_full(n), symmetry, mode, frontier, table)
    assert port.unique_state_count() == unique
    assert (port._sym is not None) is symmetry


@pytest.mark.parametrize("symmetry", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_increment_race_found_with_a_replayable_path(mode, symmetry):
    """``Increment(2)`` loses an update: ``fin`` fails, with the JAX
    package's path, which replays to a state where the counter lags the
    finished threads."""
    port, _ref = _runs(JaxIncrement(2), Increment(2), symmetry, mode, 32, 1 << 9)
    path = port.assert_any_discovery("fin")
    assert len(path.into_actions()) >= 1
    last = path.last_state()
    assert sum(1 for _t, pc in last.s if pc == 3) != last.i


@pytest.mark.parametrize("mode", list(MODES))
def test_increment_lock_holds(mode):
    """``IncrementLock(2)``: both properties hold, and the checked space is
    the full one (17 states)."""
    port, _ref = _runs(JaxIncrementLock(2), IncrementLock(2), False, mode, 32, 1 << 10)
    port.assert_properties()
    assert port.unique_state_count() == 17
