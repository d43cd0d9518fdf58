"""The port's batched 2pc packed model against the JAX package's.

On every reachable 2pc-3 and 2pc-4 state (packed by the JAX model, carried
across as numpy), the port's batched ``packed_expand`` gives the same
candidates and validity as ``jax.vmap(packed_expand)``, and the same
conditions. Exact comparisons.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.core.fingerprint import fingerprint as jfingerprint
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch.core.fingerprint import fingerprint as tfingerprint
from stateright_tpu_torch.interop import (
    packed_states_from_numpy,
    packed_states_to_numpy,
)
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

from test_torch_fingerprint import reachable_states, stacked_packed


@pytest.fixture(scope="module", params=[3, 4])
def space(request):
    n = request.param
    jmodel = JaxTwoPhaseSys(n)
    states = reachable_states(jmodel)
    return n, jmodel, states, stacked_packed(jmodel, states)


def test_reachable_counts(space):
    n, _jmodel, states, _packed = space
    assert len(states) == {3: 288, 4: 1568}[n]


def test_packed_expand_matches(space):
    n, jmodel, _states, packed = space
    jcand, jvalid = jax.vmap(jmodel.packed_expand)(
        {k: jnp.asarray(v) for k, v in packed.items()}
    )
    model = TwoPhaseSys(n)
    tcand, tvalid = model.packed_expand(packed_states_from_numpy(packed))
    assert model.packed_action_count() == jmodel.packed_action_count() == 2 + 5 * n
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    assert set(jcand) == set(tcand)
    for k in jcand:
        assert tcand[k].shape == jcand[k].shape, k
        assert np.array_equal(
            np.asarray(jcand[k]).astype(np.int64), tcand[k].numpy()
        ), k


def test_conditions_match(space):
    n, jmodel, _states, packed = space
    jstates = {k: jnp.asarray(v) for k, v in packed.items()}
    tstates = packed_states_from_numpy(packed)
    jconds = jmodel.packed_conditions()
    tconds = TwoPhaseSys(n).packed_conditions()
    assert len(jconds) == len(tconds) == 3
    for jc, tc in zip(jconds, tconds):
        assert np.array_equal(np.asarray(jax.vmap(jc)(jstates)), tc(tstates).numpy())


def test_boundary_and_pack_roundtrip(space):
    n, jmodel, states, packed = space
    model = TwoPhaseSys(n)
    tstates = packed_states_from_numpy(packed)
    assert bool(model.packed_within_boundary(tstates).all())
    assert packed_states_to_numpy(tstates).keys() == packed.keys()
    for i in (0, len(states) // 2, len(states) - 1):
        one = model.pack_state(states[i])
        for k, v in one.items():
            assert np.array_equal(v.numpy(), np.asarray(packed[k][i]).astype(np.int64))
        back = model.unpack_state(one)
        assert dataclasses.astuple(back) == dataclasses.astuple(states[i])
        # Same class name and fields: the host fingerprints (and so the
        # reporter's fingerprint paths) agree across the packages.
        assert tfingerprint(back) == jfingerprint(states[i])


def test_init_states_match():
    jinit = JaxTwoPhaseSys(4).packed_init_states()
    tinit = TwoPhaseSys(4).packed_init_states()
    for k in jinit:
        assert tuple(tinit[k].shape) == tuple(jinit[k].shape)
        assert not tinit[k].any() and not np.asarray(jinit[k]).any()
    assert tinit["rm"].dtype == torch.int64
