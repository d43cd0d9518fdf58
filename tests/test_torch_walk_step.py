"""The port's walk step (``checker/gpu_simulation.py::walk_lane_step``)
against the JAX package's (``checker/tpu_simulation.py``, vmapped over the
lanes as its swarm does), step for step, and the port's unsorted sample
insert against the JAX ``hashset_insert_unsorted``. Every output field of
every step is compared with integer equality, the coverage outputs
included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.checker.swarm import _WalkKernel as JaxWalkKernel
from stateright_tpu.models.raft import RaftModelCfg as JaxRaftModelCfg
from stateright_tpu.models.sharded_kv import ShardedKv as JaxShardedKv
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.ops.hashset import hashset_insert_unsorted as jax_insert_unsorted
from stateright_tpu.ops.hashset import hashset_new as jax_hashset_new
from stateright_tpu.telemetry.coverage import DeviceCoverage as JaxDeviceCoverage
from stateright_tpu_torch.checker.gpu_simulation import walk_lane_step
from stateright_tpu_torch.checker.swarm import _WalkKernel
from stateright_tpu_torch.interop import (
    keys_from_numpy,
    table_from_numpy,
    table_to_numpy,
    walk_carry_from_numpy,
    walk_carry_to_numpy,
)
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.models.sharded_kv import ShardedKv
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops.hashset_kernel import hashset_insert_unsorted
from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

STEPS = 40
LANES = 64
NO_CAP = 2**31 - 1
CARRY = ("state", "depth", "ebits", "done", "thi", "tlo", "key")

# name: (JAX model, port model, trace buffer D, depth cap)
CASES = {
    "2pc3": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3), 16, NO_CAP),
    "skv221_unguarded": (lambda: JaxShardedKv(2, 2, 1), lambda: ShardedKv(2, 2, 1), 16, NO_CAP),
    # Raft's "stable leader" is an eventually property (ebits) and its term
    # cap is a boundary.
    "raft3_lossy": (lambda: JaxRaftModelCfg(3, 1, lossy=True).into_model(),
                    lambda: RaftModelCfg(3, 1, lossy=True).into_model(), 12, NO_CAP),
    # A cap above the buffer: walks that fill it are truncated.
    "2pc3_cap_above_buffer": (lambda: JaxTwoPhaseSys(3), lambda: TwoPhaseSys(3), 6, 9),
}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The walks' steps are many small operations, which the intra-op
    thread pool only slows down on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernels(jmodel, tmodel, D):
    P, A = len(jmodel.properties()), jmodel.packed_action_count()
    kw = dict(lanes=LANES, wave_steps=1, max_trace_len=D, sample_capacity=1 << 12,
              sample_stride=1, seeds=None)
    jk = JaxWalkKernel(jmodel, coverage_layout=JaxDeviceCoverage(A, P), **kw)
    tk = _WalkKernel(tmodel, torch.device("cpu"), coverage_layout=DeviceCoverage(A, P), **kw)
    return jk, tk


def _fresh_carry(jmodel, D, rng):
    """A carry as the walkers start one (every lane restarts on its first
    step) with random keys, in the JAX package's dtypes."""
    inits = jmodel.packed_init_states()
    return {
        "state": {k: np.zeros((LANES,) + np.asarray(v).shape[1:], np.uint32)
                  for k, v in inits.items()},
        "depth": np.zeros(LANES, np.int32),
        "ebits": np.zeros(LANES, np.uint32),
        "done": np.ones(LANES, bool),
        "thi": np.zeros((LANES, D), np.uint32),
        "tlo": np.zeros((LANES, D), np.uint32),
        "key": rng.integers(0, 1 << 32, size=(LANES, 2), dtype=np.uint64).astype(np.uint32),
    }


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a if a.dtype == np.bool_ else a.astype(np.int64)


def _assert_equal(want, got, where):
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            _assert_equal(want[k], got[k], f"{where}.{k}")
        return
    assert want.shape == got.shape, where
    assert np.array_equal(want, got), where


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jm, tm, D, cap = CASES[request.param]
    return request.param, jm(), tm(), D, cap


def test_walk_step_matches_jax_for_40_steps(case):
    name, jmodel, tmodel, D, cap = case
    jk, tk = _kernels(jmodel, tmodel, D)
    step = jax.jit(jax.vmap(jk._lane_step, in_axes=(0, 0, 0, 0, 0, 0, 0, None)))
    carry = _fresh_carry(jmodel, D, np.random.default_rng(len(name)))
    jc = jax.tree_util.tree_map(jnp.asarray, carry)
    tc = walk_carry_from_numpy(carry)
    tcap = torch.tensor(cap, dtype=torch.int64)
    seen = {"restarted": 0, "truncated": 0, "hits": 0, "capped": 0, "not_written": 0}
    for s in range(STEPS):
        jout = step(*(jc[k] for k in CARRY), jnp.int32(cap))
        tout = walk_lane_step(tk, tk._seeds, tk._n_seeds, *(tc[k] for k in CARRY), tcap)
        assert set(jout) == set(tout)
        _assert_equal(_np(jout), walk_carry_to_numpy(tout), f"{name} step {s}")
        jc = {k: jout[k] for k in CARRY}
        tc = {k: tout[k] for k in CARRY}
        seen["restarted"] += int(tout["restarted"].sum())
        seen["truncated"] += int(tout["truncated"].sum())
        seen["capped"] += int(tout["capped"].sum())
        seen["hits"] += int(tout["hits"].sum())
        seen["not_written"] += int((~tout["write"]).sum())
    # The 40 steps exercised restarts and properties; the capped case
    # truncated walks at its buffer.
    assert seen["restarted"] > LANES and seen["hits"] > 0
    if name == "2pc3_cap_above_buffer":
        assert seen["truncated"] > 0 and seen["not_written"] > 0


def test_unsorted_insert_matches_jax():
    """Batches with duplicates, in lane order, into one table on each side
    while it stays unsaturated: the flags lane for lane and the stored key
    sets are equal."""
    rng = np.random.default_rng(5)
    universe = rng.integers(1, 1 << 32, size=(1500, 2), dtype=np.uint64).astype(np.uint32)
    jt = jax_hashset_new(4096)
    tt = table_from_numpy(np.asarray(jt))
    fresh_total = 0
    for step in range(24):
        B = int(rng.choice([64, 1024]))
        pool = universe[rng.integers(0, len(universe), size=300)]
        pick = pool[rng.integers(0, len(pool), size=B)]
        hi, lo = pick[:, 0], pick[:, 1]
        active = rng.random(B) < 0.8
        jt, *jflags = jax_insert_unsorted(jt, jnp.asarray(hi), jnp.asarray(lo),
                                          jnp.asarray(active))
        tt, *tflags = hashset_insert_unsorted(tt, *keys_from_numpy(hi, lo),
                                              torch.from_numpy(active))
        for name, a, b in zip(("fresh", "found", "pending"), jflags, tflags):
            assert np.array_equal(np.asarray(a), b.numpy()), (step, name)
        assert not np.asarray(jflags[2]).any()
        fresh_total += int(tflags[0].sum())

        def keyset(t):
            t = np.asarray(t).astype(np.uint64)
            k = (t[:, 0] << np.uint64(32)) | t[:, 1]
            return set(k[k != 0].tolist())

        assert keyset(jt) == keyset(table_to_numpy(tt))
    assert fresh_total == len(keyset(jt)) > 1000


def test_unsorted_insert_max_key_after_inactive_lane():
    """An active (MAX, MAX) key shares the inactive lanes' sort sentinel:
    placed after an inactive lane it is still inserted, fresh in its lowest
    lane and found in the next, as the JAX function has it."""
    m = 0xFFFFFFFF
    hi = np.array([m, m, 7, m, m, 7, 5], np.uint32)
    lo = np.array([m, m, 9, m, m, 9, 5], np.uint32)
    active = np.array([False, True, True, False, True, True, False])
    jt = jax_hashset_new(2048)
    tt = table_from_numpy(np.asarray(jt))
    jt, *jflags = jax_insert_unsorted(jt, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(active))
    tt, *tflags = hashset_insert_unsorted(tt, *keys_from_numpy(hi, lo), torch.from_numpy(active))
    for name, a, b in zip(("fresh", "found", "pending"), jflags, tflags):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert tflags[0].numpy().tolist() == [False, True, True, False, False, False, False]
    rows = table_to_numpy(tt)
    assert ((rows[:, 0] == m) & (rows[:, 1] == m)).sum() == 1
