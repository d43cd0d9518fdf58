"""Shared checks that hold the port's packed actor models to the JAX
package's: state by state over every reachable state of a small
configuration, and whole checks on both of the port's engines.

The test files of the actor zoo (``test_torch_actor_ordered.py``,
``test_torch_actor_raft.py``) build their cases from these.
"""

import io
import re
from collections import deque

import jax
import numpy as np
import torch

from stateright_tpu.report import WriteReporter as JaxWriteReporter
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.interop import packed_states_from_numpy

MODES = {"wave": dict(max_drain_waves=1), "drain": {}}
SPAWN = dict(frontier_capacity=64, table_capacity=4096)


def reach(model):
    """Every reachable host state within the model's boundary, breadth first
    (both packages' host models enumerate them in the same order)."""
    init = model.init_states()
    seen, queue, out = set(init), deque(init), []
    while queue:
        s = queue.popleft()
        out.append(s)
        actions = []
        model.actions(s, actions)
        for a in actions:
            n = model.next_state(s, a)
            if n is not None and model.within_boundary(n) and n not in seen:
                seen.add(n)
                queue.append(n)
    return out


def reachable_case(make_jax, make_port, n):
    """(JAX model, port model, JAX-packed states of every reachable state
    as numpy arrays, the port's host states)."""
    jm, tm = make_jax().into_model(), make_port().into_model()
    jhost, thost = reach(jm), reach(tm)
    assert len(jhost) == len(thost) == n
    jp = [jm.pack_state(s) for s in jhost]
    jstates = {k: np.stack([np.asarray(p[k]) for p in jp]) for k in jp[0]}
    return jm, tm, jstates, thost


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.int64)


def check_packed_states(jm, tm, jstates, thost):
    tp = [tm.pack_state(s) for s in thost]
    assert set(tp[0]) == set(jstates)
    for k, v in jstates.items():
        assert (np.stack([p[k].numpy() for p in tp]) == v.astype(np.int64)).all(), k
    init, jinit = tm.packed_init_states(), jm.packed_init_states()
    assert set(init) == set(jinit)
    for k in jinit:
        assert (init[k].numpy() == np.asarray(jinit[k]).astype(np.int64)).all(), k


def check_unpack_round_trips(tm, jstates, thost):
    states = packed_states_from_numpy(jstates)
    for i, s in enumerate(thost):
        assert tm.unpack_state({k: v[i] for k, v in states.items()}) == s


def check_expand(jm, tm, jstates):
    """Candidates on the valid lanes and the valid bits, lane for lane."""
    jcand, jvalid = jax.jit(jax.vmap(jm.packed_expand))(jstates)
    tcand, tvalid = tm.packed_expand(packed_states_from_numpy(jstates))
    jvalid = np.asarray(jvalid)
    assert tm.packed_action_count() == jm.packed_action_count() == jvalid.shape[1]
    assert (tvalid.numpy() == jvalid).all()
    assert 0 < jvalid.sum() < jvalid.size
    assert set(tcand) == set(jcand)
    for k in jcand:
        assert tuple(tcand[k].shape) == tuple(np.asarray(jcand[k]).shape), k
        assert (tcand[k].numpy()[jvalid] == _np(jcand[k])[jvalid]).all(), k
    return jvalid


def check_boundary_and_conditions(jm, tm, jstates):
    states = packed_states_from_numpy(jstates)
    jb = np.asarray(jax.vmap(jm.packed_within_boundary)(jstates))
    assert (tm.packed_within_boundary(states).numpy() == jb).all()
    jconds, tconds = jm.packed_conditions(), tm.packed_conditions()
    assert len(jconds) == len(tconds) > 0
    for jc, tc in zip(jconds, tconds):
        want = np.asarray(jax.vmap(jc)(jstates))
        assert (tc(states).numpy() == want).all()


def check_fingerprints(jm, tm, jstates):
    """The fingerprint view and the component-hash fingerprint."""
    states = packed_states_from_numpy(jstates)
    jview = jax.vmap(jm.packed_fingerprint_view)(jstates)
    tview = tm.packed_fingerprint_view(states)
    assert set(tview) == set(jview)
    for k in jview:
        assert (tview[k].numpy() == _np(jview[k])).all(), k
    jhi, jlo = jax.vmap(jm.packed_fingerprint)(jstates)
    thi, tlo = tm.packed_fingerprint(states)
    assert (thi.numpy() == _np(jhi)).all() and (tlo.numpy() == _np(jlo)).all()


def golden(checker, reporter_cls):
    buf = io.StringIO()
    checker.report(reporter_cls(buf))
    return re.sub(r"sec=\d+", "sec=*", buf.getvalue())


def same_run(port, ref, port_reporter=WriteReporter, ref_reporter=JaxWriteReporter):
    """Counts, depth, discoveries, each discovery path's ``encode()`` and the
    golden reporter lines."""
    assert port.worker_error() is None
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.state_count() == ref.state_count()
    assert port.max_depth() == ref.max_depth()
    pd, rd = port.discoveries(), ref.discoveries()
    assert set(pd) == set(rd)
    for name in rd:
        assert pd[name].encode() == rd[name].encode(), name
    assert golden(port, port_reporter) == golden(ref, ref_reporter)


def run_case(make_jax, make_port, against_device, spawn=SPAWN):
    """The port's host check and its ``spawn_gpu_bfs(device="cpu")`` on both
    engines, wave at a time and drained; the JAX host check, and, when
    ``against_device``, the JAX device checker in both modes at the same
    settings (``expand_fps=False``: the port runs the materializing wave)."""
    out = {
        "jax_host": make_jax().into_model().checker().spawn_bfs().join(),
        "host": make_port().into_model().checker().spawn_bfs().join(),
    }
    for mode, options in MODES.items():
        if against_device:
            out[("jax", mode)] = make_jax().into_model().checker().spawn_tpu_bfs(
                hashset_impl="xla", wave_dedup="sort", expand_fps=False, **spawn, **options
            ).join()
        for engine in ("staged", "fused"):
            out[(engine, mode)] = make_port().into_model().checker().spawn_gpu_bfs(
                device="cpu", wave_kernel=engine, **spawn, **options
            ).join()
    return out


def check_run(runs, engine, mode):
    """One of the port's device runs against the JAX device run of the same
    mode where there is one, else against the JAX host check's verdict: the
    unique count, the depth and the discoveries' names."""
    port = runs[(engine, mode)]
    assert port.keys_route == "comphash"
    if mode == "drain":
        assert port.drains > 0
    if ("jax", mode) in runs:
        same_run(port, runs[("jax", mode)])
        return
    ref = runs["jax_host"]
    assert port.worker_error() is None
    assert port.unique_state_count() == ref.unique_state_count()
    assert port.max_depth() == ref.max_depth()
    assert set(port.discoveries()) == set(ref.discoveries())
