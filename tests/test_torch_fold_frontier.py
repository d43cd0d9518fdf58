"""The fold keys stage's leaf table and the frontier stage, on the CPU,
against the JAX package.

On the card ``fw_keys`` reads the candidate leaves in place through the
table ``fused_wave.fold_leaves`` builds (each leaf's rows, words a row and
element kind, in ``state_words``' order) and converts each element to a
u32 word from its bytes. Here the bytes of every leaf go through that
conversion, written out with numpy as the kernel does it (little-endian,
bool and small ints widened with their sign, int32 and float32 bit-cast,
the low half of an int64), and the words must equal the JAX package's
``state_words`` and the port's; ``keys_plain`` over ``fingerprint_state``
(the twin of ``fw_keys``) must give the JAX package's fingerprints.
``frontier_plain`` (the twin of ``fw_frontier``) is held to the Pallas
prologue's and epilogue's frontier arithmetic (``pallas_wave.py:131-143``,
``:470-489``) written with ``jnp``: ``ebits_after``, the max depth of the
live lanes, and each property's first hit lane (``jnp.argmax``), stored as
``~lane`` and 0 for no hit. Inputs come from numpy with a seed; everything
compared is an integer, so the tolerance is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.ops import fingerprint as jfp
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops import fingerprint as tfp

U32 = 0xFFFFFFFF
CPU = torch.device("cpu")


def leaf_set(case, B, rng):
    """A packed state of B lanes as numpy leaves."""
    if case == "every_dtype":
        return {
            "a_bool": rng.random((B, 3)) < 0.5,
            "b_i8": rng.integers(-128, 128, (B, 5)).astype(np.int8),
            "c_u8": rng.integers(0, 256, (B, 1)).astype(np.uint8),
            "d_i16": rng.integers(-(1 << 15), 1 << 15, (B, 3)).astype(np.int16),
            "e_u16": rng.integers(0, 1 << 16, (B,)).astype(np.uint16),
            "f_i32": rng.integers(-(1 << 31), 1 << 31, (B, 2)).astype(np.int32),
            "g_f32": np.stack([np.full(B, np.nan), np.full(B, -0.0),
                               rng.standard_normal(B)], 1).astype(np.float32),
            "h_i64": rng.integers(-(1 << 62), 1 << 62, (B, 4), dtype=np.int64),
        }
    if case == "nested":
        return {
            "z": rng.integers(0, 1 << 32, (B, 2), dtype=np.int64),
            "a": {"y": rng.integers(-5, 5, (B, 7)).astype(np.int16),
                  "b": rng.random((B,)) < 0.3},
            "m": [rng.integers(0, 9, (B, 3, 3)).astype(np.int8),
                  rng.integers(0, 1 << 32, (B, 1), dtype=np.int64)],
        }
    if case == "odd_widths":
        return {f"l{w}": rng.integers(-3, 3, (B, w)).astype(np.int8 if w % 2 else np.int16)
                for w in (1, 3, 5, 7, 9)}
    return rng.integers(0, 1 << 32, (B, 11), dtype=np.int64)  # one-leaf words


def to_torch(state):
    if isinstance(state, dict):
        return {k: to_torch(v) for k, v in state.items()}
    if isinstance(state, list):
        return [to_torch(v) for v in state]
    return torch.from_numpy(np.ascontiguousarray(state))


def to_jax(state):
    """The JAX package's form: int64 leaves carry u32 values, as uint32."""
    if isinstance(state, dict):
        return {k: to_jax(v) for k, v in state.items()}
    if isinstance(state, list):
        return [to_jax(v) for v in state]
    if state.dtype == np.int64:
        return jnp.asarray((state & U32).astype(np.uint32))
    return jnp.asarray(state)


def table_words(xs):
    """The words ``fw_keys`` makes of the leaf table, from the leaves'
    bytes: one element's bytes, little-endian, converted by its kind."""
    out = []
    for x in xs:
        kind, B = fw._LEAF_KINDS[x.dtype], x.shape[0]
        es = x.element_size()
        raw = x.numpy().reshape(B, -1).view(np.uint8).reshape(B, -1, es).astype(np.uint64)
        le = sum(raw[:, :, i] << np.uint64(8 * i) for i in range(min(es, 4)))
        if kind in (1, 3):  # int8, int16: the sign widens
            bits = 8 * es
            le = np.where(le >> np.uint64(bits - 1), le | np.uint64((U32 >> bits) << bits), le)
        out.append(le.astype(np.int64))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("case", ["every_dtype", "nested", "odd_widths", "words"])
def test_fold_table_words_match_state_words(case):
    rng = np.random.default_rng(len(case))
    B = 37
    state = leaf_set(case, B, rng)
    tstate = to_torch(state)
    xs = fw.fold_leaves(tstate, B, CPU)
    words = table_words(xs)
    assert np.array_equal(words, tfp.state_words(tstate).numpy())
    jwords = np.asarray(jax.vmap(jfp.state_words)(to_jax(state))).astype(np.int64)
    assert np.array_equal(words, jwords)
    # The keys stage's plain twin over the same state, a third of its
    # lanes invalid, against the JAX package's fingerprints.
    cvalid = torch.from_numpy(rng.random(B) < 0.67)
    key, idx = fw.keys_plain(*tfp.fingerprint_state(tstate), cvalid)
    jhi, jlo = (np.asarray(x).astype(np.int64)
                for x in jax.vmap(jfp.fingerprint_state)(to_jax(state)))
    want = np.where(cvalid.numpy(), (jhi << 32) | jlo, -1)
    assert np.array_equal(key.numpy(), want)
    assert np.array_equal(idx.numpy(), np.arange(B, dtype=np.int32))
    assert int((key != -1).sum()) == int(cvalid.sum())


@pytest.mark.parametrize("case", ["float64", "uint32", "not_contiguous", "rows", "too_many",
                                  "empty"])
def test_fold_leaves_refuses(case):
    B = 8
    x = torch.zeros((B, 3), dtype=torch.int64)
    if case == "float64":
        state, err = {"a": x, "b": x.to(torch.float64)}, TypeError
    elif case == "uint32":
        state, err = {"a": x.to(torch.uint32)}, TypeError
    elif case == "not_contiguous":
        state, err = {"a": x.t().contiguous().t()}, ValueError
    elif case == "rows":
        state, err = {"a": x, "b": x[:B - 1]}, ValueError
    elif case == "too_many":
        state, err = {f"l{i:02d}": x for i in range(fw.MAX_FOLD_LEAVES + 1)}, ValueError
    else:
        state, err = {}, ValueError
    with pytest.raises(err):
        fw.fold_leaves(state, B, CPU)


def test_nudged_rows_match_reference():
    """Two-word rows whose fold before the nudges is (0, 0) and (MAX,
    MAX) come out as (0, 1) and (MAX, MAX - 1), as in the JAX package."""
    rows = np.array([[1689074672, 2638689674], [3058510183, 416712412]], np.uint32)
    jhi, jlo = jax.vmap(jfp.fingerprint_words)(jnp.asarray(rows))
    khi, klo = tfp.fingerprint_words(torch.from_numpy(rows.astype(np.int64)))
    key, _ = fw.keys_plain(khi, klo, torch.ones(2, dtype=torch.bool))
    got = [((k >> 32) & U32, k & U32) for k in key.tolist()]
    assert got == list(zip(np.asarray(jhi).tolist(), np.asarray(jlo).tolist()))
    assert got == [(0, 1), (U32, U32 - 1)]


def jax_frontier(kinds, ebit, cond, cvalid, ebits, depth, depth_cap, mask):
    """The Pallas fused wave's frontier arithmetic with ``jnp``: the
    prologue's eval mask, ``ebits_after`` and terminal lanes, the
    epilogue's max depth and each property's hit and ``jnp.argmax`` lane."""
    F = depth.shape[0]
    depth = jnp.asarray(depth.astype(np.int32))
    eval_mask = jnp.asarray(mask) & (depth < depth_cap)
    ebits_after = jnp.asarray(ebits.astype(np.uint32))
    for pi, b in ebit.items():
        ebits_after = jnp.where(jnp.asarray(cond[pi]), ebits_after & ~jnp.uint32(1 << b),
                                ebits_after)
    valid = jnp.asarray(cvalid).reshape(F, -1) & eval_mask[:, None]
    terminal = eval_mask & ~valid.any(axis=1)
    hits, lanes = [], []
    for i, kind in enumerate(kinds):
        cv = jnp.asarray(cond[i])
        if kind == "always":
            h = eval_mask & ~cv
        elif kind == "sometimes":
            h = eval_mask & cv
        else:
            h = terminal & (((ebits_after >> jnp.uint32(ebit[i])) & 1) == 1)
        hits.append(bool(h.any()))
        lanes.append(int(jnp.argmax(h)))
    max_depth = int(jnp.max(jnp.where(jnp.asarray(mask), depth, 0)))
    return np.asarray(ebits_after).astype(np.int64), max_depth, hits, lanes


@pytest.mark.parametrize("A,P,masked", [(1, 0, False), (42, 1, True), (125, 64, True),
                                        (42, 64, False), (3, 3, True)])
def test_frontier_plain_matches_reference(A, P, masked):
    rng = np.random.default_rng(A * 100 + P)
    F = 301  # not a multiple of a block's lanes
    kinds = [("always", "sometimes", "eventually")[i % 3] for i in range(P)]
    ev = [i for i, k in enumerate(kinds) if k == "eventually"]
    ebit = {pi: b % 32 for b, pi in enumerate(ev)}
    # Dense hits, so that many lanes hit each property and the first is
    # the lowest; a fifth of the lanes have no valid candidate.
    cond = rng.random((P, F)) < np.where(np.arange(P) % 3 == 0, 0.9, 0.3)[:, None]
    cvalid = (rng.random((F, A)) < 0.2) & (rng.random(F) < 0.8)[:, None]
    ebits = rng.integers(0, 1 << 32, F, dtype=np.int64)
    depth = rng.integers(0, 12, F, dtype=np.int64)
    mask = rng.random(F) < 0.7 if masked else np.ones(F, bool)
    depth_cap = 9
    spec = fw.FusedWaveSpec(expand=None, within_boundary=None,
                            conditions=tuple(None for _ in range(P)),
                            expectations=tuple(kinds), ebit=tuple(ebit.items()),
                            action_count=A)
    acc = torch.full((4 + P,), 7, dtype=torch.int64)
    ebits_after = fw.frontier_plain(
        spec, torch.from_numpy(cond), torch.from_numpy(cvalid.reshape(-1)),
        torch.from_numpy(ebits), torch.from_numpy(depth), depth_cap, acc,
        torch.from_numpy(mask) if masked else None)
    jeb, max_depth, hits, lanes = jax_frontier(kinds, ebit, cond, cvalid, ebits, depth,
                                               depth_cap, mask)
    assert np.array_equal(ebits_after.numpy(), jeb)
    got = acc.tolist()
    assert got[:4] == [0, 0, 0, max_depth]
    for i in range(P):
        assert (got[4 + i] != 0) == hits[i], i
        assert (~got[4 + i] if hits[i] else 0) == (lanes[i] if hits[i] else 0), i
    assert any(hits) or P == 0


@pytest.mark.parametrize("A,P,masked", [(1, 0, False), (42, 1, True), (125, 64, True),
                                        (42, 64, False), (3, 3, True)])
def test_compact_stage_stats_match_the_wave_stats(A, P, masked):
    """The stats vector ``compact_stage`` writes from the wave's counters
    (``fw_compact`` on the card, ``stats_from_acc`` here) equals
    the plain wave's ``_stats`` over the same frontier: the counters, the
    fresh count, any hit, and each property's hit with the fingerprint of
    its first hit lane (lane 0 when none hit)."""
    rng = np.random.default_rng(A * 10 + P)
    F = 301
    kinds = [("always", "sometimes", "eventually")[i % 3] for i in range(P)]
    ev = [i for i, k in enumerate(kinds) if k == "eventually"]
    spec = fw.FusedWaveSpec(expand=None, within_boundary=None,
                            conditions=tuple(None for _ in range(P)),
                            expectations=tuple(kinds),
                            ebit=tuple((pi, b % 32) for b, pi in enumerate(ev)),
                            action_count=A)
    cond = torch.from_numpy(rng.random((P, F)) < 0.3)
    cvalid = torch.from_numpy(((rng.random((F, A)) < 0.2) & (rng.random(F) < 0.8)[:, None])
                              .reshape(-1))
    ebits = torch.from_numpy(rng.integers(0, 1 << 32, F, dtype=np.int64))
    depth = torch.from_numpy(rng.integers(0, 12, F, dtype=np.int64))
    mask = torch.from_numpy(rng.random(F) < 0.7) if masked else None
    hi = torch.from_numpy(rng.integers(0, 1 << 32, F, dtype=np.int64))
    lo = torch.from_numpy(rng.integers(0, 1 << 32, F, dtype=np.int64))
    B = F * A
    acc = torch.zeros(4 + P, dtype=torch.int64)
    ebits_after = fw.frontier_plain(spec, cond, cvalid, ebits, depth, 9, acc, mask)
    eval_mask, _eb, valid, terminal = fw._frontier_plain(spec, cond, cvalid, ebits, depth, 9,
                                                         mask)
    flag = torch.from_numpy(rng.choice(np.array([0, 1, 2, 4], np.uint8), size=B))
    fresh, pending = (flag & 1) != 0, (flag & 4) != 0
    acc[0], acc[2] = valid.sum(), pending.sum()  # the keys stage's and the sweep's counts
    stats = torch.full((5 + 3 * P,), -3, dtype=torch.int64)
    fw.compact_stage(flag, torch.arange(B, dtype=torch.int64), torch.arange(B, dtype=torch.int32),
                     A, ebits_after, depth, hi, lo, acc, stats=stats)
    want = fw._stats(spec, cond, eval_mask, terminal, ebits_after, hi, lo, depth, valid.sum(),
                     fresh, pending, mask)
    assert stats.tolist() == want.tolist()
    assert stats[1] == fresh.sum() and acc[1] == fresh.sum()
    with pytest.raises(ValueError, match="stats must be"):
        fw.compact_stage(flag, torch.arange(B, dtype=torch.int64),
                         torch.arange(B, dtype=torch.int32), A, ebits_after, depth, hi, lo, acc,
                         stats=torch.zeros(6 + 3 * P, dtype=torch.int64))
