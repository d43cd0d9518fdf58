"""The port's compaction on the CPU, against the reference's expression.

``ops/fused_wave.py::compact_plain`` is the plain twin of the fused wave's
compaction stage (``fw_compact``) and the staged wave's compaction. It is
held here to the JAX epilogue's expression
(``stateright_tpu/ops/pallas_wave.py:444-463``, written with ``jnp`` below):
``pos = cumsum(fresh) - 1``, and the scatter of the lane, the key's halves,
the parent's ``ebits_after``, ``depth + 1``, ``hi`` and ``lo`` to each fresh
position's slot, every row past ``n_new`` left 0. ``compact_stage`` on CPU
tensors runs the twin and writes ``n_new`` into the wave's counters. The
inputs are made with numpy from a seed: no fresh key, every key fresh, one
lane, fresh keys only at the tail, and a random mix at a full 2pc-8 wave's
width (B = 344,064). Everything compared is an integer: the tolerance is
0. The kernel itself is held to the twin on the card
(``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch.ops import fused_wave as fw

# (F, A, pattern) of each case; B = F * A sorted positions.
CASES = {
    "none_fresh": (512, 8, "none"),
    "all_fresh": (512, 8, "all"),
    "one_lane": (1, 1, "all"),
    "tail_only": (1024, 4, "tail"),
    "random_2pc8_width": (8192, 42, "random"),
}


def wave(case):
    """The compaction's inputs as numpy arrays: the sweep's outcome bytes
    over the sorted positions, each position's lane, the lanes' (hi, lo)
    fingerprints, and the frontier's ``ebits_after``, depth, hi and lo."""
    F, A, pattern = CASES[case]
    B = F * A
    rng = np.random.default_rng(B + len(pattern))
    flag = rng.choice(np.array([0, 2, 4], np.uint8), size=B)
    if pattern == "all":
        flag[:] = 1
    elif pattern == "tail":
        flag[B - 97:] = 1
    elif pattern == "random":
        flag[rng.random(B) < 0.06] = 1
    u32 = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    return {
        "A": A,
        "flag": flag,
        "sidx": rng.permutation(B).astype(np.int32),
        "chi": u32(B),
        "clo": u32(B),
        "ebits_after": u32(F),
        "depth": rng.integers(0, 40, size=F).astype(np.int32),
        "hi": u32(F),
        "lo": u32(F),
    }


def reference_compact(w):
    """The Pallas epilogue's compaction (``pallas_wave.py:444-463``)."""
    fresh = jnp.asarray(w["flag"] & 1) != 0
    sidx = jnp.asarray(w["sidx"])
    chi, clo = jnp.asarray(w["chi"]), jnp.asarray(w["clo"])
    ebits_after, depth_v = jnp.asarray(w["ebits_after"]), jnp.asarray(w["depth"])
    hi_v, lo_v = jnp.asarray(w["hi"]), jnp.asarray(w["lo"])
    B, A = fresh.shape[0], w["A"]
    pos = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    out_slot = jnp.where(fresh, pos, B)
    zi = jnp.zeros((B,), jnp.int32)
    zu = jnp.zeros((B,), jnp.uint32)
    parent_row = sidx // A
    out = {
        "src": zi.at[out_slot].set(sidx, mode="drop"),
        "hi": zu.at[out_slot].set(chi[sidx], mode="drop"),
        "lo": zu.at[out_slot].set(clo[sidx], mode="drop"),
        "ebits": zu.at[out_slot].set(ebits_after[parent_row], mode="drop"),
        "depth": zi.at[out_slot].set(depth_v[parent_row] + 1, mode="drop"),
        "parent_hi": zu.at[out_slot].set(hi_v[parent_row], mode="drop"),
        "parent_lo": zu.at[out_slot].set(lo_v[parent_row], mode="drop"),
    }
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}, int(fresh.sum())


def torch_inputs(w):
    """``compact_plain``'s arguments: the sorted keys are the lanes'
    fingerprints at the sorted positions, ``(hi << 32) | lo`` as int64
    bits; u32 values ride in int64."""
    i64 = lambda x: torch.from_numpy(x.astype(np.int64))  # noqa: E731
    sidx = w["sidx"].astype(np.int64)
    key = ((w["chi"][sidx].astype(np.uint64) << np.uint64(32))
           | w["clo"][sidx].astype(np.uint64)).view(np.int64)
    return (torch.from_numpy(w["flag"]), torch.from_numpy(key), torch.from_numpy(w["sidx"]),
            w["A"], i64(w["ebits_after"]), i64(w["depth"]), i64(w["hi"]), i64(w["lo"]))


@pytest.mark.parametrize("case", list(CASES))
def test_compact_plain_matches_reference_epilogue(case):
    w = wave(case)
    want, n_new = reference_compact(w)
    got, got_n = fw.compact_plain(*torch_inputs(w))
    assert int(got_n) == n_new
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.int64 and got[k].shape == (len(w["flag"]),), k
        assert np.array_equal(got[k].numpy(), v), k


@pytest.mark.parametrize("case", list(CASES))
def test_compact_stage_on_cpu_runs_the_plain_twin(case):
    """On CPU tensors the stage is the twin: the same rows, and ``n_new``
    in the wave's counter vector (``acc[1]``); the kernel's launch count
    does not move."""
    w = wave(case)
    args = torch_inputs(w)
    want, n_new = fw.compact_plain(*args)
    acc = torch.full((6,), -7, dtype=torch.int64)
    before = fw.compact_launches
    got = fw.compact_stage(*args, acc)
    assert fw.compact_launches == before
    assert acc.tolist() == [-7, int(n_new), -7, -7, -7, -7]
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if case == "none_fresh":
        assert int(n_new) == 0
    elif case in ("all_fresh", "one_lane"):
        assert int(n_new) == len(w["flag"])
