"""The two halves of the port's coverage twin on the CPU, against the reference.

On the card the fused chain's coverage vector has no stage of its own:
``fw_frontier`` adds its frontier half and ``fw_compact`` its fresh half.
Their plain twins are ``ops/fused_wave.py::coverage_frontier_plain`` and
``coverage_fresh_plain``, and ``coverage_plain`` is their sum. Here, on
random inputs made with numpy from a seed (properties of all three kinds,
masked and depth-capped lanes, one action or many), each half is zero
outside its own counters, the halves sum to ``coverage_plain``, and the sum
equals the JAX package's ``DeviceCoverage.wave_reduce``
(``stateright_tpu/telemetry/coverage.py``) on the same wave. Every count
is an integer: the tolerance is 0. The kernels are held to the halves on
the card (``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu.telemetry.coverage import DeviceCoverage as JaxDeviceCoverage
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

DEPTH_CAP = 9


def wave(A, P, F, masked, seed):
    """A spec with coverage on and ``coverage_plain``'s inputs, as numpy
    arrays: valid bytes, depths (some past the cap, children past the 64
    depth bins), mask, conditions, antecedents, ``ebits_after``, the sweep's
    outcome bytes (fresh = 1) in sorted order and each position's lane."""
    rng = np.random.default_rng(seed)
    kinds = tuple(("always", "sometimes", "eventually")[i % 3] for i in range(P))
    ev = [i for i, k in enumerate(kinds) if k == "eventually"]
    spec = fw.FusedWaveSpec(expand=None, within_boundary=None,
                            conditions=(None,) * P, expectations=kinds,
                            ebit=tuple((pi, b) for b, pi in enumerate(ev)), action_count=A,
                            cov_layout=DeviceCoverage(A, P))
    B = F * A
    depth = rng.integers(0, 80, size=F)
    depth[rng.random(F) < 0.7] = DEPTH_CAP - 1
    ins = {
        "cvalid": (rng.random(B) < 0.3) & np.repeat(rng.random(F) < 0.8, A),
        "depth": depth,
        "mask": rng.random(F) < 0.75 if masked else None,
        "cond": rng.random((P, F)) < 0.4,
        "ant": np.where(np.array([k == "always" for k in kinds])[:, None],
                        rng.random((P, F)) < 0.6, True),
        "ebits_after": rng.integers(0, 1 << 20, size=F),
        "flag": rng.choice(np.array([0, 1, 2, 4], np.uint8), size=B),
        "idx": rng.permutation(B).astype(np.int32),
    }
    return spec, ins


def jax_vector(spec, ins):
    """The JAX package's ``wave_reduce`` of the same wave."""
    A, P = spec.action_count, len(spec.expectations)
    F = ins["depth"].shape[0]
    eval_mask = ins["depth"] < DEPTH_CAP
    if ins["mask"] is not None:
        eval_mask &= ins["mask"]
    ebit = dict(spec.ebit)
    exercised = []
    for i, kind in enumerate(spec.expectations):
        if kind == "always":
            exercised.append(eval_mask & ins["ant"][i])
        elif kind == "sometimes":
            exercised.append(eval_mask & ins["cond"][i])
        else:
            exercised.append(eval_mask & (((ins["ebits_after"] >> ebit[i]) & 1) == 0))
    lane = ins["idx"].astype(np.int64)
    vec = JaxDeviceCoverage(A, P).wave_reduce(
        eval_mask=jnp.asarray(eval_mask),
        cvalid=jnp.asarray(ins["cvalid"].reshape(F, A) & eval_mask[:, None]),
        fresh=jnp.asarray((ins["flag"] & 1) != 0),
        lane_action=jnp.asarray(lane % A, jnp.int32),
        new_depth=jnp.asarray(ins["depth"][lane // A] + 1, jnp.int32),
        exercised=[jnp.asarray(e) for e in exercised],
    )
    return np.asarray(vec).astype(np.int64).tolist()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("P", [0, 3, 7])
@pytest.mark.parametrize("A", [1, 5, 42])
def test_coverage_halves_sum_to_the_reference(A, P, masked):
    spec, ins = wave(A, P, 301, masked, seed=A * 10 + P)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ins.items()}
    front = fw.coverage_frontier_plain(spec, t["cvalid"], t["depth"], DEPTH_CAP, t["mask"],
                                       t["cond"], t["ant"], t["ebits_after"])
    fresh = fw.coverage_fresh_plain(spec, t["depth"], t["flag"], t["idx"])
    whole = fw.coverage_plain(spec, t["cvalid"], t["depth"], DEPTH_CAP, t["mask"], t["cond"],
                              t["ant"], t["ebits_after"], t["flag"], t["idx"])
    lay = spec.cov_layout
    in_fresh = torch.zeros(lay.size, dtype=torch.bool)
    in_fresh[lay.s_fresh] = True
    in_fresh[lay.s_depth] = True
    assert front.dtype == fresh.dtype == torch.int64
    assert not front[in_fresh].any() and not fresh[~in_fresh].any()
    assert (front + fresh).tolist() == whole.tolist()
    assert whole.tolist() == jax_vector(spec, ins)
    assert int(front[0]) > 0 and int(fresh[lay.s_fresh].sum()) == int((ins["flag"] & 1).sum())
