"""The port's per-stage wave breakdown and must-move byte counts
(``stateright_tpu_torch/checker/breakdown.py``) on the CPU: the must-move
counts equal the figures ``PERF.md`` §6 quotes for the waves
``chip_smoke.py`` timed on the card, exactly (tolerance 0), and hand
counts on small inputs made from a numpy seed; ``measure_wave_breakdown``
returns the JAX package's keys that have a meaning here, stage names that
are ``kernel_chain``'s (fused) or ``torch_wave``'s (staged), and the same
representative frontier as the JAX package's ``measure_wave_breakdown``
(live lanes, bucket, ladder: exact); ``measure_pipeline_choice`` returns
the JAX keys."""

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

from stateright_tpu.checker.breakdown import measure_wave_breakdown as jax_measure_wave_breakdown
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu.telemetry import metrics_registry as jax_metrics_registry
from stateright_tpu_torch.checker import breakdown as bd
from stateright_tpu_torch.checker.gpu import wave_spec
from stateright_tpu_torch.configs import CONFIGS
from stateright_tpu_torch.core.batch import leaves
from stateright_tpu_torch.interop import keys_from_numpy, table_to_numpy
from stateright_tpu_torch.models.paxos import PaxosModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import fused_wave as fw
from stateright_tpu_torch.ops.hashset import hashset_new
from stateright_tpu_torch.ops.hashset_kernel import hashset_insert_sorted


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_registry():
    """Leave the JAX package's process-wide registry empty, as a fresh
    process has it, for that package's own tests."""
    yield
    jax_metrics_registry().reset()


def _spec(name):
    return wave_spec(CONFIGS[name].make(), "cpu")


# -- the figures PERF.md §6 quotes ------------------------------------------------


def test_keys_must_move_pins_the_fold_route_figures():
    # 2pc-8 (B = 344,064, F = 8,192, W = 11): 82,156 valid lanes.
    assert bd.keys_must_move(344_064, 11, 8192, False, 82_156) == 8_120_464
    # 2pc-8 and skv4x4 coverage takes (masked): 97,043 and 67,384 valid.
    assert bd.keys_must_move(344_064, 11, 8192, True, 97_043) == 8_783_684
    assert bd.keys_must_move(196_608, 16, 8192, True, 67_384) == 6_909_440


def test_frontier_must_move_pins_the_figures():
    assert bd.frontier_must_move(_spec("2pc8"), 8192, False) == 122_936
    assert bd.frontier_must_move(_spec("raft5_ttc"), 2048, True) == 284_712


def test_sort_dedup_and_compact_must_move_pin_the_figures():
    assert bd.sort_must_move(344_064) == 8_257_536
    assert bd.sort_must_move(256_000) == 6_144_000
    # 2pc-8's wave into the 2^22-row table: 2,048 tiles.
    assert bd.dedup_must_move(344_064, 2048) == 3_112_968
    assert bd.compact_must_move(344_064, 18_311) == 1_369_480
    assert bd.compact_must_move(256_000, 11_561) == 903_416


def test_stats_and_gather_must_move_pin_the_figures():
    assert bd.stats_must_move(len(_spec("raft5_ttc").conditions)) == 120
    assert bd.stats_must_move(len(_spec("skv4x4").conditions)) == 264
    # paxos3 rows are 4,304 B, raft5 rows 2,600 B.
    for name, n_new, want in (("paxos3", 2600, 22_401_600), ("raft5_ttc", 11_561, 60_209_688)):
        row = sum(x[0].numel() * x.element_size()
                  for x in leaves(CONFIGS[name].make().packed_init_states("cpu")))
        assert bd.gather_must_move(n_new, row) == want


# -- hand counts on small inputs -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probed_rows_and_insert_must_move_count_the_probes(seed):
    """On a table the plain insert filled, each distinct key's probe reads
    the rows from its home to its own row, each row once: counted here
    one key at a time."""
    rng = np.random.default_rng(seed)
    k = np.unique(rng.integers(1, 1 << 64, 600, dtype=np.uint64))
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    active = rng.random(k.shape[0]) < 0.9
    table, fresh, _f, pending = hashset_insert_sorted(
        hashset_new(1 << 11), *keys_from_numpy(hi, lo), torch.from_numpy(active))
    assert not bool(pending.any())
    after = table_to_numpy(table)
    rows = (after[:, 0].astype(np.uint64) << np.uint64(32)) | after[:, 1].astype(np.uint64)
    read = set()
    for key in k[active]:
        home = int(key >> np.uint64(53))
        read.update(range(home, int(np.flatnonzero(rows == key)[0]) + 1))
    assert bd.probed_rows(after, k[active]) == len(read)
    B = k.shape[0]
    assert bd.insert_must_move(after, hi, lo, active, fresh.numpy()) == (
        len(read) * 8 + int(active.sum()) * 8 + B * 12)


def test_sweep_pairs_and_fused_wave_must_move_by_hand():
    assert bd.sweep_must_move(100, 3, 40, 7) == 100 * 8 + 100 + 4 * 8 + 40 * 8 + 100 + 7 * 8
    assert bd.pairs_keys_must_move(100, 10, True) == 100 * 21 + 10 * 5
    assert bd.fused_wave_must_move(1100, 100, 10, 2, 40, 7, 88) == (
        1100 * 4 + 100 + 160 + 20 + 320 + 56 + 2 * 7 * 88 + 6 * 7 * 4 + 11 * 8)


def test_comphash_and_coverage_must_move_by_hand():
    from stateright_tpu_torch.telemetry.coverage import DeviceCoverage

    model = PaxosModelCfg(2, 2).into_model()
    spec = wave_spec(model, "cpu")
    lay = spec.comphash["layout"]
    F = 4
    cond, cvalid, cand = fw.model_stage(spec, model.packed_init_states("cpu"), 1)
    valid = cvalid.clone()
    envs = int(((cand["net_cnt"] != 0) & valid[:, None]).sum())
    n = int(valid.sum())
    words = n * (lay["N"] * (lay["R"] + 1) + lay["H"] + lay["E"]) + envs * (2 + lay["W"])
    assert not lay["ordered"]
    assert bd.comphash_must_move(spec, cand, valid, F) == (
        valid.shape[0] * 13 + F * 5 + words * 4)
    cov = DeviceCoverage(spec.action_count, len(spec.conditions))
    cspec = dataclasses.replace(spec, cov_layout=cov)
    per_eval = spec.action_count + spec.expectations.count("sometimes")
    assert bd.coverage_must_move(cspec, F, 3, 5, 2, False) == (
        F * 8 + 3 * per_eval + 5 + 8 + 8 * cov.size)


# -- measure_wave_breakdown ------------------------------------------------------------

KEYS = {"stages_ms", "fused_wave_ms", "fused_wave_fixed_ms", "bucket_fused_ms", "compact_ms",
        "candidates_per_wave", "live_lanes", "device_kind", "hbm_bytes_per_candidate",
        "fused_wave_hbm_bytes", "hbm_peak_gbps", "hbm_roofline_attainment"}


def _marks(fn):
    return re.findall(r'mark\("(\w+)"\)', inspect.getsource(fn))


@pytest.fixture(scope="module")
def jax_breakdown():
    return jax_measure_wave_breakdown(JaxTwoPhaseSys(4), frontier_capacity=512,
                                      table_capacity=1 << 14, warmup_waves=3, iters=1,
                                      wave_dedup="sort")


@pytest.mark.parametrize("wave_kernel", ["fused", "staged"])
def test_breakdown_keys_stages_and_frontier_match_jax(wave_kernel, jax_breakdown):
    got = bd.measure_wave_breakdown(TwoPhaseSys(4), frontier_capacity=512,
                                    table_capacity=1 << 14, warmup_waves=3, iters=2,
                                    wave_kernel=wave_kernel, device="cpu")
    assert KEYS <= set(got)
    assert not {"flops_per_candidate", "stage_cost", "bytes_per_candidate"} & set(got)
    for k in ("live_lanes", "bucket", "bucket_ladder", "frontier_fill", "candidates_per_wave",
              "frontier_capacity", "table_capacity"):
        assert got[k] == jax_breakdown[k], k
    assert got["bucket"] < got["frontier_capacity"]  # the ladder picked a narrower rung
    if wave_kernel == "fused":
        assert list(got["stages_ms"]) == ["expand", "properties"] + _marks(fw.kernel_chain)
        assert list(got["stage_bytes"]) == _marks(fw.kernel_chain)
    else:
        want = [m for m in _marks(fw.model_stage) + _marks(fw.torch_wave)
                + _marks(fw._staged_wave) if m not in ("keys", "coverage")]
        assert sorted(got["stages_ms"]) == sorted(want)
    assert all(ms >= 0 for ms in got["stages_ms"].values())
    assert set(got["bucket_fused_ms"]) == {str(w) for w in got["bucket_ladder"]}
    assert got["fused_wave_hbm_bytes"] == sum(got["stage_bytes"].values()) > 0
    assert got["hbm_bytes_per_candidate"] == got["fused_wave_hbm_bytes"] / got[
        "candidates_per_wave"]
    # No device time on the CPU: no roofline.
    assert got["device_kind"] == "cpu"
    assert got["hbm_peak_gbps"] is None and got["hbm_roofline_attainment"] is None


def test_breakdown_of_the_fingerprint_only_wave_and_the_pipeline_choice():
    model = PaxosModelCfg(2, 2).into_model()
    got = bd.measure_wave_breakdown(model, frontier_capacity=64, table_capacity=1 << 12,
                                    warmup_waves=4, iters=1, wave_kernel="staged",
                                    device="cpu")
    assert got["pipeline"] == "fps" and got["keys_route"] == "comphash"
    assert {"expand_fps", "materialize", "insert"} <= set(got["stages_ms"])
    assert "fingerprint" not in got["stages_ms"]
    choice = bd.measure_pipeline_choice(model, frontier_capacity=64, table_capacity=1 << 12,
                                        iters=1, device="cpu")
    assert choice["supported"] and choice["pipeline"] == "fps"
    assert {"fps_ms", "materialize_ms", "measured_faster", "live_lanes"} <= set(choice)
    assert choice["measured_faster"] in ("fps", "materialize")
    assert bd.measure_pipeline_choice(TwoPhaseSys(3), device="cpu") == {"supported": False}


def test_breakdown_refuses_an_unknown_engine_and_runs_on_cuda_by_default():
    with pytest.raises(ValueError):
        bd.measure_wave_breakdown(TwoPhaseSys(3), wave_kernel="megakernel", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bd.measure_wave_breakdown(TwoPhaseSys(3))
