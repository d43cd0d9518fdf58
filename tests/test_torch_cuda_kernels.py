"""The port's CUDA kernels on the card, against their plain torch twins.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor
the JAX package, so it runs on a machine with only PyTorch; there, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.interop import keys_from_numpy, table_from_numpy, table_to_numpy
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import hashset_kernel as hk
from stateright_tpu_torch.ops.hashset import MAX_PROBES

TILE_ROWS = hk.TILE_ROWS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sorted_batch(rng, n, active_frac=0.9, dup_frac=0.0, span=None):
    hi = rng.integers(0, span or (1 << 32), size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    if dup_frac:
        k = max(1, int(n * dup_frac))
        hi[:k] = hi[n // 2 : n // 2 + k]
        lo[:k] = lo[n // 2 : n // 2 + k]
    active = rng.random(n) < active_frac
    hi = np.where(active, hi, 0xFFFFFFFF).astype(np.uint32)
    lo = np.where(active, lo, 0xFFFFFFFF).astype(np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order], active[order]


def empty_table(cap):
    return np.zeros((cap + MAX_PROBES, 2), np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "dense_overflow", "probe_overflow", "cross_tile"])
def test_cuda_insert_matches_plain_twin(cuda_device, case):
    rng = np.random.default_rng(0)
    if case == "random":
        table = empty_table(TILE_ROWS * 8)
        hi, lo, active = sorted_batch(rng, 20000, dup_frac=0.1)
    elif case == "dense_overflow":
        table = empty_table(TILE_ROWS * 2)
        hi, lo, active = sorted_batch(rng, 3500, active_frac=1.0, dup_frac=0.2, span=1 << 31)
    elif case == "probe_overflow":
        table = empty_table(TILE_ROWS * 2)
        n = MAX_PROBES + 16
        hi, lo, active = np.zeros(n, np.uint32), np.arange(1, n + 1, dtype=np.uint32), np.ones(n, bool)
    else:
        table = empty_table(TILE_ROWS * 2)
        shift = 32 - ((TILE_ROWS * 2).bit_length() - 1)
        hi = np.concatenate([np.full(64, (TILE_ROWS - 1) << shift), np.full(64, TILE_ROWS << shift)]).astype(np.uint32)
        lo = np.concatenate([np.arange(1, 65), np.arange(1, 65)]).astype(np.uint32)
        active = np.ones(128, bool)
    khi, klo = keys_from_numpy(hi, lo)
    act = torch.from_numpy(active)
    before = hk.launches
    pt, pf, pfo, pp = hk.hashset_insert_sorted(table_from_numpy(table), khi, klo, act)
    ct, cf, cfo, cp = hk.hashset_insert_sorted(
        table_from_numpy(table, cuda_device), khi.to(cuda_device),
        klo.to(cuda_device), act.to(cuda_device),
    )
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert np.array_equal(table_to_numpy(ct), table_to_numpy(pt))
    for p, c in ((pf, cf), (pfo, cfo), (pp, cp)):
        assert torch.equal(p, c.cpu())


@pytest.mark.cuda
def test_cuda_checker_matches_cpu_twin(cuda_device):
    """2pc-5 on the card and on the CPU twin: same counts, same paths."""
    runs = [
        TwoPhaseSys(5).checker().spawn_gpu_bfs(
            frontier_capacity=256, table_capacity=1 << 12, device=d
        ).join()
        for d in (cuda_device, "cpu")
    ]
    gpu, cpu = runs
    assert gpu.unique_state_count() == cpu.unique_state_count() == 8832
    assert gpu.state_count() == cpu.state_count()
    assert gpu.max_depth() == cpu.max_depth()
    assert gpu.table_growths == cpu.table_growths >= 1
    for name, path in cpu.discoveries().items():
        assert gpu.discoveries()[name].encode() == path.encode()
