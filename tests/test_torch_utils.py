"""The port's L0 utility types, ``DenseNatMap`` and ``VectorClock``
(``stateright_tpu_torch/utils``), held to the JAX package's copies: the
cases of ``tests/test_utils.py`` run on both packages, and the stable
hashes and fingerprints agree exactly (tolerance 0) on values made from a
numpy seed."""

import numpy as np
import pytest

from stateright_tpu.actor import Id as JaxId
from stateright_tpu.core.fingerprint import fingerprint as jax_fingerprint
from stateright_tpu.core.fingerprint import stable_hash as jax_stable_hash
from stateright_tpu.utils import DenseNatMap as JaxDenseNatMap
from stateright_tpu.utils import RewritePlan as JaxRewritePlan
from stateright_tpu.utils import VectorClock as JaxVectorClock
from stateright_tpu_torch.actor import Id
from stateright_tpu_torch.core.fingerprint import fingerprint, stable_hash
from stateright_tpu_torch.utils import DenseNatMap, VectorClock
from stateright_tpu_torch.utils.rewrite import RewritePlan, rewrite_value

PACKAGES = {
    "port": dict(VC=VectorClock, DM=DenseNatMap, Id=Id, fp=fingerprint, sh=stable_hash,
                 Plan=RewritePlan),
    "jax": dict(VC=JaxVectorClock, DM=JaxDenseNatMap, Id=JaxId, fp=jax_fingerprint,
                sh=jax_stable_hash, Plan=JaxRewritePlan),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# -- the cases of tests/test_utils.py, on both packages ------------------------


def test_vector_clock_incremented_grows(pkg):
    vc = pkg["VC"]().incremented(2)
    assert vc.elems() == (0, 0, 1)
    assert vc.incremented(0).elems() == (1, 0, 1)


def test_vector_clock_merge_max(pkg):
    VC = pkg["VC"]
    assert VC.merge_max(VC([1, 5, 0]), VC([2, 3])) == VC([2, 5, 0])


def test_vector_clock_equality_pads_implicit_zeros(pkg):
    VC = pkg["VC"]
    assert VC([1, 0]) == VC([1])
    assert VC([1, 0]) != VC([1, 1])


def test_vector_clock_hash_truncates_trailing_zeros(pkg):
    VC = pkg["VC"]
    assert hash(VC([1, 0])) == hash(VC([1]))
    assert pkg["sh"](VC([1, 0, 0])) == pkg["sh"](VC([1]))
    assert pkg["fp"](VC([2, 1, 0])) == pkg["fp"](VC([2, 1]))


def test_vector_clock_partial_order(pkg):
    VC = pkg["VC"]
    assert VC([1, 2]) < VC([2, 2])
    assert VC([1, 2]) <= VC([1, 2])
    assert VC([2, 2]) > VC([1, 2])
    assert VC([1, 2, 0]) >= VC([1, 2])


def test_vector_clock_concurrent_clocks_incomparable(pkg):
    a, b = pkg["VC"]([1, 0]), pkg["VC"]([0, 1])
    assert a.concurrent_with(b)
    assert not (a < b) and not (a > b)
    assert not (a <= b) and not (a >= b)


def test_vector_clock_display(pkg):
    assert str(pkg["VC"]([1, 2])) == "<1, 2, ...>"


def test_dense_nat_map_insert_appends_and_overwrites(pkg):
    m, Id_ = pkg["DM"](), pkg["Id"]
    assert m.insert(Id_(0), "a") is None
    assert m.insert(Id_(1), "b") is None
    assert m.insert(Id_(0), "c") == "a"
    assert list(m) == ["c", "b"]


def test_dense_nat_map_out_of_order_insert_raises(pkg):
    with pytest.raises(IndexError):
        pkg["DM"]().insert(pkg["Id"](1), "x")


def test_dense_nat_map_from_pairs_any_order(pkg):
    Id_ = pkg["Id"]
    m = pkg["DM"].from_pairs([(Id_(1), "b"), (Id_(0), "a")])
    assert m.values() == ["a", "b"]
    assert m.items() == [(Id_(0), "a"), (Id_(1), "b")]


def test_dense_nat_map_from_pairs_rejects_sparse(pkg):
    Id_ = pkg["Id"]
    with pytest.raises(ValueError):
        pkg["DM"].from_pairs([(Id_(0), "a"), (Id_(2), "c")])
    with pytest.raises(ValueError):
        pkg["DM"].from_pairs([(Id_(0), "a"), (Id_(0), "b")])


def test_dense_nat_map_rewrite_reindexes(pkg):
    m = pkg["DM"](["b", "a"])
    plan = pkg["Plan"].from_values_to_sort(m.values())
    assert plan.reindex(m.values()) == ["a", "b"]


def test_dense_nat_map_stable_hash_matches_tuple(pkg):
    m = pkg["DM"](["a", "b"])
    assert pkg["fp"](m) != 0
    assert m == pkg["DM"](["a", "b"])
    assert m != pkg["DM"](["b", "a"])


# -- the port against the JAX package ------------------------------------------


def test_port_rewrite_reindexes_dense_nat_map():
    """The port's ``rewrite_value`` reindexes a ``DenseNatMap`` through its
    ``__rewrite__``, as the JAX package's does."""
    m = DenseNatMap(["b", "a"])
    plan = RewritePlan.from_values_to_sort(m.values())
    assert rewrite_value(m, plan).values() == ["a", "b"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hashes_equal_the_jax_packages(seed):
    """Stable hashes and fingerprints of clocks and maps made from a numpy
    seed equal the JAX package's, bit for bit; so do the orders between
    clocks."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        a = [int(x) for x in rng.integers(0, 4, size=int(rng.integers(0, 6)))]
        b = [int(x) for x in rng.integers(0, 4, size=int(rng.integers(0, 6)))]
        assert stable_hash(VectorClock(a)) == jax_stable_hash(JaxVectorClock(a))
        assert fingerprint(VectorClock(a)) == jax_fingerprint(JaxVectorClock(a))
        assert str(VectorClock(a)) == str(JaxVectorClock(a))
        assert VectorClock.merge_max(VectorClock(a), VectorClock(b)).elems() == (
            JaxVectorClock.merge_max(JaxVectorClock(a), JaxVectorClock(b)).elems())
        for op in ("__lt__", "__le__", "__gt__", "__ge__", "concurrent_with", "__eq__"):
            assert getattr(VectorClock(a), op)(VectorClock(b)) == getattr(
                JaxVectorClock(a), op)(JaxVectorClock(b)), (a, b, op)
        vals = [str(x) for x in rng.integers(0, 100, size=int(rng.integers(0, 5)))]
        assert stable_hash(DenseNatMap(vals)) == jax_stable_hash(JaxDenseNatMap(vals))
        assert fingerprint(DenseNatMap(vals)) == jax_fingerprint(JaxDenseNatMap(vals))
        assert hash(DenseNatMap(vals)) == hash(JaxDenseNatMap(vals))
