"""The port's threefry draws (``stateright_tpu_torch/ops/threefry.py``)
against ``jax.random``, exactly: the keys, splits, bits, ``randint`` and
``categorical`` draws the JAX package's walkers make
(``checker/tpu_simulation.py``, ``checker/swarm.py``), on edge keys and on
random keys. Integer equality, no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stateright_tpu_torch.ops import threefry as tf

EDGE_KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF), (0xFFFFFFFF, 0)]
N_RANDOM = 48
RANDINT_N = [1, 2, 3, 7, 50, 65_537, 200_000]
CHOOSE_A = [1, 2, 14, 42, 125]


def _keys():
    rng = np.random.default_rng(2026)
    rand = rng.integers(0, 1 << 32, size=(N_RANDOM, 2), dtype=np.uint64)
    return np.concatenate([np.array(EDGE_KEYS, np.uint64), rand]).astype(np.uint32)


KEYS = _keys()
TKEYS = torch.from_numpy(KEYS.astype(np.int64))


def _i64(x):
    return np.asarray(x).astype(np.int64)


def test_jax_streams_are_partitionable():
    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is off: the JAX package's walks then draw "
        "from other counters than the port's (ops/threefry.py follows the "
        "partitionable streams, JAX's default since 0.5)")


def test_threefry2x32_matches_jax():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(7)
    counts = rng.integers(0, 1 << 32, size=(len(KEYS), 2), dtype=np.uint64).astype(np.uint32)
    want = np.stack([_i64(threefry_2x32(jnp.asarray(k), jnp.asarray(c)))
                     for k, c in zip(KEYS, counts)])
    t = torch.from_numpy(counts.astype(np.int64))
    y0, y1 = tf.threefry2x32(TKEYS[:, 0], TKEYS[:, 1], t[:, 0], t[:, 1])
    assert np.array_equal(torch.stack([y0, y1], 1).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 2**31 - 1, 0xFFFFFFFF, -1, 2**32 + 5])
def test_prng_key_and_lane_keys_match_jax(seed):
    assert np.array_equal(tf.prng_key(seed).numpy(), _i64(jax.random.PRNGKey(seed)))
    want = _i64(jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(64)))
    assert np.array_equal(tf.lane_keys(seed, 64).numpy(), want)


def test_fold_in_and_split_match_jax():
    data = np.array([0, 1, 2, 1000, 2**31 - 1], np.int64)
    for d in data:
        want = _i64(jax.vmap(lambda k: jax.random.fold_in(k, int(d)))(jnp.asarray(KEYS)))
        assert np.array_equal(tf.fold_in(TKEYS, torch.tensor(int(d))).numpy(), want)
    for n in (2, 3, 5):
        want = _i64(jax.vmap(lambda k: jax.random.split(k, n))(jnp.asarray(KEYS)))
        assert np.array_equal(tf.split(TKEYS, n).numpy(), want)


@pytest.mark.parametrize("A", CHOOSE_A)
def test_random_bits_match_jax(A):
    want = _i64(jax.vmap(lambda k: jax.random.bits(k, (A,), jnp.uint32))(jnp.asarray(KEYS)))
    assert np.array_equal(tf.random_bits32(TKEYS, A).numpy(), want)


@pytest.mark.parametrize("n", RANDINT_N)
def test_randint_matches_jax(n):
    want = _i64(jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(jnp.asarray(KEYS)))
    got = tf.randint(TKEYS, n).numpy()
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < n


def _masks(A, rng):
    none = np.zeros((len(KEYS), A), bool)
    one = none.copy()
    one[np.arange(len(KEYS)), rng.integers(0, A, len(KEYS))] = True
    rand = rng.random((len(KEYS), A)) < 0.5
    return {"none": none, "one": one, "random": rand}


@pytest.mark.parametrize("A", CHOOSE_A)
def test_choose_matches_categorical(A):
    rng = np.random.default_rng(A)
    cat = jax.vmap(lambda k, v: jax.random.categorical(k, jnp.where(v, 0.0, -1e30)))
    for kind, valid in _masks(A, rng).items():
        want = _i64(cat(jnp.asarray(KEYS), jnp.asarray(valid)))
        got = tf.choose(TKEYS, torch.from_numpy(valid)).numpy()
        assert np.array_equal(got, want), kind
        some = valid.any(axis=1)
        assert (got[~some] == 0).all()
        assert valid[np.arange(len(KEYS)), got][some].all()


def test_gumbel_noise_rises_strictly_with_the_top_bits():
    """``choose`` rests on this: JAX's Gumbel noise over the 2^23 values of
    a draw's top 23 bits (its uniform's grid) is strictly increasing, so
    the categorical draw over 0 / -1e30 logits is the arg-max of those
    bits over the valid actions."""
    m = jnp.arange(1 << 23, dtype=jnp.uint32)
    f = jax.lax.bitcast_convert_type(m | jnp.uint32(0x3F800000), jnp.float32) - 1.0
    tiny = jnp.finfo(jnp.float32).tiny
    g = np.asarray(-jnp.log(-jnp.log(jnp.maximum(tiny, f * (1.0 - tiny) + tiny))))
    assert (np.diff(g) > 0).all()
    # ... and that grid is JAX's own gumbel draw.
    key = jax.random.PRNGKey(3)
    bits = np.asarray(jax.random.bits(key, (4096,), jnp.uint32))
    assert np.array_equal(np.asarray(jax.random.gumbel(key, (4096,))), g[bits >> 9])


@pytest.mark.parametrize("A", [1, 14, 64])
def test_draw_step_equals_the_separate_draws(A):
    n_seeds = 70_000
    nxt, idx, bits = tf.draw_step(TKEYS, n_seeds, A)
    k3 = tf.split(TKEYS, 3)
    assert np.array_equal(nxt.numpy(), k3[:, 0].numpy())
    assert np.array_equal(idx.numpy(), tf.randint(k3[:, 1], n_seeds).numpy())
    assert np.array_equal(bits.numpy(), tf.random_bits32(k3[:, 2], A).numpy())
    valid = torch.from_numpy(np.random.default_rng(A).random((len(KEYS), A)) < 0.3)
    assert np.array_equal(tf.choose_from_bits(bits, valid).numpy(),
                          tf.choose(k3[:, 2], valid).numpy())
