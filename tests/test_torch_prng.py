"""The port's threefry (code_robchar_tpu_torch/ops/prng.py) against
jax.random: key words, fold_in, split and raw bits bit for bit; uniform
bit for bit on the range normal draws from; normal to the rounding of
log1p in erfinv (f32 atol 1e-6, f64 atol 1e-14)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from code_robchar_tpu_torch.ops import prng

SEEDS = [0, 1, 7, 12345, 2**32 + 3]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel worker
    processes, where torch's default of a thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_match_jax(seed):
    tk = prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jax.random.key(seed)))
    data = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(prng.key_from_data(data).numpy(),
                                  tk.numpy())


def test_key_from_data_rejects_non_key_data():
    with pytest.raises(ValueError):
        prng.key_from_data(np.zeros(2, np.int64))
    with pytest.raises(ValueError):
        prng.key_from_data(np.zeros(3, np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_equal(seed):
    gids = np.array([0, 1, 99, 2**31 - 1, 2**31, 2**31 + 5, 3_000_000_000,
                     2**32 - 1], np.uint32)
    jk = jax.random.key(seed)
    want = np.stack([_words(jax.random.fold_in(jk, g)) for g in gids])
    got = prng.fold_in(prng.key(seed), torch.as_tensor(gids.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # a scalar datum folds the same as a batch of one
    np.testing.assert_array_equal(prng.fold_in(prng.key(seed), 99).numpy(),
                                  want[2])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bit_equal(seed, num):
    jk = jax.random.key(seed)
    np.testing.assert_array_equal(prng.split(prng.key(seed), num).numpy(),
                                  _words(jax.random.split(jk, num)))


def test_split_batched_keys_bit_equal():
    jkeys = jax.random.split(jax.random.key(3), 6)
    want = _words(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys))
    got = prng.split(prng.key_from_data(jax.random.key_data(jkeys)), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bit_equal(seed):
    jk = jax.random.key(seed)
    tk = prng.key(seed)
    want32 = np.asarray(jax.random.bits(jk, (3, 5), jnp.uint32))
    np.testing.assert_array_equal(prng.random_bits(tk, (3, 5)).numpy(),
                                  want32.astype(np.int64))
    # a batch of keys draws per key
    jkeys = jax.random.split(jk, 4)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (6,), jnp.uint32))(jkeys))
    got = prng.random_bits(prng.key_from_data(jax.random.key_data(jkeys)),
                           (6,))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("jdt,tdt,ulp", [(jnp.float32, torch.float32, 5e-7),
                                         (jnp.float64, torch.float64, 1e-15)])
def test_uniform_matches_jax(jdt, tdt, ulp):
    jkeys = jax.random.split(jax.random.key(5), 2000)
    tkeys = prng.key_from_data(jax.random.key_data(jkeys))
    # the range normal() draws from: the width rounds to 2, the scaling is
    # exact, and the words are bit-equal
    lo = float(np.nextafter(jdt(-1.0), jdt(0.0)))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (7,), jdt, lo, 1.0))(jkeys))
    np.testing.assert_array_equal(
        prng.uniform(tkeys, (7,), tdt, lo, 1.0).numpy(), want)
    # a general range: XLA may fuse the scale and shift into one FMA, so
    # one rounding of the product may differ (values below 3: one ulp)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (7,), jdt, -2.0, 3.0))(jkeys))
    got = prng.uniform(tkeys, (7,), tdt, -2.0, 3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    assert got.min() >= -2.0 and got.max() < 3.0


@pytest.mark.parametrize("jdt,tdt,atol", [(jnp.float32, torch.float32, 1e-6),
                                          (jnp.float64, torch.float64, 1e-14)])
@pytest.mark.parametrize("seed", [0, 7, 2**32 + 3])
def test_normal_matches_jax(jdt, tdt, atol, seed):
    jkeys = jax.random.split(jax.random.key(seed), 20000)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (7,), jdt))(jkeys))
    got = prng.normal(prng.key_from_data(jax.random.key_data(jkeys)), (7,),
                      tdt)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # the tails reach |x| ~ 4.5, where XLA's erfinv polynomial departs
    # from the exact function: the port follows the polynomial
    assert np.abs(want).max() > 4.0


def test_normal_rejects_other_dtypes():
    with pytest.raises(ValueError):
        prng.normal(prng.key(0), (3,), torch.float16)
