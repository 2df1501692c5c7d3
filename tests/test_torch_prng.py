"""The port's threefry2x32 PRNG (``repro_torch.inference.prng``) equals
``jax.random`` bit for bit: keys, split, fold_in, 32-bit draws, float32
uniforms and permutations, with JAX's partitionable-threefry semantics."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.inference import prng  # noqa: E402

SEEDS = [0, 1, 2**31 - 1]
SIZES = [1, 10, 1430, 1626, 8508]


def test_jax_runs_partitionable_threefry():
    """The semantics the port copies; a JAX default that changes fails
    here first."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def test_golden_values():
    k = prng.prng_key(0)
    assert k.tolist() == [0, 0]
    assert prng.split(k, 2).tolist() == [[1797259609, 2579123966],
                                         [928981903, 3453687069]]
    assert prng.fold_in(k, 3).tolist() == [2467461003, 3840466878]
    assert prng.permutation(k, 10).tolist() == [0, 1, 8, 5, 6, 4, 3, 2, 7, 9]


def test_shuffle_rounds():
    assert [prng.shuffle_rounds(n) for n in (1, 10, 1430, 1625, 1626, 8508)] \
        == [0, 1, 1, 1, 2, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(prng.split(tk, 7).numpy(),
                                  np.asarray(jax.random.split(jk, 7)))
    for d in (0, 3, 2**31 - 1, 12345):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      np.asarray(jax.random.fold_in(jk, d)))
    # batched keys and data, as the surrogate stage folds in series ids
    ids = np.arange(0, 50, 7)
    want = np.stack([np.asarray(jax.random.fold_in(jk, int(i))) for i in ids])
    np.testing.assert_array_equal(prng.fold_in(tk, torch.tensor(ids)).numpy(), want)
    keys = prng.split(tk, 3)
    want = np.stack([np.asarray(jax.random.split(k, 4))
                     for k in jax.random.split(jk, 3)])
    np.testing.assert_array_equal(prng.split(keys, 4).numpy(), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_permutation_equal_jax(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tk, n).numpy(),
        np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64))
    got = prng.uniform(tk, n, 0.0, prng.TWO_PI_F32).numpy()
    want = np.asarray(jax.random.uniform(jk, (n,), minval=0.0, maxval=2.0 * jnp.pi))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = prng.uniform(tk, (2, n)).numpy()
    want = np.asarray(jax.random.uniform(jk, (2, n)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(prng.permutation(tk, n).numpy(),
                                  np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("n", [10, 1626])
def test_vmapped_shuffle_rows_equal_jax(n):
    """``random_shuffle``'s pattern: vmap of permutation over split keys,
    on float values (two sort rounds at n = 1626)."""
    from repro.inference.surrogates import random_shuffle as jshuffle
    from repro_torch.inference.surrogates import random_shuffle

    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = np.asarray(jshuffle(jax.random.PRNGKey(5), jnp.asarray(x), 6))
    got = random_shuffle(prng.prng_key(5), torch.tensor(x), 6).numpy()
    np.testing.assert_array_equal(got, want)
    # a batch of series, one key each
    keys = prng.split(prng.prng_key(6), 3)
    xs = np.stack([x, -x, 2 * x])
    got = random_shuffle(keys, torch.tensor(xs), 4).numpy()
    want = np.stack([np.asarray(jshuffle(k, jnp.asarray(r), 4))
                     for k, r in zip(jax.random.split(jax.random.PRNGKey(6), 3), xs)])
    np.testing.assert_array_equal(got, want)
