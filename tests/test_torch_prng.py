"""The port's threefry draws (`repro_torch.prng`) against `jax.random`.

Keys, splits, fold-ins, raw bits, `randint`, `permutation`, `uniform`
and `rademacher` must equal JAX's bit for bit, in the installed jax's
``jax_threefry_partitionable`` mode.  `normal` goes through `log1p`,
which differs between libraries: within 4 ulp of JAX's (3 measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, -7]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(port, ref):
    np.testing.assert_array_equal(_np(port), np.asarray(ref).astype(
        _np(port).dtype))


def test_installed_jax_uses_partitionable_threefry():
    """The mode `prng` reproduces (jax 0.9's default)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _eq(tk, jk)
    for n in (2, 3, 6):
        _eq(prng.split(tk, n), jax.random.split(jk, n))
    _eq(prng.split(tk, (2, 3)), jax.random.split(jk, (2, 3)))
    _eq(prng.fold_in(tk, 7), jax.random.fold_in(jk, 7))
    ids = torch.tensor([0, 5, 2 ** 31 + 3, 70000])
    _eq(prng.fold_in(tk, ids),
        np.stack([np.asarray(jax.random.fold_in(jk, int(i) & 0xFFFFFFFF))
                  for i in ids]))


@pytest.mark.parametrize("shape", [(1,), (7,), (5, 3), (2, 3, 5), (1001,)])
def test_random_bits_odd_sizes(shape):
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    _eq(prng.random_bits(tk, shape), jax.random.bits(jk, shape))


def test_random_bits_of_a_batch_of_keys_is_a_vmap():
    jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
    keys_j = jax.random.split(jk, 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (6,)))(keys_j)
    _eq(prng.random_bits(prng.split(tk, 4), (6,)), want)


@pytest.mark.parametrize("lo,hi", [(0, 30000), (0, 7), (-5, 1234567),
                                   (0, 1), (3, 3), (0, 2 ** 31 - 1)])
def test_randint_matches_for_any_span(lo, hi):
    for seed in (0, 11):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        got = prng.randint(tk, (13, 7), lo, hi)
        assert got.dtype == torch.int32
        _eq(got, jax.random.randint(jk, (13, 7), lo, hi, jnp.int32))


@pytest.mark.parametrize("n", [1, 7, 1000, 70000])
def test_permutation(n):
    for seed in (0, 5):
        got = prng.permutation(prng.PRNGKey(seed), n)
        _eq(got, jax.random.permutation(jax.random.PRNGKey(seed), n))
        assert sorted(got.tolist()) == list(range(n))


def test_uniform_and_rademacher():
    jk, tk = jax.random.PRNGKey(2), prng.PRNGKey(2)
    _eq(prng.uniform(tk, (4097,)), jax.random.uniform(jk, (4097,)))
    _eq(prng.uniform(tk, (33,), -2.0, 3.5),
        jax.random.uniform(jk, (33,), minval=-2.0, maxval=3.5))
    got = prng.rademacher(tk, (64, 9))
    assert got.dtype == torch.float32
    _eq(got, jax.random.rademacher(jk, (64, 9), jnp.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_four_ulp(seed):
    got = prng.normal(prng.PRNGKey(seed), (20000,))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (20000,)))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=4)
    assert (got.numpy() == want).mean() > 0.95


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 300))
def test_draws_match_over_seeds(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _eq(prng.split(tk, 3), jax.random.split(jk, 3))
    _eq(prng.fold_in(tk, n), jax.random.fold_in(jk, n))
    _eq(prng.random_bits(tk, (n,)), jax.random.bits(jk, (n,)))
    _eq(prng.randint(tk, (n,), 0, n + 17),
        jax.random.randint(jk, (n,), 0, n + 17, jnp.int32))
    _eq(prng.permutation(tk, n), jax.random.permutation(jk, n))
    _eq(prng.rademacher(tk, (n,)), jax.random.rademacher(jk, (n,),
                                                         jnp.float32))


def test_draws_follow_the_key_device():
    """Draws land on the key's device (the CPU here); a batch of keys
    drawn on another device gives the same words."""
    tk = prng.PRNGKey(4)
    assert prng.randint(tk, (3,), 0, 9).device == tk.device
    assert torch.equal(prng.random_bits(tk, (5,), device="cpu"),
                       prng.random_bits(tk, (5,)))
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31)
