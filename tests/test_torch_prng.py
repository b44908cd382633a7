"""The port's threefry PRNG and k-means against jax.random and the JAX
package's kmeans_core, on the same numpy inputs."""
import jax
import numpy as np
import pytest
import torch

from tiler_tpu.ops import kmeans as jkmeans
from tiler_tpu_torch.ops import kmeans as tkmeans
from tiler_tpu_torch.ops import prng

SEED = 0x42381337


def _key(k):
    return tuple(int(v) for v in np.asarray(k).astype(np.int64))


@pytest.mark.parametrize('seed', [0, 1, SEED, 2**31 - 1])
def test_key_split_and_bits_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    assert _key(jk) == tk
    for jsub, tsub in zip(jax.random.split(jk, 3), prng.split(tk, 3)):
        assert _key(jsub) == tuple(int(v) for v in tsub)
    a, _ = jax.random.split(jk)
    ta, _ = prng.split(tk)
    bits = np.asarray(jax.random.bits(a, (1001,), np.uint32))
    np.testing.assert_array_equal(prng.random_bits32(ta, 1001).numpy(),
                                  bits.astype(np.int64))
    for n in (1, 2, 7, 1000, 12345, 2**31 - 1):
        assert prng.randint(ta, 0, n) == int(jax.random.randint(a, (), 0, n))


def test_uniform_and_categorical_match_jax(rng):
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    _, tk = prng.split(prng.prng_key(SEED))
    tiny = float(np.finfo(np.float32).tiny)
    u = np.asarray(jax.random.uniform(k, (4096,), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(prng.uniform(tk, 4096, tiny, 1.0).numpy(),
                                  u)
    # the gumbel transform goes through two logs, whose last ulp differs
    # between implementations
    g = np.asarray(jax.random.gumbel(k, (4096,)))
    np.testing.assert_allclose(prng.gumbel(tk, 4096).numpy(), g,
                               rtol=1e-6, atol=1e-6)
    for i in range(20):
        logits = rng.normal(0, 3, 5000).astype(np.float32)
        kk = jax.random.fold_in(k, i)
        tkk = _key(kk)
        assert prng.categorical(tkk, torch.from_numpy(logits)) == \
            int(jax.random.categorical(kk, logits))


def _features(rng, n=600, d=192):
    """Clustered features with exact duplicate rows, like tile features
    of a clip with static regions."""
    centers = rng.normal(0, 10, (24, d))
    x = centers[rng.integers(0, 24, n)] + rng.normal(0, 1, (n, d))
    x[n // 2:n // 2 + 60] = x[:60]
    return x.astype(np.float32)


def test_kmeans_core_matches_jax(rng):
    x = _features(rng)
    k = 16
    jl, jc, _ = jax.jit(jkmeans.kmeans_core, static_argnums=1)(x, k)
    jl, jc = np.asarray(jl), np.asarray(jc)
    tl, tc, _ = tkmeans.kmeans_core(torch.from_numpy(x), k)
    tl, tc = tl.numpy(), tc.numpy()
    assert tl.dtype == np.int32 and tc.shape == (k, 192)
    # labels may differ only where a float64 recheck shows a near tie
    bad = np.flatnonzero(tl != jl)
    x64 = x.astype(np.float64)
    dj = ((x64[bad] - jc[jl[bad]].astype(np.float64)) ** 2).sum(1)
    dt = ((x64[bad] - jc[tl[bad]].astype(np.float64)) ** 2).sum(1)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    assert len(bad) <= len(x) // 100
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-4)
