"""The port's threefry PRNG and k-means against jax.random and the JAX
package's kmeans_core, on the same numpy inputs."""
import jax
import numpy as np
import pytest
import torch

from tiler_tpu.ops import kmeans as jkmeans
from tiler_tpu_torch.ops import kmeans as tkmeans
from tiler_tpu_torch.ops import prng
from tiler_tpu_torch.utils import dispatch

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


def _jax_schedule(seed, n, k):
    """The JAX package's key chain of a seeding: k0, key = split(key),
    first = randint(k0, (), 0, n), then key, kk = split(key) per draw."""
    k0, key = jax.random.split(jax.random.PRNGKey(seed))
    rows = [(int(jax.random.randint(k0, (), 0, n)), 0)]
    for _ in range(1, k):
        key, kk = jax.random.split(key)
        rows.append(_key(kk))
    return rows


@pytest.mark.parametrize('seed,n,k', [
    (SEED, 194400, 128), (SEED, 16384, 128), (0, 1, 2), (1, 1000, 16),
    (2**31 - 1, 7, 1), (12345, 162000, 5)])
def test_key_schedule_matches_jax(seed, n, k):
    """The seeding's keys computed up front on the host: the first row
    and every draw's key are jax.random's split chain and randint."""
    got = tkmeans.key_schedule(prng.prng_key(seed), n, k)
    assert got == _jax_schedule(seed, n, k)
    assert all(type(v) is int for row in got for v in row)


def test_plain_seeding_notes_one_upload(rng):
    """The plain seeding, as the kernel's path, uploads the key schedule
    once and waits on nothing: one h2d, no d2h or sync, no launch."""
    x = torch.from_numpy(_features(rng, n=300))
    x2 = torch.sum(x * x, dim=1)
    before = dispatch.snapshot()
    cents = tkmeans._plus_plus_init(x, x2, 16, prng.prng_key(SEED))
    assert dispatch.delta(before) == dict(h2d=1, d2h=0, sync=0, kernel=0,
                                          total=1)
    assert cents.shape == (16, 192)


def test_plus_plus_plain_draws_jax_rows(rng):
    """plus_plus on CPU tensors is the plain version: its indices are
    the rows of the JAX package's centroids, int64 as the kernel writes
    them, its centroids those rows."""
    x = _features(rng, n=500)
    k = 12
    want = np.asarray(jax.jit(jkmeans._plus_plus_init,
                              static_argnames=('k',))(
        x, k=k, key=jax.random.PRNGKey(SEED)))
    xt = torch.from_numpy(x)
    sched = torch.tensor(tkmeans.key_schedule(prng.prng_key(SEED), 500, k))
    cents, idx = tkmeans.plus_plus(xt, torch.sum(xt * xt, dim=1), sched)
    np.testing.assert_array_equal(cents.numpy(), want)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(x[idx.numpy()], want)


def test_plus_plus_checks_its_operands():
    x = torch.zeros((10, 192))
    x2 = torch.zeros(10)
    sched = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        tkmeans.plus_plus(x, x2[:5], sched)
    with pytest.raises(ValueError):
        tkmeans.plus_plus(x, x2, sched[:, :1])
    with pytest.raises(TypeError):
        tkmeans.plus_plus(x.double(), x2, sched)
    with pytest.raises(TypeError):
        tkmeans.plus_plus(x, x2, sched.int())
    with pytest.raises(ValueError):
        tkmeans.plus_plus(x[:0], x2[:0], sched)
    with pytest.raises(ValueError):
        tkmeans.plus_plus(x.to('meta'), x2.to('meta'), sched.to('meta'))


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
