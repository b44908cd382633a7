"""The port's exact 1-NN (tiler_tpu_torch.ops.nn_kernels) against the JAX
package's Pallas kernel, run in interpret mode on the CPU, and its jnp
scan. On the CPU the wrapper runs the plain torch version; the CUDA
kernel itself is checked on the card by chip_smoke.py."""
import itertools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.ops import knn
from tiler_tpu.ops.pallas_kernels import _nn_call
from tiler_tpu_torch.ops import nn_kernels as nk


def _pallas(q, c, bq, bc):
    err, idx = _nn_call(jnp.asarray(q), jnp.asarray(c), bq, bc, True)
    return np.asarray(idx), np.asarray(err)


def _port(q, c):
    idx, err = nk.nearest_1(torch.from_numpy(q), torch.from_numpy(c))
    return idx.numpy(), err.numpy()


def _near_tie_only(q, c, idx_a, idx_b, rtol=1e-4):
    """Where two index choices differ, their float64 distances agree to
    rtol (a near tie that f32 rounding may break either way)."""
    bad = np.flatnonzero(idx_a != idx_b)
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    da = ((q64[bad] - c64[idx_a[bad]]) ** 2).sum(1)
    db = ((q64[bad] - c64[idx_b[bad]]) ** 2).sum(1)
    np.testing.assert_allclose(da, db, rtol=rtol)


@pytest.mark.parametrize('reference', ['pallas_interpret', 'jnp_scan'])
def test_random_features_match_reference(rng, reference):
    q = rng.normal(0, 1, (256, 192)).astype(np.float32)
    c = rng.normal(0, 1, (2048, 192)).astype(np.float32)
    if reference == 'pallas_interpret':
        idx_r, err_r = _pallas(q, c, 128, 512)
    else:
        idx_r, err_r = knn.nearest_1(q, c, c_chunk=512)
    idx_p, err_p = _port(q, c)
    assert idx_p.dtype == np.int32 and err_p.dtype == np.float32
    np.testing.assert_allclose(err_p, err_r, rtol=1e-5, atol=1e-4)
    _near_tie_only(q, c, idx_p, idx_r)


def test_exact_eye_case():
    q = np.eye(8, 192, dtype=np.float32) * 5
    c = np.eye(8, 192, dtype=np.float32) * 5.1
    idx_r, err_r = _pallas(q, c, 8, 8)
    idx_p, err_p = _port(q, c)
    np.testing.assert_array_equal(idx_p, np.arange(8))
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(err_p, err_r)


def test_integer_features_exact_with_duplicates_and_padding(rng):
    """Integer-valued features make every distance exact: index and
    distance equal the reference's bit for bit, duplicated candidates
    resolve to the lowest index, and 1e9 padding rows never win."""
    c = rng.integers(0, 16, (1024, 192)).astype(np.float32)
    c[512:768] = c[0:256]                       # duplicates of rows 0..255
    q = np.concatenate([c[:256], rng.integers(0, 16, (256, 192))
                        .astype(np.float32)])
    cpad = np.concatenate([c, np.full((1024, 192), 1e9, np.float32)])
    idx_r, err_r = _pallas(q, cpad, 128, 512)
    idx_p, err_p = _port(q, cpad)
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(err_p, err_r)
    np.testing.assert_array_equal(idx_p[:256], np.arange(256))
    assert (idx_p < 1024).all()
    np.testing.assert_array_equal(_port(q, c)[0], idx_p)


def test_ragged_sizes_and_chunking(rng):
    """Sizes that fit no block or chunk; the plain version's chunk size
    does not change the result (strict < across chunks keeps the earlier
    index on an exact tie)."""
    q = rng.integers(0, 8, (37, 192)).astype(np.float32)
    c = rng.integers(0, 8, (1013, 192)).astype(np.float32)
    c[1000:1013] = c[3:16]
    idx_r, err_r = knn.nearest_1(q, c, c_chunk=256)
    idx_p, err_p = _port(q, c)
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(err_p, err_r)
    for chunk in (1, 100, 4096):
        i2, e2 = nk.nearest_1_plain(torch.from_numpy(q), torch.from_numpy(c),
                                    c_chunk=chunk)
        np.testing.assert_array_equal(i2.numpy(), idx_p)


def test_candidate_ranges_cover_every_tile():
    """The kernel's split of the candidate tiles into ranges: the ranges
    cover every 256-row tile once and none is empty; a full query chunk
    (one 128-query tile for each of the 132 SMs, or the 16384 of the TPU
    kernel) keeps one range, a short one spreads over the SMs."""
    assert (nk._BQ, nk._BC) == (128, 256)
    for n_q, n_c in itertools.product(
            (1, 128, 129, 2000, 9000, 16384, 16896),
            (1, 129, 257, 5013, 262144, 1500000)):
        n, per = nk.candidate_ranges(n_q, n_c, 132)
        assert n >= 1 and per >= 1
        assert (n - 1) * per < -(-n_c // 256) <= n * per
    for full in (16384, 16896):
        assert nk.candidate_ranges(full, 1500000, 132)[0] == 1
        assert nk.candidate_ranges(full, 262144, 132) == (1, 1024)
    assert nk.candidate_ranges(2000, 1500000, 132)[0] == 8
    assert nk.candidate_ranges(9000, 262144, 132)[0] == 9
    assert nk.candidate_ranges(12000, 262144, 132)[0] == 7
    assert nk.full_chunk('cpu') == 16384


@pytest.mark.parametrize('dim', [3, 100, 192, 200])
@pytest.mark.parametrize('n_c', [1, 255, 1013])
def test_prepare_plain_layout_padding_and_norms(rng, dim, n_c):
    """The plain form of the prepare kernel: per 256-candidate tile the
    candidates k-major with the width padded to 8, zeros in the padding,
    and a last row of norms with +inf in the padding; the norms' summation
    order keeps integer features exact and normal ones within one f32
    rounding per step of the float64 norm."""
    for kind in ('int', 'normal'):
        c = rng.integers(0, 16, (n_c, dim)).astype(np.float32) \
            if kind == 'int' else \
            rng.normal(0, 1, (n_c, dim)).astype(np.float32)
        p = nk.prepare(torch.from_numpy(c))
        assert isinstance(p, nk.Prepared) and (p.n_c, p.dim) == (n_c, dim)
        d_pad, tiles = -(-dim // 8) * 8, -(-n_c // 256)
        assert p.ct.shape == (tiles, d_pad + 1, 256)
        assert p.ct.dtype == torch.float32 and p.ct.is_contiguous()
        # tile by tile: [k, column] features, then the row of norms
        flat = p.ct.numpy().transpose(1, 0, 2).reshape(d_pad + 1, -1)
        ct, c2 = flat[:d_pad], flat[d_pad]
        np.testing.assert_array_equal(ct[:dim, :n_c], c.T)
        assert not ct[dim:].any() and not ct[:, n_c:].any()
        assert np.isposinf(c2[n_c:]).all()
        np.testing.assert_array_equal(p.norms().numpy(), c2[:n_c])
        want = (c.astype(np.float64) ** 2).sum(1)
        if kind == 'int':
            np.testing.assert_array_equal(c2[:n_c], want.astype(np.float32))
        else:
            np.testing.assert_allclose(c2[:n_c], want, rtol=2e-6)
        np.testing.assert_array_equal(p.rows().numpy(), c)


@pytest.mark.parametrize('dim', [3, 100, 192, 200])
def test_prepared_form_equals_raw_form(rng, dim):
    """nearest_1(q, prepare(c)) is nearest_1(q, c), for nearest_1 and on
    reuse of one prepared set by several query chunks."""
    c = rng.normal(0, 1, (1013, dim)).astype(np.float32)
    q = rng.normal(0, 1, (300, dim)).astype(np.float32)
    c[1000:1013] = c[3:16]
    q[:13] = c[3:16]
    qt, prep = torch.from_numpy(q), nk.prepare(torch.from_numpy(c))
    idx_p, err_p = _port(q, c)
    for lo, hi in ((0, 300), (0, 37), (37, 300)):
        idx, err = nk.nearest_1(qt[lo:hi].contiguous(), prep)
        np.testing.assert_array_equal(idx.numpy(), idx_p[lo:hi])
        np.testing.assert_array_equal(err.numpy(), err_p[lo:hi])
    np.testing.assert_array_equal(idx_p[:13], np.arange(3, 16))


def test_wrapper_checks_and_cpu_path_does_not_count():
    q = torch.zeros((4, 192))
    c = torch.ones((8, 192))
    before = nk.LAUNCHES
    nk.nearest_1(q, c)
    assert nk.LAUNCHES == before
    with pytest.raises(TypeError):
        nk.nearest_1(q.double(), c.double())
    with pytest.raises(ValueError):
        nk.nearest_1(q, torch.ones((8, 64)))
    with pytest.raises(ValueError):
        nk.nearest_1(q, torch.ones((8, 384))[:, ::2])
    with pytest.raises(ValueError):
        nk.nearest_1(q, torch.ones((0, 192)))
    before = (nk.LAUNCHES, nk.LAUNCHES_PREP)
    prep = nk.prepare(c)
    nk.nearest_1(q, prep)
    assert (nk.LAUNCHES, nk.LAUNCHES_PREP) == before
    with pytest.raises(ValueError):
        nk.nearest_1(torch.zeros((4, 64)), prep)
    with pytest.raises(ValueError):
        nk.nearest_1(q, nk.Prepared(prep.ct[:, :-1], 8, 192))
    with pytest.raises(ValueError):
        nk.prepare(torch.ones((8, 300)))


def test_module_imports_without_nvcc_or_build():
    """Importing the wrapper builds nothing and needs no CUDA toolkit."""
    code = ('import os, tiler_tpu_torch.ops.nn_kernels as nk; '
            'assert nk._lib is None; assert nk.LAUNCHES == 0; '
            'print(os.path.exists(nk._SO))')
    env = {'PATH': '/usr/bin:/bin'}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, cwd=repo, timeout=120)
    assert out.returncode == 0, out.stderr
