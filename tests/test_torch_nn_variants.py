"""The port's augmented (K2) and bf16 (K3) 1-NN against the JAX package's
_nn_call_aug and _nn_call_bf16, run in interpret mode on the CPU. On the
CPU the wrappers run their plain torch versions; the CUDA kernels
themselves are checked on the card by chip_smoke.py."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.ops.pallas_kernels import (_augment, _nn_call, _nn_call_aug,
                                          _nn_call_bf16)
from tiler_tpu_torch.ops import nn_kernels as nk


def _jax(call, q, c, bq=128, bc=256):
    err, idx = call(jnp.asarray(q), jnp.asarray(c), bq, bc, True)
    return np.asarray(idx), np.asarray(err)


def _np(out):
    return out[0].numpy(), out[1].numpy()


def _near_tie_only(q, c, idx_a, idx_b, rtol=1e-4, bf16=False):
    """Where two winners differ, their float64 distances (in the bf16
    kernel's metric when bf16) agree to rtol."""
    bad = np.flatnonzero(idx_a != idx_b)
    if not len(bad):
        return
    qb, cb = q.astype(np.float64), c.astype(np.float64)
    if bf16:
        qb = nk.bf16_round(torch.from_numpy(q)).double().numpy()
        cb = nk.bf16_round(torch.from_numpy(c)).double().numpy()

    def dist(idx):
        dot = (qb[bad] * cb[idx[bad]]).sum(1)
        return ((q[bad].astype(np.float64) ** 2).sum(1)
                + (c[idx[bad]].astype(np.float64) ** 2).sum(1) - 2 * dot)
    np.testing.assert_allclose(dist(idx_a), dist(idx_b), rtol=rtol)


@pytest.mark.parametrize('variant', ['aug', 'bf16'])
def test_random_features_match_pallas(rng, variant):
    """Normal features: err within the kernel's stated tolerance, winners
    different only at float near ties (K2: rtol 1e-4, atol 1e-2 on
    normal(0, 5), the JAX test's; K3: rtol 1e-5, atol 1e-4 on
    normal(0, 1))."""
    if variant == 'aug':
        q = rng.normal(0, 5, (512, 192)).astype(np.float32)
        c = rng.normal(0, 5, (1024, 192)).astype(np.float32)
        idx_r, err_r = _jax(_nn_call_aug, q, c)
        idx_p, err_p = _np(nk.nearest_1_aug(torch.from_numpy(q),
                                            torch.from_numpy(c)))
        np.testing.assert_allclose(err_p, err_r, rtol=1e-4, atol=1e-2)
    else:
        q = rng.normal(0, 1, (256, 192)).astype(np.float32)
        c = rng.normal(0, 1, (1024, 192)).astype(np.float32)
        idx_r, err_r = _jax(_nn_call_bf16, q, c)
        idx_p, err_p = _np(nk.nearest_1_bf16(torch.from_numpy(q),
                                             torch.from_numpy(c)))
        np.testing.assert_allclose(err_p, err_r, rtol=1e-5, atol=1e-4)
    assert idx_p.dtype == np.int32 and err_p.dtype == np.float32
    _near_tie_only(q, c, idx_p, idx_r, bf16=variant == 'bf16')


@pytest.mark.parametrize('variant', ['aug', 'bf16'])
def test_integer_features_exact_with_duplicates_and_padding(rng, variant):
    """Integer features make every dot exact: idx and err equal the
    Pallas kernel's bit for bit, duplicated candidates resolve to the
    lowest index, and 1e9 padding rows never win (K3's integers are
    bf16-exact, [-64, 64))."""
    lo, hi = (0, 16) if variant == 'aug' else (-64, 64)
    call, port = ((_nn_call_aug, nk.nearest_1_aug) if variant == 'aug'
                  else (_nn_call_bf16, nk.nearest_1_bf16))
    c = rng.integers(lo, hi, (1024, 192)).astype(np.float32)
    c[512:768] = c[0:256]                     # duplicates of rows 0..255
    q = np.concatenate([c[:256], rng.integers(lo, hi, (256, 192))
                        .astype(np.float32)])
    cpad = np.concatenate([c, np.full((512, 192), 1e9, np.float32)])
    idx_r, err_r = _jax(call, q, cpad)
    idx_p, err_p = _np(port(torch.from_numpy(q), torch.from_numpy(cpad)))
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(err_p, err_r)
    np.testing.assert_array_equal(idx_p[:256], np.arange(256))
    assert (idx_p < 1024).all()
    idx_u, err_u = _np(port(torch.from_numpy(q), torch.from_numpy(c)))
    np.testing.assert_array_equal(idx_u, idx_p)
    np.testing.assert_array_equal(err_u, err_p)
    # and both equal K1 on such features
    idx_1, err_1 = _jax(_nn_call, q, c)
    np.testing.assert_array_equal(idx_u, idx_1)
    np.testing.assert_array_equal(err_u, err_1)


@pytest.mark.parametrize('variant', ['aug', 'bf16'])
def test_ragged_sizes_and_chunking(rng, variant):
    """Sizes that fit no block; the plain version's candidate chunk does
    not change the result (strict < across chunks keeps the earlier
    index on an exact tie)."""
    plain = (nk.nearest_1_aug_plain if variant == 'aug'
             else nk.nearest_1_bf16_plain)
    q = torch.from_numpy(rng.integers(0, 8, (37, 192)).astype(np.float32))
    c = rng.integers(0, 8, (1013, 192)).astype(np.float32)
    c[1000:1013] = c[3:16]
    c = torch.from_numpy(c)
    idx, err = nk.nearest_1(q, c)
    for chunk in (1, 100, 4096):
        i2, e2 = plain(q, c, c_chunk=chunk)
        np.testing.assert_array_equal(i2.numpy(), idx.numpy())
        np.testing.assert_array_equal(e2.numpy(), err.numpy())


def test_augment_equals_jax(rng):
    q = rng.normal(0, 3, (37, 192)).astype(np.float32)
    c = rng.normal(0, 3, (101, 192)).astype(np.float32)
    want = [np.asarray(a) for a in _augment(jnp.asarray(q), jnp.asarray(c))]
    got = [a.numpy() for a in nk.augment(torch.from_numpy(q),
                                         torch.from_numpy(c))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-3)
    assert got[0].shape == (37, 200)
    np.testing.assert_array_equal(got[0][:, 192], 1.0)
    np.testing.assert_array_equal(got[1][:, :192], -2.0 * c)


def test_augmented_candidates_prepare_without_padding_to_32(rng):
    """K2's candidates go through the same prepare as K1's: the 200
    augmented columns stay 200 rows a tile (8 is the granule, not the
    32-wide slice), and they come back unchanged."""
    q = rng.normal(0, 3, (5, 192)).astype(np.float32)
    c = rng.normal(0, 3, (300, 192)).astype(np.float32)
    _, ca, _ = nk.augment(torch.from_numpy(q), torch.from_numpy(c))
    prep = nk.prepare(ca)
    assert prep.ct.shape == (2, 201, 256) and (prep.n_c, prep.dim) == (300, 200)
    np.testing.assert_array_equal(prep.rows().numpy(), ca.numpy())
    assert not prep.ct[1, :200, 300 - 256:].any()


def test_build_writes_library_and_ptxas_report(tmp_path):
    """nvcc_build compiles for sm_90a by way of a temporary file and
    writes the ptxas report beside the library, where a run reads the
    kernels' registers and spills."""
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\nfor a in "$@"; do case "$prev" in -o) '
                    'out="$a" ;; esac; prev="$a"; done\n'
                    'echo "$@" > "$out"\necho "Used 8 registers" >&2\n')
    nvcc.chmod(0o755)
    out = tmp_path / 'lib' / 'libv.so'
    nk.nvcc_build(str(nvcc), nk.SOURCES['nn1'], str(out))
    args = out.read_text()
    assert 'sm_90a' in args and '-Xptxas -v' in args and ' -D' not in args
    assert 'registers' in (tmp_path / 'lib' / 'libv.ptxas.txt').read_text()
    assert sorted(os.listdir(tmp_path / 'lib')) == ['libv.ptxas.txt',
                                                    'libv.so']


def test_bf16_round_is_round_to_nearest_even():
    """bf16 keeps 8 significant bits: 1 + 2^-8 is a tie and rounds to
    even (1.0); 1 + 3*2^-8 rounds up; 1 + 2^-8 + 2^-20 rounds up."""
    x = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20,
                      -(1 + 2 ** -8)], dtype=torch.float32)
    np.testing.assert_array_equal(
        nk.bf16_round(x).numpy(),
        np.array([1.0, 1 + 2 ** -6, 1 + 2 ** -7, -1.0], np.float32))


@pytest.mark.parametrize('fn', ['nearest_1_aug', 'nearest_1_bf16'])
def test_wrapper_checks_and_cpu_path_does_not_count(fn):
    wrapper = getattr(nk, fn)
    q = torch.zeros((4, 192))
    c = torch.ones((8, 192))
    before = (nk.LAUNCHES, nk.LAUNCHES_PREP, nk.LAUNCHES_AUG,
              nk.LAUNCHES_BF16)
    idx, err = wrapper(q, c)
    assert idx.shape == (4,) and err.shape == (4,)
    assert (nk.LAUNCHES, nk.LAUNCHES_PREP, nk.LAUNCHES_AUG,
            nk.LAUNCHES_BF16) == before
    with pytest.raises(TypeError):
        wrapper(q.double(), c.double())
    with pytest.raises(ValueError):
        wrapper(q, torch.ones((8, 64)))
    with pytest.raises(ValueError):
        wrapper(q, torch.ones((8, 384))[:, ::2])
    with pytest.raises(ValueError):
        wrapper(q, torch.ones((0, 192)))
    with pytest.raises(ValueError):
        wrapper(q.to('meta'), c.to('meta'))


def test_module_imports_build_nothing():
    """Importing the wrappers and the tools builds nothing, loads no
    library and needs no CUDA toolkit."""
    code = ('import os, tiler_tpu_torch.ops.nn_kernels as nk; '
            'import tiler_tpu_torch.tools.nn_prec_bench, '
            'tiler_tpu_torch.tools.assign_opt_bench; '
            'assert nk._lib is None and nk._lib_bf16 is None; '
            'assert nk.LAUNCHES == nk.LAUNCHES_AUG == nk.LAUNCHES_BF16 == 0; '
            'print(sorted(nk.SOURCES))')
    env = {'PATH': '/usr/bin:/bin'}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, cwd=repo, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['nn1', 'nn1_bf16']"


_FAKE_NVCC = '''#!/bin/sh
# stands in for nvcc: writes the -o file, or fails on the named source
for a in "$@"; do
  case "$prev" in -o) out="$a" ;; esac
  prev="$a"; src="$a"
done
case "$src" in *"$FAIL_ON"*) echo "error in $src" >&2; exit 2 ;; esac
echo "ptxas info: Used 8 registers" >&2
echo built > "$out"
'''


@pytest.mark.parametrize('fail_on', ['', 'nn1_bf16.cu'])
def test_build_compiles_each_source_or_raises(tmp_path, monkeypatch,
                                              fail_on):
    """build() runs one compiler per source into BUILD_DIR and keeps each
    ptxas report; a failing source raises with its errors, and no
    library or temporary file is left for it."""
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    out_dir = tmp_path / 'build'
    monkeypatch.setattr(nk, 'BUILD_DIR', str(out_dir))
    monkeypatch.setattr(nk, '_nvcc', lambda: str(nvcc))
    monkeypatch.setenv('FAIL_ON', fail_on or 'no such source')
    if fail_on:
        with pytest.raises(RuntimeError, match='error in .*nn1_bf16.cu'):
            nk.build()
        assert sorted(os.listdir(out_dir)) == ['libnn1.ptxas.txt',
                                               'libnn1.so']
        return
    libs = nk.build()
    assert libs == {n: str(out_dir / f'lib{n}.so') for n in nk.SOURCES}
    for n in nk.SOURCES:
        assert (out_dir / f'lib{n}.so').read_text() == 'built\n'
        assert 'registers' in (out_dir / f'lib{n}.ptxas.txt').read_text()
    stamp = os.path.getmtime(libs['nn1'])
    assert nk.build() == libs and os.path.getmtime(libs['nn1']) == stamp
