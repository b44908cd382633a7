"""The port's colour science and PsyV features against tiler_tpu.ops.color
and tiler_tpu.ops.features on the same numpy inputs: float stages to
rtol 1e-5 / atol 1e-4, integer helpers exactly.

LAB features are the exception to the atol: L spans 0..100 where Y spans
0..1, so features reach ~1000 and their f32 ulp is ~6e-5; both packages
sit 3.1e-4 from a float64 reference there. The LAB case takes atol 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.ops import color as jcolor
from tiler_tpu.ops import features as jfeat
from tiler_tpu_torch.ops import color as tcolor
from tiler_tpu_torch.ops import features as tfeat


def _close(a, b, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize('gamma', [None, 1.8])
def test_colorspaces_match(rng, gamma):
    px = rng.integers(0, 256, (4096, 3)).astype(np.uint8)
    ju = jcolor.srgb_unit(px, gamma)
    tu = tcolor.srgb_unit(torch.from_numpy(px), gamma)
    _close(tu, ju)
    _close(tcolor.rgb_to_yuv(tu), jcolor.rgb_to_yuv(ju))
    _close(tcolor.rgb_to_lab(tu), jcolor.rgb_to_lab(ju))


def test_integer_helpers_exact(rng):
    a = rng.integers(0, 256, (2000, 3)).astype(np.int32)
    b = rng.integers(-300, 600, (2000, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tcolor.color_compare_i32(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy(),
        np.asarray(jcolor.color_compare_i32(a, b)))
    x = rng.integers(-10**6, 10**6, 5000).astype(np.int32)
    for d in (7, 100, 10000):
        np.testing.assert_array_equal(
            tcolor.div_trunc(torch.from_numpy(x), d).numpy(),
            np.asarray(jcolor.jax_div_trunc(jnp.asarray(x), d)))
    rgb = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    for got, want in zip(tcolor.rgb_to_hsv_int_np(rgb),
                         jcolor.rgb_to_hsv_int_np(rgb)):
        np.testing.assert_array_equal(got, want)


def test_mirrors_and_bases_exact(rng):
    t = rng.integers(0, 256, (64, 8, 8, 3)).astype(np.uint8)
    hm = rng.random(64) < 0.5
    vm = rng.random(64) < 0.5
    np.testing.assert_array_equal(
        tfeat.mirror_tiles(torch.from_numpy(t), torch.from_numpy(hm),
                           torch.from_numpy(vm)).numpy(),
        np.asarray(jfeat.mirror_tiles(jnp.asarray(t), jnp.asarray(hm),
                                      jnp.asarray(vm))))
    np.testing.assert_array_equal(tfeat.wavelet_matrix(),
                                  jfeat.wavelet_matrix())
    for w in (False, True):
        for q in (False, True):
            for got, want in zip(tfeat.feature_basis(w, q),
                                 jfeat.feature_basis(w, q)):
                np.testing.assert_array_equal(got, want)
    perm, sign = tfeat.mirror_coeff_perms(True)
    jperm, jsign = jfeat.mirror_coeff_perms(True)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(sign, jsign)
    assert tfeat.mirror_coeff_perms(False) is None


@pytest.mark.parametrize('use_wavelets,use_lab,gamma',
                         [(True, False, None), (True, True, None),
                          (False, False, 1.8)])
def test_psyv_rgb_matches(rng, use_wavelets, use_lab, gamma):
    t = rng.integers(0, 256, (300, 8, 8, 3)).astype(np.uint8)
    kw = dict(gamma_value=gamma, use_lab=use_lab, use_wavelets=use_wavelets)
    want = jfeat.psyv_features_rgb(t, **kw)
    got = tfeat.psyv_features_rgb(torch.from_numpy(t), **kw)
    assert got.dtype == torch.float32 and got.shape == (300, 192)
    _close(got, want, atol=1e-3 if use_lab else 1e-4)


@pytest.mark.parametrize('q_weighting', [False, True])
def test_psyv_pal_matches(rng, q_weighting):
    """The DCT path with JPEG weighting, as Smooth uses it."""
    tp = rng.integers(0, 16, (200, 8, 8)).astype(np.uint8)
    pals = rng.integers(0, 256, (200, 16, 3)).astype(np.uint8)
    hm = rng.random(200) < 0.5
    vm = rng.random(200) < 0.5
    want = jfeat.psyv_features_pal(tp, pals, q_weighting=q_weighting,
                                   hmir=hm, vmir=vm)
    got = tfeat.psyv_features_pal(torch.from_numpy(tp),
                                  torch.from_numpy(pals),
                                  q_weighting=q_weighting,
                                  hmir=torch.from_numpy(hm),
                                  vmir=torch.from_numpy(vm))
    _close(got, want)


def test_knoll_dither_exact(rng):
    """Knoll dithering is int32 and byte-identical: the plan-cached form
    (shared colours across tiles and groups) and the per-tile plain form
    against the JAX package's."""
    from tiler_tpu.ops import dither as jdither
    from tiler_tpu_torch.ops import dither as tdither
    n, g = 300, 6
    tiles = rng.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    tiles[100:200] = tiles[0:100] // 16 * 16     # repeated colours
    pals = rng.integers(0, 256, (g, 16, 3)).astype(np.uint8)
    pals[1, 3] = pals[1, 7]                     # a duplicate entry
    grp = rng.integers(0, g, n).astype(np.int32)
    want = jdither.knoll_dither_tiles(tiles, pals[grp])
    np.testing.assert_array_equal(
        np.asarray(jdither.knoll_dither_tiles_cached(tiles, pals, grp)),
        want)
    got = tdither.knoll_dither_tiles_cached(torch.from_numpy(tiles), pals,
                                            torch.from_numpy(grp))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tdither.knoll_dither_tiles(torch.from_numpy(tiles),
                                       torch.from_numpy(pals[grp]))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_psyv_pal_and_mirror_permutation(rng):
    """Palette-rendered features match; and a mirrored tile's wavelet
    features are its unmirrored features through the signed column
    permutation FrameTiling's stage 2 uses."""
    n = 256
    tp = rng.integers(0, 16, (n, 8, 8)).astype(np.uint8)
    pals = rng.integers(0, 256, (n, 16, 3)).astype(np.uint8)
    hm = rng.random(n) < 0.5
    vm = rng.random(n) < 0.5
    want = jfeat.psyv_features_pal(tp, pals, use_wavelets=True, hmir=hm,
                                   vmir=vm)
    got = tfeat.psyv_features_pal(torch.from_numpy(tp),
                                  torch.from_numpy(pals), use_wavelets=True,
                                  hmir=torch.from_numpy(hm),
                                  vmir=torch.from_numpy(vm))
    _close(got, want)
    base = tfeat.psyv_features_pal(torch.from_numpy(tp),
                                   torch.from_numpy(pals), use_wavelets=True)
    perm, sign = tfeat.mirror_coeff_perms(True)
    attr = hm.astype(np.int64) | (vm.astype(np.int64) << 1)
    expanded = torch.gather(base, 1, torch.from_numpy(perm[attr])) \
        * torch.from_numpy(sign[attr])
    _close(expanded, got)
