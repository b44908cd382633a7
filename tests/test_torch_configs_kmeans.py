"""The Dither k-means under use_wavelets=False (DCT + LAB features): the
port's kmeans_core against the JAX package's on the JAX package's own
features of each keyframe of the 8x120x160 cuts_v2 clip.

The two agree on keyframes 0 and 1. On keyframe 2 they part at one f32
tie: in the first Lloyd assignment from identical k-means++ centroids,
row 481 lies 2.03 apart (in float64) from centroids 9 and 12, at a
squared norm of 4.03e7, where one f32 ulp is 4. XLA and torch sum the
f32 x.x and x.c terms in different orders, and each order alone decides
the tie differently; the trajectories part from there. So the stage is
held step by step instead: fed the same state, every assignment equals
the JAX package's except at such ties, and every centroid update agrees
to float rounding. With the JAX package's labels, the rest of the
use_wavelets=False encode gives the JAX package's stream byte for byte.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip_v2
from tiler_tpu.config import EncoderConfig
from tiler_tpu.ops import features as jfeatures
from tiler_tpu.ops import kmeans as jkmeans
from tiler_tpu.pipeline import dither_step as jdither_step
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.ops import kmeans as tkmeans
from tiler_tpu_torch.ops import prng
from tiler_tpu_torch.pipeline import dither_step
from tiler_tpu_torch.pipeline.encoder import Encoder

CFG = EncoderConfig(palette_count=16, max_tiles=400, use_wavelets=False)
SEED = 0x42381337
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope='module')
def clip():
    """The clip, the JAX package's DCT + LAB features per keyframe after
    its Load, and its k-means labels and centroids."""
    frames = synthetic_clip_v2(8, 120, 160)
    enc = JaxEncoder(dataclasses.replace(CFG, end_step='load'))
    enc.run_all(frames, fps=24)
    st = enc.state
    feats = []
    for s, e in st.keyframes:
        cells = st.tm_tile[s:e + 1].ravel()
        feats.append(np.array(jfeatures.psyv_features_rgb(
            jnp.asarray(st.tiles_rgb[cells]), gamma_value=None,
            use_lab=True, use_wavelets=False)))
    for k in range(len(st.keyframes)):
        jdither_step.prepare_dither_keyframe(st, k)
    return dict(frames=frames, feats=feats, dpi=st.tile_dpi.copy(),
                cents=st.palette_centroids.copy())


@pytest.mark.parametrize('kf', [0, 1, 2])
def test_kmeans_nowave_lockstep(clip, kf):
    """Each k-means operation of the port, fed the JAX package's state at
    every Lloyd iteration: the k-means++ centroids equal, the labels
    equal except where the two picks are an f32 tie of the distance
    formula (float64 gap within 16 f32 ulps of |x|^2 + |c|^2), the
    centroid updates within float rounding (rtol 1e-5)."""
    x = clip['feats'][kf]
    k = CFG.palette_count
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    x2j = jnp.sum(xj * xj, axis=1)
    x2t = torch.sum(xt * xt, dim=1)
    cents = np.asarray(jax.jit(jkmeans._plus_plus_init,
                               static_argnames=('k',))(
        xj, k=k, key=jax.random.PRNGKey(SEED)))
    np.testing.assert_array_equal(
        tkmeans._plus_plus_init(xt, x2t, k, prng.prng_key(SEED)).numpy(),
        cents)
    assign = jax.jit(jkmeans._assign)
    update = jax.jit(jkmeans._update, static_argnames=('k',))
    labels = np.asarray(assign(xj, x2j, jnp.asarray(cents))[0])
    ties = []
    for it in range(100):
        got = tkmeans._assign(xt, x2t, torch.from_numpy(cents)).numpy()
        for r in np.flatnonzero(got != labels):
            d = ((x[r].astype(np.float64) - cents.astype(np.float64)) ** 2
                 ).sum(1)
            scale = float(x2t[r]) + float((cents[[got[r], labels[r]]]
                                           .astype(np.float64) ** 2)
                                          .sum(1).max())
            gap = abs(d[got[r]] - d[labels[r]])
            assert gap <= 16 * F32_EPS * scale, (it, r, gap, scale)
            ties.append((it, int(r), gap))
        new = np.asarray(update(xj, jnp.asarray(labels), k=k,
                                old_cents=jnp.asarray(cents))[0])
        np.testing.assert_allclose(
            tkmeans._update(xt, torch.from_numpy(labels.astype(np.int64)),
                            k, torch.from_numpy(cents)).numpy(),
            new, rtol=1e-5, atol=1e-3)
        new_labels = np.asarray(assign(xj, x2j, jnp.asarray(new))[0])
        cents = new
        if (new_labels == labels).all():
            break
        labels = new_labels
    if kf == 2:
        assert [t[:2] for t in ties] == [(0, 481)]
        assert abs(ties[0][2] - 2.0309) < 1e-3
    else:
        assert not ties


@pytest.mark.parametrize('kf', [0, 1])
def test_kmeans_nowave_core_matches(clip, kf):
    """Where no tie intervenes, the whole kmeans_core gives the JAX
    package's labels, iteration count and centroids."""
    x = clip['feats'][kf]
    lj, cj, itj = jax.jit(jkmeans.kmeans_core, static_argnames=('k',))(
        jnp.asarray(x), k=CFG.palette_count)
    lt, ct, itt = tkmeans.kmeans_core(torch.from_numpy(x), CFG.palette_count)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert itt == int(itj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-3)


def test_nowave_stream_with_jax_kmeans(clip, monkeypatch):
    """The whole use_wavelets=False encode on the CPU, with the k-means
    labels of the JAX package: its stream byte for byte (DCT features in
    FrameTiling included)."""
    def jax_prepare(state, k):
        s, e = state.keyframes[k]
        cells = state.tm_tile[s:e + 1].ravel()
        state.tile_dpi[cells] = clip['dpi'][cells]
        state.palette_centroids[k] = clip['cents'][k]
    monkeypatch.setattr(dither_step, 'prepare_dither_keyframe', jax_prepare)
    frames = clip['frames']
    want = JaxEncoder(CFG).run_all(frames, fps=24, fast_lzma=True)
    got = Encoder(CFG, device='cpu').run_all(frames, fps=24, fast_lzma=True)
    assert got == want
