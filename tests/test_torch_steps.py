"""Step parity: the JAX package encodes a small clip and checkpoints after
every step (step_hook + utils.checkpoint); each case loads the state
before step X into the port (from_reference_state), runs the port's step
X on the CPU, and diffs it against the JAX package's state after X.

Integer stages are byte-identical. FrameTiling's float 1-NN is held by a
tie-aware check, Smooth's f32 RMS threshold by a near-threshold one.
"""
import numpy as np
import pytest
import torch

from bench import synthetic_clip_v2
from tiler_tpu.config import EncoderConfig
from tiler_tpu.constants import (BLUE_MUL, ENCODER_STEPS, GREEN_MUL,
                                 LUMA_DIV, RED_MUL)
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from tiler_tpu_torch.pipeline import (dither_step, frame_tiling,
                                      global_tiling, load, reindex, save,
                                      smooth, unique)
from tiler_tpu_torch.ops import knn as tknn
from tiler_tpu_torch.ops.features import wavelet_matrix
from tiler_tpu_torch.pipeline.load import split_into_tiles
from tiler_tpu_torch.pipeline.state import EncoderState, from_reference_state

CFG = EncoderConfig(palette_count=16, max_tiles=400)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """JAX encode of an 8x120x160 three-scene clip, checkpointed after
    every step."""
    d = tmp_path_factory.mktemp('ckpt')
    frames = synthetic_clip_v2(8, 120, 160)
    enc = JaxEncoder(CFG)
    paths = {}

    def hook(step):
        paths[step] = str(d / f'{step}.npz')
        save_checkpoint(paths[step], enc.state)
    blob = enc.run_all(frames, fps=24, fast_lzma=True, step_hook=hook)
    return dict(frames=frames, paths=paths, blob=blob,
                changed_mask=enc.state.changed_mask)


def _before(ref, step):
    prev = ENCODER_STEPS[ENCODER_STEPS.index(step) - 1]
    st = from_reference_state(load_checkpoint(ref['paths'][prev]), 'cpu')
    st.changed_mask = ref['changed_mask']
    return st


def _after(ref, step):
    return load_checkpoint(ref['paths'][step])


def _same(port, want, fields):
    for f in fields:
        got = getattr(port, f)
        exp = getattr(want, f)
        assert got.shape == exp.shape, f
        np.testing.assert_array_equal(got, exp, err_msg=f)


def _jax_dither_labels(ref):
    """The JAX package's k-means labels and centroids for the clip, so the
    port's integer dither stages run from the same clustering."""
    from tiler_tpu.pipeline import dither_step as jdither
    st = load_checkpoint(ref['paths']['load'])
    for k in range(len(st.keyframes)):
        jdither.prepare_dither_keyframe(st, k)
    return st.tile_dpi.copy(), st.palette_centroids.copy()


def _f64_feats(tiles_pal, pals, hm, vm):
    """Float64 wavelet PsyV of palette-rendered mirrored tiles (numpy)."""
    t = np.where(hm[:, None, None], tiles_pal[:, :, ::-1], tiles_pal)
    t = np.where(vm[:, None, None], t[:, ::-1, :], t)
    rgb = np.take_along_axis(pals, t.reshape(len(t), 64, 1).astype(np.int64),
                             axis=1) / 255.0
    return _yuv_wavelet(rgb)


def _yuv_wavelet(rgb):
    """[N,64,3] unit RGB -> [N,192] float64 YUV wavelet features."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (RED_MUL * r + GREEN_MUL * g + BLUE_MUL * b) / LUMA_DIV
    u = (b - y) * (0.5 / (1.0 - BLUE_MUL / LUMA_DIV))
    v = (r - y) * (0.5 / (1.0 - RED_MUL / LUMA_DIV))
    cpn = np.stack([y, u, v], axis=1)                 # [N,3,64]
    return (cpn @ wavelet_matrix().astype(np.float64)).reshape(len(rgb), 192)


def _check_frame_tiling(port, want, frames):
    got = np.stack([port.tm_tile, port.tm_pal, port.tm_h, port.tm_v])
    exp = np.stack([want.tm_tile, want.tm_pal, want.tm_h, want.tm_v])
    diff = np.flatnonzero((got != exp).any(0).ravel())
    # at most 0.1% of the cells differ in their own 1-NN query; an
    # unchanged cell copies its query's result forward, not counted again
    queried = port.changed_mask.reshape(len(frames), -1).copy()
    queried[[s for s, _ in port.keyframes]] = True
    assert queried.ravel()[diff].sum() <= 0.001 * port.tm_tile.size
    if not len(diff):
        return
    # every differing cell's two choices are a float64 near tie
    src = split_into_tiles(frames, port.tilemap_h, port.tilemap_w)[diff]
    q = _yuv_wavelet(src.reshape(len(src), 64, 3) / 255.0)
    kf = port.kf_of_frame()[diff // port.tilemap_size]
    dists = []
    for st in (port, want):
        fl = [a.ravel()[diff] for a in (st.tm_tile, st.tm_pal, st.tm_h,
                                        st.tm_v)]
        c = _f64_feats(st.tiles_pal[fl[0]], st.palettes_rgb[kf, fl[1]],
                       fl[2], fl[3])
        dists.append(((q - c) ** 2).sum(1))
    np.testing.assert_allclose(dists[0], dists[1], rtol=1e-5)


STEPS = ['load', 'dither', 'make_unique', 'global_tiling',
         'frame_tiling_stage1', 'frame_tiling_marking',
         'frame_tiling_stage2_perm', 'frame_tiling',
         'reindex', 'smooth', 'save']


@pytest.mark.parametrize('step', STEPS)
def test_step_parity(ref, step, monkeypatch):
    if step == 'load':
        port = EncoderState(config=CFG, device='cpu')
        load.run_load(port, ref['frames'], 24)
        want = _after(ref, 'load')
        _same(port, want, ['keyframes', 'tiles_rgb', 'tiles_pal', 'tm_tile',
                           'tm_pal', 'tm_h', 'tm_v', 'tile_active',
                           'tile_use', 'tile_dpi', 'palettes_rgb'])
        np.testing.assert_array_equal(port.changed_mask,
                                      ref['changed_mask'])
        assert len(port.keyframes) == 3
    elif step == 'dither':
        dpi, cents = _jax_dither_labels(ref)

        def jax_prepare(state, k):
            s, e = state.keyframes[k]
            cells = state.tm_tile[s:e + 1].ravel()
            state.tile_dpi[cells] = dpi[cells]
            state.palette_centroids[k] = cents[k]
        monkeypatch.setattr(dither_step, 'prepare_dither_keyframe',
                            jax_prepare)
        port = dither_step.run_dither(_before(ref, step))
        _same(port, _after(ref, step),
              ['tiles_pal', 'tm_pal', 'tm_h', 'tm_v', 'tile_dpi',
               'palettes_rgb', 'palette_centroids'])
    elif step == 'make_unique':
        port = unique.run_make_unique(_before(ref, step))
        _same(port, _after(ref, step), ['tiles_pal', 'tm_tile', 'tile_use',
                                        'tile_active'])
    elif step == 'global_tiling':
        port = global_tiling.run_global_tiling(_before(ref, step))
        _same(port, _after(ref, step),
              ['tiles_pal', 'tiles_rgb', 'tm_tile', 'tile_use',
               'tile_active', 'tile_dpi'])
    elif step == 'frame_tiling_stage1':
        from tiler_tpu.ops import knn as jknn
        port = _before(ref, 'frame_tiling')
        ds, _, _ = frame_tiling.build_global_dataset(port)
        q = port.tiles_pal[np.unique(port.tm_tile)].reshape(-1, 64)
        qf = q.astype(np.float32)
        idx, keep = tknn.nearest_k_keepmask(torch.from_numpy(qf), ds, k=8,
                                            q_chunk=100, c_chunk=256)
        jidx, jkeep = jknn.nearest_k_keepmask(qf, ds.numpy(), k=8)
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        assert not keep.all()                    # equal-distance runs occur
    elif step == 'frame_tiling_marking':
        # the used-combo sets of all three FTQuality branches, from the
        # same exact 8-NN results
        import dataclasses

        from tiler_tpu.config import FTQuality
        from tiler_tpu.pipeline import frame_tiling as jft
        port = _before(ref, 'frame_tiling')
        jst = load_checkpoint(ref['paths']['global_tiling'])
        ds, _, _ = frame_tiling.build_global_dataset(port)
        for quality in FTQuality:
            cfg = dataclasses.replace(CFG, ft_quality=quality)
            port.config = jst.config = cfg
            for k in range(len(port.keyframes)):
                uq, inv = frame_tiling._mark_queries_idx(port, k)
                q = torch.from_numpy(port.tiles_pal[uq].reshape(len(uq), 64))
                idx, keep = tknn.nearest_k_keepmask(q, ds, k=8)
                pm = frame_tiling.palette_similarity_mask(port, k)
                np.testing.assert_array_equal(
                    pm, jft.palette_similarity_mask(jst, k))
                args = (k, idx.numpy(), keep.numpy(), inv, len(uq), len(ds),
                        pm if quality == FTQuality.MEDIUM else None)
                got = frame_tiling._mark_from_knn(port, *args)
                np.testing.assert_array_equal(got,
                                              jft._mark_from_knn(jst, *args))
    elif step == 'frame_tiling_stage2_perm':
        # every mirror of each marked (palette, tile) used: pair dedup 4,
        # so both packages take the mirror-permutation path
        from tiler_tpu.pipeline import frame_tiling as jft
        port = _before(ref, 'frame_tiling')
        jst = load_checkpoint(ref['paths']['global_tiling'])
        ds, tile_of, attrs_of = frame_tiling.build_global_dataset(port)
        used = np.zeros((CFG.palette_count, ds.shape[0]), bool)
        pick = np.random.default_rng(5).random(
            (CFG.palette_count, ds.shape[0] // 4)) < 0.1
        used[:] = np.repeat(pick, 4, axis=1)
        got = frame_tiling.candidate_features(port, 1, used, tile_of,
                                              attrs_of)
        want = jft.candidate_features(jst, 1, used, tile_of, attrs_of)
        assert port.metrics['ft_pair_dedup'] == [4.0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)     # candidate order
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-4)
    elif step == 'frame_tiling':
        port = frame_tiling.run_frame_tiling(_before(ref, step))
        _check_frame_tiling(port, _after(ref, step), ref['frames'])
        assert port.metrics['ft_nn_calls'] == len(port.keyframes)
    elif step == 'reindex':
        port = reindex.run_reindex(_before(ref, step))
        _same(port, _after(ref, step), ['tiles_pal', 'tiles_rgb', 'tm_tile',
                                        'tile_use', 'tile_dpi'])
    elif step == 'smooth':
        port = smooth.run_smooth(_before(ref, step))
        want = _after(ref, step)
        fields = ['stm_tile', 'stm_pal', 'stm_h', 'stm_v', 'stm_smooth']
        diff = np.zeros(port.stm_tile.shape, bool)
        for f in fields:
            diff |= getattr(port, f) != getattr(want, f)
        assert diff.sum() == 0 or _near_threshold(port, diff)
    else:  # save: the same state gives the same stream
        blob = save.run_save(_before(ref, step), fast_lzma=True)
        assert blob == ref['blob']


def _near_threshold(port, diff):
    """Smooth may differ only where a cell's RMS to the previous frame
    lies within 1e-5 of the strength."""
    from tiler_tpu_torch.ops import features
    f, th, tw = port.tm_tile.shape
    tiles = torch.from_numpy(port.tiles_pal)
    kf = port.kf_of_frame()
    feats = features.psyv_features_pal(
        tiles[port.tm_tile.ravel()],
        torch.from_numpy(port.palettes_rgb[np.repeat(kf, th * tw),
                                           port.tm_pal.ravel()]),
        q_weighting=True, hmir=torch.from_numpy(port.tm_h.ravel()),
        vmir=torch.from_numpy(port.tm_v.ravel())).double().reshape(f, -1, 192)
    rms = np.zeros((f, th * tw))
    rms[1:] = np.sqrt(((feats[1:] - feats[:-1]) ** 2).sum(-1) / 192).numpy()
    cells = diff.reshape(f, -1)
    near = np.abs(rms - port.config.smoothing_strength) <= 1e-5
    near[:-1] |= near[1:]    # a flip also rewrites the previous frame
    return bool(near[cells].all())
