"""Yliluoma-2 dithering and the Value-at-Risk quantizer: the port against
the JAX package on the same inputs, from single functions up to the
whole stream of the 8x120x160 cuts_v2 clip. Integer stages are
byte-identical; FrameTiling's float 1-NN is held by the tie-aware check
of test_torch_steps."""
import numpy as np
import pytest
import torch

from bench import synthetic_clip_v2
from test_torch_steps import _check_frame_tiling, _same
from tiler_tpu.config import EncoderConfig
from tiler_tpu.constants import palette_pattern
from tiler_tpu.decode import decode_video
from tiler_tpu.ops import dither as jdither
from tiler_tpu.ops import palette as jpalette
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from tiler_tpu_torch.ops import dither, palette
from tiler_tpu_torch.ops.stats import psnr
from tiler_tpu_torch.pipeline import dither_step, frame_tiling
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.pipeline.state import from_reference_state

CFG = EncoderConfig(palette_count=16, max_tiles=400, use_thomas_knoll=False,
                    use_dl3=False)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """JAX encode (Yliluoma + VAR) of the clip, checkpointed after every
    step, and its stream."""
    d = tmp_path_factory.mktemp('ckpt_yv')
    frames = synthetic_clip_v2(8, 120, 160)
    enc = JaxEncoder(CFG)
    paths = {}

    def hook(step):
        paths[step] = str(d / f'{step}.npz')
        save_checkpoint(paths[step], enc.state)
    blob = enc.run_all(frames, fps=24, fast_lzma=True, step_hook=hook)
    return dict(frames=frames, paths=paths, blob=blob,
                changed_mask=enc.state.changed_mask)


def _port_state(ref, step):
    st = from_reference_state(load_checkpoint(ref['paths'][step]), 'cpu')
    st.changed_mask = ref['changed_mask']
    return st


@pytest.mark.parametrize('mix', [1, 2, 4, 7])
def test_yliluoma_dithers_match_jax(rng, mix):
    """Plans and per-pixel picks, cached and plain, byte-identical; the
    palettes hold duplicate entries and the tiles repeat colours."""
    tiles = rng.integers(0, 256, (300, 8, 8, 3)).astype(np.uint8)
    tiles[100:200] = tiles[0]
    group_pals = rng.integers(0, 256, (5, 16, 3)).astype(np.uint8)
    group_pals[1, 3] = group_pals[1, 9]
    groups = rng.integers(0, 5, 300)
    want = jdither.yliluoma_dither_tiles_cached(tiles, group_pals, groups,
                                                mixed_colors=mix)
    got = dither.yliluoma_dither_tiles_cached(
        torch.from_numpy(tiles), group_pals, torch.from_numpy(groups),
        mixed_colors=mix)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = dither.yliluoma_dither_tiles(
        torch.from_numpy(tiles), torch.from_numpy(group_pals[groups]),
        mixed_colors=mix)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        jdither.yliluoma_dither_tiles(tiles, group_pals[groups],
                                      mixed_colors=mix), want)


@pytest.mark.parametrize('pal_var', [0.5, 0.95, 0.999])
def test_var_palette_matches_jax(rng, pal_var):
    """The VAR quantizer (vectorized first pair pass) gives the JAX
    package's entries exactly, on skewed colour counts."""
    pattern = palette_pattern(8, 16)
    for p in range(3):
        px = rng.integers(0, 64, (6000, 3)) * 4
        px[:2000] = px[0]
        packed = palette.rgb_to_packed(px)
        cols, counts = np.unique(packed, return_counts=True)
        args = (cols, counts.astype(np.int64), 40000, pal_var, 16, 8,
                pattern[p])
        np.testing.assert_array_equal(palette.var_palette(*args),
                                      jpalette.var_palette(*args))
    empty = palette.var_palette(np.zeros(0, np.uint32), np.zeros(0),
                                10, pal_var, 16, 8, pattern[0])
    np.testing.assert_array_equal(empty, np.zeros(16, np.uint32))


def test_dither_step_yliluoma_var(ref, monkeypatch):
    """Dither fed the JAX package's k-means labels (as test_torch_steps
    does): VAR palettes, Yliluoma scans and mirrors byte-identical."""
    from tiler_tpu.pipeline import dither_step as jdither_step
    st = load_checkpoint(ref['paths']['load'])
    for k in range(len(st.keyframes)):
        jdither_step.prepare_dither_keyframe(st, k)
    dpi, cents = st.tile_dpi.copy(), st.palette_centroids.copy()

    def jax_prepare(state, k):
        s, e = state.keyframes[k]
        cells = state.tm_tile[s:e + 1].ravel()
        state.tile_dpi[cells] = dpi[cells]
        state.palette_centroids[k] = cents[k]
    monkeypatch.setattr(dither_step, 'prepare_dither_keyframe', jax_prepare)
    port = dither_step.run_dither(_port_state(ref, 'load'))
    _same(port, load_checkpoint(ref['paths']['dither']),
          ['tiles_pal', 'tm_pal', 'tm_h', 'tm_v', 'tile_dpi', 'palettes_rgb',
           'palette_centroids'])


def test_frame_tiling_yliluoma_var(ref):
    """FrameTiling from the JAX state: cells differ only at float near
    ties (on this clip one static cell's query, forward-filled over three
    frames)."""
    port = frame_tiling.run_frame_tiling(_port_state(ref, 'global_tiling'))
    _check_frame_tiling(port, load_checkpoint(ref['paths']['frame_tiling']),
                        ref['frames'])


def test_stream_yliluoma_var(ref):
    """The whole encode on the CPU, with the port's own k-means: every
    step up to GlobalTiling byte-identical to the JAX package's, and the
    stream either the JAX package's or one whose difference stays within
    a float near tie in FrameTiling (bytes within 0.1%, PSNR within 1e-3
    dB; test_frame_tiling_yliluoma_var shows where)."""
    frames = ref['frames']
    enc = Encoder(CFG, device='cpu')
    fields = {'dither': ['tiles_pal', 'tm_pal', 'tm_h', 'tm_v', 'tile_dpi',
                         'palettes_rgb'],
              'global_tiling': ['tiles_pal', 'tm_tile', 'tile_use',
                                'tile_active']}

    def hook(step):
        if step in fields:
            _same(enc.state, load_checkpoint(ref['paths'][step]),
                  fields[step])
    blob = enc.run_all(frames, fps=24, fast_lzma=True, step_hook=hook)
    if blob != ref['blob']:
        assert abs(len(blob) - len(ref['blob'])) <= 0.001 * len(ref['blob'])
        p_port = psnr(decode_video(blob)[0], frames)
        p_jax = psnr(decode_video(ref['blob'])[0], frames)
        assert abs(p_port - p_jax) <= 1e-3, (p_port, p_jax)
