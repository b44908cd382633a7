"""The port's decode paths: both torch renderers and the lazy player
against the numpy decoder and against the JAX package's decoder on the
same bytes, the preview renderer against the decoded bitstream, and the
Floyd-Steinberg posterizers. Every comparison is exact; the port runs on
the CPU."""
import os

import numpy as np
import pytest
import torch

import tiler_tpu.decode as jdecode
from tiler_tpu.ops import dither as jdither
from tiler_tpu_torch import decode as pdecode
from tiler_tpu_torch import render
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.ops import dither as pdither
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.player import GTMPlayer
from tiler_tpu_torch.tools.common import synthetic_clip_v2

# the shapes here are tiny and several test processes share the cores:
# one thread each keeps them from spinning on each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'decoders', 'web', 'sample.gtm')


@pytest.fixture(scope='module')
def encoded():
    """An encoded clip with skipped (smoothed) cells and three keyframes,
    and the encoder that made it."""
    frames = synthetic_clip_v2(8, 64, 96, seed=1)
    enc = Encoder(EncoderConfig(palette_count=8, max_tiles=100),
                  device='cpu')
    blob = enc.run_all(frames, fps=24, fast_lzma=True)
    assert enc.state.metrics['smoothed_cells'] > 0
    return enc, blob


@pytest.fixture(scope='module', params=['encoded', 'sample'])
def stream_bytes(request, encoded):
    if request.param == 'encoded':
        return encoded[1]
    with open(SAMPLE, 'rb') as fh:
        return fh.read()


@pytest.fixture(scope='module')
def want(stream_bytes):
    frames, _ = pdecode.decode_video(stream_bytes)
    jframes, _ = jdecode.decode_video(stream_bytes)
    assert frames.tobytes() == jframes.tobytes() and frames.max() > 0
    return frames


@pytest.mark.parametrize('fn', ['decode_video_torch',
                                'decode_video_torch_scan'])
def test_torch_renderer_matches_numpy(stream_bytes, want, fn):
    got = getattr(pdecode, fn)(stream_bytes, device='cpu')
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_torch_renderer_matches_jax_renderer(encoded):
    blob = encoded[1]
    np.testing.assert_array_equal(
        pdecode.decode_video_torch_scan(blob, device='cpu'),
        jdecode.decode_video_jax_scan(blob))
    np.testing.assert_array_equal(
        pdecode.decode_video_torch(blob, device='cpu'),
        jdecode.decode_video_jax(blob))


def test_render_step_draws_only_the_listed_cells():
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(rng.integers(0, 16, (5, 8, 8)).astype(np.uint8))
    pals = torch.from_numpy(
        rng.integers(0, 256, (256, 16, 3)).astype(np.uint8))
    canvas = torch.full((6, 8, 8, 3), 7, dtype=torch.uint8)
    pos = torch.tensor([4, 1], dtype=torch.int32)
    tidx = torch.tensor([2, 3], dtype=torch.int32)
    attrs = torch.tensor([(9 << 2) | 1, (200 << 2) | 2], dtype=torch.int32)
    out = pdecode.render_step(canvas, tiles, pals, pos, tidx, attrs)
    assert out is canvas
    assert (canvas[[0, 2, 3, 5]] == 7).all()
    np.testing.assert_array_equal(
        canvas[4].numpy(), pals[9].numpy()[tiles[2].numpy()[:, ::-1]])
    np.testing.assert_array_equal(
        canvas[1].numpy(), pals[200].numpy()[tiles[3].numpy()[::-1]])
    # an empty draw list (a frame of skipped cells) changes nothing
    before = canvas.clone()
    e = torch.zeros(0, dtype=torch.int32)
    pdecode.render_step(canvas, tiles, pals, e, e, e)
    assert torch.equal(canvas, before)


def test_torch_renderers_need_their_device(encoded):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    for fn in (pdecode.decode_video_torch, pdecode.decode_video_torch_scan):
        with pytest.raises(RuntimeError, match='cuda'):
            fn(encoded[1])


def test_player_is_lazy_and_matches(stream_bytes, want):
    player = GTMPlayer(stream_bytes)
    it = player.frames()
    first = next(it)
    np.testing.assert_array_equal(first, want[0])
    assert player.keyframes_decoded == 0      # still inside keyframe 0
    assert (player.height, player.width) == want.shape[1:3]
    rest = [first.copy()] + [f.copy() for f in it]
    np.testing.assert_array_equal(np.stack(rest), want)
    assert player.keyframes_decoded >= 2
    assert 0 < player.frame_interval_s < 1


def test_player_matches_jax_player_and_loops(stream_bytes, want):
    from tiler_tpu.player import GTMPlayer as JaxPlayer
    n = len(want)
    mine, theirs = GTMPlayer(stream_bytes), JaxPlayer(stream_bytes)
    assert mine.kf_max_bytes_per_sec == theirs.kf_max_bytes_per_sec
    a, b = mine.frames(loop=True), theirs.frames(loop=True)
    for i in range(n + 3):
        fa, fb = next(a), next(b)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(fa, want[i % n])


def test_render_frame_matches_decoded_bitstream(encoded):
    enc, blob = encoded
    dec, _ = pdecode.decode_video(blob)
    st = enc.state
    for f in range(st.n_frames):
        np.testing.assert_array_equal(render.render_frame(st, f), dec[f])
    from tiler_tpu_torch.ops.stats import psnr
    assert abs(render.reconstruction_psnr(st)
               - psnr(dec, st.frames_rgb)) < 1e-9
    # the unsmoothed tilemap gives other pixels only where it differs
    raw = np.stack([render.render_frame(st, f, use_smoothed=False)
                    for f in range(st.n_frames)])
    same_maps = all(np.array_equal(getattr(st, 'tm_' + k),
                                   getattr(st, 'stm_' + k))
                    for k in ('tile', 'pal', 'h', 'v'))
    assert raw.shape == dec.shape
    assert np.array_equal(raw, dec) or not same_maps
    c = render.reconstruction_correlation(st, 0)
    assert 0.9 < c <= 1.0


def test_render_views_match_jax_render(encoded):
    from tiler_tpu import render as jrender
    from tiler_tpu.pipeline.state import EncoderState as JaxState
    from tiler_tpu_torch.pipeline.state import ARRAY_FIELDS
    st = encoded[0].state
    jst = JaxState(config=st.config)
    for f in ARRAY_FIELDS + ['tilemap_w', 'tilemap_h', 'fps']:
        setattr(jst, f, getattr(st, f))
    for f in (0, 5):
        np.testing.assert_array_equal(render.render_frame(st, f),
                                      jrender.render_frame(jst, f))
        np.testing.assert_array_equal(render.render_palette_strip(st, f),
                                      jrender.render_palette_strip(jst, f))
        assert abs(render.reconstruction_correlation(st, f)
                   - jrender.reconstruction_correlation(jst, f)) < 1e-5
    for kw in (dict(), dict(pal_idx=9999), dict(page=-5), dict(page=10 ** 6),
               dict(frame=7, pal_idx=3)):
        np.testing.assert_array_equal(render.render_tiles_page(st, **kw),
                                      jrender.render_tiles_page(jst, **kw))
    far = render.render_tiles_page(st, page=10 ** 6)
    assert (far == np.array([0, 255, 255], np.uint8)).all()


def test_tile_fs_identity_at_8bpc(rng):
    t = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pdither.dither_tile_floyd_steinberg(t, 8), t)
    fr = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    assert pdither.floyd_steinberg_posterize(fr, 8) is fr


@pytest.mark.parametrize('bits', [4, 5])
def test_fs_posterize_matches_jax_package_and_python_loop(rng, bits,
                                                         monkeypatch):
    t = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    fr = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    out = pdither.dither_tile_floyd_steinberg(t, bits)
    assert out.shape == t.shape and not np.array_equal(out, t)
    np.testing.assert_array_equal(
        out, jdither.dither_tile_floyd_steinberg(t, bits))
    frame = pdither.floyd_steinberg_posterize(fr, bits)
    assert frame.shape == fr.shape and not np.array_equal(frame, fr)
    np.testing.assert_array_equal(
        frame, jdither.floyd_steinberg_posterize(fr, bits))
    # without the C++ library the Python loops give the same pixels
    from tiler_tpu_torch import native
    monkeypatch.setattr(native, 'available', lambda: False)
    np.testing.assert_array_equal(
        pdither.dither_tile_floyd_steinberg(t, bits), out)
    np.testing.assert_array_equal(
        pdither.floyd_steinberg_posterize(fr, bits), frame)


def test_run_load_posterizes_below_8_bits(rng, monkeypatch):
    from tiler_tpu_torch.pipeline import load as pload
    frames = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    monkeypatch.setattr(pload, 'BITS_PER_COMP', 5)
    enc = Encoder(EncoderConfig(palette_count=4), device='cpu')
    enc.load(frames)
    st = enc.state
    assert st.frames_rgb.tobytes() == frames.tobytes()
    np.testing.assert_array_equal(
        st.fs_pixels, np.stack([jdither.floyd_steinberg_posterize(f, 5)
                                for f in frames]))


def test_pearson_and_dl3_palette_match_jax_package(rng):
    from tiler_tpu.ops import palette as jpalette, stats as jstats
    from tiler_tpu_torch.ops import palette as ppalette, stats as pstats
    x = rng.normal(size=500).astype(np.float32)
    y = (x * 0.5 + rng.normal(size=500)).astype(np.float32)
    for a, b in ((x, y), (x, x), (x, np.ones(500, np.float32))):
        got = pstats.pearson(a, b)
        assert isinstance(got, float)
        assert abs(got - float(jstats.pearson(a, b))) < 1e-5
    px = rng.integers(0, 256, (40, 30, 3)).astype(np.uint8)
    for args in ((16, 7), (64, 6, 0), (8, 5, 16)):
        np.testing.assert_array_equal(ppalette.dl3_palette(px, *args),
                                      jpalette.dl3_palette(px, *args))
    assert not ppalette.dl3_palette(px[:0], 16).any()
