"""The JAX suite's edge cases (tests/test_edge_cases.py) and determinism
tests (tests/test_determinism.py) for the port on the CPU: each edge-case
clip gives the JAX package's stream byte for byte, a frame smaller than a
tile is refused, a corrupt or truncated stream decodes without a crash,
and two encodes of one clip are byte-identical."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import dataclasses

import numpy as np
import pytest
import torch

from tiler_tpu.config import EncoderConfig as JaxConfig
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.bitstream.gtm import parse_gtm
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.pipeline.encoder import Encoder

torch.set_num_threads(1)

SMALL = dict(palette_count=2, tile_palette_size=4)


def _gray(rng):
    g = rng.integers(0, 256, (2, 16, 16, 1)).astype(np.uint8)
    return np.repeat(g, 3, axis=3)


# id: (frames from the suite's seeded rng, config fields), as the JAX
# suite draws them
CLIPS = {
    'single_frame': (lambda r: r.integers(0, 256, (1, 16, 16, 3)), SMALL),
    'single_tile': (lambda r: r.integers(0, 256, (2, 8, 8, 3)), SMALL),
    'crop_21x13': (lambda r: r.integers(0, 256, (2, 13, 21, 3)), SMALL),
    'grayscale': (_gray, SMALL),
    'palette_count_256': (lambda r: r.integers(0, 255, (2, 32, 48, 3)),
                          dict(palette_count=256, tile_palette_size=4,
                               max_tiles=20)),
    'tile_palette_size_64': (lambda r: r.integers(0, 255, (2, 32, 48, 3)),
                             dict(palette_count=4, tile_palette_size=64,
                                  max_tiles=20)),
}


@pytest.mark.parametrize('clip', list(CLIPS))
def test_edge_clip_matches_jax(rng, clip):
    make, kw = CLIPS[clip]
    frames = make(rng).astype(np.uint8)
    want = JaxEncoder(JaxConfig(**kw)).run_all(frames, fps=24.0,
                                               fast_lzma=True)
    got = Encoder(EncoderConfig(**kw), device='cpu').run_all(
        frames, fps=24.0, fast_lzma=True)
    assert got == want
    dec, stream = decode_video(got)
    th, tw = frames.shape[1] // 8, frames.shape[2] // 8
    assert dec.shape == (len(frames), th * 8, tw * 8, 3)
    assert stream.frames[-1].kf_end


def test_too_small_input_raises():
    enc = Encoder(EncoderConfig(**SMALL), device='cpu')
    with pytest.raises(ValueError):
        enc.load(np.zeros((1, 4, 4, 3), np.uint8))


def test_corrupt_gtm_graceful():
    """A zero-filled payload: a clean ValueError or an empty decode."""
    try:
        _, stream = decode_video(b'GTMv' + b'\x00' * 100)
        assert len(stream.frames) == 0
    except ValueError:
        pass


def test_truncated_stream_partial_decode(rng):
    """Cut inside the LZMA payload: the parser returns what it can."""
    frames = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    blob = Encoder(EncoderConfig(**SMALL), device='cpu').run_all(
        frames, fast_lzma=True)
    parsed = parse_gtm(blob[:len(blob) - 20])
    assert isinstance(parsed.commands, bytes)
    assert len(parsed.commands) < len(parse_gtm(blob).commands)


def _determinism_clip(rng):
    f, h, w = 5, 40, 56
    frames = np.zeros((f, h, w, 3), np.uint8)
    _, xx = np.mgrid[0:h, 0:w]
    for i in range(f):
        frames[i] = np.clip(
            ((xx * 4 + i * 3) % 256)[..., None] * np.array([1, .7, .4])
            + rng.normal(0, 5, (h, w, 3)), 0, 255)
    return frames


@pytest.mark.parametrize('case', ['default', 'yliluoma_var'])
def test_encode_bit_identical(rng, case):
    frames = _determinism_clip(rng)
    cfg = EncoderConfig(palette_count=4, tile_palette_size=16)
    if case == 'yliluoma_var':
        cfg = dataclasses.replace(cfg, use_thomas_knoll=False, use_dl3=False)
    blob1 = Encoder(cfg, device='cpu').run_all(frames.copy(), fast_lzma=True)
    blob2 = Encoder(cfg, device='cpu').run_all(frames.copy(), fast_lzma=True)
    assert blob1 == blob2
