"""Whole streams of the 8x120x160 cuts_v2 clip under KModes restarts, a
64-colour tile palette and a GTS reload: the port on the CPU against the
JAX package, byte for byte."""
import dataclasses

import numpy as np
import pytest

from bench import synthetic_clip_v2
from tiler_tpu.bitstream.gtm import write_gts
from tiler_tpu.config import EncoderConfig
from tiler_tpu.decode import decode_video
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.pipeline.encoder import Encoder

BASE = EncoderConfig(palette_count=16, max_tiles=400)


@pytest.fixture(scope='module')
def frames():
    return synthetic_clip_v2(8, 120, 160)


def _both(cfg, frames):
    want = JaxEncoder(cfg).run_all(frames, fps=24, fast_lzma=True)
    enc = Encoder(cfg, device='cpu')
    return enc, enc.run_all(frames, fps=24, fast_lzma=True), want


@pytest.mark.parametrize('case', ['restarts3', 'palette64'])
def test_stream_matches_jax(frames, case):
    cfg = (dataclasses.replace(BASE, kmodes_restarts=3) if case ==
           'restarts3' else dataclasses.replace(BASE, tile_palette_size=64))
    enc, got, want = _both(cfg, frames)
    assert got == want
    dec, stream = decode_video(got)
    assert dec.shape == frames.shape
    assert enc.state.metrics['global_tiling_merged'] > 0


def test_stream_reload_matches_jax(frames, tmp_path):
    """Reload of the tileset the port wrote for a Yliluoma + VAR encode of
    the same clip (as the CLI's --gts-out writes it)."""
    first = Encoder(dataclasses.replace(BASE, use_thomas_knoll=False,
                                        use_dl3=False), device='cpu')
    first.run_all(frames, fps=24, fast_lzma=True)
    gts = str(tmp_path / 'first.gts')
    n = int(first.state.tile_active.sum())
    write_gts(gts, first.state.tiles_pal[:n], BASE.tile_palette_size)
    enc, got, want = _both(dataclasses.replace(BASE, reload_tileset=gts),
                           frames)
    assert got == want
    assert 'global_tiling_merged' not in enc.state.metrics
    # every tile of the reloaded encode comes from the previous tileset
    prev = {t.tobytes() for t in first.state.tiles_pal[:n]}
    tiles = decode_video(got)[1].tiles
    assert {t.tobytes() for t in np.asarray(tiles)} <= prev | {
        np.zeros((8, 8), np.uint8).tobytes()}
