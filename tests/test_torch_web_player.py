"""Streams written by the port played through the shipped web player
(decoders/web/gtm_player.js) under the mini-JS engine of tools/minijs,
frame for frame against the port's numpy decoder: the dryrun stream of
tiler_tpu_torch.graft_entry, a full-pipeline encode with several
keyframes, mirrors and skip runs, and an lzma_mode='best' encode (native
LZMA streams whose lp/pb the player's own decoder must parse). Nothing
here needs the reference player's sources."""
import os
import sys

import numpy as np
import pytest
import torch

from tiler_tpu_torch.bitstream.gtm import parse_gtm
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.decode import decode_video, interpret_commands
from tiler_tpu_torch.graft_entry import dryrun_multichip
from tiler_tpu_torch.pipeline.encoder import Encoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.join(REPO, 'tools'))

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def web_player_vm():
    """decoders/web/gtm_player.js loaded in the mini-JS engine."""
    from minijs.engine import Interpreter
    from minijs.host import BrowserHost
    it = Interpreter()
    BrowserHost(it)
    with open(os.path.join(REPO, 'decoders/web/gtm_player.js')) as fh:
        it.run(fh.read())
    return it


def play_web(it, blob: bytes, n_frames: int) -> np.ndarray:
    """Drive decoders/web/gtm_player.js's TilerGTM directly."""
    from minijs.engine import TypedArray, js_tonumber
    player = it.construct(it.get_global('TilerGTM'),
                          [TypedArray(bytearray(blob))])
    decode = it.get_property(player, 'decodeFrame')
    frames = []
    for _ in range(n_frames):
        ok = decode.call_impl(player, [])
        assert ok is True
        w = int(js_tonumber(player.get('width')))
        h = int(js_tonumber(player.get('height')))
        px = np.frombuffer(player.get('pixels').data, np.uint8)
        frames.append(px.reshape(h, w, 4)[..., :3].copy())
    return np.stack(frames)


def synthetic_multishot(w=160, h=96, shots=3, shot_len=6, seed=7):
    rng = np.random.default_rng(seed)
    frames = []
    for s in range(shots):
        coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3))
        bg = np.stack([
            np.kron(coarse[..., c], np.ones((16, 16)))[:h, :w]
            for c in range(3)], axis=-1)
        bg = (bg * 0.7 + rng.integers(0, 256, (h, w, 3)) * 0.3
              ).astype(np.uint8)
        for t in range(shot_len):
            f = bg.copy()
            x0 = (8 + 16 * t) % (w - 24)
            y0 = (12 + 8 * t) % (h - 24)
            f[y0:y0 + 16, x0:x0 + 16] = [255 - 40 * s, 32 + 50 * s, 200]
            frames.append(f)
    return np.stack(frames)


MULTISHOT = dict(palette_count=24, tile_palette_size=16,
                 smoothing_strength=0.06)


def _stream(name: str) -> bytes:
    if name == 'dryrun':
        return dryrun_multichip(2, devices=['cpu'] * 2)
    lzma = dict(lzma_mode='best') if name == 'multishot_best' else {}
    return Encoder(EncoderConfig(**MULTISHOT, **lzma), device='cpu').run_all(
        synthetic_multishot(), fps=24.0, fast_lzma=not lzma)


@pytest.mark.parametrize('name', ['dryrun', 'multishot', 'multishot_best'])
def test_port_stream_plays_in_the_web_player(web_player_vm, name):
    blob = _stream(name)
    parsed = parse_gtm(blob)
    stream = interpret_commands(parsed)
    # each stream has two keyframes or more and skips cells; the
    # multishot encodes also mirror tiles both ways
    assert parsed.header.kf_count >= 2
    drawn = sum(f.positions.size for f in stream.frames)
    assert drawn < stream.tilemap_w * stream.tilemap_h * len(stream.frames)
    if name != 'dryrun':
        attrs = np.concatenate([f.attrs for f in stream.frames])
        assert ((attrs & 1) != 0).any() and ((attrs & 2) != 0).any()
    want, _ = decode_video(blob)
    got = play_web(web_player_vm, blob, want.shape[0])
    np.testing.assert_array_equal(got, want)
