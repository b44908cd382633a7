"""Streaming GTM player: lazy per-keyframe decode with a persistent canvas.

The reference's player (decoders/htmljs/gtm.player.js)
decompresses incrementally (unpackData rate-limited to KFMaxBytesPerSec,
gtm.player.js:157-170), interprets commands frame by frame, blits onto a
persistent canvas, and loops at FrameEnd of the last keyframe. This is the
framework-native equivalent: keyframe LZMA streams decode lazily as the
playhead reaches them (each keyframe is an independent LZMA-alone stream,
the container's designed seek/stream unit), commands feed a stateful
CommandInterpreter, and frames materialize one at a time — constant memory
in the clip length, first frame available after decoding only keyframe 0.

    player = GTMPlayer(open('clip.gtm', 'rb').read())
    for frame in player.frames():          # np.uint8 [H, W, 3]
        show(frame, duration=player.frame_interval_s)
"""
from __future__ import annotations

import numpy as np

from .bitstream.gtm import HEADER_SIZE, KFINFO_SIZE, GTMHeader, \
    GTMKeyFrameInfo
from .bitstream.lzma_codec import iter_lzma_streams
from .decode import (CommandInterpreter, DecodedStream, TILE_W,
                     _blit_cells_blocked, blocks_to_image)


class GTMPlayer:
    """Pull-based streaming decoder over a GTM byte buffer."""

    def __init__(self, data: bytes):
        self.header = None
        self.kf_infos: list[GTMKeyFrameInfo] = []
        body = data
        if data[:4] == b'GTMv':
            self.header = GTMHeader.unpack(data)
            self.kf_infos = [
                GTMKeyFrameInfo.unpack(
                    data, HEADER_SIZE + i * KFINFO_SIZE)
                for i in range(self.header.kf_count)]
            whole = self.header.whole_header_size or (
                HEADER_SIZE + KFINFO_SIZE * self.header.kf_count)
            body = data[whole:]
        # legacy headerless streams (the published demos) start straight
        # with LZMA data (gtm.player.js:136-138)
        self._body = body
        self._streams = iter_lzma_streams(body)
        self.keyframes_decoded = 0
        w = self.header.width if self.header else 0
        h = self.header.height if self.header else 0
        self._interp = CommandInterpreter(w, h)
        self._blocks = None

    # -- stream properties (valid once the first keyframe has decoded) ----

    @property
    def width(self) -> int:
        return self._interp.tilemap_w * TILE_W

    @property
    def height(self) -> int:
        return self._interp.tilemap_h * TILE_W

    @property
    def frame_interval_s(self) -> float:
        ns = self._interp.frame_len_ns
        return ns / 1e9 if ns else 1.0 / 24.0

    @property
    def kf_max_bytes_per_sec(self) -> int:
        """The decoder throughput budget the encoder declared
        (main.pas:113); a pacing hint, as in gtm.player.js:162-164."""
        return self.header.kf_max_bytes_per_sec if self.header else 0

    # -- playback ----------------------------------------------------------

    def frames(self, loop: bool = False):
        """Yields frames [H, W, 3] uint8 as they decode.

        With loop=True, restarts from keyframe 0 after the last frame
        (re-parsing from the retained compressed body), like the JS
        player's rewind (gtm.player.js:355-359)."""
        while True:
            for chunk in self._streams:
                for ops in self._interp.feed(chunk):
                    yield self._render(ops)
                self.keyframes_decoded += 1
            if not loop:
                return
            # rewind: fresh interpreter over the retained compressed body
            w = self.header.width if self.header else 0
            h = self.header.height if self.header else 0
            self._interp = CommandInterpreter(w, h)
            self._streams = iter_lzma_streams(self._body)
            self._blocks = None

    def _render(self, ops) -> np.ndarray:
        interp = self._interp
        th, tw = interp.tilemap_h, interp.tilemap_w
        if self._blocks is None:
            self._blocks = np.zeros((th * tw, TILE_W, TILE_W, 3), np.uint8)
        stream = DecodedStream(
            width=tw * TILE_W, height=th * TILE_W, tilemap_w=tw,
            tilemap_h=th, frame_len_ns=interp.frame_len_ns,
            tiles=interp.tiles_3d(), frames=[])
        _blit_cells_blocked(self._blocks, stream, ops)
        return blocks_to_image(self._blocks, th, tw)
