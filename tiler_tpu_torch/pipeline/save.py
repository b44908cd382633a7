"""Save step: assemble the GTM bitstream from encoder state, the
counterpart of tiler_tpu/pipeline/save.py.

Reference: SaveStream (main.pas:4529-4763). Requires a reindexed state
(dense active tile indices; the device tiles come to the host here).
Uses the smoothed tilemap when the Smooth step ran, otherwise the plain
tilemap with no skips.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.gtm import GTMWriter
from .state import EncoderState


def run_save(state: EncoderState, fast_lzma: bool = False) -> bytes:
    cfg = state.config
    n_active = int(state.tile_active.sum())
    if not state.tile_active[:n_active].all():
        raise RuntimeError('save requires a reindexed state')

    writer = GTMWriter(
        width=state.screen_w, height=state.screen_h, fps=state.fps,
        tiles_pal=state.tiles_pal[:n_active],
        palette_size=cfg.tile_palette_size,
        frame_count=state.n_frames, kf_count=len(state.keyframes),
        fast_lzma=fast_lzma, lzma_mode=cfg.lzma_mode)

    smoothed = state.stm_tile is not None
    tile, pal, hmir, vmir = (
        (state.stm_tile, state.stm_pal, state.stm_h, state.stm_v)
        if smoothed else
        (state.tm_tile, state.tm_pal, state.tm_h, state.tm_v))
    no_skips = np.zeros(state.tilemap_size, bool)
    for k, (s, e) in enumerate(state.keyframes):
        frames = [dict(tile_idx=tile[fr].ravel(), pal_idx=pal[fr].ravel(),
                       hmir=hmir[fr].ravel(), vmir=vmir[fr].ravel(),
                       smoothed=state.stm_smooth[fr].ravel() if smoothed
                       else no_skips)
                  for fr in range(s, e + 1)]
        writer.add_keyframe(k, int(s), int(e), state.palettes_rgb[k], frames)

    blob = writer.tobytes()
    state.metrics['gtm_bytes'] = len(blob)
    state.metrics['kbps'] = (len(blob) / 1024.0 * 8.0 / state.n_frames
                             * state.fps)
    return blob
