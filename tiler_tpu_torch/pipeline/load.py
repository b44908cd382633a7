"""Load step: tile split, keyframe detection and the temporal changed
mask — the counterpart of tiler_tpu/pipeline/load.py (in-memory frames;
ffmpeg ingestion is not ported yet).

Everything here is host numpy and byte-identical to the JAX package; the
frames go to the device once, when the first step needs the source
tiles (EncoderState.device_source_tiles).
"""
from __future__ import annotations

import numpy as np

from ..constants import (BITS_PER_COMP, MAX_TILEMAP_H,
                                 MAX_TILEMAP_W, SHOT_TRANS_AVG_FRAMES,
                                 SHOT_TRANS_GRACE_PERIOD,
                                 SHOT_TRANS_HARD_THRES,
                                 SHOT_TRANS_MAX_TILES_PER_KF,
                                 SHOT_TRANS_SOFT_THRES, TILE_W)

from ..ops import stats
from .state import EncoderState


def split_into_tiles(frames: np.ndarray, th: int, tw: int) -> np.ndarray:
    """[F,H,W,3] -> [F*TH*TW, 8, 8, 3] in frame-major row-major cell order."""
    f = frames.shape[0]
    x = frames[:, :th * TILE_W, :tw * TILE_W]
    x = x.reshape(f, th, TILE_W, tw, TILE_W, 3).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(f * th * tw, TILE_W, TILE_W, 3))


def keyframes_from_correlations(corr: np.ndarray, tilemap_size: int,
                                n_frames: int) -> np.ndarray:
    """EWMA ratio thresholding of an inter-frame correlation trace into
    keyframe ranges (main.pas:1099-1155). Returns [K,2] inclusive frame
    ranges."""
    starts = [0]
    av = -1.0
    last_kf = 0
    for i in range(1, n_frames):
        v = float(corr[i - 1])
        if av == -1.0:
            av = v
        else:
            av = av * (1.0 - 1.0 / SHOT_TRANS_AVG_FRAMES) + \
                v * (1.0 / SHOT_TRANS_AVG_FRAMES)
        ratio = max(0.01, v) / max(0.01, av)
        is_kf = (ratio < SHOT_TRANS_HARD_THRES) or \
            (ratio < SHOT_TRANS_SOFT_THRES and
             (i - last_kf + 1) > SHOT_TRANS_GRACE_PERIOD) or \
            ((i - last_kf + 1) * tilemap_size > SHOT_TRANS_MAX_TILES_PER_KF)
        if is_kf:
            starts.append(i)
            av = -1.0
            last_kf = i
    starts.append(n_frames)
    return np.array([[starts[k], starts[k + 1] - 1]
                     for k in range(len(starts) - 1)], np.int32)


def detect_keyframes(fs_pixels: np.ndarray, tilemap_size: int) -> np.ndarray:
    """Shot-transition detection on the host: Pearson correlations plus
    the EWMA ratio thresholds. Returns [K,2] inclusive frame ranges."""
    f = len(fs_pixels)
    if f == 1:
        return np.array([[0, 0]], np.int32)
    corr = stats.interframe_correlations_host(np.asarray(fs_pixels))
    return keyframes_from_correlations(corr, tilemap_size, f)


def changed_mask(frames_rgb: np.ndarray, th: int, tw: int) -> np.ndarray:
    """[F,H,W,3] u8 -> bool [F, th*tw]: cell differs from the same cell
    one frame earlier (frame 0 all-True). FrameTiling's stage 3 forward-
    fills the 1-NN result of unchanged cells (exact duplicates)."""
    f = frames_rgb.shape[0]
    x = frames_rgb[:, :th * TILE_W, :tw * TILE_W] \
        .reshape(f, th, TILE_W, tw, TILE_W, 3)
    eq = (x[1:] == x[:-1]).all(axis=(2, 4, 5))
    out = np.ones((f, th * tw), bool)
    out[1:] = ~eq.reshape(f - 1, th * tw)
    return out


def run_load(state: EncoderState, frames: np.ndarray,
             fps: float | None = None) -> EncoderState:
    """Populate state from raw frames [F,H,W,3] uint8."""
    cfg = state.config
    if BITS_PER_COMP < 8:
        raise NotImplementedError('FS posterize below 8 bits/comp is not '
                                  'ported')
    if fps is not None:
        state.fps = fps
    f, h, w, _ = frames.shape
    th = min(h // TILE_W, MAX_TILEMAP_H)
    tw = min(w // TILE_W, MAX_TILEMAP_W)
    if th == 0 or tw == 0:
        raise ValueError('input smaller than one tile')
    state.tilemap_h, state.tilemap_w = th, tw
    frames = np.ascontiguousarray(frames[:, :th * TILE_W, :tw * TILE_W])
    state.frames_rgb = frames
    state.fs_pixels = frames  # FS posterize is the identity at 8 bits
    state.keyframes = detect_keyframes(state.fs_pixels, th * tw)

    state.tiles_rgb = split_into_tiles(frames, th, tw)
    n = state.tiles_rgb.shape[0]
    state.tiles_pal = np.zeros((n, TILE_W, TILE_W), np.uint8)
    state.tile_active = np.ones(n, bool)
    state.tile_use = np.ones(n, np.int64)
    state.tile_dpi = np.full(n, -1, np.int32)

    state.tm_tile = np.arange(n, dtype=np.int32).reshape(f, th, tw)
    state.tm_pal = np.full((f, th, tw), -1, np.int32)
    state.tm_h = np.zeros((f, th, tw), bool)
    state.tm_v = np.zeros((f, th, tw), bool)

    mask = changed_mask(frames, th, tw)
    mask[state.keyframes[:, 0], :] = True
    state.changed_mask = mask
    k = len(state.keyframes)
    state.palettes_rgb = np.zeros(
        (k, cfg.palette_count, cfg.tile_palette_size, 3), np.uint8)
    state.palette_centroids = np.zeros(
        (k, cfg.palette_count, 192), np.float32)
    state.metrics['n_keyframes'] = k
    return state
