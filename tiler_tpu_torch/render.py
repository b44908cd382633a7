"""Preview renderer: the counterpart of tiler_tpu/render.py. It
reconstructs frames directly from encoder state (the GUI's Render path,
main.pas:3305-3493) and gives the reconstruction-vs-source correlation
metric (main.pas:3470-3489). Host numpy, as in the JAX package: reading
`state.tiles_pal` brings the device tiles to the host once.
"""
from __future__ import annotations

import numpy as np

from .constants import TILE_W
from .ops import stats
from .pipeline.state import EncoderState


def render_frame(state: EncoderState, frame: int,
                 use_smoothed: bool = True) -> np.ndarray:
    """Reconstructed output frame [H,W,3] uint8 from the tilemap."""
    th, tw = state.tilemap_h, state.tilemap_w
    if use_smoothed and state.stm_tile is not None:
        tiles = state.stm_tile[frame].ravel()
        pals = state.stm_pal[frame].ravel()
        hm = state.stm_h[frame].ravel()
        vm = state.stm_v[frame].ravel()
    else:
        tiles = state.tm_tile[frame].ravel()
        pals = np.maximum(state.tm_pal[frame].ravel(), 0)
        hm = state.tm_h[frame].ravel()
        vm = state.tm_v[frame].ravel()
    k = int(state.kf_of_frame()[frame])
    tp = state.tiles_pal[tiles]  # [cells,8,8]
    tp = np.where(hm[:, None, None], tp[:, :, ::-1], tp)
    tp = np.where(vm[:, None, None], tp[:, ::-1, :], tp)
    pal_rgb = state.palettes_rgb[k][pals]  # [cells,S,3]
    rgb = np.take_along_axis(
        pal_rgb, tp.reshape(len(tp), -1, 1).astype(np.int64), axis=1
    ).reshape(len(tp), TILE_W, TILE_W, 3)
    return rgb.reshape(th, tw, TILE_W, TILE_W, 3) \
        .transpose(0, 2, 1, 3, 4).reshape(th * TILE_W, tw * TILE_W, 3)


def render_tiles_page(state: EncoderState, frame: int = 0, page: int = 0,
                      pal_idx: int = 0) -> np.ndarray:
    """The GUI's tiles-page view (main.pas:3371-3392): a screen-shaped
    grid of global tiles starting at index tilemap_size*page, rendered
    through the frame's keyframe palette max(0, pal_idx); cells past the
    tileset are aqua (clAqua). Tiles draw in stored (mirror-baked)
    orientation."""
    th, tw = state.tilemap_h, state.tilemap_w
    cells = th * tw
    k = int(state.kf_of_frame()[frame])
    n_pals = state.palettes_rgb.shape[1]
    pal = state.palettes_rgb[k][min(max(0, pal_idx), n_pals - 1)]  # [S,3]
    tiles_pal = state.tiles_pal
    n_tiles = len(tiles_pal)
    base = cells * max(0, page)
    out = np.zeros((cells, TILE_W, TILE_W, 3), np.uint8)
    out[...] = np.array([0, 255, 255], np.uint8)  # clAqua background
    idx = np.arange(base, base + cells)
    ok = idx < n_tiles
    sel = tiles_pal[idx[ok]].astype(np.int64)  # [m,8,8]
    out[ok] = pal[sel]
    return out.reshape(th, tw, TILE_W, TILE_W, 3) \
        .transpose(0, 2, 1, 3, 4).reshape(th * TILE_W, tw * TILE_W, 3)


def render_palette_strip(state: EncoderState, frame: int = 0) -> np.ndarray:
    """The GUI's palette view (main.pas:3403-3419 imgPalette fill): one
    row per palette, one column per palette entry."""
    k = int(state.kf_of_frame()[frame])
    return state.palettes_rgb[k].copy()  # [palette_count, S, 3]


def reconstruction_correlation(state: EncoderState, frame: int) -> float:
    """Pearson correlation of reconstruction vs source, luma-weighted per
    plane as in ComputeCorrelationBGR (main.pas:769-788)."""
    rec = render_frame(state, frame).astype(np.float64)
    src = state.frames_rgb[frame].astype(np.float64)
    w = np.array([2126.0, 7152.0, 722.0])
    a = (src * w).transpose(2, 0, 1).ravel()
    b = (rec * w).transpose(2, 0, 1).ravel()
    return float(stats.pearson(a.astype(np.float32), b.astype(np.float32)))


def reconstruction_psnr(state: EncoderState) -> float:
    rec = np.stack([render_frame(state, f) for f in range(state.n_frames)])
    return float(stats.psnr(rec, state.frames_rgb))
