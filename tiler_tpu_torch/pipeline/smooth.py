"""Smooth step: temporal tile merge for skip-run encoding — the
counterpart of tiler_tpu/pipeline/smooth.py.

Per cell, the PsyV DCT (quantization-weighted, no wavelets, linear
gamma) of the palette-rendered tile is compared with the same cell one
frame earlier; within the strength (f32 RMS over 192 dims) the lower
tile index wins and is copied across, and the cell is marked smoothed.
The backward copy overwrites the previous frame's cell including its
smoothed flag, as the reference does (main.pas:4071-4119). Each
keyframe's frame chain is a Python loop over frames, vectorised over
cells on the device, the cells cut across the state's mesh
(parallel.mesh_pipeline.map_rows; the same bytes at any shard count).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import TILE_DCT_SIZE

from ..ops import features
from ..parallel.mesh_pipeline import map_rows, replicate
from ..utils.dispatch import note
from .state import EncoderState

_SQRT_FACTOR = 1.0 / TILE_DCT_SIZE


def _cell_features(tiles_pal_all, palettes_k, tile, pal, hm, vm):
    """Gather + PsyV (DCT, JPEG weighting) of cells on the device."""
    return features.psyv_features_pal(
        tiles_pal_all[tile], palettes_k[pal], gamma_value=None,
        use_wavelets=False, q_weighting=True, hmir=hm, vmir=vm)


def smooth_chain(feats, tile, pal, hm, vm, strength: float):
    """The frame chain. feats [F,C,192] f32, tile/pal [F,C] int, hm/vm
    [F,C] bool. Returns (tile, pal, h, v, smoothed), each [F,C]."""
    out = [[tile[0]], [pal[0]], [hm[0]], [vm[0]],
           [torch.zeros_like(hm[0])]]
    p_feat = feats[0]
    for f in range(1, tile.shape[0]):
        p_tile, p_pal, p_h, p_v = (out[i][-1] for i in range(4))
        c_feat = feats[f]
        rms = torch.sqrt(torch.sum((c_feat - p_feat) ** 2, dim=1)
                         * _SQRT_FACTOR)
        near = torch.abs(rms) <= strength
        fwd = near & (tile[f] >= p_tile)
        bwd = near & ~fwd
        # backward: prev takes cur's fields, clearing its smoothed flag
        out[0][-1] = torch.where(bwd, tile[f], p_tile)
        out[1][-1] = torch.where(bwd, pal[f], p_pal)
        out[2][-1] = torch.where(bwd, hm[f], p_h)
        out[3][-1] = torch.where(bwd, vm[f], p_v)
        out[4][-1] = torch.where(bwd, False, out[4][-1])
        # forward: cur takes prev's fields and features
        out[0].append(torch.where(fwd, p_tile, tile[f]))
        out[1].append(torch.where(fwd, p_pal, pal[f]))
        out[2].append(torch.where(fwd, p_h, hm[f]))
        out[3].append(torch.where(fwd, p_v, vm[f]))
        out[4].append(near)
        p_feat = torch.where(fwd[:, None], p_feat, c_feat)
    return tuple(torch.stack(o) for o in out)


def _smooth_cells(tile, pal, hm, vm, tiles_pal_all, palettes_k,
                  strength: float):
    """One keyframe's smooth of the cells tile/pal/hm/vm [F,C]: their
    features, then smooth_chain."""
    f, c = tile.shape
    feats = _cell_features(tiles_pal_all, palettes_k, tile.reshape(-1),
                           pal.reshape(-1), hm.reshape(-1),
                           vm.reshape(-1)).reshape(f, c, -1)
    return smooth_chain(feats, tile, pal, hm, vm, strength)


def run_smooth(state: EncoderState) -> EncoderState:
    strength = float(state.config.smoothing_strength)
    cells = state.tilemap_size
    dev = state.device
    state.stm_tile = state.tm_tile.copy()
    state.stm_pal = state.tm_pal.copy()
    state.stm_h = state.tm_h.copy()
    state.stm_v = state.tm_v.copy()
    state.stm_smooth = np.zeros_like(state.tm_tile, bool)
    tiles = replicate(state.mesh, state.device_tiles_pal())

    def up(a, s, e, dtype):
        note('h2d')
        return torch.from_numpy(
            np.ascontiguousarray(a[s:e + 1].reshape(e - s + 1, cells))
        ).to(dev, dtype)

    smoothed_cells = 0
    for k, (s, e) in enumerate(state.keyframes):
        if e - s + 1 < 2:
            continue
        rows = (up(state.tm_tile, s, e, torch.int64),
                up(state.tm_pal, s, e, torch.int64),
                up(state.tm_h, s, e, torch.bool),
                up(state.tm_v, s, e, torch.bool))
        note('h2d')
        pals_k = torch.from_numpy(state.palettes_rgb[k]).to(dev)
        # every cell's frame chain is independent: the cells are cut
        note('d2h', 5)
        stm = [t.cpu().numpy() for t in map_rows(
            state.mesh, _smooth_cells, rows, tiles, pals_k, strength,
            dim=1)]
        sh = state.tm_tile[s:e + 1].shape
        state.stm_tile[s:e + 1] = stm[0].reshape(sh)
        state.stm_pal[s:e + 1] = stm[1].reshape(sh)
        state.stm_h[s:e + 1] = stm[2].reshape(sh)
        state.stm_v[s:e + 1] = stm[3].reshape(sh)
        state.stm_smooth[s:e + 1] = stm[4].reshape(sh)
        smoothed_cells += int(stm[4].sum())
    state.metrics['smoothed_cells'] = smoothed_cells
    return state
