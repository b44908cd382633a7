"""Reindex step: recount usage, drop unused tiles, sort by use count —
the counterpart of tiler_tpu/pipeline/reindex.py. Sort is use-count
descending with original-index tie-break (CompareTileUseCountRev,
main.pas:4472-4481) so frequent tiles get small indices; the tile pixels
are permuted on the device."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.dispatch import note
from .state import EncoderState


def compute_reindex(use: np.ndarray):
    """Pure: use counts [N] -> (order, idx_map). Tiles with zero use drop;
    survivors sort by use desc, index asc."""
    n = len(use)
    act = np.flatnonzero(use > 0)
    order = act[np.lexsort((act, -use[act]))]
    idx_map = np.full(n, -1, np.int64)
    idx_map[order] = np.arange(len(order))
    return order, idx_map


def run_reindex(state: EncoderState) -> EncoderState:
    n = state.n_tiles
    use = np.bincount(state.tm_tile.ravel(), minlength=n).astype(np.int64)
    order, idx_map = compute_reindex(use)

    state.tiles_rgb = state.tiles_rgb[order]
    note('h2d')
    order_d = torch.from_numpy(order.astype(np.int64)).to(state.device)
    state.set_tiles_pal_device(state.device_tiles_pal()[order_d])
    state.tile_use = use[order]
    state.tile_dpi = state.tile_dpi[order]
    state.tile_active = np.ones(len(order), bool)

    state.tm_tile = idx_map[state.tm_tile].astype(np.int32)
    if state.stm_tile is not None:
        state.stm_tile = idx_map[state.stm_tile].astype(np.int32)
    if (state.tm_tile < 0).any():
        raise RuntimeError('tilemap references a dropped tile')
    state.metrics['reindexed_tiles'] = len(order)
    return state
