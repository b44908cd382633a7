"""MakeUnique step: merge byte-identical dithered tiles — the counterpart
of tiler_tpu/pipeline/unique.py.

The dedup runs on the device against the resident tile pixels: rows are
packed into words, grouped by a sort (torch.unique over rows), and each
group's winner is its lowest tile index (a scatter-min, which is order
independent). Only the winner map comes to the host. Byte-identical to
the JAX package's tile_words/dedupe_words.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import EncoderState


def tile_words(tiles_u8: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx of [N,8,8] uint8 tiles as [R,16] int64 words (four bytes
    each, big-endian in row byte order, as the JAX package packs them):
    equal rows give equal words."""
    rows = tiles_u8[idx].reshape(idx.shape[0], 16, 4).to(torch.int64)
    shifts = torch.arange(24, -8, -8, device=rows.device)
    return torch.sum(rows << shifts, dim=2)


def dedupe_words(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row, the lowest tile id among the rows equal to it."""
    _, inv = torch.unique(words, dim=0, return_inverse=True)
    win = torch.full((int(inv.max()) + 1,), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=idx.device)
    win.scatter_reduce_(0, inv, idx, reduce='amin')
    return win[inv]


def compute_unique_fwd_device(state: EncoderState):
    """Returns (fwd [N] forwarding map, new_use [N], new_active [N],
    losers) for the device-resident tiles, without touching any
    tilemap."""
    n = state.n_tiles
    fwd = np.arange(n)
    act = np.flatnonzero(state.tile_active)
    if act.size == 0:
        return fwd, state.tile_use.copy(), state.tile_active.copy(), act
    idx = torch.from_numpy(act.astype(np.int64)).to(state.device)
    winner = dedupe_words(tile_words(state.device_tiles_pal(), idx), idx)
    fwd[act] = winner.cpu().numpy()

    tile_use = state.tile_use
    new_use = tile_use.copy()
    acc = np.bincount(fwd[act], weights=tile_use[act],
                      minlength=n).astype(np.int64)
    losers = act[fwd[act] != act]
    new_use[act] = 0
    new_use += acc
    new_active = state.tile_active.copy()
    new_active[losers] = False
    return fwd, new_use, new_active, losers


def run_make_unique(state: EncoderState) -> EncoderState:
    fwd, new_use, new_active, losers = compute_unique_fwd_device(state)
    if losers.size:
        tiles = state.device_tiles_pal().clone()
        tiles[torch.from_numpy(losers.astype(np.int64)).to(state.device)] = 0
        state.set_tiles_pal_device(tiles)  # reference zeroes merged losers
    state.tile_use = new_use
    state.tile_active = new_active
    state.tm_tile = fwd[state.tm_tile].astype(np.int32)
    if state.stm_tile is not None:
        state.stm_tile = fwd[state.stm_tile].astype(np.int32)
    state.metrics['unique_tiles'] = int(state.tile_active.sum())
    return state
