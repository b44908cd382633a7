"""MakeUnique step: merge byte-identical dithered tiles — the counterpart
of tiler_tpu/pipeline/unique.py.

The dedup runs on the device against the resident tile pixels: rows are
packed into words, grouped by a sort (torch.unique over rows), and each
group's winner is its lowest tile index (a scatter-min, which is order
independent). Only the winner map comes to the host. Byte-identical to
the JAX package's tile_words/dedupe_words. On a mesh_ok mesh (more than
one shard, a power of two) the dedup is hash-partitioned across it
(parallel.sharded_ops.sharded_unique), with the same canonical winners;
else it runs on the mesh's first device.

The tileset-level computation has an array-argument form
(compute_unique_fwd) so the multi-host encode can run it identically on
every host over the allgathered global tileset (parallel.gop_exact).
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh_pipeline import mesh_ok
from ..utils.dispatch import note, phases, span, spans
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
    # the groups' count, then their largest id, come to the host (the
    # CUDA runtime's sync check flags only the second)
    note('d2h', 2)
    _, inv = torch.unique(words, dim=0, return_inverse=True)
    win = torch.full((int(inv.max()) + 1,), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=idx.device)
    win.scatter_reduce_(0, inv, idx, reduce='amin')
    return win[inv]


def compute_unique_fwd_device(state: EncoderState):
    """Returns (fwd [N] forwarding map, new_use [N], new_active [N],
    losers) for the device-resident tiles, without touching any
    tilemap. metrics['mu_phases'] splits the dedup into its enqueue
    (the span 'make_unique/queue') and its wait for the winners
    ('make_unique/sync'; 0 on a mesh, whose sharded dedup brings them to
    the host itself), beside the rows deduplicated."""
    n = state.n_tiles
    fwd = np.arange(n)
    act = np.flatnonzero(state.tile_active)
    if act.size == 0:
        return fwd, state.tile_use.copy(), state.tile_active.copy(), act
    before = spans()
    if mesh_ok(state.mesh):
        # a lazy import: sharded_ops builds on this module's dedup
        from ..parallel.sharded_ops import sharded_unique
        with span('make_unique/queue'):
            sidx, winner = sharded_unique(state.mesh,
                                          state.device_tiles_pal(), act, n)
    else:
        sidx = act
        with span('make_unique/queue'):
            note('h2d')
            idx = torch.from_numpy(act.astype(np.int64)).to(state.device)
            winner = dedupe_words(tile_words(state.device_tiles_pal(), idx),
                                  idx)
        with span('make_unique/sync'):
            note('d2h')
            winner = winner.cpu().numpy()
    state.metrics['mu_phases'] = {
        **phases('make_unique', before, ('queue', 'sync')),
        'rows': int(act.size)}
    fwd[sidx] = winner

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


def compute_unique_fwd(tiles_pal: np.ndarray, tile_active: np.ndarray,
                       tile_use: np.ndarray, device='cuda', mesh=None):
    """compute_unique_fwd_device over GLOBAL host arrays (uploaded to
    `device`, sharded across `mesh` when it is mesh_ok): the same
    (fwd, new_use, new_active, losers)."""
    st = EncoderState(config=None, device=torch.device(device), mesh=mesh)
    st.tiles_pal, st.tile_active, st.tile_use = tiles_pal, tile_active, \
        tile_use
    return compute_unique_fwd_device(st)


def run_make_unique(state: EncoderState) -> EncoderState:
    fwd, new_use, new_active, losers = compute_unique_fwd_device(state)
    if losers.size:
        tiles = state.device_tiles_pal().clone()
        note('h2d', 2)      # the losers' rows and the fill value
        tiles[torch.from_numpy(losers.astype(np.int64)).to(state.device)] = 0
        state.set_tiles_pal_device(tiles)  # reference zeroes merged losers
    state.tile_use = new_use
    state.tile_active = new_active
    state.tm_tile = fwd[state.tm_tile].astype(np.int32)
    if state.stm_tile is not None:
        state.stm_tile = fwd[state.stm_tile].astype(np.int32)
    state.metrics['unique_tiles'] = int(state.tile_active.sum())
    return state
