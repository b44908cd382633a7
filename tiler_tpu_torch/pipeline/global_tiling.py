"""GlobalTiling step: reduce the tileset to a budget with KModes — the
counterpart of the device path of tiler_tpu/pipeline/global_tiling.py.

Per active tile an 80-byte signature (64 palette indices + 16 zone
flags) is built on the device; tiles are binned by DitheringPalIndex,
the budget is shared by EqualQualityTileCount, every bin is solved in one
batched KModes call (from its min-byte-sum line, or from golden-ratio
restarts), and each cluster merges into its winner. Then the global
MakeUnique and Reindex run. With a GTS tileset to reload, each active
tile is replaced by its nearest line of that tileset instead
(ReloadPreviousTiling), and only MakeUnique follows.

The signature build's rows are cut across the state's mesh, and with
config.mesh_kmodes the KModes solves' points too (ops.kmodes,
devices=; bit-identical at any shard count). The
tileset-level computation has an array-argument form
(compute_global_tiling_fwd) for the multi-host encode.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..bitstream.gtm import read_gts, write_gts
from ..constants import KMODES_ZONE_COUNT, equal_quality_tile_count

from ..ops.kmodes import kmodes_batch_gather
from ..parallel.mesh_pipeline import map_rows, ranges
from ..utils.dispatch import note
from .reindex import run_reindex
from .state import EncoderState
from .unique import run_make_unique


def _zone_counts(flat: torch.Tensor, palette_size: int) -> torch.Tensor:
    """[R,16] int32: how many of each row's 64 indices fall in each zone."""
    zone_of = flat * KMODES_ZONE_COUNT // palette_size
    zr = torch.arange(KMODES_ZONE_COUNT, device=flat.device)
    return torch.sum(zone_of[:, :, None] == zr, dim=1, dtype=torch.int32)


def tile_signatures(tiles_u8: torch.Tensor, idx: torch.Tensor,
                    palette_size: int):
    """[R,80] uint8 KModes lines of tiles idx, and their byte sums."""
    flat = tiles_u8[idx].reshape(idx.shape[0], 64).to(torch.int32)
    acc = _zone_counts(flat, palette_size)
    zones = (acc > palette_size // KMODES_ZONE_COUNT).to(torch.uint8)
    sigs = torch.cat([flat.to(torch.uint8), zones], dim=1)
    return sigs, torch.sum(sigs.to(torch.int64), dim=1)


def pal_signi(tiles_u8: torch.Tensor, palette_size: int) -> torch.Tensor:
    """PalSigni of [R,8,8] tiles: min over zones of (64 - zone count)."""
    flat = tiles_u8.reshape(tiles_u8.shape[0], 64).to(torch.int32)
    return torch.min(64 - _zone_counts(flat, palette_size), dim=1).values


def _signature_rows(idx: torch.Tensor, tiles: torch.Tensor,
                    palette_size: int):
    return tile_signatures(tiles, idx, palette_size)


def compute_global_tiling_fwd_device(state: EncoderState, cfg,
                                     desired_tiles: int, kmodes_mesh=None):
    """Returns (fwd, new_use, new_active, merges) for the device tiles;
    the KModes solves' points are cut across kmodes_mesh when it is
    given."""
    phases = {}
    t0 = time.perf_counter()
    n = state.n_tiles
    act = np.flatnonzero(state.tile_active)
    note('h2d', len(ranges(state.mesh, len(act))))  # each shard's rows
    sigs, sums_d = map_rows(state.mesh, _signature_rows,
                            torch.from_numpy(act.astype(np.int64)),
                            state.device_tiles_pal(), cfg.tile_palette_size)
    note('d2h')
    sums = sums_d.cpu().numpy()
    dpi = state.tile_dpi[act]

    bin_sizes = np.bincount(np.maximum(dpi, 0), minlength=cfg.palette_count)
    eqtc = np.array([equal_quality_tile_count(s) for s in bin_sizes])
    share = desired_tiles / max(eqtc.sum(), 1)
    cluster_counts = np.ceil(eqtc * share).astype(np.int64)

    jobs = []
    for p in range(cfg.palette_count):
        sel = np.flatnonzero(dpi == p)
        n_bin, k = len(sel), int(cluster_counts[p])
        if n_bin == 0 or n_bin <= k or k == 0:
            continue
        s = sums[sel]
        # starting point: the line with the smallest byte sum, last one
        # on ties (main.pas:4301-4308 uses <=); kmodes_restarts > 0 asks
        # for best-of-N golden-ratio restarts instead (kmodes.pas:949-966)
        start = (-cfg.kmodes_restarts if cfg.kmodes_restarts > 0
                 else int(np.flatnonzero(s == s.min())[-1]))
        jobs.append(dict(sel=sel, k=k, start=start))
    phases['sigs_bins'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()

    iters: list = []
    solved = kmodes_batch_gather(
        sigs, [j['sel'] for j in jobs], [j['k'] for j in jobs],
        [j['start'] for j in jobs], cfg.tile_palette_size, iters_out=iters,
        devices=None if kmodes_mesh is None else kmodes_mesh.flat)
    phases['solve'] = round(time.perf_counter() - t0, 3)
    state.metrics['gt_iters'] = iters
    t0 = time.perf_counter()

    merges = 0
    fwd = np.arange(n)
    new_use = state.tile_use.copy()
    new_active = state.tile_active.copy()
    for job, (labels, winner) in zip(jobs, solved):
        sel, k = job['sel'], job['k']
        global_idx = act[sel]
        members = np.bincount(labels, minlength=k)
        merged = members >= 2
        if not merged.any():
            continue
        win_global = np.where(winner >= 0, global_idx[winner], 0)
        use_sum = np.bincount(labels, weights=new_use[global_idx],
                              minlength=k).astype(np.int64)
        is_loser = merged[labels] & (global_idx != win_global[labels])
        losers = global_idx[is_loser]
        fwd[losers] = win_global[labels[is_loser]]
        new_use[win_global[merged]] += (use_sum
                                        - new_use[win_global])[merged]
        new_use[losers] = 0
        new_active[losers] = False
        merges += len(losers)
    phases['merge_host'] = round(time.perf_counter() - t0, 3)
    state.metrics['gt_phases'] = phases
    return fwd, new_use, new_active, merges


def compute_global_tiling_fwd(tiles_pal: np.ndarray, tile_active: np.ndarray,
                              tile_use: np.ndarray, tile_dpi: np.ndarray,
                              cfg, desired_tiles: int, mesh=None,
                              device='cuda'):
    """compute_global_tiling_fwd_device over GLOBAL host arrays (uploaded
    to `device`), the KModes solves sharded across `mesh` when it is
    given. Deterministic, so every host of a multi-host encode computes
    the identical map from the allgathered tileset (parallel.gop_exact).
    Returns (fwd, new_use, new_active, merges)."""
    st = EncoderState(config=cfg, device=torch.device(device))
    st.tiles_pal, st.tile_active, st.tile_use, st.tile_dpi = \
        tiles_pal, tile_active, tile_use, tile_dpi
    return compute_global_tiling_fwd_device(st, cfg, desired_tiles,
                                            kmodes_mesh=mesh)


def run_global_tiling(state: EncoderState, desired_tiles: int | None = None,
                      gts_out: str | None = None) -> EncoderState:
    """GlobalTiling to desired_tiles (default: max_tiles, or qb_tiles x
    EqualQualityTileCount of the raw tile count), then MakeUnique and
    Reindex; gts_out writes the reduced tileset as a GTS file."""
    cfg = state.config
    if cfg.reload_tileset:
        return run_reload_tiling(state, cfg.reload_tileset)
    if desired_tiles is None:
        raw = state.n_frames * state.tilemap_size
        budget = cfg.max_tiles if cfg.max_tiles > 0 else \
            round(cfg.qb_tiles * equal_quality_tile_count(raw))
        desired_tiles = min(budget, raw)

    # opt-in distributed per-bin KModes; bit-identical either way
    kmodes_mesh = state.mesh if cfg.mesh_kmodes else None
    fwd, new_use, new_active, merges = compute_global_tiling_fwd_device(
        state, cfg, desired_tiles, kmodes_mesh=kmodes_mesh)
    state.tile_use = new_use
    state.tile_active = new_active
    state.tm_tile = fwd[state.tm_tile].astype(np.int32)
    state.metrics['global_tiling_merged'] = merges
    t0 = time.perf_counter()
    run_make_unique(state)
    t1 = time.perf_counter()
    run_reindex(state)
    gp = state.metrics['gt_phases']
    gp['gt_unique'] = round(t1 - t0, 3)
    gp['gt_reindex'] = round(time.perf_counter() - t1, 3)
    gp['unique_reindex'] = round(time.perf_counter() - t0, 3)
    gp['gt_mu'] = state.metrics.get('mu_phases')
    if gts_out:
        n_active = int(state.tile_active.sum())
        write_gts(gts_out, state.tiles_pal[:n_active],
                  cfg.tile_palette_size)
    return state


def _match_last(queries: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Per query signature, the pool line with the smallest Hamming<<11 +
    L1 dissimilarity, the LAST one on ties (GetMinMatchingDissim uses
    <=). int32 math in query chunks of at most 2^27 compared bytes."""
    p = pool.to(torch.int32)[None]
    out = torch.empty(queries.shape[0], dtype=torch.int64,
                      device=queries.device)
    step = max(1, (1 << 27) // max(1, pool.numel()))
    for lo in range(0, queries.shape[0], step):
        q = queries[lo:lo + step].to(torch.int32)[:, None, :]
        d = (torch.sum(q != p, dim=2, dtype=torch.int32) << 11) \
            + torch.sum(torch.abs(q - p), dim=2, dtype=torch.int32)
        out[lo:lo + step] = d.shape[1] - 1 - torch.argmin(d.flip(1), dim=1)
    return out


def run_reload_tiling(state: EncoderState, gts_path: str) -> EncoderState:
    """ReloadPreviousTiling (main.pas:4372-4470): overwrite each active
    tile's pixels with the nearest line of a previous GTS tileset,
    matched on signatures within the same PalSigni bin when that bin
    exists (else against the whole tileset), then MakeUnique."""
    cfg = state.config
    dev = state.device
    gts_tiles, gts_pal_size = read_gts(gts_path)
    # rescale palette indices to the current palette size
    # (main.pas:4436-4438)
    note('h2d', 2)      # the tileset and the active rows
    scaled = torch.from_numpy(
        (gts_tiles.astype(np.int64) * cfg.tile_palette_size
         // gts_pal_size).astype(np.uint8)).to(dev)
    ds_sigs, _ = tile_signatures(
        scaled, torch.arange(scaled.shape[0], device=dev),
        cfg.tile_palette_size)
    ds_signi = pal_signi(scaled, cfg.tile_palette_size)

    act = torch.from_numpy(np.flatnonzero(state.tile_active)).to(dev)
    tiles = state.device_tiles_pal().clone()
    sigs, _ = tile_signatures(tiles, act, cfg.tile_palette_size)
    signi = pal_signi(tiles[act], cfg.tile_palette_size)
    note('d2h', 2)      # the bins' count, then their values
    for s in torch.unique(signi).tolist():
        note('d2h', 2)
        rows = torch.nonzero(signi == s)[:, 0]
        cand = torch.nonzero(ds_signi == s)[:, 0]
        if cand.numel():
            pool_sigs, pool_tiles = ds_sigs[cand], scaled[cand]
        else:
            pool_sigs, pool_tiles = ds_sigs, scaled
        tiles[act[rows]] = pool_tiles[_match_last(sigs[rows], pool_sigs)]
    state.set_tiles_pal_device(tiles)
    run_make_unique(state)
    return state
