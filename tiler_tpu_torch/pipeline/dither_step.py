"""Dither step: the counterpart of tiler_tpu/pipeline/dither_step.py.

Per keyframe: gather its source tiles on the device, PsyV (LAB) features
and k-means into palette_count groups (prepare); DL3 or VAR per group on
the host in a worker thread (quantize), both native and off the
interpreter lock, overlapping the next keyframe's prepare; sort palettes
by use (finish); then the Knoll or Yliluoma scan over every active tile
and the mirror canonicalization, both on the device. The prepare's feature rows and
k-means assignment and the Knoll scan's row-parallel halves are cut
across the state's mesh (parallel.mesh_pipeline.map_rows; the same bytes
at any shard count); Yliluoma stays on the mesh's first device.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import functools
import os

import numpy as np
import torch

from .. import native
from ..constants import TILE_W, palette_pattern

from ..ops import dither, features, palette
from ..ops.kmeans import _assign, kmeans_core
from ..parallel.mesh_pipeline import map_rows, ranges
from ..utils.dispatch import note, phases, span, spans
from .state import EncoderState


def _dithering_gamma(cfg):
    return cfg.encoder_gamma if cfg.dithering_gamma else None


def _lab_features(idx: torch.Tensor, src: torch.Tensor, gamma_value,
                 use_wavelets: bool) -> torch.Tensor:
    return features.psyv_features_rgb(src[idx], gamma_value=gamma_value,
                                      use_lab=True, use_wavelets=use_wavelets)


def prepare_dither_keyframe(state: EncoderState, k: int) -> None:
    """PsyV(LAB) features of every tile keyframe k references, clustered
    into palette_count groups (PrepareDitherTiles): writes the labels to
    tile_dpi and the centroids to palette_centroids[k]. The feature rows
    and the k-means assignment are cut across the state's mesh; the
    seeding and the centroid update run on the gathered features."""
    cfg = state.config
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    n = len(cell_tiles)
    if n > 1 and cfg.palette_count > 1:
        mesh = state.mesh
        with span('dither/features'):
            note('h2d', len(ranges(mesh, n)))   # each shard's cells go up
            feats = map_rows(mesh, _lab_features,
                             torch.from_numpy(cell_tiles.astype(np.int64)),
                             state.device_source_tiles(),
                             _dithering_gamma(cfg), cfg.use_wavelets)
        labels_d, cents_d, _ = kmeans_core(
            feats, cfg.palette_count,
            assign=lambda x, x2, cents: map_rows(mesh, _assign, (x, x2),
                                                 cents))
        note('d2h', 2)
        labels = labels_d.cpu().numpy()
        state.palette_centroids[k] = cents_d.cpu().numpy()
    else:
        labels = np.zeros(n, np.int32)
    state.tile_dpi[cell_tiles] = labels


def quantize_keyframe_palettes(state: EncoderState, k: int) -> tuple:
    """DL3 or VAR palettes of keyframe k, one per k-means group, entries
    in LHS order. Returns (use counts [P] by tile refs, [P, 2] each VAR
    group's distinct colours and merges, zeros under DL3). Each group's
    VAR job is a span 'dither/var' on the pool's thread."""
    cfg = state.config
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    active = state.tile_active[cell_tiles]
    dpi = state.tile_dpi[cell_tiles]
    use_counts = np.zeros(cfg.palette_count, np.int64)
    pattern = palette_pattern(cfg.palette_count, cfg.tile_palette_size)
    pal_indexes = np.zeros((cfg.palette_count, cfg.tile_palette_size),
                           np.uint32)
    total_budget = (e - s + 1) * state.tilemap_size * TILE_W * TILE_W
    var_stats = np.zeros((cfg.palette_count, 2), np.int64)

    def quantize_one(p: int):
        sel = cell_tiles[active & (dpi == p)]
        use_counts[p] = len(sel)
        if cfg.use_dl3:
            pal16 = palette.dl3_palette_tiles(
                state.tiles_rgb, sel, cfg.tile_palette_size, cfg.dl3_bpc,
                cfg.dl3_bin_cap)
            entries = palette.rgb_to_packed(pal16)
        else:
            with span('dither/var'):
                entries, colours, merges = native.var_quant_tiles(
                    state.tiles_rgb, sel, total_budget, cfg.pal_var,
                    cfg.tile_palette_size, cfg.palette_count, pattern[p])
            var_stats[p] = colours, merges
        pal_indexes[p] = palette.sort_palette_lhs(entries)

    # the native DL3 and VAR calls release the interpreter lock
    workers = min(os.cpu_count() or 1, 8)
    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(quantize_one, range(cfg.palette_count)))
    state.palettes_rgb[k] = palette.packed_to_rgb(pal_indexes)
    return use_counts, var_stats


def finish_quantize_keyframe(state: EncoderState, k: int,
                             use_counts: np.ndarray) -> None:
    """Sort whole palettes by use count desc (stable by original index)
    and remap DitheringPalIndex (FinishQuantizePalette)."""
    cfg = state.config
    order = np.lexsort((np.arange(cfg.palette_count), -use_counts))
    lut = np.empty(cfg.palette_count, np.int32)
    lut[order] = np.arange(cfg.palette_count)
    state.palettes_rgb[k] = state.palettes_rgb[k][order]
    state.palette_centroids[k] = state.palette_centroids[k][order]
    s, e = state.keyframes[k]
    cell_tiles = state.tm_tile[s:e + 1].ravel()
    state.tile_dpi[cell_tiles] = lut[state.tile_dpi[cell_tiles]]


def canonicalize_mirrors(tiles_u8: torch.Tensor):
    """PrepareTileMirrors (main.pas:4049-4069): pick the mirror whose
    source quadrant has the highest sum (first max in (vf,hf) scan
    order) and bake it into the pixels. [N,8,8] uint8 -> (baked [N,8,8]
    uint8, hmir [N] bool, vmir [N] bool). Zero tiles keep quadrant 0."""
    n = tiles_u8.shape[0]
    q = tiles_u8.to(torch.int32).reshape(n, 2, 4, 2, 4).sum((2, 4))
    best = torch.argmax(q.reshape(n, 4), dim=1)   # first max wins
    vf = (best >> 1).to(torch.bool)
    hf = (best & 1).to(torch.bool)
    t = torch.where(hf[:, None, None], tiles_u8.flip(2), tiles_u8)
    t = torch.where(vf[:, None, None], t.flip(1), t)
    return t, hf, vf


DITHER_PHASES = ('prepare_kmeans', 'quantize', 'dither', 'features',
                 'kmeans_pp', 'lloyd', 'mirrors', 'var', 'yliluoma')


def run_dither(state: EncoderState) -> EncoderState:
    """Keyframe k's host quantize overlaps keyframe k+1's device k-means;
    the Knoll or Yliluoma scans run per keyframe batch once its palettes
    are final. metrics['dither_phases'] holds the host seconds of the
    spans 'dither/<key>' (utils.dispatch.span), summed over keyframes:
    'prepare_kmeans' the k-means loop wall, which holds each keyframe's
    'features' (PsyV LAB rows), 'kmeans_pp' (the k-means++ seeding) and
    'lloyd' (Lloyd's iterations), both opened in ops.kmeans.kmeans_core;
    'quantize' the blocked wait on the quantizers, 'dither' the scans,
    which under Yliluoma hold 'yliluoma' (the scan up to and with its
    synchronize), 'mirrors' the mirror canonicalization with its download
    and the tilemap copies; 'var' sums the VAR jobs of the quantize
    pool's threads, which run side by side. metrics['dither_var'] counts
    VAR's groups, distinct colours and merges, metrics['dither_plan_keys']
    the unique (group, colour) keys the scans planned."""
    cfg = state.config
    plan_stats = {'plan_keys': 0}
    if cfg.use_thomas_knoll:
        dither_cached = functools.partial(
            dither.knoll_dither_tiles_cached,
            map_rows=functools.partial(map_rows, state.mesh),
            stats=plan_stats)
        scan_span = contextlib.nullcontext
    else:
        dither_cached = functools.partial(
            dither.yliluoma_dither_tiles_cached,
            mixed_colors=cfg.yliluoma_mix, stats=plan_stats)
        scan_span = functools.partial(span, 'dither/yliluoma')
    var_stats = np.zeros(2, np.int64)
    n_kf = len(state.keyframes)
    dev = state.device
    kf_of = state.kf_of_frame()
    tile_kf = np.repeat(kf_of, state.tilemap_size)  # identity layout
    act = np.flatnonzero(state.tile_active)
    act_kf = tile_kf[act]
    buf = torch.zeros((state.n_tiles, TILE_W, TILE_W), dtype=torch.uint8,
                      device=dev)
    # the dedup key's 8-bit group field holds 256 // palette_count
    # keyframes per scan; with few keyframes each scan starts as soon as
    # its own quantize is done
    kb = 1 if n_kf <= 4 else max(1, 256 // cfg.palette_count)
    before = spans()
    with cf.ThreadPoolExecutor(1) as qpool:
        futs = []
        with span('dither/prepare_kmeans'):
            for k in range(n_kf):
                prepare_dither_keyframe(state, k)
                # keyframes' cell ranges are disjoint (identity tilemap),
                # so quantize(k) reading tile_dpi is safe against
                # prepare(k+1)
                futs.append(qpool.submit(quantize_keyframe_palettes, state,
                                         k))
        for b0 in range(0, n_kf, kb):
            batch = range(b0, min(b0 + kb, n_kf))
            with span('dither/quantize'):
                for k in batch:
                    use_counts, group_stats = futs[k].result()
                    var_stats += group_stats.sum(0)
                    finish_quantize_keyframe(state, k, use_counts)
            with span('dither/dither'), scan_span():
                rows = np.flatnonzero((act_kf >= batch.start)
                                      & (act_kf < batch.stop))
                if rows.size:
                    note('h2d', 2)
                    idx = torch.from_numpy(act[rows].astype(np.int64)) \
                        .to(dev)
                    dpi_rows = np.maximum(state.tile_dpi[act[rows]], 0)
                    groups = ((act_kf[rows] - batch.start)
                              * cfg.palette_count + dpi_rows)
                    group_pals = state.palettes_rgb[batch.start:batch.stop] \
                        .reshape(-1, cfg.tile_palette_size, 3)
                    buf[idx] = dither_cached(
                        state.device_source_tiles()[idx], group_pals,
                        torch.from_numpy(groups.astype(np.int64)).to(dev))
                note('sync')
                if dev.type == 'cuda':
                    torch.cuda.synchronize(dev)

    with span('dither/mirrors'):
        baked, hf, vf = canonicalize_mirrors(buf)
        state.set_tiles_pal_device(baked)
        note('d2h', 2)
        hf, vf = hf.cpu().numpy(), vf.cpu().numpy()
        f, th, tw = state.tm_tile.shape
        flat_tiles = state.tm_tile.reshape(-1)
        state.tm_pal = state.tile_dpi[flat_tiles].reshape(f, th, tw).copy()
        state.tm_h = hf[flat_tiles].reshape(f, th, tw)
        state.tm_v = vf[flat_tiles].reshape(f, th, tw)
    state.metrics['dither_phases'] = phases('dither', before, DITHER_PHASES)
    state.metrics['dither_plan_keys'] = plan_stats['plan_keys']
    if not cfg.use_dl3:
        state.metrics['dither_var'] = {
            'groups': cfg.palette_count * n_kf,
            'colours': int(var_stats[0]), 'merges': int(var_stats[1])}
    return state
