"""Dither step: the counterpart of tiler_tpu/pipeline/dither_step.py.

Per keyframe: gather its source tiles on the device, PsyV (LAB) features
and k-means into palette_count groups (prepare); DL3 (native) or VAR
(host numpy) per group on the host in a worker thread (quantize),
overlapping the next keyframe's prepare; sort palettes by use (finish);
then the Knoll or Yliluoma scan over every active tile and the mirror
canonicalization, both on the device. The prepare's feature rows and
k-means assignment and the Knoll scan's row-parallel halves are cut
across the state's mesh (parallel.mesh_pipeline.map_rows; the same bytes
at any shard count); Yliluoma stays on the mesh's first device.
"""
from __future__ import annotations

import concurrent.futures as cf
import functools
import os
import time

import numpy as np
import torch

from ..constants import TILE_W, palette_pattern

from ..ops import dither, features, palette
from ..ops.kmeans import _assign, kmeans_core
from ..parallel.mesh_pipeline import map_rows, ranges
from ..utils.dispatch import note
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
        note('h2d', len(ranges(mesh, n)))   # each shard's cells go up
        feats = map_rows(mesh, _lab_features,
                         torch.from_numpy(cell_tiles.astype(np.int64)),
                         state.device_source_tiles(), _dithering_gamma(cfg),
                         cfg.use_wavelets)
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


def quantize_keyframe_palettes(state: EncoderState, k: int) -> np.ndarray:
    """DL3 or VAR palettes of keyframe k, one per k-means group, entries
    in LHS order. Returns use counts [P] (by tile refs)."""
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

    def quantize_one(p: int):
        sel = cell_tiles[active & (dpi == p)]
        use_counts[p] = len(sel)
        if cfg.use_dl3:
            pal16 = palette.dl3_palette_tiles(
                state.tiles_rgb, sel, cfg.tile_palette_size, cfg.dl3_bpc,
                cfg.dl3_bin_cap)
            entries = palette.rgb_to_packed(pal16)
        else:
            px = state.tiles_rgb[sel].reshape(-1, 3)
            cols, counts = np.unique(palette.rgb_to_packed(px),
                                     return_counts=True)
            entries = palette.var_palette(
                cols, counts.astype(np.int64), total_budget, cfg.pal_var,
                cfg.tile_palette_size, cfg.palette_count, pattern[p])
        pal_indexes[p] = palette.sort_palette_lhs(entries)

    # the native DL3 call releases the interpreter lock (VAR does not)
    workers = min(os.cpu_count() or 1, 8)
    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(quantize_one, range(cfg.palette_count)))
    state.palettes_rgb[k] = palette.packed_to_rgb(pal_indexes)
    return use_counts


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


def run_dither(state: EncoderState) -> EncoderState:
    """Keyframe k's host quantize overlaps keyframe k+1's device k-means;
    the Knoll or Yliluoma scans run per keyframe batch once its palettes
    are final. Phase times: 'prepare_kmeans' is the k-means loop wall,
    'quantize' the blocked wait on the quantizers, 'dither' the scans."""
    cfg = state.config
    if cfg.use_thomas_knoll:
        dither_cached = functools.partial(
            dither.knoll_dither_tiles_cached,
            map_rows=functools.partial(map_rows, state.mesh))
    else:
        dither_cached = functools.partial(
            dither.yliluoma_dither_tiles_cached,
            mixed_colors=cfg.yliluoma_mix)
    n_kf = len(state.keyframes)
    phases = {}
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
    t_quant = t_scan = 0.0
    with cf.ThreadPoolExecutor(1) as qpool:
        t0 = time.perf_counter()
        futs = []
        for k in range(n_kf):
            prepare_dither_keyframe(state, k)
            # keyframes' cell ranges are disjoint (identity tilemap), so
            # quantize(k) reading tile_dpi is safe against prepare(k+1)
            futs.append(qpool.submit(quantize_keyframe_palettes, state, k))
        phases['prepare_kmeans'] = time.perf_counter() - t0
        for b0 in range(0, n_kf, kb):
            batch = range(b0, min(b0 + kb, n_kf))
            t0 = time.perf_counter()
            for k in batch:
                finish_quantize_keyframe(state, k, futs[k].result())
            t_quant += time.perf_counter() - t0
            t0 = time.perf_counter()
            rows = np.flatnonzero((act_kf >= batch.start)
                                  & (act_kf < batch.stop))
            if rows.size:
                note('h2d', 2)
                idx = torch.from_numpy(act[rows].astype(np.int64)).to(dev)
                dpi_rows = np.maximum(state.tile_dpi[act[rows]], 0)
                groups = ((act_kf[rows] - batch.start) * cfg.palette_count
                          + dpi_rows)
                group_pals = state.palettes_rgb[batch.start:batch.stop] \
                    .reshape(-1, cfg.tile_palette_size, 3)
                buf[idx] = dither_cached(
                    state.device_source_tiles()[idx], group_pals,
                    torch.from_numpy(groups.astype(np.int64)).to(dev))
            note('sync')
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            t_scan += time.perf_counter() - t0
    phases['quantize'] = t_quant
    phases['dither'] = t_scan
    state.metrics['dither_phases'] = {k: round(v, 3)
                                      for k, v in phases.items()}

    baked, hf, vf = canonicalize_mirrors(buf)
    state.set_tiles_pal_device(baked)
    note('d2h', 2)
    hf, vf = hf.cpu().numpy(), vf.cpu().numpy()
    f, th, tw = state.tm_tile.shape
    flat_tiles = state.tm_tile.reshape(-1)
    state.tm_pal = state.tile_dpi[flat_tiles].reshape(f, th, tw).copy()
    state.tm_h = hf[flat_tiles].reshape(f, th, tw)
    state.tm_v = vf[flat_tiles].reshape(f, th, tw)
    return state
