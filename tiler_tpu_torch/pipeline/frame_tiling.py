"""FrameTiling step: remap every tilemap cell to its best (tile, palette,
mirror) candidate — the counterpart of tiler_tpu/pipeline/frame_tiling.py.

Three bulk phases:
  1. marking, one pass for all keyframes: an exact 8-NN of each
     keyframe's referenced tiles against the 4-mirror PalPixels dataset,
     expanded across palettes by quality (UseOne /
     BuildPaletteCorrTriangle, main.pas:3802-3867);
  2. per keyframe, PsyV features of every used (palette, tile, mirror)
     combo, directly or from per-(palette, tile) features through the
     wavelet basis's exact signed mirror permutations when that halves
     the work;
  3. per keyframe, the exact 1-NN of each changed cell's source-tile
     features among the combos (ops.nn_kernels: the CUDA kernels on the
     card), which are prepared for the kernel once per keyframe and
     walked by every query chunk; unchanged cells are forward-filled
     from the previous frame.
Candidate order is np.nonzero(used)'s row-major order in both stage-2
paths, so stage-3 ties resolve as in the JAX package. Each phase's rows
are cut across the state's mesh (parallel.mesh_pipeline.map_rows), every
shard running the functions below on its range, with the same bytes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import FTQuality
from ..constants import TILE_DCT_SIZE, TILE_W

from ..ops import features, knn, nn_kernels
from ..parallel.mesh_pipeline import map_rows, ranges, replicate
from ..utils.dispatch import note
from .load import changed_mask
from .state import EncoderState

_ATTR_ORDER = np.array([0, 1, 3, 2], np.int64)  # h|v<<1 per dataset slot
_FEAT_CHUNK = 524288      # stage-2 combos per feature pass


def _ft_gamma(cfg):
    return cfg.encoder_gamma if cfg.ft_gamma else None


def _sync(dev: torch.device) -> None:
    note('sync')
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def expand_mirrors(t_u8: torch.Tensor) -> torch.Tensor:
    """[A,8,8] uint8 -> [4A,64] float32 mirror variants in the
    reference's walk order (attrs 0, 1, 3, 2 per tile)."""
    variants = torch.stack([t_u8, t_u8.flip(2), t_u8.flip(1).flip(2),
                            t_u8.flip(1)], dim=1)
    return variants.reshape(-1, TILE_W * TILE_W).to(torch.float32)


def build_global_dataset(state: EncoderState):
    """[4A,64] float32 mirrored PalPixels on the device + maps to
    (tile, attrs)."""
    act = np.flatnonzero(state.tile_active)
    note('h2d')
    act_d = torch.from_numpy(act.astype(np.int64)).to(state.device)
    ds = expand_mirrors(state.device_tiles_pal()[act_d])
    return ds, np.repeat(act, 4), np.tile(_ATTR_ORDER, len(act))


# -- stage 1: candidate marking -------------------------------------------

def _mark_queries_idx(state: EncoderState, k: int):
    """Unique referenced tile ids of keyframe k + the cell->unique map."""
    s, e = state.keyframes[k]
    return np.unique(state.tm_tile[s:e + 1].ravel(), return_inverse=True)


def _mark_from_knn(state: EncoderState, k: int, idxs, keep, tile_inv,
                   n_uq: int, n_ds: int, pal_mask: np.ndarray | None):
    """Host set logic turning the 8-NN results into the bool[P, 4A]
    used-combo indicator (UseOne, main.pas:3802-3853)."""
    cfg = state.config
    s, e = state.keyframes[k]
    cell_pals = state.tm_pal[s:e + 1].ravel()
    pair_ids = cell_pals.astype(np.int64) * n_uq + tile_inv
    uq_pairs = np.unique(pair_ids)
    pair_pal = (uq_pairs // n_uq).astype(np.int64)
    pair_tile_row = (uq_pairs % n_uq).astype(np.int64)

    marked_q = np.zeros((cfg.palette_count, n_ds), bool)
    km = keep[pair_tile_row]
    marked_q[np.repeat(pair_pal, km.sum(1)),
             idxs[pair_tile_row][km]] = True
    if cfg.ft_quality == FTQuality.FAST:
        return marked_q
    if cfg.ft_quality == FTQuality.SLOW:
        return np.broadcast_to(marked_q.any(0), marked_q.shape).copy()
    # MEDIUM: used[j] = any marking palette q with centroid near j
    return (pal_mask.astype(np.float32) @ marked_q.astype(np.float32)) > 0


def palette_similarity_mask(state: EncoderState, k: int) -> np.ndarray:
    """[P,P] bool: centroid j close enough to centroid q
    (BuildPaletteCorrTriangle + APalTol, main.pas:3843-3847)."""
    cfg = state.config
    c = state.palette_centroids[k].astype(np.float64)
    d = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    finite = np.nan_to_num(d, nan=0.0, posinf=0.0)
    highest = finite.max() if finite.size else 0.0
    return d < cfg.ft_palette_tol * highest


# -- stage 2: candidate-combo PsyV features -------------------------------

def _chunk_feats(tiles, pal, hm, vm, tiles_pal_d, pals_d, cfg):
    """PsyV features of combos (tile, palette, mirrors) as device
    gathers on the tiles' device, in chunks; host index arrays in,
    [N,192] out."""
    dev = tiles_pal_d.device
    out = torch.empty((len(tiles), TILE_DCT_SIZE), dtype=torch.float32,
                      device=dev)
    for lo in range(0, len(tiles), _FEAT_CHUNK):
        hi = min(len(tiles), lo + _FEAT_CHUNK)
        note('h2d', 4)      # the tiles, palettes and two mirror flags

        def up(a, dtype=torch.int64):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(
                dev, dtype)
        out[lo:hi] = features.psyv_features_pal(
            tiles_pal_d[up(tiles)], pals_d[up(pal)],
            gamma_value=_ft_gamma(cfg), use_wavelets=cfg.use_wavelets,
            hmir=up(hm, torch.bool), vmir=up(vm, torch.bool))
    return out


def candidate_features(state: EncoderState, k: int, used, tile_of,
                       attrs_of):
    """Stage 2 for keyframe k: returns (feats [C,192] device, pal_idx [C],
    tile_idx [C], attrs [C]) in np.nonzero(used) order.

    The mirror-permutation path runs when the keyframe's (palette, tile)
    pair dedup at least halves the base feature work (the JAX package's
    gate); its features differ from the direct path's only in f32 low
    bits."""
    cfg = state.config
    n_tiles = int(state.n_tiles)
    dev = state.device
    tiles_pal_d = state.device_tiles_pal()
    note('h2d')
    pals_d = torch.from_numpy(np.ascontiguousarray(
        state.palettes_rgb[k])).to(dev)

    def chunk_feats(*rows):
        return map_rows(state.mesh, _chunk_feats, rows, tiles_pal_d, pals_d,
                        cfg)
    pp = features.mirror_coeff_perms(cfg.use_wavelets)
    pal_idx, dentry = np.nonzero(used)
    pal_idx = pal_idx.astype(np.int64)
    tiles = tile_of[dentry]
    attrs = attrs_of[dentry]
    uq, inv = np.unique(pal_idx * n_tiles + tiles, return_inverse=True)
    c = len(pal_idx)
    state.metrics.setdefault('ft_pair_dedup', []).append(
        round(c / max(len(uq), 1), 3))
    if pp is not None and len(uq) <= 0.5 * c:
        zeros = np.zeros(len(uq), bool)
        base = chunk_feats(uq % n_tiles, uq // n_tiles, zeros, zeros)
        note('h2d', 3)
        perm4 = torch.from_numpy(pp[0]).to(dev)
        sign4 = torch.from_numpy(pp[1]).to(dev)
        inv_d = torch.from_numpy(inv.astype(np.int64)).to(dev)
        feats = torch.empty((c, TILE_DCT_SIZE), dtype=torch.float32,
                            device=dev)
        for a in range(4):
            note('h2d')
            rows = torch.from_numpy(np.flatnonzero(attrs == a)).to(dev)
            if rows.numel():
                feats[rows] = base[inv_d[rows]][:, perm4[a]] \
                    * sign4[a][None, :]
        del base
    else:
        feats = chunk_feats(tiles, pal_idx, (attrs & 1).astype(bool),
                            (attrs & 2).astype(bool))
    return (feats, pal_idx.astype(np.int32), tiles.astype(np.int32),
            attrs)


# -- stage 3: query features + exact 1-NN ---------------------------------

def assign_rows(rows_d: torch.Tensor, src: torch.Tensor, cands,
                gamma_value, use_wavelets: bool):
    """The 1-NN among `cands` (a nn_kernels.Prepared set on src's device)
    of the PsyV features of source tiles rows_d, in query chunks that give
    every SM one query tile; the results do not depend on the chunking.
    Returns (idx, err, kernel calls)."""
    idx_parts, err_parts = [], []
    q_chunk = nn_kernels.full_chunk(src.device)
    for lo in range(0, len(rows_d), q_chunk):
        q = features.psyv_features_rgb(
            src[rows_d[lo:lo + q_chunk]], gamma_value=gamma_value,
            use_wavelets=use_wavelets)
        idx, err = nn_kernels.nearest_1(q, cands)
        idx_parts.append(idx)
        err_parts.append(err)
    return torch.cat(idx_parts), torch.cat(err_parts), len(idx_parts)


def _assign_keyframe(state: EncoderState, k: int, cands, ch_all, src_all):
    """Stage 3 for keyframe k: the 1-NN of each changed cell (all cells
    of the first frame) among the keyframe's combos `cands` (a
    nn_kernels.Prepared set per device of the mesh, as src_all holds the
    source tiles), the cells cut across the state's mesh, forward-filled
    to the unchanged cells. Returns (best_idx [n_q], best_err [n_q],
    n_run, kernel calls per shard, None for a shard without cells); a
    cell byte-identical to the previous frame has the same source tile
    and so the same nearest combo."""
    cfg = state.config
    s, e = state.keyframes[k]
    cells = state.tilemap_size
    f_kf = e - s + 1
    ch = ch_all[s:e + 1].copy()
    ch[0, :] = True
    changed = np.flatnonzero(ch.ravel())
    rows = (s * cells + changed).astype(np.int64)
    note('h2d', len(ranges(state.mesh, len(rows))))   # each shard's cells
    run_idx, run_err, calls = map_rows(
        state.mesh, assign_rows, torch.from_numpy(rows), src_all, cands,
        _ft_gamma(cfg), cfg.use_wavelets)
    note('d2h', 2)
    run_idx, run_err = run_idx.cpu().numpy(), run_err.cpu().numpy()
    # forward fill: each cell takes the result computed at its most
    # recent changed frame; the fill never crosses a keyframe start
    last = np.maximum.accumulate(
        np.where(ch, np.arange(f_kf)[:, None], -1), axis=0)
    changed_pos = np.cumsum(ch.ravel()) - 1
    fill = changed_pos[(last * cells + np.arange(cells)[None, :]).ravel()]
    return run_idx[fill], run_err[fill], len(changed), calls


def run_frame_tiling(state: EncoderState) -> EncoderState:
    cfg = state.config
    dev = state.device
    n_kf = len(state.keyframes)
    phases = {}
    t0 = time.perf_counter()
    ds, tile_of, attrs_of = build_global_dataset(state)
    _sync(dev)
    phases['dataset'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    mesh = state.mesh
    # resident since Dither; one copy per device of the mesh
    src_all = replicate(mesh, state.device_source_tiles())
    _sync(dev)
    phases['upload'] = round(time.perf_counter() - t0, 3)
    ch_all = state.changed_mask if state.changed_mask is not None else \
        changed_mask(state.frames_rgb, state.tilemap_h, state.tilemap_w)

    # ---- stage 1, all keyframes in one k-NN pass over the dataset ----
    t0 = time.perf_counter()
    mark_q = [_mark_queries_idx(state, k) for k in range(n_kf)]
    note('h2d')
    q_idx = torch.from_numpy(np.concatenate([m[0] for m in mark_q])
                             .astype(np.int64)).to(dev)
    queries = state.device_tiles_pal()[q_idx].reshape(len(q_idx), -1)
    idxs_d, keep_d = map_rows(mesh, knn.nearest_k_keepmask, queries, ds, 8)
    note('d2h', 2)
    idxs_all, keep_all = idxs_d.cpu().numpy(), keep_d.cpu().numpy()
    used_list = []
    off = 0
    for k in range(n_kf):
        uq_tiles, tile_inv = mark_q[k]
        n_uq = len(uq_tiles)
        pal_mask = palette_similarity_mask(state, k) \
            if cfg.ft_quality == FTQuality.MEDIUM else None
        used_list.append(_mark_from_knn(
            state, k, idxs_all[off:off + n_uq], keep_all[off:off + n_uq],
            tile_inv, n_uq, len(ds), pal_mask))
        off += n_uq
    del mark_q, idxs_all, keep_all, ds, queries
    phases['mark'] = round(time.perf_counter() - t0, 3)

    # ---- stages 2+3, one keyframe at a time ----
    t_feats = t_assign = 0.0
    knn_sizes = []
    nn_calls = np.zeros(mesh.size, np.int64)
    q_total = q_changed = 0
    residual = 0.0
    for k in range(n_kf):
        t0 = time.perf_counter()
        feats, cand_pal, cand_tile, cand_attrs = candidate_features(
            state, k, used_list[k], tile_of, attrs_of)
        used_list[k] = None
        _sync(dev)
        t_feats += time.perf_counter() - t0
        t0 = time.perf_counter()
        knn_sizes.append(int(feats.shape[0]))
        # once per keyframe and device
        cands = replicate(mesh, feats, nn_kernels.prepare)
        del feats
        best_idx, best_err, n_run, calls = _assign_keyframe(
            state, k, cands, ch_all, src_all)
        del cands
        nn_calls += [c or 0 for c in calls]
        s, e = state.keyframes[k]
        shape = (e - s + 1, state.tilemap_h, state.tilemap_w)
        q_total += best_idx.size
        q_changed += n_run
        state.tm_tile[s:e + 1] = cand_tile[best_idx].reshape(shape)
        state.tm_pal[s:e + 1] = cand_pal[best_idx].reshape(shape)
        state.tm_h[s:e + 1] = (cand_attrs[best_idx] & 1).astype(bool) \
            .reshape(shape)
        state.tm_v[s:e + 1] = (cand_attrs[best_idx] & 2).astype(bool) \
            .reshape(shape)
        residual += float(best_err.sum())
        t_assign += time.perf_counter() - t0
    phases['cand_feats'] = round(t_feats, 3)
    phases['assign'] = round(t_assign, 3)

    state.metrics['ft_residual_err'] = residual
    state.metrics['ft_knn_sizes'] = knn_sizes
    state.metrics['ft_nn_calls'] = int(nn_calls.sum())
    if mesh.size > 1:
        state.metrics['ft_nn_calls_shards'] = nn_calls.tolist()
    state.metrics['ft_q_changed_frac'] = round(
        q_changed / max(q_total, 1), 4)
    state.metrics['ft_phases'] = phases
    return state
