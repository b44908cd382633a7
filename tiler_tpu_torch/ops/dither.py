"""Ordered dithering in torch: the counterpart of tiler_tpu/ops/dither.py
(Thomas Knoll pattern dithering and Yliluoma-2 mixing plans).

Each pixel's plan is an independent lane of int32 math. Knoll: the
luma-sorted 64-step plan is fully determined by per-index counts plus
the palette's luma order, so only the counts are computed and the
Bayer-rank entry is selected from their cumulative sums. Yliluoma-2: a
plan of at most 2L-1 entries (L = mixed colours), sorted by palette
luma, from which each pixel picks entry (bayer * count) >> 6. Plans
depend only on (palette, colour), so the cached forms compute one plan
per unique (palette group, colour) key and gather it per pixel. All
integer math, so the results are byte-identical to the JAX package on
any device.
"""
from __future__ import annotations

import numpy as np
import torch

from tiler_tpu.constants import DITHERING_MAP, TILE_W

from .color import color_compare_i32, div_trunc

# unique keys per plan pass and tiles per selection pass: bounds the
# [keys,S,3] palette gather and the [tiles,64,S] count gather to ~1 GB
_KEY_CHUNK = 1 << 20
_TILE_CHUNK = 131072


def _bayer(device) -> torch.Tensor:
    return torch.from_numpy(DITHERING_MAP.astype(np.int64)).to(device)


def knoll_counts(cols: torch.Tensor, pal: torch.Tensor) -> torch.Tensor:
    """cols [M,3] int pixels; pal [M,S,3] int per-pixel palette. Returns
    [M,S] int32: how many of the 64 Knoll plan steps chose each index
    (first minimum wins, as in the reference)."""
    s = cols.to(torch.int32)
    pal = pal.to(torch.int32)
    m, s_size = pal.shape[0], pal.shape[1]
    e = torch.zeros_like(s)
    counts = torch.zeros((m, s_size), dtype=torch.int32, device=s.device)
    ones = torch.ones((m, 1), dtype=torch.int32, device=s.device)
    for _ in range(64):
        t = s + div_trunc(e * 9, 100)
        pens = color_compare_i32(t[:, None, :], pal)
        chosen = torch.argmin(pens, dim=1, keepdim=True)
        picked = torch.gather(pal, 1, chosen[..., None].expand(-1, 1, 3))
        e = e + s - picked[:, 0]
        counts.scatter_add_(1, chosen, ones)
    return counts


def rank_select(counts: torch.Tensor, order: torch.Tensor,
                rank: torch.Tensor) -> torch.Tensor:
    """Entry `rank` of the sorted plan from per-index counts: counts
    [...,S] (summing to 64), order [...,S] palette indices luma-ascending,
    rank [...]. The entry is the luma rank j whose cumulative count
    window covers rank: j = #{ranks with inclusive cumsum <= rank}."""
    cnt_sorted = torch.gather(counts, -1, order)
    cum = torch.cumsum(cnt_sorted, dim=-1)
    j = torch.sum(cum <= rank[..., None], dim=-1, keepdim=True)
    return torch.gather(order, -1, j)[..., 0]


def _luma_raw(pal_u8: torch.Tensor) -> torch.Tensor:
    """Undivided integer luma, the plans' sort key (Plan.LumaPal)."""
    pal = pal_u8.to(torch.int32)
    return pal[..., 0] * 2126 + pal[..., 1] * 7152 + pal[..., 2] * 722


def _luma_order(pal_u8: torch.Tensor) -> torch.Tensor:
    return torch.argsort(_luma_raw(pal_u8), dim=-1, stable=True)


def knoll_dither_tiles(tiles_rgb: torch.Tensor,
                       palettes_rgb: torch.Tensor) -> torch.Tensor:
    """Plain per-pixel Knoll dither: tiles [N,8,8,3] uint8 with one
    palette per tile [N,S,3] uint8 -> [N,8,8] uint8 indices."""
    n = tiles_rgb.shape[0]
    cols = tiles_rgb.reshape(n * 64, 3)
    pal_px = palettes_rgb.repeat_interleave(64, dim=0)
    counts = knoll_counts(cols, pal_px)
    order = _luma_order(palettes_rgb).repeat_interleave(64, dim=0)
    rank = _bayer(tiles_rgb.device).repeat(n)
    sel = rank_select(counts.to(torch.int64), order, rank)
    return sel.to(torch.uint8).reshape(n, TILE_W, TILE_W)


def _dedup_keys(tiles_rgb: torch.Tensor, group_pals: np.ndarray,
                pal_group: torch.Tensor):
    """The cached dithers' key dedup: per pixel the key group<<24 | b<<16
    | g<<8 | r. Returns (sorted unique keys, inverse [N,64], the palettes
    [G,S,3] uint8 on the tiles' device)."""
    if group_pals.shape[0] > 256:
        raise ValueError('pal_group must fit 8 bits')
    n = tiles_rgb.shape[0]
    t = tiles_rgb.reshape(n, 64, 3).to(torch.int64)
    keys = (t[..., 0] | (t[..., 1] << 8) | (t[..., 2] << 16)
            | (pal_group.to(torch.int64)[:, None] << 24))
    uniq, inv = torch.unique(keys.reshape(-1), return_inverse=True)
    pals = torch.from_numpy(np.ascontiguousarray(group_pals)).to(
        tiles_rgb.device)
    return uniq, inv.reshape(n, 64), pals


def _key_cols(u: torch.Tensor) -> torch.Tensor:
    return torch.stack([u & 0xff, (u >> 8) & 0xff, (u >> 16) & 0xff], 1)


def knoll_dither_tiles_cached(tiles_rgb: torch.Tensor,
                              group_pals: np.ndarray,
                              pal_group: torch.Tensor) -> torch.Tensor:
    """Knoll dither with one plan per unique (palette group, colour).

    tiles_rgb [N,8,8,3] uint8 and pal_group [N] int (ids into group_pals
    [G,S,3] uint8, G <= 256) on the working device. Returns [N,8,8]
    uint8 on that device."""
    dev = tiles_rgb.device
    n = tiles_rgb.shape[0]
    if n == 0:
        return torch.zeros((0, TILE_W, TILE_W), dtype=torch.uint8,
                           device=dev)
    uniq, inv, pals = _dedup_keys(tiles_rgb, group_pals, pal_group)
    parts = []
    for lo in range(0, uniq.shape[0], _KEY_CHUNK):
        u = uniq[lo:lo + _KEY_CHUNK]
        parts.append(knoll_counts(_key_cols(u), pals[u >> 24])
                     .to(torch.uint8))
    counts = torch.cat(parts)
    order_g = _luma_order(pals)
    bayer = _bayer(dev)
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    for lo in range(0, n, _TILE_CHUNK):
        hi = min(n, lo + _TILE_CHUNK)
        cnt = counts[inv[lo:hi]].to(torch.int64)            # [c,64,S]
        order = order_g[pal_group[lo:hi].to(torch.int64)]   # [c,S]
        order = order[:, None, :].expand(-1, 64, -1)
        rank = bayer[None, :].expand(hi - lo, -1)
        out[lo:hi] = rank_select(cnt, order, rank).to(torch.uint8)
    return out.reshape(n, TILE_W, TILE_W)


def yliluoma_plans(cols: torch.Tensor, pal: torch.Tensor,
                   luma_pal: torch.Tensor, mixed_colors: int):
    """Yliluoma-2 mixing plans (the scalar semantics of main.pas:
    1753-1794, as tiler_tpu's _yliluoma_plans computes them).

    cols [M,3] int; pal [M,S,3] int per-pixel palette; luma_pal [M,S]
    int raw luma. Returns (plans [M, 2L-1] int64 palette indices sorted
    by luma, the first `count` valid; counts [M] int64), L =
    mixed_colors. Each of the L steps adds the palette entry and repeat
    count k (1..max(count, 1)) whose running average, with the
    reference's +1-per-repeat ramp, is closest by ColorCompare; ties take
    the lowest (entry, k) in palette-major order."""
    cols = cols.to(torch.int32)
    pal = pal.to(torch.int32)
    m, s_size = pal.shape[0], pal.shape[1]
    big = torch.iinfo(torch.int32).max
    L = mixed_colors
    l_buf = max(2 * L - 1, 1)              # a plan can overshoot to 2L-2
    dev = cols.device
    t_rng = torch.arange(1, L + 1, dtype=torch.int32, device=dev)
    t_rng = t_rng[None, None, :, None]     # k = t - count
    ramp = (t_rng * (t_rng - 1)) // 2
    add = pal[:, :, None, :] * t_rng + ramp            # [M,S,L,3]
    t_idx = torch.arange(L, device=dev)[None, None, :]
    pos = torch.arange(l_buf, device=dev)[None, :]
    so_far = torch.zeros_like(cols)
    plan = torch.zeros((m, l_buf), dtype=torch.int64, device=dev)
    count = torch.zeros(m, dtype=torch.int64, device=dev)
    for _ in range(L):
        active = count < L
        max_test = torch.clamp(count, min=1)
        cand = torch.div(so_far[:, None, None, :] + add,
                         (count[:, None, None, None] + t_rng),
                         rounding_mode='floor')      # values are >= 0
        pens = color_compare_i32(cols[:, None, None, :], cand)  # [M,S,L]
        pens = torch.where(t_idx < max_test[:, None, None], pens, big)
        best = torch.argmin(pens.reshape(m, -1), dim=1)  # first minimum
        chosen = best // L
        amount = torch.where(active, best % L + 1, 0)
        picked = torch.gather(pal, 1, chosen[:, None, None].expand(-1, 1, 3))
        write = (pos >= count[:, None]) & (pos < (count + amount)[:, None])
        plan = torch.where(write, chosen[:, None], plan)
        so_far = so_far + picked[:, 0] * amount[:, None].to(torch.int32)
        count = count + amount
    keys = torch.gather(luma_pal.to(torch.int32), 1, plan)
    keys = torch.where(pos < count[:, None], keys, big)
    order = torch.argsort(keys, dim=1, stable=True)
    return torch.gather(plan, 1, order), count


def _yliluoma_pick(plans: torch.Tensor, counts: torch.Tensor,
                   bayer: torch.Tensor) -> torch.Tensor:
    """Plan entry (bayer * count) >> 6 per pixel: plans [...,2L-1],
    counts [...], bayer broadcastable to counts."""
    mv = (bayer * counts) >> 6
    return torch.gather(plans, -1, mv[..., None].to(torch.int64))[..., 0]


def yliluoma_dither_tiles(tiles_rgb: torch.Tensor,
                          palettes_rgb: torch.Tensor,
                          mixed_colors: int = 4) -> torch.Tensor:
    """Plain per-pixel Yliluoma-2 dither (main.pas:2055-2066): tiles
    [N,8,8,3] uint8 with one palette per tile [N,S,3] uint8 -> [N,8,8]
    uint8 indices."""
    n = tiles_rgb.shape[0]
    cols = tiles_rgb.reshape(n * 64, 3)
    pal_px = palettes_rgb.repeat_interleave(64, dim=0)
    plans, counts = yliluoma_plans(cols, pal_px, _luma_raw(pal_px),
                                   mixed_colors)
    sel = _yliluoma_pick(plans, counts,
                         _bayer(tiles_rgb.device).repeat(n))
    return sel.to(torch.uint8).reshape(n, TILE_W, TILE_W)


def yliluoma_dither_tiles_cached(tiles_rgb: torch.Tensor,
                                 group_pals: np.ndarray,
                                 pal_group: torch.Tensor,
                                 mixed_colors: int = 4) -> torch.Tensor:
    """Yliluoma-2 dither with one plan per unique (palette group, colour),
    as knoll_dither_tiles_cached: tiles_rgb [N,8,8,3] uint8 and pal_group
    [N] int (ids into group_pals [G,S,3] uint8, G <= 256) on the working
    device. Returns [N,8,8] uint8 on that device."""
    dev = tiles_rgb.device
    n = tiles_rgb.shape[0]
    if n == 0:
        return torch.zeros((0, TILE_W, TILE_W), dtype=torch.uint8,
                           device=dev)
    uniq, inv, pals = _dedup_keys(tiles_rgb, group_pals, pal_group)
    # the [keys,S,L,3] candidate averages bound the chunk to ~1 GB
    chunk = max(1024, (1 << 24) // (pals.shape[1] * mixed_colors))
    plan_parts, count_parts = [], []
    for lo in range(0, uniq.shape[0], chunk):
        u = uniq[lo:lo + chunk]
        pal = pals[u >> 24]
        p, c = yliluoma_plans(_key_cols(u), pal, _luma_raw(pal),
                              mixed_colors)
        plan_parts.append(p.to(torch.uint8))
        count_parts.append(c.to(torch.uint8))
    plans = torch.cat(plan_parts)
    counts = torch.cat(count_parts)
    bayer = _bayer(dev)
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    for lo in range(0, n, _TILE_CHUNK):
        rows = inv[lo:lo + _TILE_CHUNK]
        out[lo:lo + _TILE_CHUNK] = _yliluoma_pick(
            plans[rows].to(torch.int64), counts[rows].to(torch.int64),
            bayer).to(torch.uint8)
    return out.reshape(n, TILE_W, TILE_W)
