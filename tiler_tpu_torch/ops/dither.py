"""Thomas Knoll pattern dithering in torch: the counterpart of the Knoll
half of tiler_tpu/ops/dither.py (the Yliluoma planner is not ported yet).

Each pixel's 64-step Knoll plan is an independent lane of int32 math;
the luma-sorted plan is fully determined by per-index counts plus the
palette's luma order, so only the counts are computed and the Bayer-rank
entry is selected from their cumulative sums. Plans depend only on
(palette, colour), so the cached form computes one plan per unique
(palette group, colour) key and gathers it per pixel. All int32, so the
result is byte-identical to the JAX package on any device.
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


def _luma_order(pal_u8: torch.Tensor) -> torch.Tensor:
    pal = pal_u8.to(torch.int32)
    luma = pal[..., 0] * 2126 + pal[..., 1] * 7152 + pal[..., 2] * 722
    return torch.argsort(luma, dim=-1, stable=True)


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
    if group_pals.shape[0] > 256:
        raise ValueError('pal_group must fit 8 bits')
    t = tiles_rgb.reshape(n, 64, 3).to(torch.int64)
    keys = (t[..., 0] | (t[..., 1] << 8) | (t[..., 2] << 16)
            | (pal_group.to(torch.int64)[:, None] << 24))
    uniq, inv = torch.unique(keys.reshape(-1), return_inverse=True)
    pals = torch.from_numpy(np.ascontiguousarray(group_pals)).to(dev)
    parts = []
    for lo in range(0, uniq.shape[0], _KEY_CHUNK):
        u = uniq[lo:lo + _KEY_CHUNK]
        cols = torch.stack([u & 0xff, (u >> 8) & 0xff, (u >> 16) & 0xff], 1)
        parts.append(knoll_counts(cols, pals[u >> 24]).to(torch.uint8))
    counts = torch.cat(parts)
    order_g = _luma_order(pals)
    bayer = _bayer(dev)
    inv = inv.reshape(n, 64)
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    for lo in range(0, n, _TILE_CHUNK):
        hi = min(n, lo + _TILE_CHUNK)
        cnt = counts[inv[lo:hi]].to(torch.int64)            # [c,64,S]
        order = order_g[pal_group[lo:hi].to(torch.int64)]   # [c,S]
        order = order[:, None, :].expand(-1, 64, -1)
        rank = bayer[None, :].expand(hi - lo, -1)
        out[lo:hi] = rank_select(cnt, order, rank).to(torch.uint8)
    return out.reshape(n, TILE_W, TILE_W)
