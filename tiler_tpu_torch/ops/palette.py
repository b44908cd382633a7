"""Palette quantization: the counterpart of tiler_tpu/ops/palette.py.

DL3 runs in the package's C++ library (tiler_tpu_torch.native, built by
the host compiler at first use), and so does the Value-at-Risk quantizer
that the Dither step calls (native.var_quant_tiles); both calls release
the interpreter lock. var_palette is VAR in host numpy, as in the JAX
package: the plain version that the native one is held to. The LHS entry
sort and the packed/RGB converters are host numpy.
"""
from __future__ import annotations

import heapq

import numpy as np

from .. import native
from .color import hsv_to_rgb_int_np, luma_int, rgb_to_hsv_int_np

_RGB_W = 13


def _color_compare_scalar(rgb1, rgb2) -> int:
    r1, g1, b1 = int(rgb1[0]), int(rgb1[1]), int(rgb1[2])
    r2, g2, b2 = int(rgb2[0]), int(rgb2[1]), int(rgb2[2])
    luma1 = r1 * 2126 + g1 * 7152 + b1 * 722
    luma2 = r2 * 2126 + g2 * 7152 + b2 * 722
    ld = luma1 - luma2
    lumadiff = -((-ld) // 10000) if ld < 0 else ld // 10000
    return ((r1 - r2) ** 2 + (g1 - g2) ** 2 + (b1 - b2) ** 2) * _RGB_W \
        + lumadiff * lumadiff * 32


DL3_BIN_CAP = 4096


def dl3_palette(pixels_rgb: np.ndarray, palette_size: int,
                bpc: int = 7, bin_cap: int = DL3_BIN_CAP) -> np.ndarray:
    """DL3 palette of the given pixels ([...,3] uint8). Returns
    [palette_size, 3] uint8; as in DoDennisLeeV3, entries beyond the
    distinct histogram bins stay black. Above `bin_cap` distinct bins the
    rare ones are merged into their nearest frequent bin before the
    exact greedy runs (bin_cap 0: no cap)."""
    if pixels_rgb.size == 0:
        return np.zeros((palette_size, 3), np.uint8)
    pal, _n = native.dl3_quant_capped(pixels_rgb.reshape(-1, 3),
                                      palette_size, bpc, bin_cap)
    return pal


def dl3_palette_tiles(tiles_rgb: np.ndarray, sel: np.ndarray,
                      palette_size: int, bpc: int, bin_cap: int
                      ) -> np.ndarray:
    """DL3 palette of the pixels of tiles_rgb[sel] ([N,8,8,3] uint8),
    gathered inside the native call. Returns [palette_size, 3] uint8;
    entries beyond the distinct bins stay black."""
    if len(sel) == 0:
        return np.zeros((palette_size, 3), np.uint8)
    pal, _n = native.dl3_quant_tiles_capped(tiles_rgb, sel, palette_size,
                                            bpc, bin_cap)
    return pal


def _color_compare_np(rgb1: np.ndarray, rgb2: np.ndarray) -> np.ndarray:
    """_color_compare_scalar over [N,3] int64 rows."""
    w = np.array([2126, 7152, 722], np.int64)
    ld = (rgb1 - rgb2) @ w
    lumadiff = np.sign(ld) * (np.abs(ld) // 10000)
    return ((rgb1 - rgb2) ** 2).sum(1) * _RGB_W + lumadiff * lumadiff * 32


def var_palette(colors_packed: np.ndarray, counts: np.ndarray,
                total_budget: int, pal_var: float,
                tile_palette_size: int, palette_count: int,
                pattern_row: np.ndarray) -> np.ndarray:
    """Value-at-Risk palette (DoValueAtRiskBased, main.pas:2256-2394).

    colors_packed: [U] uint32 packed r|g<<8|b<<16 of the used colours;
    counts: [U] usage counts; total_budget: the keyframe's pixel count;
    pattern_row: gPalettePattern[palIdx]. Returns [tile_palette_size]
    packed colours (possibly duplicated).

    Colours sorted by count desc, hue, val, sat are merged pairwise,
    always the adjacent pair with the smallest ColorCompare (a lazily
    invalidated heap over a linked list, insertion order on ties), each
    merge a count-weighted average of HSV and luma, until the survivors
    reach the CmlPct position or two successive minima are equal; the
    palette samples the survivors along pattern_row."""
    if colors_packed.size == 0:
        return np.zeros(tile_palette_size, np.uint32)

    r = (colors_packed & 0xff).astype(np.int64)
    g = ((colors_packed >> 8) & 0xff).astype(np.int64)
    b = ((colors_packed >> 16) & 0xff).astype(np.int64)
    rgb = np.stack([r, g, b], axis=1)
    h, s, v = rgb_to_hsv_int_np(rgb)
    luma = luma_int(rgb)

    # sort: count desc, hue asc, val asc, sat asc (CompareCMUCntHLS)
    order = np.lexsort((colors_packed, s, v, h, -counts.astype(np.int64)))
    n = len(order)

    # CmlPct: position where the cumulative count reaches pal_var * budget
    acc = int(round(total_budget * pal_var))
    csum = np.cumsum(counts[order.astype(np.int64)])
    hit = np.flatnonzero(csum >= acc)
    cml_pct = int(hit[0]) if hit.size else 0
    cml_pct = max(cml_pct, min(n, tile_palette_size * palette_count))

    # node state (in sorted order)
    cnt = counts[order].astype(np.int64).copy()
    hh = h[order].astype(np.int64).copy()
    ss = s[order].astype(np.int64).copy()
    vv = v[order].astype(np.int64).copy()
    lum = luma[order].astype(np.int64).copy()
    idx = colors_packed[order].astype(np.int64).copy()
    rr, gg, bb = r[order].copy(), g[order].copy(), b[order].copy()

    prv = np.arange(-1, n - 1)
    nxt = np.arange(1, n + 1)
    version = np.zeros(n, np.int64)
    dead = np.zeros(n, bool)
    alive = n

    # the initial adjacent pairs (p, p + 1) in one vectorized pass, seq =
    # p: the heap pops them in the order one push per pair would
    d0 = _color_compare_np(rgb[order][1:], rgb[order][:-1])
    heap: list = [(int(d), p, p, p + 1, 0, 0) for p, d in enumerate(d0)]
    heapq.heapify(heap)
    seq = len(heap)

    def push_pair(p, j):
        nonlocal seq
        if p < 0 or j >= n:
            return
        d = _color_compare_scalar((rr[j], gg[j], bb[j]),
                                  (rr[p], gg[p], bb[p]))
        heapq.heappush(heap, (d, seq, p, j, version[p], version[j]))
        seq += 1

    prev_best = None
    while alive > cml_pct:
        # the current minimal adjacent diff (lazily invalidated)
        while heap:
            d, _, p, j, vp, vj = heap[0]
            if version[p] == vp and version[j] == vj and nxt[p] == j:
                break
            heapq.heappop(heap)
        if not heap:
            break
        if prev_best is not None and d == prev_best:
            break  # reference: until best = PrevBest
        prev_best = d
        heapq.heappop(heap)

        # merge p (earlier) into j, weighted by counts (main.pas:2375-2382)
        acc2 = cnt[j] + cnt[p]
        hh[j] = (hh[j] * cnt[j] + hh[p] * cnt[p]) // acc2
        ss[j] = (ss[j] * cnt[j] + ss[p] * cnt[p]) // acc2
        vv[j] = (vv[j] * cnt[j] + vv[p] * cnt[p]) // acc2
        lum[j] = (lum[j] * cnt[j] + lum[p] * cnt[p]) // acc2
        cnt[j] = acc2
        nrgb = hsv_to_rgb_int_np(np.array([hh[j]]), np.array([ss[j]]),
                                 np.array([vv[j]]))[0]
        rr[j], gg[j], bb[j] = int(nrgb[0]), int(nrgb[1]), int(nrgb[2])
        idx[j] = int(nrgb[0]) | (int(nrgb[1]) << 8) | (int(nrgb[2]) << 16)
        version[j] += 1
        version[p] += 1
        # unlink p (merges never reorder: list order == index order)
        pp = int(prv[p])
        if pp >= 0:
            nxt[pp] = j
        prv[j] = pp
        dead[p] = True
        alive -= 1
        push_pair(pp, j)
        if nxt[j] < n:
            push_pair(j, int(nxt[j]))

    surv = np.flatnonzero(~dead)
    pos = np.clip(np.round(pattern_row * (len(surv) - 1)).astype(np.int64),
                  0, len(surv) - 1)
    return idx[surv[pos]].astype(np.uint32)


def sort_palette_lhs(entries_packed: np.ndarray) -> np.ndarray:
    """CompareCMULHS sort (main.pas:2081-2090): luma, val, sat, hue asc."""
    r = (entries_packed & 0xff).astype(np.int64)
    g = (entries_packed >> 8) & 0xff
    b = (entries_packed >> 16) & 0xff
    rgb = np.stack([r, g, b], axis=1)
    h, s, v = rgb_to_hsv_int_np(rgb)
    order = np.lexsort((h, s, v, luma_int(rgb)))
    return entries_packed[order]


def packed_to_rgb(packed: np.ndarray) -> np.ndarray:
    p = np.asarray(packed, np.int64)
    return np.stack([p & 0xff, (p >> 8) & 0xff, (p >> 16) & 0xff],
                    axis=-1).astype(np.uint8)


def rgb_to_packed(rgb: np.ndarray) -> np.ndarray:
    x = np.asarray(rgb, np.int64)
    return (x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16)).astype(np.uint32)
