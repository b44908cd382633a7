"""The plain reference of Dither's Value-at-Risk palettes: upstream's
DoValueAtRiskBased (b0nefish/tiler main.pas:2256-2394; SURVEY.md section
2.1, Dither phase B) in plain Python and NumPy, for one k-means group.

- The histogram: the group's distinct colours, packed r | g << 8 |
  b << 16, with their pixel counts.
- Each colour's integer HSV (RGBToHSV, main.pas:3496-3543): value the
  largest component; saturation and hue by MulDiv, which rounds half away
  from zero; the hue of the largest component's sector (red before green
  before blue on equal components) plus 0, 84 or 168, taken mod 252 with
  the sign of the dividend and stored in a byte, so that a hue of -5
  reads 251; a grey has hue and saturation 0.
- The list: colours by count descending, then hue, value, saturation and
  packed colour ascending (CompareCMUCntHLS).
- CmlPct: the first list position at which the running count reaches
  round(budget * PalVAR), the budget being the keyframe's pixels, or 0
  where none does; at least the palette count times the palette size,
  or the whole list where it is shorter.
- The merges: while more colours survive than CmlPct, take the adjacent
  pair of the list with the smallest ColorCompare (main.pas:1557-1571:
  13 times the squared RGB distance plus 32 times the square of the luma
  difference divided by 10,000 toward zero). Stop where that distance
  equals the one merged last. Otherwise fold the earlier colour into the
  later: count-weighted floor means of its hue, saturation and value, the
  counts summed, its RGB from HSVToRGB (main.pas:3545-3579).
- The palette: entry i is the survivor at position round(pattern[i] *
  (survivors - 1)), rounding half to even, pattern being the group's row
  of gPalettePattern (main.pas:625-641).

Departures from upstream, each on purpose:
- among adjacent pairs at the same distance the one whose distance was
  computed first is merged (the first list's pairs in list order, then
  the two pairs each merge forms, the left one first), the order that the
  JAX package documents; upstream's own order among ties is not in this
  repository;
- upstream also averages each colour's luma on a merge; nothing here
  reads it, so it is left out;
- the list is compacted after every merge, where upstream keeps its
  slots.
"""
from __future__ import annotations

import numpy as np


def _muldiv(a, b, c):
    prod = np.asarray(a, np.int64) * b
    q = (np.abs(prod) + c // 2) // c
    return np.where(prod < 0, -q, q)


def hsv(rgb: np.ndarray):
    """[n, 3] int -> (hue, saturation, value), each [n] int64."""
    rgb = np.asarray(rgb, np.int64)
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    val = rgb.max(1)
    delta = val - rgb.min(1)
    grey = delta == 0
    d = np.where(grey, 1, delta)
    sat = np.where(grey, 0, _muldiv(delta, 255, np.where(val == 0, 1, val)))
    hue = np.select([r == val, g == val],
                    [_muldiv(g - b, 42, d), _muldiv(b - r, 42, d) + 84],
                    _muldiv(r - g, 42, d) + 168)
    hue = np.where(grey, 0, np.fmod(hue, 252) & 0xff)
    return hue, sat, val


def rgb(hue: int, sat: int, val: int) -> tuple:
    """HSVToRGB of one colour: (r, g, b) ints."""
    if sat == 0:
        return val, val, val
    hue %= 252
    sector, frac = divmod(hue, 42)
    vs = val * sat
    lo = val - vs // 255
    down = val - vs * frac // (255 * 42)
    up = val - vs * (42 - frac) // (255 * 42)
    return ((val, up, lo), (down, val, lo), (lo, val, up),
            (lo, down, val), (up, lo, val), (val, lo, down))[sector]


def color_compare(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ColorCompare of rows a against rows b ([..., 3] int64)."""
    w = np.array([2126, 7152, 722], np.int64)
    ld = np.abs((a - b) @ w) // 10000
    return 13 * ((a - b) ** 2).sum(-1) + 32 * ld * ld


def histogram(pixels: np.ndarray):
    """[..., 3] uint8 pixels -> (packed colours [U] int64, counts [U])."""
    p = np.asarray(pixels, np.int64).reshape(-1, 3)
    return np.unique(p[:, 0] | p[:, 1] << 8 | p[:, 2] << 16,
                     return_counts=True)


def palette(pixels: np.ndarray, budget: int, pal_var: float,
            tile_palette_size: int, palette_count: int,
            pattern_row: np.ndarray) -> np.ndarray:
    """The group's palette: [tile_palette_size] packed colours (uint32);
    zeros for a group without pixels."""
    return palette_of_histogram(*histogram(pixels), budget, pal_var,
                                tile_palette_size, palette_count,
                                pattern_row)


def palette_of_histogram(packed, counts, budget: int, pal_var: float,
                         tile_palette_size: int, palette_count: int,
                         pattern_row: np.ndarray) -> np.ndarray:
    """The palette of a histogram (packed colours and their counts)."""
    packed = np.asarray(packed, np.int64)
    counts = np.asarray(counts, np.int64)
    if len(packed) == 0:
        return np.zeros(tile_palette_size, np.uint32)
    cols = np.stack([packed & 0xff, packed >> 8 & 0xff, packed >> 16 & 0xff],
                    1)
    hue, sat, val = hsv(cols)
    order = np.lexsort((packed, sat, val, hue, -counts))
    n = len(order)
    reach = np.flatnonzero(np.cumsum(counts[order])
                           >= int(round(budget * pal_var)))
    cml = max(int(reach[0]) if len(reach) else 0,
              min(n, tile_palette_size * palette_count))

    # the list, one entry a surviving colour, in list order
    cnt = counts[order]
    hsvs = np.stack([hue, sat, val], 1)[order]
    col = cols[order]
    # pair i joins entries i and i + 1: its distance and when it was made
    dist = color_compare(col[1:], col[:-1])
    made = np.arange(n - 1, dtype=np.int64)
    stamp = n - 1
    last = None
    while len(cnt) > cml and len(dist):
        best = dist.min()
        if best == last:
            break
        last = best
        ties = np.flatnonzero(dist == best)
        i = int(ties[np.argmin(made[ties])])
        a, j = cnt[i], cnt[i + 1]
        hsvs[i + 1] = (hsvs[i + 1] * j + hsvs[i] * a) // (a + j)
        cnt[i + 1] = a + j
        col[i + 1] = rgb(*(int(x) for x in hsvs[i + 1]))
        cnt, hsvs, col, dist, made = (np.delete(x, i, axis=0) for x in
                                      (cnt, hsvs, col, dist, made))
        # the entry now at i joins its left and its right neighbour anew
        for k in (i - 1, i):
            if 0 <= k < len(dist):
                dist[k] = color_compare(col[k + 1], col[k])
                made[k] = stamp
                stamp += 1
    last_pos = len(col) - 1
    pos = np.clip(np.rint(np.asarray(pattern_row, np.float64) * last_pos)
                  .astype(np.int64), 0, last_pos)
    out = col[pos, 0] | col[pos, 1] << 8 | col[pos, 2] << 16
    return out.astype(np.uint32)
