"""Palette quantization helpers: the counterpart of
tiler_tpu/ops/palette.py for the DL3 path.

DL3 runs in the shared C++ library (tiler_tpu.native, built by the host
compiler at first use); the LHS entry sort and the packed/RGB converters
are host numpy, re-homed unchanged.
"""
from __future__ import annotations

import numpy as np

from tiler_tpu import native

from .color import luma_int, rgb_to_hsv_int_np


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
