"""Psychovisual tile features in torch: the counterpart of
tiler_tpu/ops/features.py.

A 192-dim descriptor per 8x8 tile: three colour planes, each through a
[64,64] linear map (depth-2 Haar wavelet or the DCT LUT) as one float32
matmul. The numpy bases are re-homed here unchanged.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (DCT_BASIS_FLAT, DCT_QUANT, TILE_DCT_SIZE,
                                 TILE_W, UV_RATIO)

from ..utils.dispatch import note
from . import color


def _wavelet_level_np(buf: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """One Haar level on the top-left dx x dy of [n,8,8] buffers."""
    f = 1.0 / np.sqrt(2.0)
    out = buf.copy()
    t = buf[:, :dy, :dx]
    lo = (t[:, :, 0::2] + t[:, :, 1::2]) * f
    hi = (t[:, :, 0::2] - t[:, :, 1::2]) * f
    tx = np.concatenate([lo, hi], axis=2)
    lo = (tx[:, 0::2, :] + tx[:, 1::2, :]) * f
    hi = (tx[:, 0::2, :] - tx[:, 1::2, :]) * f
    out[:, :dy, :dx] = np.concatenate([lo, hi], axis=1)
    return out


@functools.cache
def wavelet_matrix() -> np.ndarray:
    """[64 pix, 64 coeff] float32 matrix of the depth-2 WaveletGS layout."""
    buf = np.eye(64).reshape(64, TILE_W, TILE_W).astype(np.float64)
    dx = dy = TILE_W
    for _ in range(3):  # depth=2 -> 8x8, 4x4, 2x2 levels
        buf = _wavelet_level_np(buf, dx, dy)
        dx //= 2
        dy //= 2
    return buf.reshape(64, 64).astype(np.float32)


@functools.cache
def feature_basis(use_wavelets: bool, q_weighting: bool):
    """(B [64,64] f32, weights [3,64] f32) numpy arrays."""
    if use_wavelets:
        return wavelet_matrix(), np.ones((3, 64), np.float32)
    w = UV_RATIO.reshape(1, 64) * np.ones((3, 1), np.float32)
    if q_weighting:
        w = w * DCT_QUANT.reshape(3, 64)
    return DCT_BASIS_FLAT, w.astype(np.float32)


@functools.cache
def mirror_coeff_perms(use_wavelets: bool):
    """Per-mirror signed column permutations of the 192 features
    (perm [4,192] int64, sign [4,192] float32, indexed by attrs h|v<<1),
    or None when the basis has no exact signed-permutation flip (only the
    Haar wavelet qualifies)."""
    basis, _w = feature_basis(use_wavelets, False)
    eye = np.eye(64).reshape(64, TILE_W, TILE_W)
    binv = np.linalg.inv(basis)
    perms = {}
    for key, flip in ((1, eye[:, :, ::-1]), (2, eye[:, ::-1, :])):
        s = binv @ flip.reshape(64, 64) @ basis
        sr = np.round(s)
        if not (np.allclose(s, sr, atol=1e-10)
                and (np.abs(sr).sum(0) == 1).all()
                and (np.abs(sr).sum(1) == 1).all()):
            return None
        src, dst = np.nonzero(sr)
        perm = np.empty(64, np.int64)
        sign = np.empty(64, np.float32)
        perm[dst] = src
        sign[dst] = sr[src, dst]
        perms[key] = (perm, sign)
    ph, sh = perms[1]
    pv, sv = perms[2]
    perm4 = np.stack([np.arange(64), ph, pv, ph[pv]])
    sign4 = np.stack([np.ones(64, np.float32), sh, sv, sh[pv] * sv])
    off = (np.arange(3) * 64)[None, :, None]
    return (np.tile(perm4[:, None, :], (1, 3, 1)) + off).reshape(4, 192), \
        np.tile(sign4[:, None, :], (1, 3, 1)).reshape(4, 192)


def mirror_tiles(tiles: torch.Tensor, hmir: torch.Tensor,
                 vmir: torch.Tensor):
    """Batched H/V mirror: tiles [N,8,8,...], hmir/vmir [N] bool."""
    extra = (1,) * (tiles.dim() - 3)
    h = hmir.reshape(-1, 1, 1, *extra)
    v = vmir.reshape(-1, 1, 1, *extra)
    tiles = torch.where(h, tiles.flip(2), tiles)
    return torch.where(v, tiles.flip(1), tiles)


def rgb_tiles_to_cpn(tiles_rgb: torch.Tensor, gamma_value: float | None,
                     use_lab: bool):
    """[N,8,8,3] uint8 -> [N,3,8,8] float32 component planes."""
    unit = color.srgb_unit(tiles_rgb, gamma_value)
    cpn = color.rgb_to_lab(unit) if use_lab else color.rgb_to_yuv(unit)
    return torch.movedim(cpn, -1, 1)


def pal_tiles_to_cpn(tiles_pal: torch.Tensor, palettes_rgb: torch.Tensor,
                     gamma_value: float | None, use_lab: bool):
    """Palette-rendered planes: tiles_pal [N,8,8] uint8 indices,
    palettes_rgb [N,S,3] uint8 (per-tile palette)."""
    n = tiles_pal.shape[0]
    idx = tiles_pal.reshape(n, -1, 1).to(torch.int64).expand(-1, -1, 3)
    rgb = torch.gather(palettes_rgb, 1, idx).reshape(n, TILE_W, TILE_W, 3)
    return rgb_tiles_to_cpn(rgb, gamma_value, use_lab)


def _basis_tensors(use_wavelets: bool, q_weighting: bool, device):
    basis, weights = feature_basis(use_wavelets, q_weighting)
    note('h2d', 2)
    return (torch.from_numpy(basis).to(device),
            torch.from_numpy(weights).to(device))


def psyv_from_cpn(cpn: torch.Tensor, use_wavelets: bool = False,
                  q_weighting: bool = False):
    """[N,3,8,8] planes -> [N,192] features (plane-major coeff order):
    one float32 [N*3,64]@[64,64] matmul."""
    basis, weights = _basis_tensors(use_wavelets, q_weighting, cpn.device)
    n = cpn.shape[0]
    coeff = (cpn.reshape(n * 3, 64) @ basis).reshape(n, 3, 64)
    coeff = coeff * weights[None]
    return coeff.reshape(n, TILE_DCT_SIZE)


def psyv_features_rgb(tiles_rgb: torch.Tensor, gamma_value=None,
                      use_lab=False, use_wavelets=False, q_weighting=False,
                      hmir=None, vmir=None):
    """RGB tiles [N,8,8,3] uint8 -> [N,192] float32. Mirrors apply to the
    pixels before the colour transform."""
    if hmir is not None:
        tiles_rgb = mirror_tiles(tiles_rgb, hmir, vmir)
    cpn = rgb_tiles_to_cpn(tiles_rgb, gamma_value, use_lab)
    return psyv_from_cpn(cpn, use_wavelets=use_wavelets,
                         q_weighting=q_weighting)


def psyv_features_pal(tiles_pal: torch.Tensor, palettes_rgb: torch.Tensor,
                      gamma_value=None, use_lab=False, use_wavelets=False,
                      q_weighting=False, hmir=None, vmir=None):
    """Palette-indexed tiles [N,8,8] + per-tile palettes [N,S,3] ->
    [N,192]. Mirrors apply to the index plane before the palette LUT."""
    if hmir is not None:
        tiles_pal = mirror_tiles(tiles_pal, hmir, vmir)
    cpn = pal_tiles_to_cpn(tiles_pal, palettes_rgb, gamma_value, use_lab)
    return psyv_from_cpn(cpn, use_wavelets=use_wavelets,
                         q_weighting=q_weighting)
