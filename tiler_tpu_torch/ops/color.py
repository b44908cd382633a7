"""Colour science in torch: the counterpart of tiler_tpu/ops/color.py.

Rec.709 YUV, Wright-Guild/D50 CIELAB and the integer ColorCompare, on
tensors of any device; the integer HSV helpers stay numpy (they run on
the host inside the palette sort and the VAR quantizer).
"""
from __future__ import annotations

import numpy as np
import torch

from tiler_tpu.constants import BLUE_MUL, GREEN_MUL, LUMA_DIV, RED_MUL

_U_SCALE = 0.5 / (1.0 - BLUE_MUL / LUMA_DIV)
_V_SCALE = 0.5 / (1.0 - RED_MUL / LUMA_DIV)


def srgb_unit(rgb_u8: torch.Tensor, gamma_value: float | None):
    """uint8 -> [0,1] float32, optionally gamma-corrected."""
    x = rgb_u8.to(torch.float32) / 255.0
    if gamma_value is not None:
        x = torch.pow(x, gamma_value)
    return x


def rgb_to_yuv(rgb_unit: torch.Tensor):
    """[..., 3] unit floats -> YUV. Rec.709 luma weights."""
    r, g, b = rgb_unit[..., 0], rgb_unit[..., 1], rgb_unit[..., 2]
    y = (RED_MUL * r + GREEN_MUL * g + BLUE_MUL * b) / LUMA_DIV
    u = (b - y) * _U_SCALE
    v = (r - y) * _V_SCALE
    return torch.stack([y, u, v], dim=-1)


def rgb_to_lab(rgb_unit: torch.Tensor):
    """[..., 3] unit floats -> CIELAB (Wright-Guild XYZ, D50)."""
    c = rgb_unit
    c = torch.where(c > 0.04045, torch.pow((c + 0.055) / 1.055, 2.4),
                    c / 12.92)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    x = (r * 0.49000 + g * 0.31000 + b * 0.20000) / 0.17697
    y = (r * 0.17697 + g * 0.81240 + b * 0.01063) / 0.17697
    z = (r * 0.00000 + g * 0.01000 + b * 0.99000) / 0.17697
    x = x / (96.6797 / 100)
    z = z / (82.5188 / 100)
    xyz = torch.stack([x, y, z], dim=-1)
    f = torch.where(xyz > 0.008856, _cbrt(xyz), 7.787 * xyz + 16 / 116)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)],
                       dim=-1)


def _cbrt(x: torch.Tensor):
    # torch has no cbrt: a float64 power rounded once to float32 lands
    # within an ulp of a correctly rounded cube root
    x64 = x.to(torch.float64)
    return (torch.sign(x64) * torch.pow(torch.abs(x64), 1.0 / 3.0)).to(
        x.dtype)


def div_trunc(x: torch.Tensor, d: int):
    """Truncating integer division (Pascal div) for possibly-negative x."""
    return torch.div(x, d, rounding_mode='trunc')


def color_compare_i32(rgb1: torch.Tensor, rgb2: torch.Tensor):
    """ColorCompare (main.pas:1557-1571) in int32; broadcasting allowed.
    int32 on purpose: the JAX reference wraps in int32 too."""
    a = rgb1.to(torch.int32)
    b = rgb2.to(torch.int32)
    luma1 = a[..., 0] * RED_MUL + a[..., 1] * GREEN_MUL + a[..., 2] * BLUE_MUL
    luma2 = b[..., 0] * RED_MUL + b[..., 1] * GREEN_MUL + b[..., 2] * BLUE_MUL
    lumadiff = div_trunc(luma1 - luma2, LUMA_DIV)
    d = a - b
    res = torch.sum(d * d, dim=-1, dtype=torch.int32) * 13
    return res + lumadiff * lumadiff * 32


def luma_int(rgb_u8) -> np.ndarray:
    """Integer luma in [0,255]: (r*2126+g*7152+b*722) div 10000."""
    x = np.asarray(rgb_u8, np.int64)
    return (x[..., 0] * RED_MUL + x[..., 1] * GREEN_MUL +
            x[..., 2] * BLUE_MUL) // LUMA_DIV


def _muldiv(a, b, c):
    p = a.astype(np.int64) * b
    sign = np.where(p < 0, -1, 1)
    return sign * ((np.abs(p) + c // 2) // c)


def rgb_to_hsv_int_np(rgb):
    """Vectorized integer HSV (main.pas:3496-3543). rgb: [...,3] uint8."""
    rgb = np.asarray(rgb, np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    delta = mx - mn
    nz = delta != 0
    safe_delta = np.where(nz, delta, 1)
    safe_mx = np.where(mx != 0, mx, 1)
    ss = np.where(nz, _muldiv(delta, 255, safe_mx), 0)
    hh = np.zeros_like(r)
    is_r = (r == mx)
    is_g = (g == mx) & ~is_r
    is_b = (b == mx) & ~is_r & ~is_g
    hh = np.where(is_r, _muldiv(g - b, 42, safe_delta), hh)
    hh = np.where(is_g, _muldiv(b - r, 42, safe_delta) + 84, hh)
    hh = np.where(is_b, _muldiv(r - g, 42, safe_delta) + 168, hh)
    hh = np.where(nz, np.fmod(hh, 252).astype(np.int64) & 0xff, 0)
    return (hh.astype(np.uint8), (ss & 0xff).astype(np.uint8),
            (mx & 0xff).astype(np.uint8))


def hsv_to_rgb_int_np(h, s, v):
    """Vectorized integer HSV->RGB (main.pas:3545-3579)."""
    h = np.asarray(h, np.int64) % 252
    s = np.asarray(s, np.int64)
    v = np.asarray(v, np.int64)
    f = h % 42
    hi = h // 42
    ls = v * s
    p = v - ls // 255
    q = v - (ls * f) // (255 * 42)
    r_ = v - (ls * (42 - f)) // (255 * 42)
    cases = np.stack([
        np.stack([v, r_, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, r_], -1), np.stack([p, q, v], -1),
        np.stack([r_, p, v], -1), np.stack([v, p, q], -1),
    ])  # [6, ..., 3]
    out = np.take_along_axis(
        cases, np.clip(hi, 0, 5)[None, ..., None], axis=0)[0]
    gray = np.broadcast_to(v[..., None], out.shape)
    return np.where((s == 0)[..., None], gray, out).astype(np.uint8)
