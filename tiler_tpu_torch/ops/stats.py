"""Pearson correlation, shot-detection correlations and PSNR: the
counterpart of tiler_tpu/ops/stats.py, on the host in numpy."""
from __future__ import annotations

import numpy as np


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    """PearsonCorrelation (main.pas:1465-1492) on flat arrays, in float32
    as the JAX package computes it; 0 when either side is constant."""
    x = np.asarray(x).astype(np.float32).ravel()
    y = np.asarray(y).astype(np.float32).ravel()
    xm = x - np.mean(x)
    ym = y - np.mean(y)
    num = np.sum(xm * ym)
    den = np.sqrt(np.sum(xm * xm)) * np.sqrt(np.sum(ym * ym))
    return 0.0 if den == 0 else float(num / den)


def interframe_correlations_host(frames_u8: np.ndarray) -> np.ndarray:
    """Pearson correlation between consecutive frames in float64
    (ComputeInterFrameCorrelation, main.pas:811-833): [F,H,W,3] uint8 ->
    [F-1]. Each pair is computed independently."""
    n = len(frames_u8)
    out = np.empty(max(n - 1, 0), np.float64)
    flat = frames_u8.reshape(n, -1)
    prev = flat[0].astype(np.float64)
    prev -= prev.mean()
    prev_ss = float(prev @ prev)
    for i in range(1, n):
        cur = flat[i].astype(np.float64)
        cur -= cur.mean()
        cur_ss = float(cur @ cur)
        den = np.sqrt(prev_ss) * np.sqrt(cur_ss)
        out[i - 1] = 0.0 if den == 0 else float(prev @ cur) / den
        prev, prev_ss = cur, cur_ss
    return out


def psnr(a_u8: np.ndarray, b_u8: np.ndarray) -> float:
    """Peak signal-to-noise ratio (dB) between two uint8 arrays, with the
    squared error summed in float64 frame by frame."""
    sq = 0.0
    for x, y in zip(a_u8, b_u8):
        d = (x.astype(np.float64) - y.astype(np.float64)).ravel()
        sq += float(d @ d)
    mse = sq / a_u8.size
    return float('inf') if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
