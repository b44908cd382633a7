"""What the experiment tools and the smoke run share: the device (a card
unless asked for the CPU), the card's name and power limit, a timer,
PsyV features of random tiles, the default stream of the decode
benchmark and the synthetic clips (the noise clip, cuts_v2 and the
plasma clip of the web player's sample stream)."""
from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from ..ops import features
from ..pipeline.encoder import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the reference project's published demo stream (300 frames of 352x288 at
# 30 fps), at the place it takes in this repository once committed; the
# tools read nothing outside their own checkout
REF = os.path.join(ROOT, 'docs', 'demo', 'city_cif.gtm')


def device_from(name: str) -> torch.device:
    """The tools' --device; cuda must exist (no fallback to the CPU)."""
    import tiler_tpu_torch  # noqa: F401  (sets the TF32 switches)
    return resolve_device(name)


def card_line(device='cuda') -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device type when the run is not on a card."""
    if torch.device(device).type != 'cuda':
        return torch.device(device).type
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def time_ms(fn, dev: torch.device) -> tuple[float, object]:
    """Milliseconds of one call of fn and its result: CUDA events around
    it on a card, the host clock on the CPU."""
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b), out


def psyv_of_tiles(tiles_u8: np.ndarray, dev: torch.device) -> torch.Tensor:
    """[N,192] f32 PsyV features (wavelets on, YUV, no gamma) of [N,8,8,3]
    uint8 tiles, on dev: FrameTiling's stage-3 feature distribution.
    Converted 65536 tiles at a time to bound the float temporaries."""
    out = torch.empty((len(tiles_u8), 192), dtype=torch.float32, device=dev)
    for lo in range(0, len(tiles_u8), 1 << 16):
        t = torch.from_numpy(tiles_u8[lo:lo + (1 << 16)]).to(dev)
        out[lo:lo + (1 << 16)] = features.psyv_features_rgb(
            t, gamma_value=None, use_lab=False, use_wavelets=True)
    return out


def synthetic_clip(f, h, w, seed=0):
    """The single-scene noise clip [f,h,w,3] uint8: full-frame motion and
    noise, every cell changed in every frame, one keyframe. Frame for
    frame the JAX package's benchmark clip of its rounds 1-4, kept there
    and here as the continuity entry."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(f):
        base = ((xx * 2 + i * 3) % 256)[..., None] * np.array([1, .8, .5])
        base += ((yy + 2 * i) % 64)[..., None] * np.array([.2, .5, 1.])
        frames[i] = np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255)
    return frames


def synthetic_clip_v2(f, h, w, seed=0):
    """The cuts_v2 clip [f,h,w,3] uint8: three scenes (hard cuts -> 3
    keyframes) and a static bottom band (~38% of cells unchanged within a
    scene), as real video has shots and static regions. Frame for frame
    the clip of the JAX package's benchmark script, so that the two
    packages' streams compare."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    h_static = (int(h * 0.38) // 8) * 8      # whole 8px tile rows
    cuts = [0, (f * 3) // 8, (f * 11) // 16, f]   # 16 -> scenes 6/5/5
    mixes = [np.array([[1., .7, .4], [.2, .5, 1.]]),
             np.array([[.3, 1., .5], [1., .3, .6]]),
             np.array([[.5, .4, 1.], [.9, .8, .2]])]
    for s in range(3):
        lo, hi = cuts[s], cuts[s + 1]
        mix = mixes[s]
        # per-scene static band content (noise frozen within the scene)
        if s == 0:
            sb = ((xx * 3) % 256)[..., None] * mix[0]
        elif s == 1:
            sb = ((yy * 2 + xx) % 256)[..., None] * mix[1]
        else:
            sb = (((xx // 4) * 7) % 256)[..., None] * mix[0]
        static_band = np.clip(
            sb[h - h_static:] + rng.normal(0, 6, (h_static, w, 3)),
            0, 255).astype(np.uint8)
        for i in range(lo, hi):
            t = i - lo
            if s == 0:
                base = ((xx * 2 + t * 3) % 256)[..., None] * mix[0] \
                    + ((yy + 2 * t) % 64)[..., None] * mix[1]
            elif s == 1:
                base = ((yy * 2 - t * 5) % 256)[..., None] * mix[0] \
                    + (((xx + yy) // 2 + t) % 96)[..., None] * mix[1]
            else:
                base = (((xx + yy) + t * 4) % 256)[..., None] * mix[0] \
                    + ((xx % 128 + t) % 128)[..., None] * mix[1]
            frames[i] = np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255)
            frames[i, h - h_static:] = static_band
    return frames


# the clip of tools/gen_sample_stream.py, which writes the web player's
# decoders/web/sample.gtm with the JAX encoder: a copy of its source,
# since that script imports jax
def sample_clip(w=320, h=176, n=48):
    """Two shots of animated plasma + moving sprites."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        shot = i >= n // 2
        t = i * 0.25
        if not shot:
            v = (np.sin(xx * 0.045 + t) + np.sin(yy * 0.06 - 0.7 * t)
                 + np.sin((xx + yy) * 0.03 + 0.4 * t))
            r = 128 + 90 * np.sin(v * 1.1)
            g = 128 + 90 * np.sin(v * 1.1 + 2.1)
            b = 128 + 90 * np.sin(v * 1.1 + 4.2)
        else:
            v = (np.sin(np.hypot(xx - w / 2, yy - h / 2) * 0.07 - t)
                 + np.sin(xx * 0.02 + 2 * t))
            r = 110 + 100 * np.sin(v + 1.0)
            g = 120 + 80 * np.sin(v * 1.3)
            b = 150 + 100 * np.sin(v * 0.8 - 1.0)
        f = np.stack([r, g, b], -1)
        # moving sprites (sharp edges exercise tile reuse + mirrors)
        for s in range(3):
            cx = int((w - 40) * (0.5 + 0.45 * np.sin(t * (0.6 + 0.2 * s)
                                                     + s * 2.1))) + 20
            cy = int((h - 40) * (0.5 + 0.45 * np.cos(t * (0.5 + 0.15 * s)
                                                     + s * 1.3))) + 20
            col = np.array([[255, 230, 40], [40, 220, 255],
                            [255, 70, 160]][s], np.float32)
            f[cy - 10:cy + 10, cx - 10:cx + 10] = col
        frames[i] = np.clip(f, 0, 255).astype(np.uint8)
    return frames
