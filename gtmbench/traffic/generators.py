"""The general generator of the benchmark's traffic: the clip that a
traffic file (traffic/<name>.json) names, made on the host. A traffic
file gives the generator's name, the seed of the clip's noise
(`clip_seed`), the frame count, height and width, the frame rate and who
sends such clips. The clip is the traffic file's alone: every run of a
cell, whatever its seed, encodes the same frames.

The two generators are frozen copies of the port's synthetic clips
(tiler_tpu_torch/tools/common.py: synthetic_clip_v2 and synthetic_clip),
so that the program can change and the yardstick cannot. They give the
originals' frames to the byte; the noise is drawn in the originals'
order and each frame's arithmetic runs on a few worker threads.
"""
from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

WORKERS = min(4, os.cpu_count() or 1)


class _Frames:
    """Runs frame jobs on WORKERS threads, at most 2 x WORKERS queued, so
    that the drawn noise waiting for its frame stays bounded."""

    def __init__(self):
        self.pool = cf.ThreadPoolExecutor(WORKERS)
        self.pending = []

    def submit(self, fn, *args):
        if len(self.pending) >= 2 * WORKERS:
            self.pending.pop(0).result()
        self.pending.append(self.pool.submit(fn, *args))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for f in self.pending:
            f.result()
        self.pool.shutdown()


def cuts_v2(f, h, w, seed=0):
    """[f,h,w,3] uint8: three scenes (hard cuts, so three keyframes) and a
    static bottom band (~38% of the cells unchanged within a scene)."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    h_static = (int(h * 0.38) // 8) * 8      # whole 8px tile rows
    cuts = [0, (f * 3) // 8, (f * 11) // 16, f]   # 16 -> scenes 6/5/5
    mixes = [np.array([[1., .7, .4], [.2, .5, 1.]]),
             np.array([[.3, 1., .5], [1., .3, .6]]),
             np.array([[.5, .4, 1.], [.9, .8, .2]])]
    with _Frames() as jobs:
        _cuts_scenes(frames, rng, xx, yy, h_static, cuts, mixes, jobs)
    return frames


def _cuts_scenes(frames, rng, xx, yy, h_static, cuts, mixes, jobs):
    h, w = frames.shape[1:3]
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
            jobs.submit(_cuts_frame, frames, i, i - lo, s, mix, xx, yy,
                        rng.normal(0, 6, (h, w, 3)), static_band)


def _cuts_frame(frames, i, t, s, mix, xx, yy, noise, static_band):
    h = frames.shape[1]
    if s == 0:
        base = ((xx * 2 + t * 3) % 256)[..., None] * mix[0] \
            + ((yy + 2 * t) % 64)[..., None] * mix[1]
    elif s == 1:
        base = ((yy * 2 - t * 5) % 256)[..., None] * mix[0] \
            + (((xx + yy) // 2 + t) % 96)[..., None] * mix[1]
    else:
        base = (((xx + yy) + t * 4) % 256)[..., None] * mix[0] \
            + ((xx % 128 + t) % 128)[..., None] * mix[1]
    frames[i] = np.clip(base + noise, 0, 255)
    frames[i, h - len(static_band):] = static_band


def noise(f, h, w, seed=0):
    """[f,h,w,3] uint8, one scene: full-frame motion and noise, every
    cell changed in every frame, one keyframe."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    with _Frames() as jobs:
        for i in range(f):
            jobs.submit(_noise_frame, frames, i, xx, yy,
                        rng.normal(0, 6, (h, w, 3)))
    return frames


def _noise_frame(frames, i, xx, yy, noise):
    base = ((xx * 2 + i * 3) % 256)[..., None] * np.array([1, .8, .5])
    base += ((yy + 2 * i) % 64)[..., None] * np.array([.2, .5, 1.])
    frames[i] = np.clip(base + noise, 0, 255)


GENERATORS = {'cuts_v2': cuts_v2, 'noise': noise}


def make(traffic: dict) -> np.ndarray:
    """The clip of a traffic file's parameters."""
    gen = GENERATORS[traffic['generator']]
    return gen(int(traffic['frames']), int(traffic['height']),
               int(traffic['width']), seed=int(traffic['clip_seed']))
