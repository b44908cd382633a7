"""Where one warm encode spends the card's time:

    python -m tiler_tpu_torch.tools.profile_encode [--frames 16]
        [--height 1080] [--width 1920] [--palettes 128]

Encodes the cuts_v2 clip once untimed (builds, CUDA context), then once
more step by step under torch.profiler. For each step it prints the wall
seconds, the seconds the card was busy (the union of the kernels' and
copies' intervals that start inside the step; the steps' own annotations
are not counted) and their share, and the kernels with the most device
time. Prints one JSON object; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..config import EncoderConfig
from ..constants import ENCODER_STEPS
from ..pipeline.encoder import Encoder
from .common import device_name, synthetic_clip_v2


def _union_s(spans) -> float:
    """Seconds covered by (start, end) microsecond intervals."""
    total, edge = 0.0, float('-inf')
    for a, b in sorted(spans):
        if b > edge:
            total += b - max(a, edge)
            edge = b
    return total * 1e-6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='profile_encode')
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--palettes', type=int, default=128)
    ap.add_argument('--top', type=int, default=8)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('profile_encode needs a cuda device')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    frames = synthetic_clip_v2(a.frames, a.height, a.width)
    cfg = EncoderConfig(palette_count=a.palettes)
    Encoder(cfg, device='cuda').run_all(frames, fps=24, fast_lzma=True)

    enc = Encoder(cfg, device='cuda')
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for step in ENCODER_STEPS:
            with record_function(f'step:{step}'):
                if step == 'load':
                    enc.load(frames, 24)
                elif step == 'save':
                    enc.save(fast_lzma=True)
                else:
                    getattr(enc, step)()
    wall = time.perf_counter() - t0
    events = prof.events()
    steps = {e.name[5:]: (e.time_range.start, e.time_range.end)
             for e in events if e.name.startswith('step:')
             and e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith('step:')]
    per_step = {}
    for name, (lo, hi) in steps.items():
        spans = [(e.time_range.start, e.time_range.end) for e in device
                 if lo <= e.time_range.start < hi]
        busy = _union_s(spans)
        per_step[name] = {'wall_s': (hi - lo) * 1e-6, 'busy_s': busy,
                          'busy_share': busy / max((hi - lo) * 1e-6, 1e-9)}
    by_name = {}
    for e in device:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) * 1e-6
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:a.top]
    busy_all = _union_s([(e.time_range.start, e.time_range.end)
                         for e in device])
    out = {'card': device_name(enc.device), 'frames': list(frames.shape),
           'wall_s': wall, 'busy_s': busy_all, 'busy_share': busy_all / wall,
           'device_time_s': sum(v[0] for v in by_name.values()),
           'steps': per_step,
           'top_kernels': [{'name': k[:80], 'seconds': v[0], 'calls': v[1]}
                           for k, v in top]}
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
    sys.exit(0)
