"""Where one warm encode spends the card's time:

    python -m tiler_tpu_torch.tools.profile_encode [--frames 16]
        [--height 1080] [--width 1920] [--palettes 128] [--device cuda]

Encodes the cuts_v2 clip once untimed (builds, CUDA context), then once
more as Encoder.run_all(profile_dir=...) traces it, and reads the Chrome
trace that run writes. For each step it prints the wall seconds, the
seconds the card was busy (the union of the kernels' and copies'
intervals that start inside the step's annotation) and their share, and
the kernels with the most device time. Prints one JSON object; --device
defaults to cuda and fails without a card (on the CPU the trace holds no
device activity).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

from ..config import EncoderConfig
from ..pipeline.encoder import Encoder
from .common import device_from, device_name, synthetic_clip_v2

_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _union_s(spans) -> float:
    """Seconds covered by (start, end) microsecond intervals."""
    total, edge = 0.0, float('-inf')
    for a, b in sorted(spans):
        if b > edge:
            total += b - max(a, edge)
            edge = b
    return total * 1e-6


def summarize(events, wall: float, top: int) -> dict:
    """Busy seconds per step and the top kernels from a Chrome trace's
    events (torch.profiler's export)."""
    span = [e for e in events if e.get('ph') == 'X']
    steps = {e['name'][5:]: (e['ts'], e['ts'] + e['dur']) for e in span
             if e.get('cat') == 'user_annotation'
             and e['name'].startswith('step:')}
    device = [(e['ts'], e['ts'] + e['dur'], e['name']) for e in span
              if e.get('cat') in _DEVICE_CATS]
    per_step = {}
    for name, (lo, hi) in steps.items():
        busy = _union_s([(a, b) for a, b, _ in device if lo <= a < hi])
        per_step[name] = {'wall_s': (hi - lo) * 1e-6, 'busy_s': busy,
                          'busy_share': busy / max((hi - lo) * 1e-6, 1e-9)}
    by_name = {}
    for a, b, name in device:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += (b - a) * 1e-6
        t[1] += 1
    busy_all = _union_s([(a, b) for a, b, _ in device])
    return {'wall_s': wall, 'busy_s': busy_all,
            'busy_share': busy_all / wall,
            'device_time_s': sum(v[0] for v in by_name.values()),
            'steps': per_step,
            'top_kernels': [{'name': k[:80], 'seconds': v[0], 'calls': v[1]}
                            for k, v in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][0])[:top]]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='profile_encode')
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--palettes', type=int, default=128)
    ap.add_argument('--top', type=int, default=8)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    dev = device_from(a.device)
    frames = synthetic_clip_v2(a.frames, a.height, a.width)
    cfg = EncoderConfig(palette_count=a.palettes)
    Encoder(cfg, device=dev).run_all(frames, fps=24, fast_lzma=True)

    enc = Encoder(cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        enc.run_all(frames, fps=24, fast_lzma=True, profile_dir=tmp)
        wall = time.perf_counter() - t0
        trace, = glob.glob(os.path.join(tmp, '*.pt.trace.json'))
        with open(trace) as fh:
            events = json.load(fh)['traceEvents']
    out = {'card': device_name(dev), 'frames': list(frames.shape),
           **summarize(events, wall, a.top)}
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
    sys.exit(0)
