"""Where one warm encode spends the card's time:

    python -m tiler_tpu_torch.tools.profile_encode [--frames 16]
        [--height 1080] [--width 1920] [--palettes 128]
        [--kmodes-restarts 0] [--device cuda]

Encodes the cuts_v2 clip once untimed (builds, CUDA context), then once
more as Encoder.run_all(profile_dir=...) traces it, both with Save at the
user's default (full LZMA effort), and reads the Chrome trace that run
writes. It prints the seconds the card was busy and the kernels with the
most device time; `steps` gives each step's wall seconds, the seconds
the card was busy inside it (the union of the kernels', copies' and
fills' intervals, cut to the step's annotation) and their share.

`spans` reads the program's spans (utils.dispatch.span: 'step:<name>'
and '<step>/<key>') on the encode thread. Per label, over its intervals:
the host seconds, the card's busy seconds (the union of its kernels,
copies and fills, cut to the intervals), the idle seconds and the number
of idle gaps, the kernels launched inside (a kernel belongs to the span
in which the host called its launch: the trace links the two by their
correlation id), and the host's wait in the CUDA runtime's blocking
calls (HOST_WAITS). `idle_gaps` puts each idle gap of the card down to
the innermost span that the host was in, 'between_steps' outside every
step. `per_frame` gives the whole run's launches and host wait, and the
idle share of the k-means++ spans. Prints one JSON object; --device
defaults to cuda and fails without a card (on the CPU the trace holds no
device activity).
"""
from __future__ import annotations

import argparse
import bisect
import glob
import itertools
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

from ..config import EncoderConfig
from ..pipeline.encoder import Encoder
from .common import device_from, device_name, synthetic_clip_v2

_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# the CUDA runtime's calls in which the host waits for the card: the
# explicit synchronizations, and every copy (PyTorch copies between the
# card and pageable host memory, which the runtime does synchronously)
HOST_WAITS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy')


def _merged(intervals) -> list:
    """The union of (start, end) intervals: sorted, disjoint [start, end]."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events, wall: float, top: int) -> dict:
    """The card's busy seconds and the kernels with the most device time
    from a Chrome trace's events (torch.profiler's export)."""
    device = [(e['ts'], e['ts'] + e['dur'], e['name']) for e in events
              if e.get('ph') == 'X' and e.get('cat') in _DEVICE_CATS]
    by_name = {}
    for a, b, name in device:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += (b - a) * 1e-6
        t[1] += 1
    busy_all = sum(hi - lo for lo, hi in
                   _merged((a, b) for a, b, _ in device)) * 1e-6
    return {'wall_s': wall, 'busy_s': busy_all,
            'busy_share': busy_all / wall,
            'device_time_s': sum(v[0] for v in by_name.values()),
            'top_kernels': [{'name': k[:80], 'seconds': v[0], 'calls': v[1]}
                            for k, v in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][0])[:top]]}


def _segments(spans):
    """(start, end, innermost label) of nested host spans, in order."""
    out, stack, at = [], [], None
    for lo, hi, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= lo:
            end, label = stack.pop()
            out.append((at, end, label))
            at = end
        if stack and lo > at:
            out.append((at, lo, stack[-1][1]))
        at = lo
        stack.append((hi, name))
    while stack:
        end, label = stack.pop()
        out.append((at, end, label))
        at = end
    return [seg for seg in out if seg[1] > seg[0]]


class _Timeline:
    """Sorted points with prefix sums, for sums over a time interval."""

    def __init__(self, points):
        points = sorted(points)
        self.at = [p[0] for p in points]
        self.cum = [0.0, *itertools.accumulate(p[1] for p in points)]

    def count(self, lo, hi) -> int:
        return bisect.bisect_left(self.at, hi) - bisect.bisect_left(
            self.at, lo)

    def total(self, lo, hi) -> float:
        return (self.cum[bisect.bisect_left(self.at, hi)]
                - self.cum[bisect.bisect_left(self.at, lo)])


def span_summary(events, n_frames: int, top: int = 10) -> dict:
    """The spans' readings (see the module's docstring) from a Chrome
    trace's events; times in microseconds in, seconds out."""
    x = [e for e in events if e.get('ph') == 'X']
    ann = [e for e in x if e.get('cat') == 'user_annotation']
    steps = [e for e in ann if e['name'].startswith('step:')]
    if not steps:
        return {}
    thread = (steps[0]['pid'], steps[0]['tid'])
    spans = [(e['ts'], e['ts'] + e['dur'], e['name']) for e in ann
             if (e['pid'], e['tid']) == thread]
    w0 = min(s[0] for s in spans if s[2].startswith('step:'))
    w1 = max(s[1] for s in spans if s[2].startswith('step:'))
    device = [e for e in x if e.get('cat') in _DEVICE_CATS]
    gaps, prev = [], w0
    for lo, hi in _merged((e['ts'], e['ts'] + e['dur']) for e in device):
        if lo > prev:
            gaps.append((prev, min(lo, w1)))
        prev = max(prev, hi)
        if prev >= w1:
            break
    if prev < w1:
        gaps.append((prev, w1))
    gaps = [g for g in gaps if g[1] > g[0]]
    # the encode thread's CUDA API calls ('cuda_runtime' and the like)
    runtime = [e for e in x if e.get('cat', '').startswith('cuda_')
               and (e['pid'], e['tid']) == thread]
    launched = {e['args']['correlation']: e['ts'] for e in runtime
                if 'correlation' in e.get('args', {})}
    launches = _Timeline(
        (launched[e['args']['correlation']], 1.0) for e in device
        if e['cat'] == 'kernel'
        and e.get('args', {}).get('correlation') in launched)
    waits = _Timeline((e['ts'], e['dur']) for e in runtime
                      if e['name'].startswith(HOST_WAITS))
    gap_line = _Timeline((lo, hi - lo) for lo, hi in gaps)
    gap_ends = [hi for _, hi in gaps]

    def idle(lo, hi):
        """Idle microseconds and gaps of the card inside [lo, hi)."""
        i = bisect.bisect_right(gap_ends, lo)
        j = bisect.bisect_left(gap_line.at, hi)
        if i >= j:
            return 0.0, 0
        total = gap_line.cum[j] - gap_line.cum[i]
        total -= max(0.0, lo - gaps[i][0])
        total -= max(0.0, gaps[j - 1][1] - hi)
        return total, j - i

    per = defaultdict(lambda: dict(count=0, host_s=0.0, busy_s=0.0,
                                   idle_s=0.0, idle_gaps=0, kernels=0,
                                   host_wait_s=0.0))
    for lo, hi, name in spans:
        r = per[name]
        idle_us, n_gaps = idle(lo, hi)
        r['count'] += 1
        r['host_s'] += (hi - lo) * 1e-6
        r['idle_s'] += idle_us * 1e-6
        r['busy_s'] += (hi - lo - idle_us) * 1e-6
        r['idle_gaps'] += n_gaps
        r['kernels'] += launches.count(lo, hi)
        r['host_wait_s'] += waits.total(lo, hi) * 1e-6
    by_label, count = defaultdict(float), defaultdict(int)
    at = w0
    for lo, hi, name in _segments(spans) + [(w1, w1, None)]:
        lo, hi = max(lo, w0), min(hi, w1)
        pieces = [(at, lo, 'between_steps')] if lo > at else []
        if hi > lo:
            pieces.append((lo, hi, name[len('step:'):]
                           if name.startswith('step:') else name))
        for a, b, label in pieces:
            idle_us, n_gaps = idle(a, b)
            if n_gaps:
                by_label[label] += idle_us * 1e-6
                count[label] += n_gaps
        at = max(at, hi)
    pp = per.get('dither/kmeans_pp')
    return {
        'window_s': (w1 - w0) * 1e-6,
        'steps': {n[len('step:'):]: {
            'wall_s': r['host_s'], 'busy_s': r['busy_s'],
            'busy_share': r['busy_s'] / max(r['host_s'], 1e-9)}
            for n, r in per.items() if n.startswith('step:')},
        'spans': dict(per),
        'idle_gaps': [[f'{n} ({count[n]} gaps)', v] for n, v in sorted(
            by_label.items(), key=lambda kv: -kv[1])[:top]],
        'per_frame': {
            'launches': launches.count(w0, w1) / n_frames,
            'host_wait_ms': waits.total(w0, w1) * 1e-3 / n_frames,
            'kmeans_pp_ms': pp['host_s'] * 1e3 / n_frames if pp else None,
            'kmeans_pp_idle_pct': (100.0 * pp['idle_s'] / pp['host_s']
                                   if pp and pp['host_s'] > 0 else None)}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='profile_encode')
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--palettes', type=int, default=128)
    ap.add_argument('--kmodes-restarts', type=int, default=0)
    ap.add_argument('--top', type=int, default=8)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    dev = device_from(a.device)
    frames = synthetic_clip_v2(a.frames, a.height, a.width)
    cfg = EncoderConfig(palette_count=a.palettes,
                        kmodes_restarts=a.kmodes_restarts)
    Encoder(cfg, device=dev).run_all(frames, fps=24)

    enc = Encoder(cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        enc.run_all(frames, fps=24, profile_dir=tmp)
        wall = time.perf_counter() - t0
        trace, = glob.glob(os.path.join(tmp, '*.pt.trace.json'))
        with open(trace) as fh:
            events = json.load(fh)['traceEvents']
    out = {'card': device_name(dev), 'frames': list(frames.shape),
           **summarize(events, wall, a.top),
           **span_summary(events, len(frames))}
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
    sys.exit(0)
