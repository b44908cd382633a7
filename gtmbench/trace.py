"""What the traced run reads from torch.profiler, held in memory (no trace
file is written): the device's busy intervals (its kernels, copies and
fills: the profiler's device events that are not annotations), their
union against the traced window (the first `step:` annotation's start to
the last one's end), the device time by operation name, and the device's
idle gaps by the encoder step that the host was running (the program's
`step:<name>` annotations, Encoder._timed)."""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

def _ns(e, what: str) -> int:
    f = getattr(e, f'{what}_ns', None)
    return int(f()) if f is not None else int(getattr(e, f'{what}_us')()
                                               * 1000)


def short(name: str) -> str:
    """An operation's name as the breakdown gives it: 64 characters of
    letters, digits, '_', '.' and '-'."""
    return re.sub(r'[^A-Za-z0-9_.-]', '_', name)[:64]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict | None:
    """The traced window's device readings (see reduce) of a finished
    torch.profiler.profile."""
    from torch.autograd import DeviceType
    dev, steps = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, 'start')
        span = (start, start + _ns(e, 'duration'), e.name())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(span)
        elif e.is_user_annotation() and e.name().startswith('step:'):
            steps.append(span)
    return reduce(dev, steps)


def reduce(dev, steps) -> dict | None:
    """dev: (start, end, name) of every device operation; steps: (start,
    end, 'step:<name>') of the host's step annotations, in ns. Returns
    None where either is empty, else busy_s, window_s, op_s {name:
    device seconds}, and the breakdown's device_ops and idle_gaps (at
    most 10 each)."""
    if not dev or not steps:
        return None
    steps = sorted((s, e, n[len('step:'):]) for s, e, n in steps)
    w0, w1 = steps[0][0], max(s[1] for s in steps)
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev
                   if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)
    op_s = defaultdict(float)
    for s, e, name in dev:
        op_s[name] += (e - s) / 1e9
    # idle gaps: the window less the busy union, each cut by the steps'
    # host ranges; what lies outside every step is between steps
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    by_step, count = defaultdict(float), defaultdict(int)
    starts = [st[0] for st in steps]
    for s, e in gaps:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        at = s
        while at < e:
            if i < len(steps) and steps[i][0] <= at < steps[i][1]:
                end, name = min(e, steps[i][1]), steps[i][2]
                i += 1
            else:
                if i < len(steps) and steps[i][1] <= at:
                    i += 1
                    continue
                end = min(e, steps[i][0]) if i < len(steps) else e
                name = 'between_steps'
            by_step[name] += (end - at) / 1e9
            count[name] += 1
            at = end
    top_ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(by_step.items(), key=lambda kv: -kv[1])[:10]
    return {
        'busy_s': busy_ns / 1e9,
        'window_s': (w1 - w0) / 1e9,
        'op_s': dict(op_s),
        'device_ops': [[short(n), v] for n, v in top_ops],
        'idle_gaps': [[short(f'{n} ({count[n]} gaps)'), v]
                      for n, v in top_gaps],
    }
