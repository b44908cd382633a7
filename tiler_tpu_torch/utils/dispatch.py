"""Host<->card round-trip counter for the encoder pipeline: the
counterpart of tiler_tpu/utils/dispatch.py.

Eager PyTorch enqueues every op on the card's stream and returns; the
host waits only where it needs a device result, uploads host memory, or
is told to wait. Those waits are the round trips that hold the card
idle between steps, so their count is a pipeline metric: each step's
delta lands in metrics['dispatches'] and the bench prints them.

This is call-site instrumentation, as in the JAX package: the pipeline
notes its own interactions where it issues them. note() reads no device
value and fires whatever the device, so an encode on the CPU counts the
same sites as one on the card. Kinds:

  h2d    - host data uploaded to the card (torch.from_numpy(a).to(dev),
           a tensor made from Python values on the card, a host index
           into a card tensor). From pageable host memory PyTorch copies
           synchronously, so the host also waits for the card's stream
           to drain there.
  d2h    - an operation that makes the host wait for a card result:
           .cpu()/.numpy()/.item()/.tolist(), int()/bool()/float() of a
           card tensor, an op whose output size depends on the data
           (nonzero, unique, boolean-mask indexing), indexing with a 0-d
           card tensor.
  sync   - an explicit wait: torch.cuda.synchronize, the step timer's
           own included.
  kernel - launches of the repo's own CUDA kernels, read from the
           ops.nn_kernels.LAUNCHES* counters (not a second count); 0 on
           the CPU, where the wrappers run their plain versions.

The JAX package's `jit` and `eager` kinds have no counterpart here: in
eager PyTorch every op is a launch enqueued without a wait, so there is
no program dispatch to count apart from the ops themselves. `total` is
h2d + d2h + sync, the round trips, and is the same on the CPU and the
card; `kernel` stands beside it.

The count is process-wide and guarded by a lock: the Dither quantize pool
and the exact GOP-sharded encode's host threads (parallel.gop_exact) call
noted code. With those hosts as threads of one process, a step's delta
also counts the notes the other hosts made in the same window.

Beside the counts, span(label) is the program's one clock for its steps
and phases. A span is a torch.profiler.record_function annotation, so it
lies on the profiler's clock with the card's kernels and copies, and its
host wall time (time.perf_counter) adds into a process-wide accumulator
keyed by label, under the same lock and with the same caveat for threads
as the counts. Encoder._timed opens 'step:<name>'; a step opens
'<step>/<key>' per phase, and writes phases(step, before, keys), the
accumulator's delta over the step, into its phase dict
(metrics['dither_phases'], ...). A span measures the host: device work
that a phase only enqueues is finished, and waited for, by a later one.
With no profiler running a span costs two clock reads, the lock and
record_function's cheap path, and the program opens a few dozen a run:
none inside a per-draw, per-iteration or per-search-call loop. Save's
compression pool opens one span per (keyframe stream, encoder) job, and
Dither's quantize pool one per VAR group, on their worker threads, so
those labels' seconds add up the jobs run side by side; a profiler
started on the encode thread need not record them.
"""
from __future__ import annotations

import threading
import time

import torch

_NOTED = ('h2d', 'd2h', 'sync')
_lock = threading.Lock()
_counts = dict.fromkeys(_NOTED, 0)
_kernel_base = 0
_span_s: dict = {}


def _launches() -> int:
    from ..ops import nn_kernels as nk
    return (nk.LAUNCHES + nk.LAUNCHES_PREP + nk.LAUNCHES_AUG
            + nk.LAUNCHES_BF16 + nk.LAUNCHES_BF16_PREP + nk.LAUNCHES_KPP)


def note(kind: str, n: int = 1) -> None:
    with _lock:
        _counts[kind] += n


def reset() -> None:
    global _kernel_base
    with _lock:
        for k in _NOTED:
            _counts[k] = 0
        _kernel_base = _launches()


def snapshot() -> dict:
    with _lock:
        out = dict(_counts)
        out['kernel'] = _launches() - _kernel_base
    out['total'] = sum(out[k] for k in _NOTED)
    return out


def delta(before: dict) -> dict:
    """Interactions since `before` (a snapshot())."""
    now = snapshot()
    return {k: now[k] - before.get(k, 0) for k in now}


class span:
    """`with span(label) as s:` a phase on the host's and the profiler's
    clocks; s.seconds holds its host wall time once it has closed."""

    def __init__(self, label: str):
        self.label = label
        self.seconds = 0.0

    def __enter__(self):
        self._annotation = torch.profiler.record_function(self.label)
        self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        with _lock:
            _span_s[self.label] = _span_s.get(self.label, 0.0) + self.seconds
        self._annotation.__exit__(*exc)
        return False


def spans() -> dict:
    """Host seconds per span label, summed over the process's spans."""
    with _lock:
        return dict(_span_s)


def phases(step: str, before: dict, keys) -> dict:
    """The phase dict of `step`: per key, the host seconds of the spans
    '<step>/<key>' since `before` (a spans()), to the millisecond; 0.0
    for a phase that opened no span."""
    now = spans()
    return {k: round(now.get(f'{step}/{k}', 0.0)
                     - before.get(f'{step}/{k}', 0.0), 3) for k in keys}
