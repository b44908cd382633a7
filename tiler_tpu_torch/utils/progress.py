"""Step-weighted progress/ETA and the progressive external-process runner.

Progress mirrors the reference's ProgressRedraw model
(reference main.pas:3581-3631): each encoder step has a fixed
weight (cEncoderStepLen, main.pas:61) and overall completion is the
weighted share of finished steps; ETA extrapolates elapsed wall time over
the weighted fraction.

run_command is the internalRuncommand equivalent
(reference extern.pas:94-200): spawn a child, pump stdout/stderr
concurrently without blocking either pipe, optionally echoing lines live,
and return both captured streams with the exit code.
"""
from __future__ import annotations

import selectors
import subprocess
import sys
import time

# cEncoderStepLen (main.pas:61) without the leading esNone slot, keyed by
# our step names. The reference scales negative entries by keyframe count;
# its shipped table has none, so plain weights suffice.
STEP_WEIGHTS = {
    'load': 2,
    'dither': 3,
    'make_unique': 1,
    'global_tiling': 5,
    'frame_tiling': 2,
    'reindex': 2,
    'smooth': 2,
    'save': 1,
}


class StepProgress:
    """Weighted overall progress across the 8-step pipeline."""

    def __init__(self, steps=None):
        self.weights = dict(STEP_WEIGHTS if steps is None
                            else {s: STEP_WEIGHTS.get(s, 1) for s in steps})
        self.total = sum(self.weights.values())
        self.done = 0
        self.t0 = time.perf_counter()

    def finish_step(self, name: str) -> None:
        self.done += self.weights.get(name, 0)

    @property
    def fraction(self) -> float:
        return self.done / self.total if self.total else 1.0

    def eta_seconds(self) -> float | None:
        """Remaining wall time extrapolated from the weighted fraction
        (None until any weighted step has finished)."""
        if self.done == 0:
            return None
        elapsed = time.perf_counter() - self.t0
        return elapsed * (self.total - self.done) / self.done

    def format_suffix(self) -> str:
        pct = int(round(100 * self.fraction))
        eta = self.eta_seconds()
        if eta is None:
            return f'{pct:3d}%'
        m, s = divmod(int(round(eta)), 60)
        return f'{pct:3d}%  ETA: {m:d}:{s:02d}'


def run_command(argv, echo: bool = False, text: bool = True,
                timeout: float | None = None):
    """Run a child process, pumping stdout/stderr concurrently.

    Returns (exit_code, stdout, stderr). With echo=True, completed lines
    of both streams print to our stderr as they arrive (the reference
    echoes ffmpeg/lzma progress the same way)."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    sel = selectors.DefaultSelector()
    bufs = {proc.stdout: bytearray(), proc.stderr: bytearray()}
    tails = {proc.stdout: b'', proc.stderr: b''}
    sel.register(proc.stdout, selectors.EVENT_READ)
    sel.register(proc.stderr, selectors.EVENT_READ)
    deadline = None if timeout is None else time.monotonic() + timeout
    open_streams = 2
    while open_streams:
        tmo = None if deadline is None else max(0.0, deadline -
                                                time.monotonic())
        events = sel.select(timeout=tmo)
        if not events:
            if deadline is not None and time.monotonic() >= deadline:
                proc.kill()
                proc.wait()
                raise subprocess.TimeoutExpired(argv, timeout)
            continue
        for key, _ in events:
            chunk = key.fileobj.read1(65536)
            if not chunk:
                sel.unregister(key.fileobj)
                open_streams -= 1
                continue
            bufs[key.fileobj] += chunk
            if echo:
                data = tails[key.fileobj] + chunk
                *lines, tails[key.fileobj] = data.split(b'\n')
                for ln in lines:
                    print(ln.decode('utf-8', 'replace'), file=sys.stderr)
    code = proc.wait()
    out, err = bytes(bufs[proc.stdout]), bytes(bufs[proc.stderr])
    if text:
        return code, out.decode('utf-8', 'replace'), \
            err.decode('utf-8', 'replace')
    return code, out, err
