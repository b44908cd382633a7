"""One run of one benchmark cell: whole GTM encodes of tiler_tpu_torch on
one CUDA card, back to back for `--seconds`.

    python3 -m gtmbench --workload default.cuts1080 --seed 7 --seconds 51 \
        --trace 0

Set-up makes the cell's clip (the traffic file's, the same for every
seed), builds or loads the port's libraries (into build/ inside the
checkout) and warms up with a 2-frame encode at the clip's size. The
window then runs whole encodes, each on a fresh Encoder (`run_all`, whose
every step ends in a device synchronize), until `--seconds` have passed,
and at least two; the last one runs to its end. `encode_fps` is all the
window's frames over the wall from the first encode's start to the last
one's end.

Correctness is judged once the window has closed and the peak has been
read, on one more encode of the same clip under probe.Capture, whose
stream has to equal the window's to the byte. The checks, each sampled
from the run's seed: every encode wrote the first one's bytes; the first
stream parses and decodes with the benchmark's own decoder
(reference/gtm.py) to the source's frame count and size; K1's winners
for a sample of a keyframe's queries lie no further above the float64
reference's best (reference/nn.py) than the cell's limit; GlobalTiling's
clusterings of a sample of KModes bins merge at the reference solve's
cost (reference/kmodes.py); and Dither's palette grouping of a keyframe
costs no more than the reference k-means's (reference/kmeans.py) by more
than the limit, and one more Lloyd step takes off no more than its
limit.

With `--trace 1` the window runs under torch.profiler and the line
carries the per-layer metrics, the device's busy and window seconds and
the breakdown. The last line of standard output is the result; the
compared numbers, each beside its limit, are also the last lines of
standard error. Without a CUDA card, or with fewer than the cell asks
for, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import cells
from .probe import Calls, Capture
from .reference import gtm, kmeans, kmodes, nn
from .traffic import generators

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'tiler_tpu'}
PER_CALL = 128          # sampled queries per search call of the keyframe
KMODES_BINS = 4         # sampled KModes bins
WARM_FRAMES = 2
GIB = float(1 << 30)
NOT_MEASURED = 'not measured'
# end-to-end metrics that only a card gives
DEVICE_E2E = {'encode_fps', 'setup_s', 'peak_device_gib'}


@dataclasses.dataclass
class Window:
    """What the per-layer readers read (gtmbench/metrics/*.py)."""
    encodes: list         # per encode: wall_s, step_times, metrics
    frames: int           # frames over all the window's encodes
    calls: list           # (Q, C, D) of every stage-3 search call
    trace: dict | None    # trace.summarize()'s readings, None untraced
    on_card: bool


@dataclasses.dataclass
class Program:
    """What set-up made: the program's entry, the clip and the cell's
    configuration, on one device."""
    Encoder: object
    cfg: object
    save: dict
    fps: float
    frames: np.ndarray
    dev: object
    parts: dict

    @property
    def on_card(self) -> bool:
        return self.dev.type == 'cuda'

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.dev)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is a JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f'nvidia-smi failed: {exc}'


def setup(cell: cells.Cell, device: str, t_start: float) -> Program:
    """Imports, the device's context, the libraries and the clip; the
    parts' seconds go to Program.parts."""
    t = time.perf_counter()
    # the interpreter, torch's import and the cell's files, before this
    parts = {'startup_s': t - t_start}
    import tiler_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from tiler_tpu_torch import native
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.ops import nn_kernels
    from tiler_tpu_torch.pipeline.encoder import Encoder
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    parts['import_and_context_s'] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == 'cuda':
        nn_kernels.build()
    native.available()
    parts['libraries_s'] = time.perf_counter() - t
    t = time.perf_counter()
    frames = generators.make(cell.traffic)
    parts['clip_s'] = time.perf_counter() - t
    return Program(
        Encoder=Encoder,
        cfg=cells.encoder_config(EncoderConfig, cell.config['encoder']),
        save={'fast_lzma': bool(cell.config['save']['fast_lzma'])},
        fps=float(cell.traffic['fps']), frames=frames, dev=dev,
        parts=parts)


def encode(prog: Program, frames=None) -> tuple:
    """One whole encode on a fresh Encoder: (stream, record)."""
    frames = prog.frames if frames is None else frames
    enc = prog.Encoder(prog.cfg, device=prog.dev)
    t0 = time.perf_counter()
    blob = enc.run_all(frames, fps=prog.fps, **prog.save)
    wall = time.perf_counter() - t0
    st = enc.state
    rec = {'wall_s': wall, 'step_times': dict(st.step_times),
           'metrics': {k: st.metrics.get(k) for k in (
               'dispatches', 'dither_phases', 'gt_phases', 'ft_phases',
               'ft_nn_calls', 'ft_knn_sizes')},
           'keyframes': len(st.keyframes)}
    st.release_device()
    del enc, st
    return blob, rec


def capture(prog: Program, control=None) -> tuple:
    """One more encode under probe.Capture: (stream, the Capture)."""
    cap = Capture(control=control).install()
    try:
        blob, _ = encode(prog)
    finally:
        cap.uninstall()
    return blob, cap


def _k1_gap(cap: Capture, rng, seed: int, dev):
    """K1's check: 128 sampled queries of each search call of a sampled
    keyframe."""
    kfs = [kf for kf in cap.k1 if kf['queries']]
    if not kfs:
        return {'value': None, 'queries': 0, 'moved': None}
    kf = kfs[int(rng.integers(len(kfs)))]
    gen = torch.Generator(device=kf['queries'][0].device)
    gen.manual_seed(int(seed) % (1 << 63))
    qs, ws = [], []
    for q, w in zip(kf['queries'], kf['winners']):
        rows = torch.randperm(len(q), generator=gen,
                              device=q.device)[:PER_CALL]
        qs.append(q.index_select(0, rows))
        ws.append(w.index_select(0, rows))
    g, moved, n_q = nn.gap(torch.cat(qs).to(dev), kf['cands'].to(dev),
                           torch.cat(ws))
    return {'value': g, 'queries': n_q, 'moved': moved}


def _kmodes_gap(cap: Capture, rng, restarts: int, dev):
    """GlobalTiling's check: KMODES_BINS sampled bins of its solve (none
    to judge, and a gap of 0, where no bin holds more lines than its
    cluster count)."""
    if not cap.kmodes:
        return {'value': None, 'bins': 0}
    call = cap.kmodes[int(rng.integers(len(cap.kmodes)))]
    n = len(call['bins'])
    if n == 0:
        return {'value': 0.0, 'bins': 0}
    pick = rng.choice(n, size=min(KMODES_BINS, n), replace=False)
    gaps, lines = [], 0
    for i in sorted(pick.tolist()):
        sel, k, lab, win = call['bins'][i]
        x = call['sigs'][torch.from_numpy(sel).to(call['sigs'].device)]
        gaps.append(kmodes.gap(x.to(dev), k, restarts, call['m'],
                               torch.from_numpy(lab), torch.from_numpy(win)))
        lines += len(sel)
    return {'value': max(gaps), 'bins': len(gaps), 'lines': lines}


def _kmeans(cap: Capture, rng, seed: int, dev):
    """Dither's checks: the palette grouping of a sampled keyframe."""
    if not cap.kmeans:
        return {'value': None, 'rows': 0}, {'value': None}
    kf = cap.kmeans[int(rng.integers(len(cap.kmeans)))]
    x = kf['x'].to(dev)
    return ({'value': kmeans.gap(x, kf['k'], kf['labels'], seed),
             'rows': len(x)},
            {'value': kmeans.step_gain(x, kf['labels'], kf['k'])})


def judge(cell: cells.Cell, cap: Capture, seed: int, dev) -> dict:
    """The layer checks of one captured encode for `seed`, each with its
    number beside the cell's limit."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    restarts = int(cell.config['encoder'].get('kmodes_restarts', 0))
    out = {'k1_gap': _k1_gap(cap, rng, seed, dev),
           'kmodes_gap': _kmodes_gap(cap, rng, restarts, dev)}
    out['kmeans_gap'], out['kmeans_step_gain'] = _kmeans(cap, rng, seed,
                                                         dev)
    return {name: {'value': c.pop('value'), 'limit': cell.limits[name],
                   **c} for name, c in out.items()}


def passes(check: dict) -> bool:
    v = check['value']
    return v is not None and v == v and v <= check['limit']


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', control=None, t_start: float | None = None,
             log=sys.stderr) -> dict:
    """Set-up, window and checks of one run; returns the result line's
    object (and, under '_window', what the readers read). `control`, when
    given, takes the place of the program's stage-3 search."""
    t_start = time.perf_counter() if t_start is None else t_start
    prog = setup(cell, device, t_start)
    dev, parts = prog.dev, prog.parts
    on_card = prog.on_card
    probe = Calls(control=control).install()
    try:
        t = time.perf_counter()
        encode(prog, prog.frames[:WARM_FRAMES])
        gc.collect()
        prog.sync()
        parts['warmup_s'] = time.perf_counter() - t
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        probe.calls.clear()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            t = time.perf_counter()
            prof = profile(activities=acts)
            prof.__enter__()
            parts['profiler_start_s'] = time.perf_counter() - t
        blobs, recs = [], []
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        try:
            while True:
                blob, rec = encode(prog)
                t_w1 = time.perf_counter()
                blobs.append(blob)
                recs.append(rec)
                if len(recs) >= 2 and t_w1 - t_w0 >= seconds:
                    break
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        window_wall = t_w1 - t_w0
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    finally:
        probe.uninstall()

    t_checks = time.perf_counter()
    summary = None
    if prof is not None:
        from . import trace as trace_mod
        summary = trace_mod.summarize(prof)
        del prof
        if on_card and summary is None:
            raise RuntimeError('the trace holds no device operation')
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    first = blobs[0]
    t = time.perf_counter()
    blob_c, cap = capture(prog, control=control)
    capture_s = time.perf_counter() - t
    differing = sum(b != first for b in blobs[1:] + [blob_c])
    checks = {'encodes_differing': {'value': differing, 'limit': 0}}
    try:
        decoded = gtm.decode(first)
        decode_errors = int(decoded.shape != prog.frames.shape)
    except ValueError as exc:
        print(f'decode failed: {exc}', file=log)
        decoded, decode_errors = None, 1
    checks['stream_decode_errors'] = {'value': decode_errors, 'limit': 0}
    psnr = min(gtm.psnr(decoded, prog.frames), 99.0) if not decode_errors \
        else 0.0
    checks.update(judge(cell, cap, seed, dev))
    del cap
    correct = all(passes(c) for c in checks.values())
    failed = len(blobs) if decode_errors else sum(
        b != first for b in blobs[1:])

    n_frames = len(prog.frames) * len(recs)
    e2e = {'encode_fps': n_frames / window_wall, 'psnr_db': psnr,
           'stream_bytes_per_frame': len(first) / len(prog.frames),
           'peak_device_gib': peak / GIB if peak is not None else None,
           'setup_s': setup_s}
    window = Window(encodes=recs, frames=n_frames, calls=probe.calls,
                    trace=summary, on_card=on_card)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            if not on_card and m['source'] != 'program_counter':
                metrics[m['name']] = {'value': NOT_MEASURED,
                                      'unit': m['unit']}
                continue
            v = cells.reader(m['name'], cell.root)(window)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        for m in cell.end_to_end:
            v = e2e[m['name']]
            if not on_card and m['name'] in DEVICE_E2E:
                v = NOT_MEASURED
            metrics[m['name']] = {'value': v, 'unit': m['unit']}

    if on_card:
        dev_info = {'platform': 'gpu',
                    'kind': torch.cuda.get_device_name(dev),
                    'count': cell.chips, 'memory_peak_bytes': peak}
    else:
        dev_info = {'platform': dev.type, 'kind': NOT_MEASURED,
                    'count': 0, 'memory_peak_bytes': NOT_MEASURED}
    result = {'correct': correct, 'attempted': len(recs), 'failed': failed,
              'metrics': metrics, 'device': dev_info}
    if trace:
        if summary is not None:
            dev_info['busy_s'] = summary['busy_s']
            dev_info['window_s'] = summary['window_s']
            result['breakdown'] = {'device_ops': summary['device_ops'],
                                   'idle_gaps': summary['idle_gaps']}
        else:
            dev_info['busy_s'] = dev_info['window_s'] = NOT_MEASURED
    result['checks'] = checks
    result['_window'] = window
    result['_info'] = {
        'workload': cell.name, 'seed': seed, 'setup_parts_s': parts,
        'setup_s': setup_s, 'encodes': len(recs),
        'encode_walls_s': [r['wall_s'] for r in recs],
        'window_s': window_wall, 'stream_bytes': len(first),
        'keyframes': recs[0]['keyframes'],
        'candidates': recs[0]['metrics']['ft_knn_sizes'],
        'capture_encode_s': capture_s,
        'after_window_s': time.perf_counter() - t_checks,
        'sha256': hashlib.sha256(first).hexdigest()}
    return result


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The earlier line (set-up parts, the encodes' walls), the compared
    numbers beside their limits on standard error, and the result as the
    last line of standard output."""
    print(json.dumps(result['_info']), file=out, flush=True)
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]} <= {c["limit"]}', file=err)
    print(f'correct: {result["correct"]}', file=err, flush=True)
    line = {k: v for k, v in result.items() if not k.startswith('_')}
    print(json.dumps(line), file=out, flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(prog='python3 -m gtmbench',
                                description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'gtmbench: {cell.name} needs {cell.chips} CUDA card(s); '
              f'this host has {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      'cuda', t_start=t_start)
    result['_info']['card'] = card_line()
    found = forbidden_modules()
    if found:
        print(f'gtmbench: modules of JAX or its package loaded: {found}',
              file=sys.stderr)
        return 3
    emit(result)
    return 0
