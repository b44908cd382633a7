"""Benchmark of the port: end-to-end GTM encode throughput at 1080p on one
CUDA card, against a run of the same pipeline on the host's CPU, as the
JAX package's benchmark script measures it on its TPU:

    python -m tiler_tpu_torch.bench

The headline clip is cuts_v2 (tools/common.synthetic_clip_v2: three
scenes, a ~38%-static band) at 16 frames, 128 palettes x 16 colours.
An untimed warm-up encode at the same shapes builds the kernels and the
CUDA context; then TILER_BENCH_RUNS timed encodes (default 5), each on a
fresh Encoder, the host clock around Encoder.run_all (which synchronizes
the device after each step). Every timed run must write the warm-up's
bytes and make the first timed run's host<->card round trips
(metrics['dispatches'], utils.dispatch), or the bench raises. The
headline `value` is the median of the runs' frames/s, and every run is
listed. PSNR is the stream decoded by
the numpy decoder against the source frames.

The CPU baseline is a child process of this module with
TILER_BENCH_CPU=1 and no CUDA card visible: F_CPU frames of the same
clip on the CPU, normalized per frame (fixed costs amortize over fewer
frames, so cpu_fps is understated and vs_baseline overstated). When it
fails, times out or is switched off, `vs_baseline` is null and
`baseline_error` says why. The noise clip of rounds 1-4
(tools/common.synthetic_clip) rides along once as the `continuity`
entry, and the reference's 300-frame city_cif demo stream, decoded and
re-encoded, as `real_content` when the repository holds that file
(REF, docs/demo/city_cif.gtm).

Prints the full JSON line, then a compact headline as the last line, so
that a reader of the output's tail always has it. Every number stands
beside `card`, the line `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` prints. Without a CUDA card it exits non-zero,
unless TILER_BENCH_CPU=1 asks for the CPU.

Environment: TILER_BENCH_SMALL=1 -> the 320x240 clip at 32 palettes;
TILER_BENCH_RUNS=N -> timed runs for the median; TILER_BENCH_NO_CPU=1,
TILER_BENCH_NO_REAL=1, TILER_BENCH_NO_CONT=1 -> skip the baseline, the
real-content or the continuity entry; TILER_BENCH_DEVICES=N (N>1, a
power of two) -> encode on a mesh of the first N cards;
TILER_BENCH_REAL_FRAMES=N -> the first N frames of the real-content
clip only; TILER_BENCH_CPU=1 -> the baseline run itself.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import EncoderConfig
from .decode import decode_video
from .ops import nn_kernels
from .ops.stats import psnr
from .parallel.mesh import make_mesh
from .parallel.mesh_pipeline import mesh_ok
from .pipeline.encoder import Encoder
from .tools.common import synthetic_clip, synthetic_clip_v2

SMALL = os.environ.get('TILER_BENCH_SMALL') == '1'
H, W, F = (240, 320, 16) if SMALL else (1080, 1920, 16)
# the CPU baseline: fewer frames, the same per-frame work
F_CPU = 8 if SMALL else 2
PAL = 32 if SMALL else 128

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference project's published demo stream (300 frames of 352x288 at
# 30 fps), at the place it takes in this repository once committed; the
# bench reads nothing outside its own checkout
REF = os.path.join(ROOT, 'docs', 'demo', 'city_cif.gtm')
CPU_TIMEOUT_S = 1200


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


def _psnr(decoded: np.ndarray, frames: np.ndarray) -> float:
    p = psnr(decoded, frames)
    return round(p, 3) if np.isfinite(p) else 99.0


def _bench_mesh():
    """TILER_BENCH_DEVICES=N (N>1, a power of two): encode on a mesh of
    the first N CUDA cards. Fewer cards, or N not a power of two, exits:
    a silent single-device fallback would mislabel the scaling numbers."""
    n = int(os.environ.get('TILER_BENCH_DEVICES', '1'))
    if n <= 1:
        return None
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > avail:
        raise SystemExit(f'TILER_BENCH_DEVICES={n}: only {avail} '
                         f'device(s) available')
    mesh = make_mesh(n)
    if not mesh_ok(mesh):
        raise SystemExit(f'TILER_BENCH_DEVICES={n}: must be a power of '
                         'two (a silent single-device fallback would '
                         'mislabel the scaling numbers)')
    return mesh


def _timed_encode(frames, cfg, fps, device, mesh=None):
    """One encode on a fresh Encoder, timed by the host clock: (frames/s,
    encoder, stream, record). The record holds the wall, K1's and its
    prepare's launches, the peak device memory of the cards used (None
    off a card), the stream's SHA-256 and the per-step round trips. The encoder's device tensors
    are released before it returns, so that no later run's peak counts
    them; its step times and metrics stay."""
    cards = []
    if torch.device(device).type == 'cuda':
        cards = sorted({d.index for d in mesh.flat}) if mesh is not None \
            else [torch.device(device).index or 0]
    if cards:
        torch.cuda.init()   # the peak counters exist once CUDA is set up
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    nn_kernels.LAUNCHES = nn_kernels.LAUNCHES_PREP = 0
    enc = Encoder(cfg, device, mesh=mesh)
    t0 = time.perf_counter()
    blob = enc.run_all(frames, fps=fps, fast_lzma=True)
    dt = time.perf_counter() - t0
    rec = {'wall_s': dt, 'k1_launches': nn_kernels.LAUNCHES,
           'k1_prepare_launches': nn_kernels.LAUNCHES_PREP,
           'peak_bytes': max((torch.cuda.max_memory_allocated(c)
                              for c in cards), default=None),
           'sha256': hashlib.sha256(blob).hexdigest(),
           'dispatches': enc.state.metrics['dispatches']}
    enc.state.release_device()
    return len(frames) / dt, enc, blob, rec


def _encode_runs(frames, cfg, fps, device, mesh, warm: bool, runs: int):
    """An untimed warm-up encode (with `warm`), then `runs` timed ones
    (_timed_encode). Returns (frames/s per run, the last run's encoder,
    its stream, the per-run records). Raises if a run's stream differs
    from the warm-up's (without one, from the first run's), or its round
    trips from the first timed run's. The warm-up's round trips are the
    first record's `warmup_dispatches` where they differ."""
    want = warm_dispatches = None
    if warm:
        _, _, want, rec = _timed_encode(frames, cfg, fps, device, mesh)
        warm_dispatches = rec['dispatches']
    all_fps, recs = [], []
    for _ in range(max(runs, 1)):
        fps_run, enc, blob, rec = _timed_encode(frames, cfg, fps, device,
                                                mesh)
        want = blob if want is None else want
        if blob != want:
            raise RuntimeError(
                f'timed run {len(recs)} wrote {len(blob)} bytes '
                f'({rec["sha256"][:16]}), not the {len(want)} bytes of '
                f'the first encode ({hashlib.sha256(want).hexdigest()[:16]})')
        if recs and rec['dispatches'] != recs[0]['dispatches']:
            raise RuntimeError(
                f'timed run {len(recs)} made the round trips '
                f'{rec["dispatches"]}, not the first timed run\'s '
                f'{recs[0]["dispatches"]}')
        all_fps.append(fps_run)
        recs.append(rec)
    if warm_dispatches not in (None, recs[0]['dispatches']):
        recs[0]['warmup_dispatches'] = warm_dispatches
    return all_fps, enc, blob, recs


def encode_once(frames, warm: bool = True, runs: int = 1, device='cuda'):
    """The headline's encodes (_encode_runs) at PAL palettes x 16
    colours, fps 24, fast LZMA, on `device` (a mesh of cards under
    TILER_BENCH_DEVICES)."""
    cfg = EncoderConfig(palette_count=PAL, tile_palette_size=16)
    mesh = _bench_mesh() if torch.device(device).type == 'cuda' else None
    return _encode_runs(frames, cfg, 24.0, device, mesh, warm, runs)


def _phases(st) -> dict:
    return {'dither': st.metrics.get('dither_phases'),
            'global_tiling': st.metrics.get('gt_phases'),
            'frame_tiling': st.metrics.get('ft_phases')}


def _dispatch_total(st) -> int:
    """The encode's host<->card round trips (h2d + d2h + sync) over every
    step (utils.dispatch)."""
    d = st.metrics.get('dispatches') or {}
    return sum(v.get('total', 0) for v in d.values())


def _port_keys(st, recs: list) -> dict:
    """The round trips, as the JAX package's bench prints its tunnel
    counter (n_dispatches, per-step dispatches; the warm-up's beside them
    where they differ), and what the port records in place of its other
    tunnel counters: stage 3's 1-NN calls and, per timed run, K1's and
    its prepare's launches, the peak device memory and the stream's
    SHA-256."""
    warm = {'warmup_dispatches': recs[0]['warmup_dispatches']} \
        if 'warmup_dispatches' in recs[0] else {}
    return {'n_dispatches': _dispatch_total(st),
            'dispatches': st.metrics.get('dispatches'), **warm,
            'ft_nn_calls': st.metrics.get('ft_nn_calls'),
            'k1_launches': [r['k1_launches'] for r in recs],
            'k1_prepare_launches': [r['k1_prepare_launches'] for r in recs],
            'peak_bytes': [r['peak_bytes'] for r in recs],
            'sha256': [r['sha256'] for r in recs]}


def real_content_entry(ref_path: str = REF, device='cuda'):
    """Re-encode the reference's own 300-frame city demo (352x288 at 30
    fps) at 64 palettes x 16 colours, the real-content configuration:
    a warm-up encode of the full clip, then one timed. None when the
    stream is absent or TILER_BENCH_NO_REAL=1."""
    if not os.path.exists(ref_path) or \
            os.environ.get('TILER_BENCH_NO_REAL') == '1':
        return None
    with open(ref_path, 'rb') as fh:
        src = fh.read()
    frames, _ = decode_video(src)
    n = int(os.environ.get('TILER_BENCH_REAL_FRAMES', '0'))
    if n:
        frames = frames[:n]
    cfg = EncoderConfig(palette_count=64, tile_palette_size=16)
    (fps,), enc, blob, recs = _encode_runs(frames, cfg, 30.0, device, None,
                                           True, 1)
    st = enc.state
    return {
        'metric': 'encode_city_cif_300f',
        'wall_s': round(recs[0]['wall_s'], 2),
        'fps': round(fps, 3),
        'psnr': _psnr(decode_video(blob)[0], frames),
        'gtm_bytes': len(blob),
        'ref_gtm_bytes': len(src),
        'n_keyframes': st.metrics.get('n_keyframes'),
        'ft_q_changed_frac': st.metrics.get('ft_q_changed_frac'),
        'ft_pair_dedup': st.metrics.get('ft_pair_dedup'),
        'step_times': {k: round(v, 2) for k, v in st.step_times.items()},
        'phases': _phases(st),
        'mesh_sharded_wall': st.metrics.get('mesh_sharded_wall'),
        **_port_keys(st, recs),
    }


def continuity_entry(device='cuda'):
    """One timed run of the single-scene noise clip of rounds 1-4, after
    its own warm-up, so that the headline clip's switch stays comparable
    across rounds. None when TILER_BENCH_NO_CONT=1."""
    if os.environ.get('TILER_BENCH_NO_CONT') == '1':
        return None
    frames = synthetic_clip(F, H, W)
    all_fps, enc, blob, recs = encode_once(frames, runs=1, device=device)
    return {
        'metric': f'encode_fps_{W}x{H}_noise16_r1_clip',
        'fps': round(all_fps[0], 3),
        'step_times': {k: round(v, 2)
                       for k, v in enc.state.step_times.items()},
        'psnr': _psnr(decode_video(blob)[0], frames),
        'gtm_bytes': len(blob),
        **_port_keys(enc.state, recs),
    }


def cpu_baseline() -> dict:
    """The CPU baseline: this module with TILER_BENCH_CPU=1 in a child
    process, run from the repository root with no CUDA card visible.
    Returns cpu_fps (None when the child gave none), the child's wall
    seconds and, when it gave none, the reason."""
    if os.environ.get('TILER_BENCH_NO_CPU') == '1':
        return {'cpu_fps': None, 'wall_s': None,
                'error': 'skipped: TILER_BENCH_NO_CPU=1'}
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, TILER_BENCH_CPU='1', CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=ROOT + (os.pathsep + path if path else ''))
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, '-m', 'tiler_tpu_torch.bench'],
                             env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=CPU_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {'cpu_fps': None, 'wall_s': time.perf_counter() - t0,
                'error': f'timed out after {CPU_TIMEOUT_S} s'}
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        return {'cpu_fps': None, 'wall_s': wall,
                'error': f'exit {out.returncode}: {out.stderr[-300:]}'}
    for line in out.stdout.splitlines():
        if line.startswith('{') and 'cpu_fps' in line:
            return {'cpu_fps': json.loads(line)['cpu_fps'], 'wall_s': wall,
                    'error': None}
    return {'cpu_fps': None, 'wall_s': wall,
            'error': f'no cpu_fps line in: {out.stdout[-300:]}'}


def report(all_fps, st, blob, recs, psnr_db, baseline, real, continuity,
           card: str, device_type: str) -> tuple[dict, dict]:
    """Print the full JSON line, then the compact headline as the last
    line; return both. st is the last timed run's EncoderState; baseline
    is cpu_baseline()'s result."""
    fps = float(np.median(all_fps))
    metric = f'encode_fps_{W}x{H}_{device_type}'
    vs = round(fps / baseline['cpu_fps'], 3) if baseline['cpu_fps'] \
        else None
    runs_fps = [round(v, 3) for v in all_fps]
    full = {
        'metric': metric,
        'value': round(fps, 3),
        'unit': 'frames/s',
        'clip': 'cuts_v2',
        'runs_fps': runs_fps,
        'vs_baseline': vs,
        'psnr': psnr_db,
        'gtm_bytes': len(blob),
        'real_content': real,
        'continuity': continuity,
        'step_times': {k: round(v, 2) for k, v in st.step_times.items()},
        'phases': _phases(st),
        'ft_pair_dedup': st.metrics.get('ft_pair_dedup'),
        'ft_q_changed_frac': st.metrics.get('ft_q_changed_frac'),
        'mesh_sharded_wall': st.metrics.get('mesh_sharded_wall'),
        **_port_keys(st, recs),
        'runs_wall_s': [round(r['wall_s'], 3) for r in recs],
        'cpu_fps': baseline['cpu_fps'],
        'baseline_wall_s': baseline['wall_s'],
        'baseline_error': baseline['error'],
        'card': card,
    }
    headline = {
        'metric': metric,
        'value': round(fps, 3),
        'unit': 'frames/s',
        'clip': 'cuts_v2',
        'vs_baseline': vs,
        'runs_fps': runs_fps,
        'psnr': psnr_db,
        'n_keyframes': st.metrics.get('n_keyframes'),
        'q_changed': st.metrics.get('ft_q_changed_frac'),
        'load_s': round(st.step_times.get('load', 0.0), 2),
        'quantize_s': round((st.metrics.get('dither_phases') or {})
                            .get('quantize', 0.0), 2),
        'real_wall_s': real.get('wall_s') if real else None,
        'real_fps': real.get('fps') if real else None,
        'continuity_fps': continuity.get('fps') if continuity else None,
        'card': card,
    }
    print(json.dumps(full))
    print(json.dumps(headline), flush=True)
    return full, headline


def wall_entry(f: int, h: int, w: int, tag: str, warm: bool,
               device='cuda') -> dict:
    """The 720p and 1080p tools' measurement: one timed encode of the
    noise clip at f x h x w, 128 palettes x 16 colours, after an untimed
    one with `warm` (_encode_runs: the timed run must write the warm-up's
    bytes). Prints one JSON line (wall, fps, PSNR, bytes, step and phase
    times, the card) and returns it."""
    frames = synthetic_clip(f, h, w)
    cfg = EncoderConfig(palette_count=128, tile_palette_size=16)
    (fps,), enc, blob, recs = _encode_runs(frames, cfg, 24.0, device, None,
                                           warm, 1)
    st = enc.state
    out = {
        'metric': f'encode_{tag}_wall_s' + ('_warm' if warm else ''),
        'value': round(recs[0]['wall_s'], 1),
        'fps': round(fps, 4),
        'psnr': _psnr(decode_video(blob)[0], frames),
        'gtm_bytes': len(blob),
        'step_times': {k: round(v, 1) for k, v in st.step_times.items()},
        'dither_phases': st.metrics.get('dither_phases'),
        'ft_phases': st.metrics.get('ft_phases'),
        'gt_phases': st.metrics.get('gt_phases'),
        'ft_knn_sizes': st.metrics.get('ft_knn_sizes'),
        'card': card_line(device),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    if os.environ.get('TILER_BENCH_CPU') == '1':
        frames = synthetic_clip_v2(F_CPU, H, W)
        all_fps, _, _, _ = encode_once(frames, warm=False, device='cpu')
        print(json.dumps({'cpu_fps': all_fps[0]}))
        return
    if not torch.cuda.is_available():
        raise SystemExit('tiler_tpu_torch.bench: no CUDA card; the bench '
                         'measures the port on a card (TILER_BENCH_CPU=1 '
                         'runs the CPU baseline alone)')
    card = card_line('cuda')
    frames = synthetic_clip_v2(F, H, W)
    runs = int(os.environ.get('TILER_BENCH_RUNS', '5'))
    all_fps, enc, blob, recs = encode_once(frames, runs=runs)
    psnr_db = _psnr(decode_video(blob)[0], frames)
    baseline = cpu_baseline()
    real = real_content_entry()
    continuity = continuity_entry()
    report(all_fps, enc.state, blob, recs, psnr_db, baseline, real,
           continuity, card, 'cuda')


if __name__ == '__main__':
    main()
