"""Wall and phase times of warm batch encodes on the card:

    python -m tiler_tpu_torch.tools.time_encode [--runs 2] [--frames 16]
        [--height 1080] [--width 1920] [--palettes 128] [--tag NAME]

Encodes the cuts_v2 clip once untimed (builds, CUDA context), then
`--runs` more times with Encoder.run_all (fast_lzma, the default
EncoderConfig at `--palettes` palettes). Prints the card's name and
power limit, then one JSON object per timed run: its wall, step_times,
the Dither, GlobalTiling and FrameTiling phases, the stream's bytes and
their SHA-256, the peak device memory and the K1 launches. Run it in two
checkouts within one session to compare them on one card. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import torch

from ..config import EncoderConfig
from ..ops import nn_kernels
from ..pipeline.encoder import Encoder
from .common import synthetic_clip_v2


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog='time_encode')
    ap.add_argument('--runs', type=int, default=2)
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--palettes', type=int, default=128)
    ap.add_argument('--tag', default='')
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('time_encode needs a cuda device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    frames = synthetic_clip_v2(a.frames, a.height, a.width)
    cfg = EncoderConfig(palette_count=a.palettes)
    Encoder(cfg, device='cuda').run_all(frames, fps=24, fast_lzma=True)
    out = []
    for run in range(a.runs):
        torch.cuda.reset_peak_memory_stats()
        nn_kernels.LAUNCHES = 0
        enc = Encoder(cfg, device='cuda')
        t0 = time.perf_counter()
        blob = enc.run_all(frames, fps=24, fast_lzma=True)
        wall = time.perf_counter() - t0
        m = enc.state.metrics
        rec = dict(tag=a.tag, run=run, wall_s=wall,
                   step_times=enc.state.step_times,
                   dither_phases=m.get('dither_phases'),
                   gt_phases={k: v for k, v in m['gt_phases'].items()
                              if k != 'gt_mu'},
                   ft_phases=m.get('ft_phases'),
                   gtm_bytes=len(blob),
                   sha256=hashlib.sha256(blob).hexdigest(),
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   k1_launches=nn_kernels.LAUNCHES)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == '__main__':
    main()
