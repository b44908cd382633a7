"""What bf16 operands in FrameTiling's stage-3 1-NN do to the stream:

    python -m tiler_tpu_torch.tools.stage3_precision [--frames 16]
        [--height 1080] [--width 1920] [--palettes 128] [--device cuda]

Encodes the cuts_v2 clip twice with the default EncoderConfig at
--palettes palettes (fast LZMA): once as the encoder does, stage 3 through
the f32 kernel K1 (nn_kernels.prepare, nearest_1), and once with stage 3's
prepare and 1-NN replaced, in this process only, by the bf16 kernel K3
(nn_kernels.prepare_bf16, nearest_1_bf16: both operands of the dot rounded
to bf16, f32 accumulation, f32 norms), the rounding a TPU applies to f32
matmul operands at its default precision. Every other step runs the same
code in both encodes and each keyframe's candidates come out the same, so
the stage-3 winners compare query by query.

Prints one JSON object: for each run the PSNR of the stream (the numpy
decoder against the source), gtm_bytes, its SHA-256, the encode's wall
seconds, its stage-3 1-NN calls and the launches of each kernel; the
share of stage-3 queries whose winner is the same in both; K1's PSNR
less K3's; and the PSNR on record for the JAX package's encode of this
clip on its TPU. On the CPU the kernels' plain versions run. --device
defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
import types

import torch

from ..config import EncoderConfig
from ..decode import decode_video
from ..ops import nn_kernels as nk
from ..ops.stats import psnr
from ..pipeline import frame_tiling
from ..pipeline.encoder import Encoder
from .common import device_from, device_name, synthetic_clip_v2

# BENCH_r05.json: tiler_tpu's encode of the 1080p x 16 cuts_v2 clip at 128
# palettes on its TPU
TILER_TPU_PSNR = 29.282

ROUTES = {'k1': (nk.prepare, nk.nearest_1),
          'k3': (nk.prepare_bf16, nk.nearest_1_bf16)}


@contextlib.contextmanager
def stage3_through(prepare, nearest, winners: list):
    """FrameTiling's stage 3 prepares its candidates with `prepare` and
    queries them with `nearest` inside the block, each call's winners
    appended to `winners` (device tensors, no sync)."""
    def recorded(q, cands):
        idx, err = nearest(q, cands)
        winners.append(idx)
        return idx, err
    saved = frame_tiling.nn_kernels
    frame_tiling.nn_kernels = types.SimpleNamespace(
        full_chunk=nk.full_chunk, prepare=prepare, nearest_1=recorded)
    try:
        yield
    finally:
        frame_tiling.nn_kernels = saved


def _counts() -> dict:
    return {'nn1': nk.LAUNCHES, 'nn1_prepare': nk.LAUNCHES_PREP,
            'nn1_bf16': nk.LAUNCHES_BF16,
            'nn1_bf16_prepare': nk.LAUNCHES_BF16_PREP}


def encode(frames, cfg, dev, route: str) -> tuple[dict, torch.Tensor]:
    """One encode with stage 3 through `route`: its figures and the
    stage-3 winners of every query, in query order."""
    winners = []
    before = _counts()
    enc = Encoder(cfg, device=dev)
    with stage3_through(*ROUTES[route], winners):
        t0 = time.perf_counter()
        blob = enc.run_all(frames, fps=24, fast_lzma=True)
        wall = time.perf_counter() - t0
    m = enc.state.metrics
    run = {'psnr': psnr(decode_video(blob)[0], frames),
           'gtm_bytes': len(blob),
           'sha256': hashlib.sha256(blob).hexdigest(), 'wall_s': wall,
           'assign_s': m['ft_phases']['assign'],
           'ft_nn_calls': m['ft_nn_calls'],
           'launches': {k: v - before[k] for k, v in _counts().items()}}
    return run, torch.cat(winners).cpu()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='stage3_precision')
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--palettes', type=int, default=128)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    dev = device_from(a.device)
    frames = synthetic_clip_v2(a.frames, a.height, a.width)
    cfg = EncoderConfig(palette_count=a.palettes)
    runs, winners = {}, {}
    for route in ROUTES:
        runs[route], winners[route] = encode(frames, cfg, dev, route)
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    same = winners['k1'] == winners['k3']
    out = {'tool': 'stage3_precision', 'device': device_name(dev),
           'frames': list(frames.shape[:3]), 'palettes': a.palettes,
           **runs, 'stage3_queries': int(same.numel()),
           'winner_agreement': same.double().mean().item(),
           'psnr_drop_db': runs['k1']['psnr'] - runs['k3']['psnr'],
           'tiler_tpu_psnr_of_record': TILER_TPU_PSNR}
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
    sys.exit(0)
