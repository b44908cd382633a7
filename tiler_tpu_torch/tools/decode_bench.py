"""Decode throughput of a GTM stream (the "GTM decode frames/s" metric):

    python -m tiler_tpu_torch.tools.decode_bench [path.gtm] [--device cuda]

The path defaults to the reference's city_cif demo stream at its place
in the repository (common.REF, docs/demo/city_cif.gtm); a missing file is
an error that names it. Measures the numpy decoder
(native parse + numpy blit; one warm call first), the lazy player
(frames/s and the first frame's milliseconds), and the two device
renderers on --device: decode_video_torch_scan (one upload, one
download) and decode_video_torch (a frame at a time), each after a warm
call, the clock stopped after torch.cuda.synchronize() on a card. Both
renderers' frames must equal the numpy decoder's. Prints one JSON line
with the card (common.card_line) beside the rates. --device defaults to
cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..decode import decode_video, decode_video_torch, decode_video_torch_scan
from ..player import GTMPlayer
from .common import REF, card_line, device_from


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='decode_bench')
    ap.add_argument('path', nargs='?', default=REF)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    if not os.path.exists(a.path):
        raise SystemExit(f'decode_bench: no stream at {a.path}')
    dev = device_from(a.device)
    with open(a.path, 'rb') as fh:
        data = fh.read()

    decode_video(data)  # warm
    t0 = time.perf_counter()
    frames, _ = decode_video(data)
    t_np = time.perf_counter() - t0
    result = {
        'metric': 'decode_fps',
        'stream': os.path.basename(a.path),
        'frames': len(frames),
        'numpy_fps': round(len(frames) / t_np, 2),
    }
    t0 = time.perf_counter()
    n_streamed = sum(1 for _ in GTMPlayer(data).frames())
    t_pl = time.perf_counter() - t0
    result['player_fps'] = round(n_streamed / t_pl, 2)
    t0 = time.perf_counter()
    next(GTMPlayer(data).frames())
    result['player_first_frame_ms'] = round(
        (time.perf_counter() - t0) * 1000, 1)

    same = True
    for key, fn in (('torch_scan_fps', decode_video_torch_scan),
                    ('torch_fps', decode_video_torch)):
        fn(data, dev)  # warm
        t0 = time.perf_counter()
        got = fn(data, dev)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        result[key] = round(len(got) / (time.perf_counter() - t0), 2)
        same = same and np.array_equal(got, frames)
    result['same_frames'] = same
    result['device'] = dev.type
    result['card'] = card_line(dev)
    print(json.dumps(result), flush=True)
    if not same:
        raise RuntimeError(f'decode_bench: a device renderer on {dev} '
                           f'decoded {a.path} to other frames than the '
                           'numpy decoder')
    return result


if __name__ == '__main__':
    main()
