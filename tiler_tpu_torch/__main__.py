"""Command line: `python -m tiler_tpu_torch encode in.npy out.gtm` and
`python -m tiler_tpu_torch decode in.gtm out.npy`.

Encode runs the port on --device (default cuda) and fails when that
device is missing; it never falls back to the CPU by itself. Decode uses
the shared numpy decoder.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _config_from_args(a):
    from tiler_tpu.config import EncoderConfig, FTQuality
    return EncoderConfig(
        tile_palette_size=a.palette_size, palette_count=a.palette_count,
        qb_tiles=a.qb_tiles, max_tiles=a.max_tiles,
        ft_quality=FTQuality[a.ft_quality.upper()],
        smoothing_strength=a.smoothing / 1000.0, fps=a.fps,
        lzma_mode=a.lzma_mode)


def cmd_encode(a) -> int:
    from .ops.stats import psnr
    from .pipeline.encoder import Encoder
    if not a.input.endswith('.npy'):
        print('error: the port reads [F,H,W,3] uint8 .npy clips',
              file=sys.stderr)
        return 2
    try:
        enc = Encoder(_config_from_args(a), device=a.device)
    except RuntimeError as e:
        print(f'error: {e} (pass --device cpu to run the port on the CPU)',
              file=sys.stderr)
        return 2
    blob = enc.run_all(np.load(a.input), fps=a.fps, fast_lzma=a.fast_lzma)
    with open(a.output, 'wb') as fh:
        fh.write(blob)
    if a.gts_out:
        from tiler_tpu.bitstream.gtm import write_gts
        n_act = int(enc.state.tile_active.sum())
        write_gts(a.gts_out, enc.state.tiles_pal[:n_act],
                  enc.config.tile_palette_size)
    metrics = {k: v for k, v in enc.state.metrics.items()
               if isinstance(v, (int, float, str, dict))}
    from tiler_tpu.decode import decode_video
    decoded, _ = decode_video(blob)
    metrics['psnr'] = round(psnr(decoded, enc.state.frames_rgb), 3)
    metrics['step_times'] = {k: round(v, 3)
                             for k, v in enc.state.step_times.items()}
    metrics['device'] = str(enc.device)
    print(json.dumps(metrics))
    return 0


def cmd_decode(a) -> int:
    from tiler_tpu.decode import decode_video
    with open(a.input, 'rb') as fh:
        frames, stream = decode_video(fh.read())
    np.save(a.output, frames)
    print(json.dumps(dict(frames=len(frames), width=stream.width,
                          height=stream.height,
                          tiles=int(stream.tiles.shape[0]))))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='tiler_tpu_torch')
    sub = ap.add_subparsers(dest='cmd', required=True)
    pe = sub.add_parser('encode', help='encode a .npy clip to GTM')
    pe.add_argument('input', help='[F,H,W,3] uint8 .npy clip')
    pe.add_argument('output', help='output .gtm path')
    pe.add_argument('--device', default='cuda')
    pe.add_argument('--palette-size', type=int, default=16)
    pe.add_argument('--palette-count', type=int, default=128)
    pe.add_argument('--qb-tiles', type=float, default=2.0)
    pe.add_argument('--max-tiles', type=int, default=0)
    pe.add_argument('--ft-quality', choices=['fast', 'medium', 'slow'],
                    default='medium')
    pe.add_argument('--smoothing', type=float, default=20.0,
                    help='temporal smoothing strength x1000')
    pe.add_argument('--fps', type=float, default=24.0)
    pe.add_argument('--lzma-mode', choices=('lc3', 'lc8', 'auto', 'best'),
                    default='auto')
    pe.add_argument('--fast-lzma', action='store_true')
    pe.add_argument('--gts-out', default=None,
                    help='also write the final tileset as GTS')
    pe.set_defaults(fn=cmd_encode)
    pd = sub.add_parser('decode', help='decode GTM to a .npy clip')
    pd.add_argument('input')
    pd.add_argument('output', help='.npy path')
    pd.set_defaults(fn=cmd_decode)
    a = ap.parse_args(argv)
    return a.fn(a)


if __name__ == '__main__':
    sys.exit(main())
