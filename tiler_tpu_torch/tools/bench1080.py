"""1080p encode benchmark, the north-star resolution (the reference caps
its tilemap at 1920x1080):

    python -m tiler_tpu_torch.tools.bench1080 [--warm] [--device cuda]

The noise clip (tools/common.synthetic_clip) at 16 x 1080 x 1920, the
reference's default quality point (128 palettes x 16 colours, Knoll
dithering, FT Medium), fast LZMA. --warm runs an untimed encode first.
Prints one JSON line (bench.wall_entry): wall, fps, PSNR, bytes, step
and phase times, and the card's name and power limit. --device defaults
to cuda and fails without a card.
"""
from __future__ import annotations

import argparse

from .. import bench
from .common import device_from

F, H, W = 16, 1080, 1920


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='bench1080')
    ap.add_argument('--warm', action='store_true')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    return bench.wall_entry(F, H, W, '1080p16', a.warm,
                            device_from(a.device))


if __name__ == '__main__':
    main()
