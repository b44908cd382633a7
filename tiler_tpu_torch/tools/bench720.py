"""720p encode benchmark, the scale point between the CIF clip and the
reference's 1080p cap:

    python -m tiler_tpu_torch.tools.bench720 [--warm] [--device cuda]

The noise clip (tools/common.synthetic_clip) at 24 x 720 x 1280, the
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

F, H, W = 24, 720, 1280


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='bench720')
    ap.add_argument('--warm', action='store_true')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    return bench.wall_entry(F, H, W, '720p24', a.warm,
                            device_from(a.device))


if __name__ == '__main__':
    main()
