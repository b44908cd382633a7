"""What the experiment tools share: the device (a card unless asked for
the CPU), a timer and PsyV features of random tiles."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import features
from ..pipeline.encoder import resolve_device


def device_from(name: str) -> torch.device:
    """The tools' --device; cuda must exist (no fallback to the CPU)."""
    import tiler_tpu_torch  # noqa: F401  (sets the TF32 switches)
    return resolve_device(name)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def time_ms(fn, dev: torch.device) -> tuple[float, object]:
    """Milliseconds of one call of fn and its result: CUDA events around
    it on a card, the host clock on the CPU."""
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b), out


def psyv_of_tiles(tiles_u8: np.ndarray, dev: torch.device) -> torch.Tensor:
    """[N,192] f32 PsyV features (wavelets on, YUV, no gamma) of [N,8,8,3]
    uint8 tiles, on dev: FrameTiling's stage-3 feature distribution.
    Converted 65536 tiles at a time to bound the float temporaries."""
    out = torch.empty((len(tiles_u8), 192), dtype=torch.float32, device=dev)
    for lo in range(0, len(tiles_u8), 1 << 16):
        t = torch.from_numpy(tiles_u8[lo:lo + (1 << 16)]).to(dev)
        out[lo:lo + (1 << 16)] = features.psyv_features_rgb(
            t, gamma_value=None, use_lab=False, use_wavelets=True)
    return out
