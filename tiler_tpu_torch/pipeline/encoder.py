"""Encoder orchestrator: the counterpart of tiler_tpu/pipeline/encoder.py.

Runs Load -> Dither -> MakeUnique -> GlobalTiling -> FrameTiling ->
Reindex -> Smooth -> Save on one device, honouring the config's
start/end steps, with the JAX package's `step_times` and metric keys.
Each step's time ends with a device synchronize, so it is the step's
wall time on the card and not its enqueue time.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import EncoderConfig
from ..constants import ENCODER_STEPS, equal_quality_tile_count
from ..utils.progress import StepProgress

from .state import EncoderState


def resolve_device(device) -> torch.device:
    """torch.device from a name; a CUDA device must exist (the port never
    falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but torch finds no CUDA '
                           'device')
    return dev


class Encoder:
    def __init__(self, config: EncoderConfig | None = None, device='cuda'):
        self.config = config or EncoderConfig()
        self.device = resolve_device(device)
        self.state = EncoderState(config=self.config, device=self.device)
        first = ENCODER_STEPS.index(self.config.start_step)
        last = ENCODER_STEPS.index(self.config.end_step)
        self.progress = StepProgress(ENCODER_STEPS[first:last + 1])

    # -- individual steps ---------------------------------------------------

    def load(self, frames: np.ndarray, fps: float | None = None):
        from .load import run_load
        return self._timed('load', run_load, self.state, frames, fps)

    def dither(self):
        from .dither_step import run_dither
        return self._timed('dither', run_dither, self.state)

    def make_unique(self):
        from .unique import run_make_unique
        return self._timed('make_unique', run_make_unique, self.state)

    def global_tiling(self):
        from .global_tiling import run_global_tiling
        return self._timed('global_tiling', run_global_tiling, self.state)

    def frame_tiling(self):
        from .frame_tiling import run_frame_tiling
        return self._timed('frame_tiling', run_frame_tiling, self.state)

    def reindex(self):
        from .reindex import run_reindex
        return self._timed('reindex', run_reindex, self.state)

    def smooth(self):
        from .smooth import run_smooth
        return self._timed('smooth', run_smooth, self.state)

    def save(self, fast_lzma: bool = False) -> bytes:
        from .save import run_save
        return self._timed('save', run_save, self.state, fast_lzma)

    # -- drivers ------------------------------------------------------------

    def max_tiles(self) -> int:
        cfg = self.config
        raw = self.state.n_frames * self.state.tilemap_size
        if cfg.max_tiles > 0:
            return min(cfg.max_tiles, raw)
        return min(round(cfg.qb_tiles * equal_quality_tile_count(raw)), raw)

    def run_all(self, frames: np.ndarray, fps: float | None = None,
                fast_lzma: bool = False, step_hook=None) -> bytes:
        """Full pipeline Load..Save honouring start/end step config.
        step_hook: optional callable(step_name) invoked after each
        completed step."""
        first = ENCODER_STEPS.index(self.config.start_step)
        last = ENCODER_STEPS.index(self.config.end_step)
        blob = b''
        for step in ENCODER_STEPS[first:last + 1]:
            if step == 'load':
                self.load(frames, fps)
            elif step == 'save':
                blob = self.save(fast_lzma=fast_lzma)
            else:
                getattr(self, step)()
            if step_hook is not None:
                step_hook(step)
        return blob

    # -- internals ----------------------------------------------------------

    def _timed(self, name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.state.step_times[name] = time.perf_counter() - t0
        self._report(name)
        return result

    def _report(self, name):
        t = self.state.step_times[name]
        total = sum(self.state.step_times.values())
        self.progress.finish_step(name)
        print(f'Step: {name:<14} Time: {t:8.3f}  All: {total:8.3f}  '
              f'{self.progress.format_suffix()}')
