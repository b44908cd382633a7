"""Inter-step checkpointing: the counterpart of
tiler_tpu/utils/checkpoint.py.

The whole EncoderState goes into one compressed npz (`__meta__` JSON plus
the fields of pipeline.state.ARRAY_FIELDS), so any pipeline step can
resume from disk. The file format is shared with the JAX package: a
checkpoint written by either package loads in the other. Only the host
arrays are stored; the device the loaded state works on is the caller's
choice.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

from ..config import EncoderConfig, FTQuality
from ..pipeline.state import ARRAY_FIELDS, EncoderState


def checkpoint_path(path: str) -> str:
    """The on-disk name: np.savez appends .npz when absent, so every
    consumer (existence probe, cleanup, load) must use this normalized
    form or silently look at the wrong file."""
    return path if path.endswith('.npz') else path + '.npz'


def save_checkpoint(path: str, state: EncoderState) -> None:
    arrays = {}
    for f in ARRAY_FIELDS:
        # read-only snapshot: serializing must not change which side
        # (host or device) owns tiles_pal, nor drop the device tensor
        v = state.peek_tiles_pal() if f == 'tiles_pal' else getattr(state, f)
        if v is not None:
            arrays[f] = v
    cfg = dataclasses.asdict(state.config)
    cfg['ft_quality'] = int(state.config.ft_quality)
    meta = dict(config=cfg, fps=state.fps, tilemap_w=state.tilemap_w,
                tilemap_h=state.tilemap_h, step_times=state.step_times,
                metrics={k: v for k, v in state.metrics.items()
                         if isinstance(v, (int, float, str, list))})
    # atomic write: a crash mid-write (the very event --auto-checkpoint
    # recovers from) must not leave a truncated npz at the final name.
    # The tmp name is unique per writer so a stale tmp from an earlier
    # crash is never reused and two encodes sharing one --auto-checkpoint
    # path cannot clobber each other's in-flight write.
    final = checkpoint_path(path)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(final) + '.tmp.',
        suffix='.npz', dir=os.path.dirname(final) or '.')
    try:
        with os.fdopen(fd, 'wb') as fh:
            np.savez_compressed(fh, __meta__=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str, device='cuda') -> EncoderState:
    """The saved state, its arrays on the host, bound to `device` (a CUDA
    device must exist: pipeline.encoder.resolve_device)."""
    from ..pipeline.encoder import resolve_device
    dev = resolve_device(device)
    with np.load(checkpoint_path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z['__meta__']).decode())
        cfg_d = meta['config']
        cfg_d['ft_quality'] = FTQuality(cfg_d['ft_quality'])
        state = EncoderState(config=EncoderConfig(**cfg_d), device=dev)
        state.fps = meta['fps']
        state.tilemap_w = meta['tilemap_w']
        state.tilemap_h = meta['tilemap_h']
        state.step_times = dict(meta.get('step_times', {}))
        state.metrics = dict(meta.get('metrics', {}))
        for f in ARRAY_FIELDS:
            if f in z:
                setattr(state, f, z[f])
    return state
