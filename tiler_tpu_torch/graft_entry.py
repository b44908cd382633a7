"""Compile-check entry points of the port: the counterpart of
__graft_entry__.py.

entry(device): the flagship forward step and its example arguments, the
FrameTiling hot loop: PsyV features of source tiles, then an exact 1-NN
over a candidate feature set through nn_kernels.nearest_1 (the K1 kernel
on a CUDA tensor, after one nn1_prepare launch; its plain version on the
CPU). The step is eager: no torch.compile, no torch.jit.

dryrun_multichip(n, devices): the real Encoder.run_all on an n-shard
('gop','frame') mesh with config.mesh_kmodes (the sharded FrameTiling,
dither, smooth and KModes stages, parallel.mesh_pipeline) on a tiny
two-scene clip; the stream must equal the 1-device encode's byte for
byte. Without `devices` the mesh is the first n CUDA cards, or n logical
shards of cuda:0 when there are fewer cards; it is never put on the CPU
unless `devices` names it.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .config import EncoderConfig
from .ops import features, nn_kernels
from .parallel.mesh import make_mesh
from .pipeline.encoder import Encoder
from .pipeline.state import resolve_device


def _dryrun_clip():
    """Tiny two-scene clip: a hard cut (two keyframes → per-keyframe
    candidate sets) and a static half after the cut (temporal query dedup
    → the sharded gather path)."""
    rng = np.random.default_rng(0)
    f, h, w = 6, 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((f, h, w, 3), np.uint8)
    for i in range(f):
        if i < 3:
            pat = ((xx * 4 + i * 7) % 256)[..., None] * np.array([1, .7, .4])
        else:
            pat = ((yy * 5 + (i - 3) * 9) % 256)[..., None] \
                * np.array([.3, .5, 1])
        frames[i] = np.clip(pat + rng.normal(0, 5, (h, w, 3)), 0, 255)
    frames[4:, :, : w // 2] = frames[3, :, : w // 2]
    return frames


def entry(device='cuda'):
    """(ft_forward, example_args). ft_forward(src_tiles_u8 [256,8,8,3]
    uint8, cand_feats [512,192] float32) -> (idx [256] int32, err [256]
    float32): per source tile's PsyV feature q (wavelets on) the first
    argmin and the minimum over the candidates c of |q|^2 + |c|^2 -
    2 q.c. The arguments are the JAX entry's arrays from
    np.random.default_rng(0), as tensors on `device` (a card unless the
    caller names the CPU)."""
    dev = resolve_device(device)
    n_tiles, n_cand = 256, 512

    def ft_forward(src_tiles_u8, cand_feats):
        q = features.psyv_features_rgb(src_tiles_u8, use_wavelets=True)
        return nn_kernels.nearest_1(q, cand_feats)

    rng = np.random.default_rng(0)
    example_args = (
        torch.from_numpy(rng.integers(0, 256, (n_tiles, 8, 8, 3))
                         .astype(np.uint8)).to(dev),
        torch.from_numpy(rng.normal(0, 1, (n_cand, 192))
                         .astype(np.float32)).to(dev),
    )
    return ft_forward, example_args


def dryrun_multichip(n_devices: int, devices=None) -> bytes:
    """Encode _dryrun_clip() on an n_devices-shard mesh with mesh_kmodes
    and on its first device alone; raise unless the two streams are
    equal, the clip gave two keyframes or more and some queries were
    unchanged. Prints one OK line and returns the stream."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('dryrun_multichip: torch finds no CUDA '
                               'device (name devices= to run elsewhere)')
        n_cards = torch.cuda.device_count()
        devices = ([torch.device('cuda', i) for i in range(n_devices)]
                   if n_cards >= n_devices else ['cuda:0'] * n_devices)
    mesh = make_mesh(n_devices, devices=devices)
    if mesh.size != n_devices:
        raise ValueError(f'need {n_devices} devices, have {mesh.size}')
    frames = _dryrun_clip()
    # mesh_kmodes=True: the GlobalTiling KModes solves run distributed
    # across the mesh; without a mesh the flag does nothing, so the
    # single-device comparison encode uses the same config
    cfg = EncoderConfig(palette_count=8, tile_palette_size=16,
                        max_tiles=120, mesh_kmodes=True)
    enc = Encoder(cfg, device=mesh.flat[0], mesh=mesh)
    got = enc.run_all(frames, fast_lzma=True)
    want = Encoder(cfg, device=mesh.flat[0]).run_all(frames, fast_lzma=True)
    if got != want:
        raise AssertionError('mesh encode stream differs from the '
                             'single-device encode')
    m = enc.state.metrics
    if len(enc.state.keyframes) < 2 or not m['ft_q_changed_frac'] < 1.0:
        raise AssertionError(f'dryrun clip: {len(enc.state.keyframes)} '
                             f'keyframes, q_changed_frac '
                             f'{m["ft_q_changed_frac"]}')

    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    print(f'dryrun_multichip OK: mesh={mesh_shape}, full-pipeline encode '
          f'byte-identical to 1-device '
          f'(gtm_bytes={len(got)}, '
          f'sha256={hashlib.sha256(got).hexdigest()[:16]}, '
          f'keyframes={len(enc.state.keyframes)}, '
          f"q_changed_frac={m['ft_q_changed_frac']})")
    return got
