"""Multi-process orchestration and GOP sharding across hosts: the
counterpart of tiler_tpu/parallel/distributed.py.

init_distributed joins this process to a torch.distributed job (gloo:
the payloads are host numpy arrays), the counterpart of
jax.distributed.initialize. Keyframe spans (GOPs) are distributed across
`n_hosts` workers balanced by frame count. In encode_gop_sharded each
worker encodes its GOPs independently (its own tileset and palettes) and
host 0 concatenates the per-GOP command streams into one GTM (all file
I/O stays on host 0, like the reference's single writer, main.pas:4529);
here the workers run one after the other on one device, which gives the
multi-host bytes by construction. The exact shared-tileset form is
parallel.gop_exact.
"""
from __future__ import annotations

import datetime
import os

import numpy as np

# seconds a process waits to join the job, and at each gather of it
DIST_TIMEOUT = 600


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join a torch.distributed job (backend gloo) from the arguments or
    the environment (TILER_COORDINATOR=host:port, TILER_NUM_PROCESSES,
    TILER_PROCESS_ID). Rank 0 listens on the coordinator's port. No-op
    without a coordinator (a single process)."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ.get('TILER_COORDINATOR')
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ['TILER_NUM_PROCESSES'])
    if process_id is None:
        process_id = int(os.environ['TILER_PROCESS_ID'])
    if '://' not in coordinator:
        coordinator = f'tcp://{coordinator}'
    dist.init_process_group(
        'gloo', init_method=coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=DIST_TIMEOUT))


def assign_gops_to_hosts(keyframes: np.ndarray, n_hosts: int) -> np.ndarray:
    """[K] host id per keyframe, balanced by frame count (greedy)."""
    sizes = keyframes[:, 1] - keyframes[:, 0] + 1
    order = np.argsort(-sizes, kind='stable')
    load = np.zeros(n_hosts, np.int64)
    owner = np.zeros(len(keyframes), np.int32)
    for k in order:
        h = int(np.argmin(load))
        owner[k] = h
        load[h] += sizes[k]
    return owner


def encode_gop_sharded(frames: np.ndarray, config, n_hosts: int = 2,
                       fps: float = 24.0, fast_lzma: bool = True,
                       device='cuda') -> bytes:
    """GOP-sharded encode producing ONE valid GTM stream.

    The multi-host execution shape of BASELINE config #5: keyframes are
    detected globally, partitioned across `n_hosts` workers, each worker
    encodes its GOPs independently (its own tileset + palettes), and host 0
    assembles the final stream — each keyframe carries its own gtTileSet
    segment at a disjoint index range, so any GTM player decodes the
    result. In a real multi-host run each partition executes on its own
    host; here workers run sequentially in-process on `device`, which is
    bit-identical to the distributed result by construction (per-GOP
    encodes are independent).

    Trade-off vs the single-host encoder: no cross-GOP tile sharing, so
    streams are somewhat larger (documented divergence until the
    cross-host KModes allreduce lands).
    """
    from ..pipeline.encoder import Encoder
    from ..bitstream.gtm import GTMWriter

    probe = Encoder(config, device=device)
    probe.load(frames, fps=fps)
    keyframes = probe.state.keyframes
    width, height = probe.state.screen_w, probe.state.screen_h
    owner = assign_gops_to_hosts(keyframes, n_hosts)

    results = []
    for h in range(n_hosts):
        results.extend(encode_gop_partition(frames, keyframes, owner, h,
                                            config, device=device))
    results.sort(key=lambda r: r['kf_index'])

    total_tiles = sum(len(r['tiles_pal']) for r in results)
    writer = GTMWriter(width=width, height=height, fps=fps,
                       tiles_pal=None,
                       palette_size=config.tile_palette_size,
                       frame_count=len(frames), kf_count=len(results),
                       fast_lzma=fast_lzma,
                       total_tile_count=total_tiles,
                       lzma_mode=config.lzma_mode)
    offset = 0
    for r in results:
        st = r['state']
        kf_frames = []
        n_local = st.n_frames
        for f in range(n_local):
            kf_frames.append(dict(
                tile_idx=st.stm_tile[f].ravel() + offset,
                pal_idx=st.stm_pal[f].ravel(),
                hmir=st.stm_h[f].ravel(),
                vmir=st.stm_v[f].ravel(),
                smoothed=st.stm_smooth[f].ravel()))
        writer.add_keyframe(
            r['kf_index'], r['start'], r['end'], r['palettes_rgb'],
            kf_frames, tileset=(offset, r['tiles_pal']))
        offset += len(r['tiles_pal'])
    return writer.tobytes()


def encode_gop_partition(frames: np.ndarray, keyframes: np.ndarray,
                         owner: np.ndarray, my_host: int, config,
                         device='cuda'):
    """Encode only the keyframes owned by this host; returns per-KF
    (palettes, frame dicts, state metrics) ready for host-0 assembly.

    Each GOP is an independent encode (the reference's keyframes are
    self-contained except for the shared global tileset, which multi-host
    runs rebuild per GOP partition — a documented divergence until the
    cross-host KModes allreduce lands). Each returned state has given
    up its device tensors, so the card holds one GOP at a time."""
    from ..pipeline.encoder import Encoder

    results = []
    for k in np.flatnonzero(owner == my_host):
        s, e = keyframes[k]
        enc = Encoder(config, device=device)
        enc.load(frames[s:e + 1])
        # single-KF clip: force one keyframe spanning the GOP
        enc.state.keyframes = np.array([[0, e - s]], np.int32)
        enc.dither()
        enc.make_unique()
        enc.global_tiling()
        enc.frame_tiling()
        enc.reindex()
        enc.smooth()
        n_act = int(enc.state.tile_active.sum())
        enc.state.release_device()
        results.append(dict(
            kf_index=int(k), start=int(s), end=int(e),
            tiles_pal=enc.state.tiles_pal[:n_act],
            palettes_rgb=enc.state.palettes_rgb[0],
            state=enc.state))
    return results
