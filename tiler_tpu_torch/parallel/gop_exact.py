"""Cross-host-consistent GOP-sharded encode (SURVEY.md §5.8 design): the
counterpart of tiler_tpu/parallel/gop_exact.py.

The reference encoder is a single shared-memory process; its global
tileset is just an array every thread mutates (main.pas:364-390). This
module is the multi-host replacement: keyframe spans (GOPs) partition
across hosts, every per-keyframe phase (dither, frame tiling, smoothing)
runs purely host-locally, and the four global artifacts are kept
consistent with explicit collectives:

  (a) candidate-tile allgather  — each host contributes its dithered
      tiles before MakeUnique/GlobalTiling (tiles_pal u8 + dpi + use);
  (b) centroid allreduce        — KModes runs either replicated (the
      gathered set is identical on every host, and the solver is
      deterministic) or sharded across a mesh with summed integer
      category counts (sharded_ops.sharded_kmodes_batch, bit-identical);
  (c) tileset replication       — the reduced tileset broadcasts to every
      host for FrameTiling (the reference's shared kd-tree dataset);
  (d) use-count sum             — Reindex orders tiles by global use, the
      sum of per-host tilemap bincounts.

Because every global computation consumes only allgathered/summed values
and is deterministic, an N-host encode produces the byte-identical GTM
stream of the 1-host encoder (tests/test_torch_parallel.py asserts this
for 1, 2 and 3 hosts).

The encode is ONE SPMD function, `_encode_my_partition`, parameterized by
a communicator:

  - ThreadComm: in-process simulation — n_hosts lockstep threads, gathers
    through a barrier, every thread on the same device;
  - ProcessComm: real multi-process — torch.distributed (gloo) processes
    exchanging pickled host payloads with all_gather_object. Entry point:
    encode_multihost(), used by the CLI's --distributed flag.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..bitstream.gtm import GTMWriter
from ..constants import (MAX_TILEMAP_H, MAX_TILEMAP_W, TILE_W,
                         equal_quality_tile_count)
from ..pipeline.dither_step import run_dither
from ..pipeline.frame_tiling import run_frame_tiling
from ..pipeline.global_tiling import compute_global_tiling_fwd
from ..pipeline.load import detect_keyframes
from ..pipeline.reindex import compute_reindex
from ..pipeline.smooth import run_smooth
from ..pipeline.unique import compute_unique_fwd
from .distributed import assign_gops_to_hosts
from .mesh import check_device

# seconds a host waits at a gather for the others before the encode fails
BARRIER_TIMEOUT = 1800.0


# ---------------------------------------------------------------------------
# communicators

class ThreadComm:
    """Barrier-based allgather between n_hosts lockstep threads; a wait
    longer than `timeout` seconds breaks the barrier for every host."""

    def __init__(self, n_hosts: int, timeout: float = BARRIER_TIMEOUT):
        self.n_hosts = n_hosts
        self._slots = [None] * n_hosts
        self._barrier = threading.Barrier(n_hosts, timeout=timeout)

    def allgather(self, host: int, payload):
        self._slots[host] = payload
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()   # everyone has read before next round writes
        return out

    def abort(self):
        self._barrier.abort()


class ProcessComm:
    """torch.distributed-backed allgather of arbitrary (ragged) host
    payloads: all_gather_object pickles each one, gathers the sizes and
    then the size-padded bytes (the JAX package's process_allgather
    steps), in the process group that parallel.distributed
    .init_distributed made, whose timeout bounds each gather. Without a
    group the process is a job of one."""

    def __init__(self):
        import torch.distributed as dist
        self._joined = dist.is_available() and dist.is_initialized()
        self.n_hosts = dist.get_world_size() if self._joined else 1
        self.rank = dist.get_rank() if self._joined else 0

    def allgather(self, host: int, payload):
        if not self._joined:
            return [payload]
        import torch.distributed as dist
        out = [None] * self.n_hosts
        dist.all_gather_object(out, payload)
        return out


# ---------------------------------------------------------------------------
# per-host partition state

@dataclasses.dataclass
class HostPartition:
    """One host's shard of the encode: its GOPs' frames + tilemaps.

    g_frame[f_local] = global frame number; tile indices inside tm_* are
    LOCAL until _to_global_tiles() after the dither phase, GLOBAL after."""
    kf_ids: np.ndarray          # global keyframe indices owned (sorted)
    g_frame: np.ndarray         # [F_local] global frame numbers
    state: object               # pipeline.state.EncoderState (local)


def _build_partition(frames, config, fps, keyframes, owner, my_host,
                     device='cuda'):
    from ..pipeline.encoder import Encoder

    kf_ids = np.flatnonzero(owner == my_host)
    if kf_ids.size == 0:
        return None
    spans = keyframes[kf_ids]
    g_frame = np.concatenate(
        [np.arange(s, e + 1) for s, e in spans]).astype(np.int64)
    enc = Encoder(config, device=device)
    enc.load(frames[g_frame], fps=fps)
    # overwrite the locally re-detected keyframes with this host's shard
    # of the GLOBAL detection (local spans, concatenated order)
    sizes = spans[:, 1] - spans[:, 0] + 1
    ends = np.cumsum(sizes)
    local_kf = np.stack([ends - sizes, ends - 1], axis=1).astype(np.int32)
    st = enc.state
    st.keyframes = local_kf
    k = len(local_kf)
    st.palettes_rgb = np.zeros(
        (k, config.palette_count, config.tile_palette_size, 3), np.uint8)
    st.palette_centroids = np.zeros(
        (k, config.palette_count, 192), np.float32)
    return HostPartition(kf_ids, g_frame, st)


def _to_global_tiles(part: HostPartition, cells: int) -> None:
    """Convert tilemap tile references from local to global indexing."""
    st = part.state
    f = st.tm_tile // cells
    st.tm_tile = (part.g_frame[f] * cells
                  + st.tm_tile % cells).astype(np.int32)


def _assemble_global(payloads, cells, n_global, key, shape_tail, dtype):
    """Collective (a) consumer: frame-major GLOBAL tile array from every
    host's gathered local tiles."""
    out = np.zeros((n_global,) + shape_tail, dtype)
    for p in payloads:
        if p is None:
            continue
        local = p[key]
        for f_loc, g in enumerate(p['g_frame']):
            out[g * cells:(g + 1) * cells] = \
                local[f_loc * cells:(f_loc + 1) * cells]
    return out


# ---------------------------------------------------------------------------
# the SPMD encode

def _encode_my_partition(frames, config, my_host, n_hosts, fps, fast_lzma,
                         comm, kmodes_mesh=None, device='cuda') -> bytes:
    """One host's run of the GOP-sharded encode, its device work on
    `device`. Every host returns the identical full GTM stream (assembly
    is replicated, like the fwd-map computations; a real deployment
    writes it on process 0 only)."""
    f_total, h_px, w_px, _ = frames.shape
    th = min(h_px // TILE_W, MAX_TILEMAP_H)
    tw = min(w_px // TILE_W, MAX_TILEMAP_W)
    cells = th * tw
    frames = np.ascontiguousarray(frames[:, :th * TILE_W, :tw * TILE_W])

    # ---- phase 0 (replicated): global keyframe detection + GOP ownership
    keyframes = detect_keyframes(frames, cells)
    owner = assign_gops_to_hosts(keyframes, n_hosts)
    part = _build_partition(frames, config, fps, keyframes, owner, my_host,
                            device)

    # ---- phase 1 (host-local): dither every owned keyframe
    if part is not None:
        run_dither(part.state)
        _to_global_tiles(part, cells)

    # ---- phase 2: candidate-tile allgather -> global MakeUnique
    n_global = f_total * cells
    payload = None if part is None else dict(
        g_frame=part.g_frame,
        tiles_pal=part.state.tiles_pal,
        tile_dpi=part.state.tile_dpi,
        tile_use=part.state.tile_use)
    gathered = comm.allgather(my_host, payload)
    g_tiles_pal = _assemble_global(gathered, cells, n_global, 'tiles_pal',
                                   (TILE_W, TILE_W), np.uint8)
    g_dpi = _assemble_global(gathered, cells, n_global, 'tile_dpi',
                             (), np.int32)
    g_use = _assemble_global(gathered, cells, n_global, 'tile_use',
                             (), np.int64)
    g_active = np.ones(n_global, bool)

    fwd, g_use, g_active, losers = compute_unique_fwd(
        g_tiles_pal, g_active, g_use, device=device)
    g_tiles_pal[losers] = 0
    if part is not None:
        part.state.tm_tile = fwd[part.state.tm_tile].astype(np.int32)

    # ---- phase 3: global tiling (KModes) on the gathered tileset
    budget = config.max_tiles if config.max_tiles > 0 else \
        round(config.qb_tiles * equal_quality_tile_count(n_global))
    desired = min(budget, n_global)
    fwd, g_use, g_active, _merges = compute_global_tiling_fwd(
        g_tiles_pal, g_active, g_use, g_dpi, config, desired,
        mesh=kmodes_mesh, device=device)
    if part is not None:
        part.state.tm_tile = fwd[part.state.tm_tile].astype(np.int32)
    fwd, g_use, g_active, losers = compute_unique_fwd(
        g_tiles_pal, g_active, g_use, device=device)
    g_tiles_pal[losers] = 0
    if part is not None:
        part.state.tm_tile = fwd[part.state.tm_tile].astype(np.int32)

    # collective (d): sum of per-host use counts, then identical reindex
    local_use = np.zeros(n_global, np.int64) if part is None else \
        np.bincount(part.state.tm_tile.ravel(), minlength=n_global)
    use = np.sum(comm.allgather(my_host, local_use), axis=0)
    order, idx_map = compute_reindex(use)
    g_tiles_pal = g_tiles_pal[order]       # collective (c): replicate
    g_dpi = g_dpi[order]
    n_reduced = len(order)
    if part is not None:
        part.state.tm_tile = idx_map[part.state.tm_tile].astype(np.int32)

    # ---- phase 4 (host-local): FrameTiling against the replicated tileset
    if part is not None:
        st = part.state
        st.tiles_rgb = None     # no longer needed; queries use frames_rgb
        st.tiles_pal = g_tiles_pal      # drops the local device tiles
        st.tile_active = np.ones(n_reduced, bool)
        st.tile_dpi = g_dpi
        st.tile_use = np.zeros(n_reduced, np.int64)
        run_frame_tiling(st)

    # ---- phase 5: second reindex (use sum again)
    local_use = np.zeros(n_reduced, np.int64) if part is None else \
        np.bincount(part.state.tm_tile.ravel(), minlength=n_reduced)
    use = np.sum(comm.allgather(my_host, local_use), axis=0)
    order, idx_map = compute_reindex(use)
    g_tiles_pal = g_tiles_pal[order]
    n_final = len(order)
    if part is not None:
        st = part.state
        st.tm_tile = idx_map[st.tm_tile].astype(np.int32)
        st.tiles_pal = g_tiles_pal
        st.tile_active = np.ones(n_final, bool)

    # ---- phase 6 (host-local): temporal smoothing per keyframe
    if part is not None:
        run_smooth(part.state)
        part.state.release_device()

    # ---- phase 7: gather command-stream inputs, assemble ONE GTM
    kf_payload = {}
    if part is not None:
        st = part.state
        for k_loc, k in enumerate(part.kf_ids):
            ls, le = st.keyframes[k_loc]
            kf_payload[int(k)] = dict(
                palettes=st.palettes_rgb[k_loc],
                stm_tile=st.stm_tile[ls:le + 1],
                stm_pal=st.stm_pal[ls:le + 1],
                stm_h=st.stm_h[ls:le + 1],
                stm_v=st.stm_v[ls:le + 1],
                stm_smooth=st.stm_smooth[ls:le + 1])
    all_kf = {}
    for p in comm.allgather(my_host, kf_payload):
        all_kf.update(p)

    writer = GTMWriter(
        width=tw * TILE_W, height=th * TILE_W, fps=fps,
        tiles_pal=g_tiles_pal, palette_size=config.tile_palette_size,
        frame_count=f_total, kf_count=len(keyframes), fast_lzma=fast_lzma,
        lzma_mode=config.lzma_mode)
    for k, (s, e) in enumerate(keyframes):
        kf = all_kf[k]
        kf_frames = [dict(tile_idx=kf['stm_tile'][i].ravel(),
                          pal_idx=kf['stm_pal'][i].ravel(),
                          hmir=kf['stm_h'][i].ravel(),
                          vmir=kf['stm_v'][i].ravel(),
                          smoothed=kf['stm_smooth'][i].ravel())
                     for i in range(e - s + 1)]
        writer.add_keyframe(k, int(s), int(e), kf['palettes'], kf_frames)
    return writer.tobytes()


# ---------------------------------------------------------------------------
# entry points

def encode_gop_sharded_exact(frames: np.ndarray, config, n_hosts: int = 2,
                             fps: float = 24.0, fast_lzma: bool = False,
                             kmodes_mesh=None, device='cuda',
                             timeout: float = BARRIER_TIMEOUT) -> bytes:
    """In-process N-host simulation: n_hosts lockstep threads running the
    SPMD encode with barrier-backed gathers, all on `device`.
    Byte-identical to Encoder.run_all (tested). An exception in one
    thread aborts the barrier for the others and is re-raised here; a
    gather that waits longer than `timeout` seconds fails the same way."""
    from ..pipeline.encoder import resolve_device
    device = resolve_device(device)
    if kmodes_mesh is not None:
        check_device(kmodes_mesh, device)
    comm = ThreadComm(n_hosts, timeout)
    results: list = [None] * n_hosts
    errors: list = []

    def worker(h):
        try:
            results[h] = _encode_my_partition(
                frames, config, h, n_hosts, fps, fast_lzma, comm,
                kmodes_mesh=kmodes_mesh, device=device)
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)
            comm.abort()

    threads = [threading.Thread(target=worker, args=(h,), daemon=True)
               for h in range(n_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results[0]


def encode_multihost(frames: np.ndarray, config, fps: float = 24.0,
                     fast_lzma: bool = False, device='cuda') -> bytes:
    """Real multi-process encode: call from EVERY process of an
    initialized torch.distributed job (parallel.distributed
    .init_distributed). Each process encodes its GOP partition on
    `device`; gathers ride all_gather_object. Every process returns the
    identical stream; write it on process 0."""
    from ..pipeline.encoder import resolve_device
    comm = ProcessComm()
    return _encode_my_partition(frames, config, comm.rank, comm.n_hosts,
                                fps, fast_lzma, comm,
                                device=resolve_device(device))
