"""Bounded-memory streaming encode for arbitrarily long clips: the
counterpart of tiler_tpu/pipeline/stream.py.

The reference (and our batch path) loads the whole clip into RAM
(btnLoadClick, main.pas:984-1166). This module encodes a
frame ITERATOR instead: keyframes are detected online (bit-identical
boundaries — the batch detector's EWMA resets at every keyframe, so
chunked feeding changes nothing, load.keyframes_from_correlations), each
completed GOP is encoded independently, and its compressed stream is
appended to disk immediately. RAM high-water is one GOP plus one
detector chunk; the budget guard (SHOT_TRANS_MAX_TILES_PER_KF) bounds
GOP length, so memory is O(1) in clip length — on the device too: every
GOP builds its own Encoder and state, and gives up its source tiles and
device tiles before the next GOP starts (EncoderState.release_device;
FrameTiling frees its features and prepared candidates itself).

Two container modes:
  * default: each GOP carries its own tileset segment (the
    parallel.distributed.encode_gop_sharded form). Output is
    BYTE-IDENTICAL to encode_gop_sharded(frames, n_hosts=1) on the same
    frames (asserted by test); the one whole-clip datum — the total tile
    count in SET_DIMENSIONS — is resolved by keeping the FIRST GOP's
    payload raw until finalize.
  * config.reload_tileset set (the reference's ReloadPreviousTiling
    workflow, main.pas:4372-4470): every GOP maps onto that FIXED GTS
    tileset, which is emitted once and referenced globally — streaming
    regains cross-GOP tile sharing. Pass 1 typically builds the GTS from
    sampled frames with --gts-out.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from ..bitstream.gtm import (GTMKeyFrameInfo, GTMWriter,
                             build_keyframe_stream, compress_keyframe_stream)
from ..constants import (MAX_TILEMAP_H, MAX_TILEMAP_W,
                         SHOT_TRANS_AVG_FRAMES, SHOT_TRANS_GRACE_PERIOD,
                         SHOT_TRANS_HARD_THRES, SHOT_TRANS_MAX_TILES_PER_KF,
                         SHOT_TRANS_SOFT_THRES, TILE_W)


class OnlineKeyframeDetector:
    """Chunk-fed shot detection with the exact batch recurrence
    (load.keyframes_from_correlations). feed() returns the GLOBAL frame
    indices that start a new keyframe within the fed chunk."""

    def __init__(self, tilemap_size: int):
        self.tilemap_size = tilemap_size
        self._prev = None      # last frame of the previous chunk
        self._i = 0            # global index of the next frame to judge
        self._av = -1.0
        self._last_kf = 0

    def feed(self, frames: np.ndarray) -> list[int]:
        from ..ops import stats
        if len(frames) == 0:
            return []
        starts = []
        if self._prev is None:
            self._prev = frames[0]
            self._i = 1
            frames = frames[1:]
            if len(frames) == 0:
                return []
        stack = np.concatenate([self._prev[None], frames])
        # host correlations (pair-independent => chunk-invariant), same
        # implementation as the batch detect_keyframes
        corr = stats.interframe_correlations_host(stack)
        for j in range(len(frames)):
            i = self._i
            v = float(corr[j])
            if self._av == -1.0:
                self._av = v
            else:
                self._av = self._av * (1.0 - 1.0 / SHOT_TRANS_AVG_FRAMES) \
                    + v * (1.0 / SHOT_TRANS_AVG_FRAMES)
            ratio = max(0.01, v) / max(0.01, self._av)
            is_kf = (ratio < SHOT_TRANS_HARD_THRES) or \
                (ratio < SHOT_TRANS_SOFT_THRES and
                 (i - self._last_kf + 1) > SHOT_TRANS_GRACE_PERIOD) or \
                ((i - self._last_kf + 1) * self.tilemap_size
                 > SHOT_TRANS_MAX_TILES_PER_KF)
            if is_kf:
                starts.append(i)
                self._av = -1.0
                self._last_kf = i
            self._i += 1
        self._prev = frames[-1]
        return starts


def _encode_gop(config, gop_frames: np.ndarray, fps: float, device='cuda',
                mesh=None):
    """One GOP as an independent single-keyframe encode (the
    parallel.distributed.encode_gop_partition body) on `device`; mesh
    shards the frame-axis-parallel stages (byte-identical,
    parallel.mesh_pipeline) and then stands for the device. The returned
    state holds host arrays only."""
    from .encoder import Encoder
    enc = Encoder(config, device=device, mesh=mesh)
    enc.load(gop_frames, fps=fps)
    enc.state.keyframes = np.array([[0, len(gop_frames) - 1]], np.int32)
    enc.dither()
    enc.make_unique()
    enc.global_tiling()
    enc.frame_tiling()
    enc.reindex()
    enc.smooth()
    st = enc.state
    n_act = int(st.tile_active.sum())
    st.release_device()
    return st, n_act


def _stream_driver(frames_iter, out_path: str, chunk: int,
                   process_gop, finalize) -> dict:
    """Shared scaffolding for both streaming modes: chunked iteration,
    online detection on tile-grid-CROPPED frames (the batch detector
    sees cropped frames, load.run_load:175 — feeding raw pixels would
    flip boundaries near thresholds), GOP buffering, the compressed-
    stream spool NEXT TO out_path (a tmpfs /tmp would re-introduce an
    O(clip) RAM footprint), and cleanup.

    process_gop(tmp_fh, gop_frames, start, end) encodes + appends one
    GOP; finalize(tmp_path, total) assembles the final file and returns
    its metrics dict."""
    det = None
    crop = None
    buf: list[np.ndarray] = []
    buf_start = 0
    total = 0
    max_buf = 0
    tmp_fd, tmp_path = tempfile.mkstemp(
        prefix=os.path.basename(out_path) + '.streams.',
        dir=os.path.dirname(out_path) or '.')
    tmp = os.fdopen(tmp_fd, 'wb')
    try:
        it = iter(frames_iter)
        done = False
        while not done:
            chunk_frames = []
            for _ in range(chunk):
                try:
                    chunk_frames.append(np.asarray(next(it)))
                except StopIteration:
                    done = True
                    break
            if chunk_frames:
                if det is None:
                    h, w = chunk_frames[0].shape[:2]
                    th = min(h // TILE_W, MAX_TILEMAP_H)
                    tw = min(w // TILE_W, MAX_TILEMAP_W)
                    if th == 0 or tw == 0:
                        raise ValueError('input smaller than one tile')
                    det = OnlineKeyframeDetector(th * tw)
                    crop = (th * TILE_W, tw * TILE_W)
                arr = np.stack(chunk_frames)[:, :crop[0], :crop[1]]
                starts = det.feed(arr)
                buf.extend(chunk_frames)
                total += len(chunk_frames)
                max_buf = max(max_buf, len(buf))
                for s in starts:
                    process_gop(tmp, np.stack(buf[:s - buf_start]),
                                buf_start, s - 1)
                    del buf[: s - buf_start]
                    buf_start = s
        if total == 0:
            raise ValueError('streaming encode received no frames')
        if buf:
            process_gop(tmp, np.stack(buf), buf_start, total - 1)
            buf.clear()
        tmp.close()
        metrics = finalize(tmp_path, total)
        metrics['max_buffered_frames'] = max_buf
        return metrics
    finally:
        try:
            tmp.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            os.unlink(tmp_path)
        except OSError:
            pass


def _kf_info(kf_index: int, start: int, raw: bytes, comp: bytes,
             fps: float) -> GTMKeyFrameInfo:
    return GTMKeyFrameInfo(
        kf_index=kf_index, frame_index=start, raw_size=len(raw),
        compressed_size=len(comp),
        timecode_ms=int(round(1000.0 * start / fps)))


def encode_streaming(frames_iter, config, out_path: str, fps: float = 24.0,
                     fast_lzma: bool = False, chunk: int = 64,
                     device='cuda', mesh=None) -> dict:
    """Encode an iterator/iterable of [H,W,3] uint8 frames to out_path
    with bounded memory (see module docstring for the two container
    modes), every GOP on `device`, or sharded across `mesh` (stream
    bytes unchanged). Returns metrics (n_frames, n_keyframes, gtm_bytes,
    max_buffered_frames, and ft_nn_calls: the 1-NN launches of each
    GOP's FrameTiling)."""
    from .encoder import resolve_device
    device = resolve_device(device)
    if config.reload_tileset:
        return _encode_streaming_reload(frames_iter, config, out_path,
                                        fps, fast_lzma, chunk, device, mesh)
    state = dict(kf=0, tiles=0, gop0=None)
    infos: list[GTMKeyFrameInfo] = []
    kf_counts: list[int] = []
    nn_calls: list[int] = []
    dims = {}

    def process_gop(tmp, gop, start, end):
        st, n_act = _encode_gop(config, gop, fps, device, mesh)
        nn_calls.append(int(st.metrics.get('ft_nn_calls', 0)))
        dims.setdefault('w', st.screen_w)
        dims.setdefault('h', st.screen_h)
        off = state['tiles']
        frames_d = [dict(tile_idx=st.stm_tile[f].ravel() + off,
                         pal_idx=st.stm_pal[f].ravel(),
                         hmir=st.stm_h[f].ravel(),
                         vmir=st.stm_v[f].ravel(),
                         smoothed=st.stm_smooth[f].ravel())
                    for f in range(st.n_frames)]
        kf_counts.append(end - start + 1)
        if state['kf'] == 0:
            # held raw until the total tile count is known (the
            # SET_DIMENSIONS prefix lives in stream 0)
            state['gop0'] = (start, st.palettes_rgb[0], frames_d,
                             st.tiles_pal[:n_act].copy())
        else:
            raw = build_keyframe_stream(
                [], st.palettes_rgb[0], frames_d,
                (off, st.tiles_pal[:n_act]), config.tile_palette_size)
            comp = compress_keyframe_stream(raw, fast_lzma=fast_lzma,
                                            lzma_mode=config.lzma_mode)
            tmp.write(comp)
            infos.append(_kf_info(state['kf'], start, raw, comp, fps))
        state['tiles'] += n_act
        state['kf'] += 1

    def finalize(tmp_path, total):
        writer = GTMWriter(
            width=dims['w'], height=dims['h'], fps=fps, tiles_pal=None,
            palette_size=config.tile_palette_size, frame_count=total,
            kf_count=state['kf'], fast_lzma=fast_lzma,
            total_tile_count=state['tiles'], lzma_mode=config.lzma_mode)
        start0, pals0, frames0, tiles0 = state['gop0']
        raw0 = build_keyframe_stream(writer._pending, pals0, frames0,
                                     (0, tiles0), config.tile_palette_size)
        comp0 = compress_keyframe_stream(raw0, fast_lzma=fast_lzma,
                                         lzma_mode=config.lzma_mode)
        writer.kf_infos = [_kf_info(0, start0, raw0, comp0, fps)] + infos
        writer._kf_frames = kf_counts
        prefix = writer.finalize_container()
        with open(out_path, 'wb') as out:
            out.write(prefix)
            out.write(comp0)
            with open(tmp_path, 'rb') as sf:
                shutil.copyfileobj(sf, out)
        return dict(n_frames=total, n_keyframes=state['kf'],
                    gtm_bytes=os.path.getsize(out_path),
                    ft_nn_calls=nn_calls)

    return _stream_driver(frames_iter, out_path, chunk, process_gop,
                          finalize)


def _encode_streaming_reload(frames_iter, config, out_path: str,
                             fps: float, fast_lzma: bool, chunk: int,
                             device, mesh=None) -> dict:
    """Streaming encode against a FIXED global tileset (see module
    docstring): the scaled GTS is emitted once, every GOP's tilemap maps
    onto its indices, no per-GOP tileset segments."""
    from ..bitstream.gtm import emit_tileset, read_gts

    gts_tiles, gts_pal_size = read_gts(config.reload_tileset)
    scaled = (gts_tiles.astype(np.int64) * config.tile_palette_size
              // gts_pal_size).astype(np.uint8)
    lut: dict[bytes, int] = {}
    for i, row in enumerate(scaled):
        lut.setdefault(row.tobytes(), i)

    state = dict(kf=0)
    infos: list[GTMKeyFrameInfo] = []
    kf_counts: list[int] = []
    nn_calls: list[int] = []
    dims = {}

    def process_gop(tmp, gop, start, end):
        st, n_act = _encode_gop(config, gop, fps, device, mesh)
        nn_calls.append(int(st.metrics.get('ft_nn_calls', 0)))
        if not dims:
            dims['w'], dims['h'] = st.screen_w, st.screen_h
            dims['prefix'] = [emit_tileset(
                scaled, config.tile_palette_size,
                st.tilemap_w, st.tilemap_h, fps)]
        # every active tile's pixels ARE a scaled GTS line after the
        # reload path (run_reload_tiling overwrote them); map local
        # dense indices to the shared global ones
        lutarr = np.array([lut[st.tiles_pal[i].tobytes()]
                           for i in range(n_act)], np.int64)
        frames_d = [dict(tile_idx=lutarr[st.stm_tile[f].ravel()],
                         pal_idx=st.stm_pal[f].ravel(),
                         hmir=st.stm_h[f].ravel(),
                         vmir=st.stm_v[f].ravel(),
                         smoothed=st.stm_smooth[f].ravel())
                    for f in range(st.n_frames)]
        raw = build_keyframe_stream(
            dims['prefix'] if state['kf'] == 0 else [],
            st.palettes_rgb[0], frames_d, None, config.tile_palette_size)
        comp = compress_keyframe_stream(raw, fast_lzma=fast_lzma,
                                        lzma_mode=config.lzma_mode)
        tmp.write(comp)
        infos.append(_kf_info(state['kf'], start, raw, comp, fps))
        kf_counts.append(end - start + 1)
        state['kf'] += 1

    def finalize(tmp_path, total):
        writer = GTMWriter(
            width=dims['w'], height=dims['h'], fps=fps, tiles_pal=None,
            palette_size=config.tile_palette_size, frame_count=total,
            kf_count=state['kf'], fast_lzma=fast_lzma,
            total_tile_count=len(scaled), lzma_mode=config.lzma_mode)
        writer.kf_infos = infos
        writer._kf_frames = kf_counts
        prefix = writer.finalize_container()
        with open(out_path, 'wb') as out:
            out.write(prefix)
            with open(tmp_path, 'rb') as sf:
                shutil.copyfileobj(sf, out)
        return dict(n_frames=total, n_keyframes=state['kf'],
                    gtm_bytes=os.path.getsize(out_path),
                    shared_tileset=len(scaled), ft_nn_calls=nn_calls)

    return _stream_driver(frames_iter, out_path, chunk, process_gop,
                          finalize)


def iter_frames_npy(path: str):
    """Lazy frame iterator over a [F,H,W,3] .npy (memory-mapped)."""
    arr = np.load(path, mmap_mode='r')
    for i in range(arr.shape[0]):
        yield np.asarray(arr[i])


def iter_frames_pngs(pattern: str):
    """Lazy frame iterator over a numerically sorted PNG glob."""
    from PIL import Image

    from .load import sorted_frame_paths
    for p in sorted_frame_paths(pattern):
        yield np.asarray(Image.open(p).convert('RGB'))
