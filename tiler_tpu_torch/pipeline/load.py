"""Load step: ingestion (ffmpeg, PNG sequences), tile split, FS
posterize, keyframe detection and the temporal changed mask — the
counterpart of tiler_tpu/pipeline/load.py.

Everything here is host code and byte-identical to the JAX package
(ffmpeg and PIL are reached only inside the functions that need them);
the frames go to the device once, when the first step needs the source
tiles (EncoderState.device_source_tiles).
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..constants import (BITS_PER_COMP, MAX_TILEMAP_H, MAX_TILEMAP_W,
                         SHOT_TRANS_AVG_FRAMES, SHOT_TRANS_GRACE_PERIOD,
                         SHOT_TRANS_HARD_THRES, SHOT_TRANS_MAX_TILES_PER_KF,
                         SHOT_TRANS_SOFT_THRES, TILE_W)
from ..ops import stats
from ..ops.dither import floyd_steinberg_posterize
from .state import EncoderState


def ffmpeg_args(path: str, out_pattern: str, start_frame: int = 0,
                frame_count: int = 0, scale: float = 1.0) -> list[str]:
    """ffmpeg argv for frame extraction (DoExternalFFMpeg,
    main.pas:4780-4787): frame-range select, full-range conversion and
    Lanczos scale, rgb24 PNG sequence out. A bounded frame_count also
    caps the OUTPUT (-frames:v): the select filter alone keeps decoding
    the input to EOF after the range."""
    last = start_frame + frame_count - 1 if frame_count > 0 else 2**30
    sel = (f"select=between(n\\,{start_frame}\\,{last}),"
           f"setpts=PTS-STARTPTS,scale=in_range=auto:out_range=full")
    vf = f"{sel},scale=iw*{scale}:ih*{scale}:flags=lanczos"
    args = ['-y', '-i', path, '-vf', vf]
    if frame_count > 0:
        args += ['-frames:v', str(frame_count)]
    return args + ['-pix_fmt', 'rgb24', out_pattern]


def parse_ffmpeg_fps(stderr: str, default: float = 24.0) -> float:
    """Frame rate from ffmpeg's stream-info stderr.

    The reference scrapes the token before the first ' fps'
    (main.pas:4794-4799); real ffmpeg prints e.g.
    `... 1280x720, 1074 kb/s, 29.97 fps, 30 tbr, ...`. We match the
    number immediately preceding 'fps' anywhere (first occurrence), fall
    back to the 'tbr' figure, then to `default`."""
    import re
    for unit in ('fps', 'tbr'):
        m = re.search(r'(\d+(?:\.\d+)?)\s*' + unit + r'\b', stderr)
        if m:
            try:
                v = float(m.group(1))
                if v > 0:
                    return v
            except ValueError:
                pass
    return default


def frames_from_video(path: str, start_frame: int = 0, frame_count: int = 0,
                      scale: float = 1.0) -> tuple[np.ndarray, float]:
    """Extract frames with ffmpeg (DoExternalFFMpeg equivalent: frame-range
    select + Lanczos scale + full-range rgb24). Returns (frames, fps)."""
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise RuntimeError('ffmpeg not available on this host')
    from ..utils.progress import run_command
    tmp = tempfile.mkdtemp(prefix='tiler_png_')
    try:
        # progressive pipe pump with live echo (internalRuncommand,
        # extern.pas:94-200): ffmpeg reports progress on stderr
        code, _out, stderr = run_command(
            [ffmpeg] + ffmpeg_args(path, os.path.join(tmp, '%06d.png'),
                                   start_frame, frame_count, scale),
            echo=True)
        if code != 0:
            raise RuntimeError(f'ffmpeg failed ({code}): {stderr[-500:]}')
        fps = parse_ffmpeg_fps(stderr)
        frames = frames_from_pngs(os.path.join(tmp, '*.png'))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return frames, fps


def ffmpeg_rawvideo_args(path: str, start_frame: int = 0,
                         frame_count: int = 0,
                         scale: float = 1.0) -> list[str]:
    """ffmpeg argv streaming rgb24 raw frames to stdout: the PNG-form
    argv with only the output target swapped for a rawvideo pipe."""
    args = ffmpeg_args(path, '-', start_frame, frame_count, scale)
    return args[:-1] + ['-f', 'rawvideo', '-']


def open_video_stream(path: str, start_frame: int = 0,
                      frame_count: int = 0, scale: float = 1.0):
    """Pipe-based ingestion for the streaming encoder: returns
    (frame_iterator, fps, (h, w)). A one-frame probe
    (frames_from_video) learns the post-filter output dimensions and
    fps, then a single `-f rawvideo` pipe streams every frame — frames
    are never all in RAM and, unlike the batch frames_from_video spool,
    never all on disk either.

    The iterator fails LOUDLY: a nonzero ffmpeg exit or a mid-frame
    pipe end raises (with the stderr tail) instead of silently
    finalizing a truncated encode; abandoning the iterator early
    terminates ffmpeg rather than blocking on a full residual decode."""
    import collections
    import threading

    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise RuntimeError('ffmpeg not available on this host')
    probe, fps = frames_from_video(path, start_frame, 1, scale)
    h, w = probe.shape[1:3]

    proc = subprocess.Popen([ffmpeg] + ffmpeg_rawvideo_args(
        path, start_frame, frame_count, scale),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    err_tail: collections.deque = collections.deque(maxlen=50)

    def drain():
        for line in proc.stderr:
            err_tail.append(line)
    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()

    def tail() -> str:
        return b''.join(err_tail).decode('utf-8', 'replace')[-500:]

    def gen():
        nbytes = h * w * 3
        completed = False
        try:
            while True:
                buf = proc.stdout.read(nbytes)
                if not buf:
                    completed = True
                    break
                if len(buf) < nbytes:
                    raise RuntimeError(
                        f'ffmpeg pipe ended mid-frame ({len(buf)} of '
                        f'{nbytes} bytes): {tail()}')
                yield np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        finally:
            proc.stdout.close()
            if not completed and proc.poll() is None:
                proc.terminate()  # abandoned early: don't block on EOF
            code = proc.wait()
            drainer.join(timeout=5)
            if completed and code != 0:
                raise RuntimeError(f'ffmpeg failed ({code}): {tail()}')

    return gen(), fps, (h, w)


def sorted_frame_paths(pattern: str) -> list[str]:
    """Glob sorted NUMERICALLY by the digits in each name: a plain
    lexicographic sort interleaves '10000.png' between '0999' and
    '2000' once a spool passes 9999 frames — exactly the long-clip case
    streaming exists for."""
    import re

    def key(p):
        name = os.path.basename(p)
        nums = re.findall(r'\d+', name)
        return ([int(x) for x in nums], name)

    paths = sorted(glob.glob(pattern), key=key)
    if not paths:
        raise FileNotFoundError(pattern)
    return paths


def frames_from_pngs(pattern: str) -> np.ndarray:
    from PIL import Image
    return np.stack([np.asarray(Image.open(p).convert('RGB'))
                     for p in sorted_frame_paths(pattern)])


def split_into_tiles(frames: np.ndarray, th: int, tw: int) -> np.ndarray:
    """[F,H,W,3] -> [F*TH*TW, 8, 8, 3] in frame-major row-major cell order."""
    f = frames.shape[0]
    x = frames[:, :th * TILE_W, :tw * TILE_W]
    x = x.reshape(f, th, TILE_W, tw, TILE_W, 3).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(f * th * tw, TILE_W, TILE_W, 3))


def keyframes_from_correlations(corr: np.ndarray, tilemap_size: int,
                                n_frames: int) -> np.ndarray:
    """EWMA ratio thresholding of an inter-frame correlation trace into
    keyframe ranges (main.pas:1099-1155). Returns [K,2] inclusive frame
    ranges."""
    starts = [0]
    av = -1.0
    last_kf = 0
    for i in range(1, n_frames):
        v = float(corr[i - 1])
        if av == -1.0:
            av = v
        else:
            av = av * (1.0 - 1.0 / SHOT_TRANS_AVG_FRAMES) + \
                v * (1.0 / SHOT_TRANS_AVG_FRAMES)
        ratio = max(0.01, v) / max(0.01, av)
        is_kf = (ratio < SHOT_TRANS_HARD_THRES) or \
            (ratio < SHOT_TRANS_SOFT_THRES and
             (i - last_kf + 1) > SHOT_TRANS_GRACE_PERIOD) or \
            ((i - last_kf + 1) * tilemap_size > SHOT_TRANS_MAX_TILES_PER_KF)
        if is_kf:
            starts.append(i)
            av = -1.0
            last_kf = i
    starts.append(n_frames)
    return np.array([[starts[k], starts[k + 1] - 1]
                     for k in range(len(starts) - 1)], np.int32)


def detect_keyframes(fs_pixels: np.ndarray, tilemap_size: int) -> np.ndarray:
    """Shot-transition detection on the host: Pearson correlations plus
    the EWMA ratio thresholds. Returns [K,2] inclusive frame ranges."""
    f = len(fs_pixels)
    if f == 1:
        return np.array([[0, 0]], np.int32)
    corr = stats.interframe_correlations_host(np.asarray(fs_pixels))
    return keyframes_from_correlations(corr, tilemap_size, f)


def changed_mask(frames_rgb: np.ndarray, th: int, tw: int) -> np.ndarray:
    """[F,H,W,3] u8 -> bool [F, th*tw]: cell differs from the same cell
    one frame earlier (frame 0 all-True). FrameTiling's stage 3 forward-
    fills the 1-NN result of unchanged cells (exact duplicates)."""
    f = frames_rgb.shape[0]
    x = frames_rgb[:, :th * TILE_W, :tw * TILE_W] \
        .reshape(f, th, TILE_W, tw, TILE_W, 3)
    eq = (x[1:] == x[:-1]).all(axis=(2, 4, 5))
    out = np.ones((f, th * tw), bool)
    out[1:] = ~eq.reshape(f - 1, th * tw)
    return out


def run_load(state: EncoderState, frames: np.ndarray,
             fps: float | None = None) -> EncoderState:
    """Populate state from raw frames [F,H,W,3] uint8."""
    cfg = state.config
    if fps is not None:
        state.fps = fps
    f, h, w, _ = frames.shape
    th = min(h // TILE_W, MAX_TILEMAP_H)
    tw = min(w // TILE_W, MAX_TILEMAP_W)
    if th == 0 or tw == 0:
        raise ValueError('input smaller than one tile')
    state.tilemap_h, state.tilemap_w = th, tw
    frames = np.ascontiguousarray(frames[:, :th * TILE_W, :tw * TILE_W])
    state.frames_rgb = frames
    # whole-frame FS posterize (identity at the default 8 bits/comp)
    if BITS_PER_COMP >= 8:
        state.fs_pixels = frames
    else:
        state.fs_pixels = np.stack(
            [floyd_steinberg_posterize(fr, BITS_PER_COMP) for fr in frames])
    state.keyframes = detect_keyframes(state.fs_pixels, th * tw)

    state.tiles_rgb = split_into_tiles(frames, th, tw)
    n = state.tiles_rgb.shape[0]
    state.tiles_pal = np.zeros((n, TILE_W, TILE_W), np.uint8)
    state.tile_active = np.ones(n, bool)
    state.tile_use = np.ones(n, np.int64)
    state.tile_dpi = np.full(n, -1, np.int32)

    state.tm_tile = np.arange(n, dtype=np.int32).reshape(f, th, tw)
    state.tm_pal = np.full((f, th, tw), -1, np.int32)
    state.tm_h = np.zeros((f, th, tw), bool)
    state.tm_v = np.zeros((f, th, tw), bool)

    mask = changed_mask(frames, th, tw)
    mask[state.keyframes[:, 0], :] = True
    state.changed_mask = mask
    k = len(state.keyframes)
    state.palettes_rgb = np.zeros(
        (k, cfg.palette_count, cfg.tile_palette_size, 3), np.uint8)
    state.palette_centroids = np.zeros(
        (k, cfg.palette_count, 192), np.float32)
    state.metrics['n_keyframes'] = k
    return state
