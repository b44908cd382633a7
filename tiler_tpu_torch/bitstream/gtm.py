"""GTM bitstream container: header structs, command grammar, writer, parser.

Layout (reference structs at reference main.pas:103-139, writer at
main.pas:4529-4763, reader semantics defined by the JS player
reference decoders/htmljs/gtm.player.js):

  [GTMHeader 40B] [GTMKeyFrameInfo 28B] * KFCount  [lzma stream] * KFCount

Command stream: 16-bit little-endian words, low 6 bits = opcode, high
10 bits = attrs. Tilemap attrs pack palette<<2 | VMirror<<1 | HMirror.
The writer here is numpy-vectorized: skip runs and tilemap items are
emitted by computing per-cell word offsets and scattering, instead of the
reference's per-cell loop (main.pas:4677-4719).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import enum
import os
import struct

import numpy as np

from .. import native
from ..utils.dispatch import span
from .lzma_codec import lzma_compress_alone, lzma_decompress_concat

TILE_W = 8
TILE_BYTES = TILE_W * TILE_W

CMD_BITS = 6          # round(log2(64)) commands (main.pas:4531-4532)
ATTR_BITS = 16 - CMD_BITS
MAX_BLK_SKIP = 1 << ATTR_BITS  # 1024 (main.pas:4535)


class GTMCommand(enum.IntEnum):
    SKIP_BLOCK = 0
    SHORT_TILE_IDX = 1
    LONG_TILE_IDX = 2
    LOAD_PALETTE = 3
    FRAME_END = 28
    TILE_SET = 29
    SET_DIMENSIONS = 30
    EXTENDED = 31


_HEADER_FMT = '<4sIIIIIIIII'   # 40 bytes
_KFINFO_FMT = '<4sIIIIII'      # 28 bytes
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
KFINFO_SIZE = struct.calcsize(_KFINFO_FMT)


@dataclasses.dataclass
class GTMHeader:
    width: int
    height: int
    kf_count: int
    frame_count: int
    average_bytes_per_sec: int = 0
    kf_max_bytes_per_sec: int = 0
    encoder_version: int = 1
    whole_header_size: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT, b'GTMv', HEADER_SIZE - 8, self.whole_header_size,
            self.encoder_version, self.width, self.height, self.kf_count,
            self.frame_count, self.average_bytes_per_sec,
            self.kf_max_bytes_per_sec)

    @classmethod
    def unpack(cls, buf: bytes) -> 'GTMHeader':
        (fourcc, _riff, whole, ver, w, h, kfc, frc, avg, kfmax) = \
            struct.unpack_from(_HEADER_FMT, buf)
        if fourcc != b'GTMv':
            raise ValueError('not a GTM stream (bad FourCC)')
        return cls(width=w, height=h, kf_count=kfc, frame_count=frc,
                   average_bytes_per_sec=avg, kf_max_bytes_per_sec=kfmax,
                   encoder_version=ver, whole_header_size=whole)


@dataclasses.dataclass
class GTMKeyFrameInfo:
    kf_index: int
    frame_index: int
    raw_size: int = 0
    compressed_size: int = 0
    timecode_ms: int = 0

    def pack(self) -> bytes:
        return struct.pack(_KFINFO_FMT, b'GTMk', KFINFO_SIZE - 8,
                           self.kf_index, self.frame_index, self.raw_size,
                           self.compressed_size, self.timecode_ms)

    @classmethod
    def unpack(cls, buf: bytes, offset: int = 0) -> 'GTMKeyFrameInfo':
        (fourcc, _riff, kfi, fri, raw, comp, tc) = \
            struct.unpack_from(_KFINFO_FMT, buf, offset)
        if fourcc != b'GTMk':
            raise ValueError('bad keyframe info FourCC')
        return cls(kf_index=kfi, frame_index=fri, raw_size=raw,
                   compressed_size=comp, timecode_ms=tc)


def _cmd_word(cmd: int, data: int) -> bytes:
    assert data < (1 << ATTR_BITS) and cmd < (1 << CMD_BITS)
    return struct.pack('<H', (data << CMD_BITS) | cmd)


def emit_tileset(tiles_pal: np.ndarray, palette_size: int,
                 tilemap_w: int, tilemap_h: int, fps: float) -> bytes:
    """gtSetDimensions + gtTileSet sections (main.pas:4603-4622)."""
    n = tiles_pal.shape[0]
    out = [
        _cmd_word(GTMCommand.SET_DIMENSIONS, 0),
        struct.pack('<HHII', tilemap_w, tilemap_h,
                    int(round(1000 * 1000 * 1000 / fps)), n),
    ]
    if n > 0:
        out += [
            _cmd_word(GTMCommand.TILE_SET, palette_size),
            struct.pack('<II', 0, n - 1),
            np.ascontiguousarray(tiles_pal, dtype=np.uint8).tobytes(),
        ]
    return b''.join(out)


def emit_kf_palettes(palettes_rgb: np.ndarray) -> bytes:
    """gtLoadPalette per palette (main.pas:4589-4601).

    palettes_rgb: [palette_count, palette_size, 3] uint8.
    """
    pal_count, pal_size, _ = palettes_rgb.shape
    out = []
    rgba = np.concatenate(
        [palettes_rgb,
         np.full((pal_count, pal_size, 1), 255, np.uint8)], axis=-1)
    for j in range(pal_count):
        out.append(_cmd_word(GTMCommand.LOAD_PALETTE, 0))
        out.append(bytes((j, 0)))
        out.append(rgba[j].tobytes())
    return b''.join(out)


def emit_frame(tile_idx: np.ndarray, pal_idx: np.ndarray,
               hmir: np.ndarray, vmir: np.ndarray,
               smoothed: np.ndarray, kf_end: bool) -> bytes:
    """One frame's tilemap command words (main.pas:4671-4726), vectorized.

    All inputs are flat [tilemap_size] arrays in row-major cell order.
    Smoothed cells become gtSkipBlock runs (chunked to 1024); the rest
    become gtShort/LongTileIdx with attrs palette<<2|vmir<<1|hmir.
    """
    tile_idx = np.asarray(tile_idx, np.int64).ravel()
    pal_idx = np.asarray(pal_idx, np.int64).ravel()
    hmir = np.asarray(hmir, bool).ravel()
    vmir = np.asarray(vmir, bool).ravel()
    sm = np.asarray(smoothed, bool).ravel()
    s = tile_idx.size

    # position of each cell inside its smoothed run
    pos = np.arange(s)
    if sm.any():
        run_start = sm & np.concatenate(([True], ~sm[:-1]))
        run_no = np.cumsum(run_start) - 1  # valid where sm
        starts_pos = np.flatnonzero(run_start)
        safe_no = np.clip(run_no, 0, starts_pos.size - 1)
        pos_in_run = np.where(sm, pos - starts_pos[safe_no], 0)
        run_len = np.bincount(run_no[sm])
        rem = np.where(sm, run_len[safe_no] - pos_in_run, 0)
    else:
        pos_in_run = np.zeros(s, np.int64)
        rem = np.zeros(s, np.int64)

    chunk_start = sm & (pos_in_run % MAX_BLK_SKIP == 0)
    skip_count = np.minimum(rem, MAX_BLK_SKIP)

    is_long = (~sm) & (tile_idx >= (1 << 16))
    is_short = (~sm) & ~is_long

    # words per cell: skip chunk start=1, short=2, long=3, else 0
    words = (chunk_start.astype(np.int64) + is_short * 2 + is_long * 3)
    offs = np.concatenate(([0], np.cumsum(words)[:-1]))
    total = int(words.sum())
    buf = np.zeros(total, np.uint16)

    attrs = (pal_idx << 2) | (vmir.astype(np.int64) << 1) | hmir.astype(np.int64)

    cs = np.flatnonzero(chunk_start)
    buf[offs[cs]] = (((skip_count[cs] - 1) << CMD_BITS)
                     | GTMCommand.SKIP_BLOCK).astype(np.uint16)

    sh = np.flatnonzero(is_short)
    buf[offs[sh]] = ((attrs[sh] << CMD_BITS) | GTMCommand.SHORT_TILE_IDX
                     ).astype(np.uint16)
    buf[offs[sh] + 1] = tile_idx[sh].astype(np.uint16)

    lg = np.flatnonzero(is_long)
    buf[offs[lg]] = ((attrs[lg] << CMD_BITS) | GTMCommand.LONG_TILE_IDX
                     ).astype(np.uint16)
    buf[offs[lg] + 1] = (tile_idx[lg] & 0xffff).astype(np.uint16)
    buf[offs[lg] + 2] = (tile_idx[lg] >> 16).astype(np.uint16)

    return buf.tobytes() + _cmd_word(GTMCommand.FRAME_END, int(kf_end))


class GTMWriter:
    """Assembles a complete GTM file from encoded state.

    Usage: construct, then add_keyframe(...) per keyframe in order, then
    tobytes(). Statistics (bytes/sec header fields, per-KF sizes) follow
    main.pas:4727-4757.
    """

    def __init__(self, width: int, height: int, fps: float,
                 tiles_pal: np.ndarray | None, palette_size: int,
                 frame_count: int, kf_count: int, fast_lzma: bool = False,
                 total_tile_count: int | None = None,
                 lzma_mode: str = 'lc3'):
        """lzma_mode: 'lc3' = liblzma optimal parse (this primitive's
        default: the no-native-toolchain-safe choice; EncoderConfig
        defaults to 'auto', the measured-smallest mode —
        docs/RESULTS.md round 4), 'lc8' = the native lc=8 encoder
        (lzma.exe `-lc8 -eos` parity, extern.pas:224), 'auto' = encode
        both per keyframe and keep the smaller stream, 'best' = also
        sweep native (lc,lp,pb) configs (~1% smaller, ~3x cost)."""
        self.fps = fps
        self.fast_lzma = fast_lzma
        if lzma_mode not in ('lc3', 'lc8', 'auto', 'best'):
            raise ValueError(f'unknown lzma_mode {lzma_mode!r}')
        self.lzma_mode = lzma_mode
        self.palette_size = palette_size
        self.header = GTMHeader(width=width, height=height,
                                kf_count=kf_count, frame_count=frame_count)
        self.kf_infos: list[GTMKeyFrameInfo] = []
        self.streams: list[bytes] = []
        # the compression jobs run, per encoder (compress_keyframe_streams)
        self.lzma_jobs = {'native': 0, 'liblzma': 0}
        tw, th = width // TILE_W, height // TILE_W
        # First keyframe's stream is prefixed by dimensions (+ the global
        # tileset when given; per-keyframe segmented tilesets may instead
        # arrive via add_keyframe(tileset=...), as GOP-sharded multi-host
        # encodes produce).
        if tiles_pal is not None:
            self._pending = [emit_tileset(tiles_pal, palette_size, tw, th,
                                          fps)]
        else:
            n_total = total_tile_count or 0
            self._pending = [
                _cmd_word(GTMCommand.SET_DIMENSIONS, 0),
                struct.pack('<HHII', tw, th,
                            int(round(1000 * 1000 * 1000 / fps)), n_total)]

    def add_keyframe(self, kf_index: int, start_frame: int, end_frame: int,
                     palettes_rgb: np.ndarray, frames: list[dict],
                     tileset: tuple[int, np.ndarray] | None = None) -> None:
        """frames: list of dicts with keys tile_idx, pal_idx, hmir, vmir,
        smoothed (flat arrays), one per frame of this keyframe.

        tileset: optional (start_index, tiles [n,8,8]) segment to emit
        before this keyframe's palettes (gtTileSet supports arbitrary
        ranges; the players grow their tile store)."""
        raw = build_keyframe_stream(self._pending, palettes_rgb, frames,
                                    tileset, self.palette_size)
        self._pending = []
        n_frames = end_frame - start_frame + 1
        info = GTMKeyFrameInfo(
            kf_index=kf_index, frame_index=start_frame,
            raw_size=len(raw), compressed_size=0,
            timecode_ms=int(round(1000.0 * start_frame / self.fps)))
        self.kf_infos.append(info)
        self.streams.append(raw)  # compressed in tobytes (threaded)
        self._kf_frames = getattr(self, '_kf_frames', [])
        self._kf_frames.append(n_frames)

    def tobytes(self) -> bytes:
        # compress keyframe streams on a thread pool; stats follow
        # main.pas:4727-4757
        comps = self._compress_pending()
        return b''.join([self.finalize_container()] + comps)

    def _compress_pending(self) -> list[bytes]:
        """Compress every buffered raw keyframe stream (one thread pool
        job per stream and encoder) and record the compressed sizes in
        kf_infos."""
        comps = compress_keyframe_streams(self.streams,
                                          fast_lzma=self.fast_lzma,
                                          lzma_mode=self.lzma_mode,
                                          jobs=self.lzma_jobs)
        for info, comp in zip(self.kf_infos, comps):
            info.compressed_size = len(comp)
        self.streams = []
        return comps

    def finalize_container(self) -> bytes:
        """Header + keyframe-info block, from the recorded compressed
        sizes (every stream must have been compressed — via tobytes or
        flush_streams). Stats follow main.pas:4727-4757."""
        hdr = self.header
        hdr.kf_count = len(self.kf_infos)
        recompute_bitrate_stats(hdr, self.kf_infos, self._kf_frames,
                                self.fps)
        hdr.whole_header_size = HEADER_SIZE + KFINFO_SIZE * len(self.kf_infos)
        return b''.join([hdr.pack()] + [i.pack() for i in self.kf_infos])


def recompute_bitrate_stats(hdr: GTMHeader,
                            infos: list[GTMKeyFrameInfo],
                            kf_frames, fps: float) -> None:
    """KFMaxBytesPerSec / AverageBytesPerSec from the recorded
    compressed sizes (main.pas:4727-4757) — shared by the writer's
    finalize_container and transcode_gtm so the stats semantics cannot
    drift. KFMaxBytesPerSec excludes KF 0 unless it is the only one
    (main.pas:4741-4742): KF 0 carries the tileset burst."""
    hdr.kf_max_bytes_per_sec = 0
    hdr.average_bytes_per_sec = 0
    for info, n_frames in zip(infos, kf_frames):
        if info.kf_index > 0 or len(infos) == 1:
            hdr.kf_max_bytes_per_sec = max(
                hdr.kf_max_bytes_per_sec,
                int(round(info.compressed_size * fps / n_frames)))
        hdr.average_bytes_per_sec += info.compressed_size
    hdr.average_bytes_per_sec = int(round(
        hdr.average_bytes_per_sec * fps / max(hdr.frame_count, 1)))


def build_keyframe_stream(prefix_parts: list[bytes],
                          palettes_rgb: np.ndarray, frames: list[dict],
                          tileset: tuple[int, np.ndarray] | None,
                          palette_size: int) -> bytes:
    """One keyframe's raw command stream: optional prefix (the first
    keyframe's SET_DIMENSIONS / global tileset), an optional gtTileSet
    segment, palette loads, then the frame command runs — shared by
    GTMWriter.add_keyframe and the bounded-memory streaming assembler
    (pipeline.stream)."""
    parts = list(prefix_parts)
    if tileset is not None:
        start, tiles = tileset
        if len(tiles):
            parts.append(_cmd_word(GTMCommand.TILE_SET, palette_size))
            parts.append(struct.pack('<II', start, start + len(tiles) - 1))
            parts.append(np.ascontiguousarray(
                tiles, dtype=np.uint8).tobytes())
    parts.append(emit_kf_palettes(palettes_rgb))
    for k, fr in enumerate(frames):
        parts.append(emit_frame(fr['tile_idx'], fr['pal_idx'],
                                fr['hmir'], fr['vmir'], fr['smoothed'],
                                kf_end=(k == len(frames) - 1)))
    return b''.join(parts)


# native candidate configs for the sweep modes: (lc, lp, pb). lc8/pb2 is
# the reference toolchain's setting; pb4 wins on tileset-heavy first
# keyframes and lp1 on command-run keyframes (measured on both published
# demos, ~1% total under 'best' — docs/RESULTS.md round 4)
_NATIVE_CFG = (8, 0, 2)
_BEST_CFGS = ((8, 0, 2), (8, 0, 4), (8, 1, 2))


def compress_keyframe_stream(raw: bytes, fast_lzma: bool = False,
                             lzma_mode: str = 'lc3') -> bytes:
    """One keyframe stream's LZMA-alone bytes under the configured mode:
    the one-stream case of compress_keyframe_streams."""
    return compress_keyframe_streams([raw], fast_lzma, lzma_mode)[0]


def _native_cfgs(lzma_mode: str) -> tuple:
    """The native (lc, lp, pb) configs that `lzma_mode` encodes with:
    none under 'lc3'. 'auto'/'best' degrade to liblzma alone when the
    native encoder cannot build (no C++ toolchain on this host); 'lc8'
    stays a hard requirement because the caller asked for that exact
    framing."""
    if lzma_mode == 'lc3':
        return ()
    try:
        # availability check ONLY (lazy g++ build): a genuine encode
        # failure in a job must raise, not masquerade as "no toolchain"
        # and silently ship larger lc3 bytes. Only the MISSING
        # toolchain is a graceful-degrade condition — a nonzero
        # compile exit propagates even for 'auto'/'best'. Deliberately,
        # that also surfaces environmentally-broken toolchains
        # (half-installed g++, stale incompatible .so) as errors rather
        # than silent downgrades — a host that CLAIMS a toolchain but
        # cannot build is a host the operator should hear about.
        native.get_lib()
    except native.NoToolchainError:
        if lzma_mode == 'lc8':
            raise
        global _warned_no_native_lzma
        if not _warned_no_native_lzma:
            _warned_no_native_lzma = True
            import warnings
            warnings.warn(
                'native LZMA encoder unavailable; '
                f'lzma_mode={lzma_mode!r} falls back to liblzma lc3')
        return ()
    return _BEST_CFGS if lzma_mode == 'best' else (_NATIVE_CFG,)


_warned_no_native_lzma = False


def transcode_gtm(data: bytes, lzma_mode: str,
                  fast_lzma: bool = False) -> bytes:
    """Recompress a GTM's keyframe streams with another LZMA mode
    (commands and pixels untouched — the decoded video is identical).
    Handles both container forms: headered (GTMv; bitrate header fields
    recomputed from the new sizes, main.pas:4727-4757 semantics) and
    legacy headerless (the published demos: bare concatenated
    LZMA-alone streams). The CLI `transcode` command and the bench
    tooling both route through here."""
    from .lzma_codec import iter_lzma_streams

    # strict split: transcode REWRITES the container, so a truncated or
    # trailing-garbage input must error rather than be laundered into an
    # apparently-valid output (playback paths stay lenient)
    if data[:4] != b'GTMv':
        return b''.join(compress_keyframe_streams(
            list(iter_lzma_streams(data, strict=True)),
            fast_lzma=fast_lzma, lzma_mode=lzma_mode))

    hdr = GTMHeader.unpack(data)
    whole = hdr.whole_header_size or (HEADER_SIZE
                                      + KFINFO_SIZE * hdr.kf_count)
    infos = [GTMKeyFrameInfo.unpack(data, HEADER_SIZE + i * KFINFO_SIZE)
             for i in range(hdr.kf_count)]
    raws = list(iter_lzma_streams(data[whole:],
                                  expected_count=hdr.kf_count,
                                  strict=True))
    streams = compress_keyframe_streams(raws, fast_lzma=fast_lzma,
                                        lzma_mode=lzma_mode)
    if len(streams) != hdr.kf_count:
        raise ValueError(f'{len(streams)} streams but header declares '
                         f'{hdr.kf_count} keyframes')
    # recompute the bitrate header fields from the NEW sizes; per-KF
    # frame counts derive from consecutive frame_index values, fps from
    # stream 0's SET_DIMENSIONS frame length
    fps = 24.0
    if raws and len(raws[0]) >= 14:
        w0 = raws[0][0] | (raws[0][1] << 8)
        if (w0 & ((1 << CMD_BITS) - 1)) == GTMCommand.SET_DIMENSIONS:
            ns = int.from_bytes(raws[0][6:10], 'little')
            if ns > 0:
                fps = 1e9 / ns
    kf_frames = []
    for i, (info, s) in enumerate(zip(infos, streams)):
        info.compressed_size = len(s)
        nxt = infos[i + 1].frame_index if i + 1 < len(infos) \
            else hdr.frame_count
        kf_frames.append(max(nxt - info.frame_index, 1))
    recompute_bitrate_stats(hdr, infos, kf_frames, fps)
    # the output header region is written dense (no input padding
    # preserved), so the declared offset must match what we emit
    hdr.whole_header_size = HEADER_SIZE + KFINFO_SIZE * hdr.kf_count
    return b''.join([hdr.pack()] + [i.pack() for i in infos] + streams)


def compress_keyframe_streams(raws: list[bytes], fast_lzma: bool = False,
                              lzma_mode: str = 'lc3',
                              jobs: dict | None = None) -> list[bytes]:
    """Each keyframe stream's LZMA-alone bytes under the configured mode:
    'lc3' liblzma / 'lc8' native / 'auto' smaller-of-both / 'best'
    smallest over a small native (lc,lp,pb) sweep + liblzma (~3x the
    compression cost of 'auto'; for transcode/final distribution).

    One thread pool runs one job per (stream, encoder), so a stream's
    encoders run side by side (both release the GIL). The largest
    streams are submitted first, each with its native jobs before its
    liblzma job, so the longest jobs start first where jobs outnumber
    workers. A stream keeps its shortest result: the liblzma one on a
    tie with a native one, else the first in _BEST_CFGS order. Each job
    runs under the span 'save/lzma_native' or 'save/lzma_liblzma';
    `jobs`, where given, counts the jobs run of each kind under
    'native' and 'liblzma'."""
    if not raws:
        return []
    cfgs = _native_cfgs(lzma_mode)
    with_liblzma = lzma_mode != 'lc8'
    # fast: greedy parse at shallow depth; full: the optimal
    # (price-DP) parse that beats the reference's own lzma.exe
    # output on its payloads (docs/RESULTS.md round-4 table).
    # depth 32 for the optimal parse: measured ±0.08% vs depth
    # 128 on both demo payloads at ~1.7x the throughput (deeper
    # chains mostly add farther matches the price DP rejects)
    depth, nice = (16, 32) if fast_lzma else (32, 128)

    def native_job(raw, lc, lp, pb):
        with span('save/lzma_native'):
            return native.lzma_encode_alone(
                raw, lc=lc, lp=lp, pb=pb, depth=depth, nice_len=nice,
                optimal=not fast_lzma)

    def liblzma_job(raw):
        with span('save/lzma_liblzma'):
            return lzma_compress_alone(raw, fast=fast_lzma)

    if jobs is not None:
        jobs['native'] = jobs.get('native', 0) + len(cfgs) * len(raws)
        jobs['liblzma'] = (jobs.get('liblzma', 0)
                           + with_liblzma * len(raws))
    workers = min(max(os.cpu_count() or 1, 1), 8)
    futures = [None] * len(raws)
    with cf.ThreadPoolExecutor(workers) as ex:
        for i in sorted(range(len(raws)), key=lambda i: -len(raws[i])):
            nat = [ex.submit(native_job, raws[i], *c) for c in cfgs]
            lib = [ex.submit(liblzma_job, raws[i])] if with_liblzma else []
            # min keeps the first of equal lengths: liblzma, then the
            # native configs in order
            futures[i] = lib + nat
        return [min((f.result() for f in fs), key=len) for fs in futures]


@dataclasses.dataclass
class ParsedGTM:
    header: GTMHeader
    kf_infos: list[GTMKeyFrameInfo]
    commands: bytes  # decompressed concatenated command stream


def parse_gtm(data: bytes) -> ParsedGTM:
    """Parses either the headered (GTMv) or the legacy headerless format.

    The JS player rewinds and treats the whole file as LZMA data when the
    FourCC is absent (gtm.player.js:136-138); the published demo streams use
    that legacy form, so we accept it too (dimensions then come from the
    gtSetDimensions command)."""
    if data[:4] == b'GTMv':
        if len(data) < HEADER_SIZE:
            raise ValueError(
                f'truncated GTM header ({len(data)} of {HEADER_SIZE} bytes)')
        header = GTMHeader.unpack(data)
        if HEADER_SIZE + header.kf_count * KFINFO_SIZE > len(data):
            raise ValueError(
                f'truncated GTM: header declares {header.kf_count} '
                f'keyframes but only {len(data)} bytes present')
        infos = [GTMKeyFrameInfo.unpack(data, HEADER_SIZE + i * KFINFO_SIZE)
                 for i in range(header.kf_count)]
        whole = header.whole_header_size or (HEADER_SIZE +
                                             KFINFO_SIZE * header.kf_count)
        commands = lzma_decompress_concat(
            data[whole:], expected_count=header.kf_count)
        if header.kf_count > 0 and not commands:
            raise ValueError('corrupt GTM: no decodable command data')
        return ParsedGTM(header=header, kf_infos=infos, commands=commands)
    header = GTMHeader(width=0, height=0, kf_count=0, frame_count=0)
    commands = lzma_decompress_concat(data)
    if data and not commands:
        # the legacy headerless form is raw LZMA from byte 0
        # (gtm.player.js:136-138); non-empty input yielding no commands
        # is garbage, not a video
        raise ValueError('not a GTM stream (no FourCC, no LZMA data)')
    return ParsedGTM(header=header, kf_infos=[], commands=commands)


def write_gts(path: str, tiles_pal: np.ndarray, palette_size: int) -> None:
    """Standalone tileset file: palette-size byte + raw 64-byte tiles
    (main.pas:4359-4367)."""
    with open(path, 'wb') as f:
        f.write(bytes([palette_size]))
        f.write(np.ascontiguousarray(tiles_pal, np.uint8).tobytes())


def read_gts(path: str) -> tuple[np.ndarray, int]:
    """Reads a GTS tileset; returns (tiles [N,8,8] uint8, palette_size).

    Handles both headerless legacy files (size % 64 == 0 -> palette size 64)
    and palette-size-prefixed files (main.pas:4428-4431)."""
    raw = open(path, 'rb').read()
    if len(raw) % TILE_BYTES == 0:
        pal_size = TILE_BYTES
        body = raw
    else:
        pal_size = raw[0]
        body = raw[1:]
    tiles = np.frombuffer(body, np.uint8).reshape(-1, TILE_W, TILE_W)
    return tiles.copy(), pal_size
