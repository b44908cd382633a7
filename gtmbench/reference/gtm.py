"""The benchmark's own GTM decoder, frozen: the container, the per-keyframe
LZMA streams, the 16-bit command walk and the tile blit, in numpy and
the standard library. It follows the port's numpy decoder
(tiler_tpu_torch/decode.py, bitstream/gtm.py, bitstream/lzma_codec.py)
and the JavaScript player's semantics it copies, and imports nothing of
the program, so that a later change to the program's decoder cannot
change what the benchmark reads.

decode(data) -> uint8 frames [F, H, W, 3]; any malformed, truncated or
trailing input raises ValueError.
"""
from __future__ import annotations

import lzma
import struct

import numpy as np

from . import lzma1

TILE_W = 8
CMD_BITS = 6
SKIP_BLOCK, SHORT_TILE_IDX, LONG_TILE_IDX, LOAD_PALETTE = 0, 1, 2, 3
FRAME_END, TILE_SET, SET_DIMENSIONS = 28, 29, 30

_HEADER_FMT = '<4sIIIIIIIII'   # 40 bytes
_KFINFO_FMT = '<4sIIIIII'      # 28 bytes
HEADER_SIZE = struct.calcsize(_HEADER_FMT)
KFINFO_SIZE = struct.calcsize(_KFINFO_FMT)


def lzma_streams(data: bytes, count: int) -> list[bytes]:
    """Exactly `count` back-to-back LZMA-alone streams, nothing after
    them: liblzma where it takes the props (lc + lp <= 4), lzma1 else."""
    out, rest = [], data
    for i in range(count):
        if len(rest) < 13:
            raise ValueError(f'keyframe stream {i}: truncated header')
        lc, lp = rest[0] % 9, (rest[0] // 9) % 5
        if lc + lp <= 4:
            dec = lzma.LZMADecompressor(format=lzma.FORMAT_ALONE)
            try:
                chunk = dec.decompress(rest)
            except lzma.LZMAError as exc:
                raise ValueError(f'keyframe stream {i}: {exc}') from exc
            if not dec.eof:
                raise ValueError(f'keyframe stream {i}: truncated')
            rest = dec.unused_data
        else:
            chunk, used = lzma1.decode_alone(rest)
            rest = rest[used:]
        out.append(chunk)
    if rest:
        raise ValueError(f'{len(rest)} bytes after the last keyframe stream')
    return out


def commands(data: bytes) -> tuple[int, int, int, bytes]:
    """(width, height, frame count, the concatenated command words) of a
    headered GTM stream."""
    if len(data) < HEADER_SIZE:
        raise ValueError('truncated GTM header')
    (fourcc, _riff, whole, _ver, w, h, kfc, frc, _avg, _kfmax) = \
        struct.unpack_from(_HEADER_FMT, data)
    if fourcc != b'GTMv':
        raise ValueError('not a GTM stream (bad FourCC)')
    if HEADER_SIZE + kfc * KFINFO_SIZE > len(data):
        raise ValueError('truncated keyframe table')
    for i in range(kfc):
        if struct.unpack_from(_KFINFO_FMT, data,
                              HEADER_SIZE + i * KFINFO_SIZE)[0] != b'GTMk':
            raise ValueError('bad keyframe info FourCC')
    whole = whole or HEADER_SIZE + KFINFO_SIZE * kfc
    return w, h, frc, b''.join(lzma_streams(data[whole:], kfc))


def decode(data: bytes) -> np.ndarray:
    """Every frame of the stream [F, H, W, 3] uint8, as the player draws
    it: a persistent canvas, skipped cells keep their pixels, tiles drawn
    through the palette in force with their mirror flips."""
    width, height, n_frames, cmd = commands(data)
    words = np.frombuffer(cmd, np.uint16, count=len(cmd) // 2)
    n = len(words)
    tw = th = 0
    tiles = np.zeros((0, TILE_W, TILE_W), np.uint8)
    pal_size = 0
    palettes = np.zeros((256, 1, 4), np.uint8)
    blocks = None
    frames = []
    cur_pos, cur_tile, cur_attr = [], [], []
    tm_pos = pos = 0

    def dword(p):
        return int(words[p]) | (int(words[p + 1]) << 16)

    while pos < n:
        w = int(words[pos])
        pos += 1
        cmd_id, attrs = w & ((1 << CMD_BITS) - 1), w >> CMD_BITS
        if cmd_id == SET_DIMENSIONS:
            tw, th = int(words[pos]), int(words[pos + 1])
            pos += 6
            blocks = np.zeros((th * tw, TILE_W, TILE_W, 3), np.uint8)
        elif cmd_id == TILE_SET:
            lo, hi = dword(pos), dword(pos + 2)
            pos += 4
            pal_size = attrs
            cnt = hi - lo + 1
            blob = np.frombuffer(cmd, np.uint8, count=cnt * 64,
                                 offset=pos * 2).reshape(cnt, TILE_W, TILE_W)
            if hi >= len(tiles):
                grown = np.zeros((hi + 1, TILE_W, TILE_W), np.uint8)
                grown[:len(tiles)] = tiles
                tiles = grown
            tiles[lo:hi + 1] = blob
            pos += cnt * 32
        elif cmd_id == LOAD_PALETTE:
            off = pos * 2
            entries = np.frombuffer(cmd, np.uint8, count=pal_size * 4,
                                    offset=off + 2).reshape(pal_size, 4)
            if palettes.shape[1] != pal_size:
                grown = np.zeros((256, pal_size, 4), np.uint8)
                keep = min(pal_size, palettes.shape[1])
                grown[:, :keep] = palettes[:, :keep]
                palettes = grown
            palettes = palettes.copy()
            palettes[cmd[off]] = entries
            pos += (2 + pal_size * 4) // 2
        elif cmd_id == SKIP_BLOCK:
            tm_pos += attrs + 1
        elif cmd_id == SHORT_TILE_IDX:
            cur_pos.append(tm_pos)
            cur_tile.append(int(words[pos]))
            cur_attr.append(attrs)
            tm_pos += 1
            pos += 1
        elif cmd_id == LONG_TILE_IDX:
            cur_pos.append(tm_pos)
            cur_tile.append(dword(pos))
            cur_attr.append(attrs)
            tm_pos += 1
            pos += 2
        elif cmd_id == FRAME_END:
            if blocks is None or tm_pos != tw * th:
                raise ValueError(f'frame {len(frames)}: incomplete tilemap')
            _blit(blocks, tiles, palettes, np.asarray(cur_pos, np.int64),
                  np.asarray(cur_tile, np.int64),
                  np.asarray(cur_attr, np.int64))
            frames.append(blocks.reshape(th, tw, TILE_W, TILE_W, 3)
                          .transpose(0, 2, 1, 3, 4)
                          .reshape(th * TILE_W, tw * TILE_W, 3).copy())
            cur_pos, cur_tile, cur_attr = [], [], []
            tm_pos = 0
        else:
            raise ValueError(f'unknown command {cmd_id} at word {pos - 1}')
    if len(frames) != n_frames:
        raise ValueError(f'{len(frames)} frames decoded, the header says '
                         f'{n_frames}')
    if frames and frames[0].shape[:2] != (height, width):
        raise ValueError('frame size differs from the header')
    return np.stack(frames) if frames else \
        np.zeros((0, height, width, 3), np.uint8)


def _blit(blocks, tiles, palettes, positions, tile_idx, attrs) -> None:
    """Draw the cells of one frame onto the [cells, 8, 8, 3] canvas."""
    if positions.size == 0:
        return
    if tile_idx.max() >= len(tiles) or positions.max() >= len(blocks):
        raise ValueError('tile or cell index out of range')
    pix = tiles[tile_idx]
    hm, vm = (attrs & 1).astype(bool), (attrs & 2).astype(bool)
    pix = np.where(hm[:, None, None], pix[:, :, ::-1], pix)
    pix = np.where(vm[:, None, None], pix[:, ::-1, :], pix)
    pal = palettes[attrs >> 2][..., :3]                  # [n, S, 3]
    if pix.max(initial=0) >= pal.shape[1]:
        raise ValueError('pixel index past the palette')
    rgb = np.take_along_axis(pal, pix.reshape(len(pix), -1, 1)
                             .astype(np.int64), axis=1)
    blocks[positions] = rgb.reshape(len(pix), TILE_W, TILE_W, 3)


def psnr(decoded: np.ndarray, source: np.ndarray) -> float:
    """PSNR (dB) of two uint8 clips of one shape, the squared error summed
    in float64 frame by frame (the port's bench arithmetic); inf where
    they are equal."""
    if decoded.shape != source.shape:
        raise ValueError(f'shapes differ: {decoded.shape} vs {source.shape}')
    sq = 0.0
    for x, y in zip(decoded, source):
        d = (x.astype(np.float64) - y.astype(np.float64)).ravel()
        sq += float(d @ d)
    mse = sq / source.size
    return float('inf') if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
