"""Native (C++) runtime components, bound via ctypes.

Built lazily with g++ on first use from the sources in this directory
into build/tiler_tpu_torch/ at the repository root (never into the
package). Each binding has a pure-Python capability check so the package
still imports on systems without a toolchain (features needing the
library raise NoToolchainError then).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), 'build',
                         'tiler_tpu_torch')
_SO_PATH = os.path.join(BUILD_DIR, 'libtiler_native.so')
_SOURCES = ['lzma1.cc', 'lzma1_enc.cc', 'dl3.cc', 'gtm_pack.cc',
            'fs_dither.cc']
_lock = threading.Lock()
_lib = None
_build_error: Exception | None = None


def _needs_build() -> bool:
    if not os.path.exists(_SO_PATH):
        return True
    so_mtime = os.path.getmtime(_SO_PATH)
    for src in _SOURCES:
        p = os.path.join(_DIR, src)
        if os.path.exists(p) and os.path.getmtime(p) > so_mtime:
            return True
    return False


class NoToolchainError(RuntimeError):
    """No C++ compiler on this host (g++ not found).

    Distinct from a nonzero compile exit: callers that can degrade
    gracefully (e.g. lzma_mode='auto' falling back to liblzma) should
    fall back ONLY on this — a compile error in the .cc sources is a
    real breakage that must surface, not silently downgrade output."""


def _build() -> None:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES
            if os.path.exists(os.path.join(_DIR, s))]
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = ['g++', '-O3', '-march=native', '-fno-math-errno',
           '-shared', '-fPIC', '-std=c++17', '-o', tmp] + srcs
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO_PATH)   # two processes building at once: no torn file
    except FileNotFoundError as e:
        raise NoToolchainError('g++ not found on this host') from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Returns the loaded ctypes library, building it if needed."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        try:
            if _needs_build():
                _build()
            lib = ctypes.CDLL(_SO_PATH)
        except Exception as e:  # noqa: BLE001
            _build_error = e
            raise
        lib.tiler_lzma_decode_alone.restype = ctypes.c_void_p
        lib.tiler_lzma_decode_alone.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int)]
        lib.tiler_free.argtypes = [ctypes.c_void_p]
        lib.tiler_lzma_encode_alone.restype = ctypes.c_void_p
        lib.tiler_lzma_encode_alone.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)]
        lib.tiler_lzma_encode_alone2.restype = ctypes.c_void_p
        lib.tiler_lzma_encode_alone2.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)]
        lib.tiler_dl3_quant.restype = ctypes.c_int
        lib.tiler_dl3_quant.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.tiler_dl3_quant_capped.restype = ctypes.c_int
        lib.tiler_dl3_quant_capped.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.tiler_dl3_quant_tiles_capped.restype = ctypes.c_int
        lib.tiler_dl3_quant_tiles_capped.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tiler_dl3_quant_bins.restype = ctypes.c_int
        lib.tiler_dl3_quant_bins.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.tiler_gtm_parse.restype = ctypes.c_void_p
        lib.tiler_gtm_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)]
        lib.tiler_gtm_free.argtypes = [ctypes.c_void_p]
        lib.tiler_gtm_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.tiler_gtm_tiles.restype = ctypes.c_void_p
        lib.tiler_gtm_tiles.argtypes = [ctypes.c_void_p]
        lib.tiler_gtm_frame.restype = ctypes.c_int
        lib.tiler_gtm_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.tiler_gtm_palettes.restype = ctypes.c_void_p
        lib.tiler_gtm_palettes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tiler_fs_posterize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.tiler_fs_tile.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except Exception:  # noqa: BLE001
        return False


_warned_pure_python_lzma = False


def lzma_decode_alone(data: bytes) -> tuple[bytes, int]:
    """Decode one LZMA-alone stream (any lc 0..8). Returns (out, consumed).

    On hosts without a C++ toolchain this degrades to the pure-Python
    decoder (bitstream.pylzma1, ~1 MB/s, differentially tested against
    this fast path incl. consumed counts) so default-`auto` encoded
    files stay decodable everywhere."""
    try:
        lib = get_lib()
    except Exception:
        global _warned_pure_python_lzma
        if not _warned_pure_python_lzma:
            _warned_pure_python_lzma = True
            import warnings
            warnings.warn('native LZMA decoder unavailable (no C++ '
                          'toolchain); using the pure-Python fallback '
                          '(~1 MB/s)')
        from ..bitstream.pylzma1 import decode_alone
        return decode_alone(data)
    out_len = ctypes.c_size_t()
    consumed = ctypes.c_size_t()
    status = ctypes.c_int()
    ptr = lib.tiler_lzma_decode_alone(data, len(data),
                                      ctypes.byref(out_len),
                                      ctypes.byref(consumed),
                                      ctypes.byref(status))
    if status.value != 0 or not ptr:
        raise ValueError(f'lzma decode failed (status {status.value})')
    try:
        out = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.tiler_free(ptr)
    return out, consumed.value


def lzma_encode_alone(data: bytes, lc: int = 8, lp: int = 0, pb: int = 2,
                      depth: int = 128, nice_len: int = 128,
                      optimal: bool = True) -> bytes:
    """Encode one LZMA-alone stream with the full lc 0..8 range — the
    `lzma.exe e -lc8 -eos` equivalent (reference extern.pas:224)
    liblzma cannot produce (it enforces lc+lp<=4).

    optimal=True runs the windowed price-DP parse (lzma.exe's own parse
    class): measured 2,038,816 B on the reference city command payloads
    vs the reference file's 2,051,899 and liblzma lc3's 2,056,939
    (docs/RESULTS.md). False = the ~8x-faster greedy+lazy parse."""
    lib = get_lib()
    out_len = ctypes.c_size_t()
    status = ctypes.c_int()
    ptr = lib.tiler_lzma_encode_alone2(data, len(data), lc, lp, pb,
                                       depth, nice_len,
                                       1 if optimal else 0,
                                       ctypes.byref(out_len),
                                       ctypes.byref(status))
    if status.value != 0 or not ptr:
        raise ValueError(f'lzma encode failed (status {status.value})')
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.tiler_free(ptr)


def dl3_quant(pixels_rgb, quant_to: int, lookup_bpc: int):
    """Dennis Lee v3 palette from flat [M,3] uint8 pixels.

    Returns ([quant_to,3] uint8 palette, n_produced)."""
    import numpy as np
    lib = get_lib()
    px = np.ascontiguousarray(pixels_rgb, np.uint8)
    out = np.zeros((quant_to, 3), np.uint8)
    n = lib.tiler_dl3_quant(px.ctypes.data_as(ctypes.c_char_p), px.shape[0],
                            quant_to, lookup_bpc,
                            out.ctypes.data_as(ctypes.c_void_p))
    return out, n


def dl3_quant_capped(pixels_rgb, quant_to: int, lookup_bpc: int,
                     cap: int):
    """DL3 with the C++-internal bin cap (no host-side pre-reduce)."""
    import numpy as np
    lib = get_lib()
    px = np.ascontiguousarray(pixels_rgb, np.uint8)
    out = np.zeros((quant_to, 3), np.uint8)
    n = lib.tiler_dl3_quant_capped(
        px.ctypes.data_as(ctypes.c_char_p), px.shape[0], quant_to,
        lookup_bpc, cap, out.ctypes.data_as(ctypes.c_void_p))
    return out, n


def dl3_quant_tiles_capped(tiles_rgb, sel, quant_to: int, lookup_bpc: int,
                           cap: int):
    """DL3 over whole 8x8 tiles selected by index from a [N,8,8,3] array —
    identical to dl3_quant_capped(tiles_rgb[sel].reshape(-1,3), ...)
    without materializing the gathered pixel copy."""
    import numpy as np
    lib = get_lib()
    t = np.ascontiguousarray(tiles_rgb, np.uint8)
    s = np.ascontiguousarray(sel, np.int32)
    out = np.zeros((quant_to, 3), np.uint8)
    n = lib.tiler_dl3_quant_tiles_capped(
        t.ctypes.data_as(ctypes.c_void_p),
        s.ctypes.data_as(ctypes.c_void_p), len(s), quant_to, lookup_bpc,
        cap, out.ctypes.data_as(ctypes.c_void_p))
    return out, n


def dl3_quant_bins(r_sums, g_sums, b_sums, counts, quant_to: int):
    """DL3 greedy reduction from pre-aggregated bins (int64 arrays)."""
    import numpy as np
    lib = get_lib()
    r = np.ascontiguousarray(r_sums, np.int64)
    g = np.ascontiguousarray(g_sums, np.int64)
    b = np.ascontiguousarray(b_sums, np.int64)
    c = np.ascontiguousarray(counts, np.int64)
    out = np.zeros((quant_to, 3), np.uint8)
    n = lib.tiler_dl3_quant_bins(
        r.ctypes.data_as(ctypes.c_void_p), g.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p), c.ctypes.data_as(ctypes.c_void_p),
        len(c), quant_to, out.ctypes.data_as(ctypes.c_void_p))
    return out, n


def gtm_parse_commands(commands: bytes):
    """Parse a decompressed GTM command stream natively.

    Returns (tilemap_w, tilemap_h, frame_ns, pal_size, tiles [N,8,8] u8,
    frames: list of (pos i32[], tile i32[], attrs i32[], kf_end bool,
    palettes [256, pal_size, 4] u8)). Arrays are copies (handle is freed)."""
    import numpy as np
    lib = get_lib()
    status = ctypes.c_int()
    h = lib.tiler_gtm_parse(commands, len(commands), ctypes.byref(status))
    if not h:
        raise ValueError('gtm parse failed (null handle)')
    try:
        if status.value != 0:
            raise ValueError(f'gtm parse failed (status {status.value})')
        tw = ctypes.c_int32()
        th = ctypes.c_int32()
        ns = ctypes.c_int64()
        tc = ctypes.c_int64()
        ps = ctypes.c_int32()
        nf = ctypes.c_int32()
        lib.tiler_gtm_info(h, ctypes.byref(tw), ctypes.byref(th),
                           ctypes.byref(ns), ctypes.byref(tc),
                           ctypes.byref(ps), ctypes.byref(nf))
        tiles_ptr = lib.tiler_gtm_tiles(h)
        n_tiles = max(tc.value, 0)
        tiles = np.frombuffer(
            ctypes.string_at(tiles_ptr, n_tiles * 64), np.uint8
        ).reshape(n_tiles, 8, 8).copy() if n_tiles else \
            np.zeros((0, 8, 8), np.uint8)
        frames = []
        for f in range(nf.value):
            pp = ctypes.c_void_p()
            tp = ctypes.c_void_p()
            ap = ctypes.c_void_p()
            n = ctypes.c_int32()
            kfe = ctypes.c_int32()
            lib.tiler_gtm_frame(h, f, ctypes.byref(pp), ctypes.byref(tp),
                                ctypes.byref(ap), ctypes.byref(n),
                                ctypes.byref(kfe))
            cnt = n.value

            def arr(ptr):
                if cnt == 0:
                    return np.zeros(0, np.int32)
                return np.frombuffer(ctypes.string_at(ptr, cnt * 4),
                                     np.int32).copy()
            pal_ptr = lib.tiler_gtm_palettes(h, f)
            pals = np.frombuffer(
                ctypes.string_at(pal_ptr, 256 * max(ps.value, 1) * 4),
                np.uint8).reshape(256, max(ps.value, 1), 4).copy()
            frames.append((arr(pp.value), arr(tp.value), arr(ap.value),
                           bool(kfe.value), pals))
        return (tw.value, th.value, ns.value, ps.value, tiles, frames)
    finally:
        lib.tiler_gtm_free(h)


def lzma_decode_concat(data: bytes) -> bytes:
    """Decode concatenated LZMA-alone streams (GTM keyframe framing)."""
    out = []
    off = 0
    while off + 13 <= len(data):
        chunk, consumed = lzma_decode_alone(data[off:])
        out.append(chunk)
        if consumed == 0:
            break
        off += consumed
    return b''.join(out)


def fs_posterize(frame_rgb, bits: int):
    """Whole-frame Floyd-Steinberg posterize to `bits` per component
    (DitherFloydSteinberg, main.pas:1966-1996). Returns a new array."""
    import numpy as np
    lib = get_lib()
    h, w, _ = frame_rgb.shape
    buf = np.ascontiguousarray(frame_rgb, np.uint8).copy()
    lib.tiler_fs_posterize(buf.ctypes.data_as(ctypes.c_void_p),
                           h, w, bits)
    return buf


def fs_tile(tile_rgb, bits: int):
    """Per-tile FS diffusion with replicated borders
    (DitherTileFloydSteinberg, main.pas:1877-1929)."""
    import numpy as np
    lib = get_lib()
    src = np.ascontiguousarray(tile_rgb, np.uint8)
    dst = np.empty_like(src)
    lib.tiler_fs_tile(src.ctypes.data_as(ctypes.c_void_p), bits,
                      dst.ctypes.data_as(ctypes.c_void_p))
    return dst
