"""LZMA framing for GTM keyframe streams.

The reference spawns `lzma.exe e src dst -lc8 -eos` per keyframe
(reference extern.pas:202-240) producing LZMA-alone streams (13-byte
header: props byte, dict-size dword, 8-byte unknown size) terminated by an
end-of-stream marker, concatenated back to back after the GTM header. The
bundled JS player re-reads a header whenever the previous stream finished
(reference decoders/htmljs/lzma.js:692-721), so any valid LZMA-alone
framing decodes; liblzma cannot encode lc=8 (lc+lp<=4), so we emit the
default lc=3 lp=0 pb=2 — the player reads lc/lp/pb from the props byte.
"""
from __future__ import annotations

import lzma


_FILTERS = [{'id': lzma.FILTER_LZMA1, 'preset': 9 | lzma.PRESET_EXTREME}]


def lzma_compress_alone(data: bytes, fast: bool = False) -> bytes:
    """Compress one keyframe's command stream as a standalone .lzma stream."""
    filters = [{'id': lzma.FILTER_LZMA1, 'preset': 1}] if fast else _FILTERS
    comp = lzma.LZMACompressor(format=lzma.FORMAT_ALONE, filters=filters)
    return comp.compress(data) + comp.flush()


def iter_lzma_streams(data: bytes, expected_count: int | None = None,
                      strict: bool = False):
    """Lazily decode a concatenation of LZMA-alone streams, yielding one
    decompressed chunk per stream (= per keyframe) — the incremental
    unpack of the JS player (gtm.player.js:157-170) at keyframe
    granularity.

    Streams with lc+lp<=4 go through liblzma; lc=8 streams (the reference's
    `-lc8` output) go through the native C++ decoder in tiler_tpu_torch.native.

    `expected_count` (the header's kf_count, when the caller knows it)
    turns EVERY short read into an error — without it a corrupt/truncated
    FIRST stream returns whatever decoded, because a headerless container
    has no stream count to check against.

    `strict` raises on ANY truncation/corruption/trailing-garbage, even
    the single-truncated-stream case playback tolerates — for callers
    that REWRITE the container (transcode), where lenience would launder
    a detectably-corrupt input into an apparently-valid output.
    """
    rest = data
    n_done = 0

    def short_read(reason: str):
        if strict:
            raise ValueError(
                f'{reason} ({n_done} keyframe stream(s) decoded)')
        if expected_count is not None and n_done < expected_count:
            raise ValueError(
                f'{reason}: {n_done} of {expected_count} keyframe '
                'streams decoded')

    while len(rest) >= 13:
        props = rest[0]
        lc = props % 9
        lp = (props // 9) % 5
        if lc + lp <= 4:
            dec = lzma.LZMADecompressor(format=lzma.FORMAT_ALONE)
            try:
                chunk = dec.decompress(rest)
            except lzma.LZMAError:
                # First-stream corruption: stop; parse_gtm raises on
                # no-commands-from-nonempty-data. Mid-file corruption
                # must NOT silently truncate the video to fewer frames.
                if n_done:
                    raise ValueError(
                        f'corrupt LZMA stream after keyframe {n_done}')
                short_read('corrupt first LZMA stream')
                return
            yield chunk
            n_done += 1
            if not dec.eof:
                # (unused_data is always empty before eof, so a truncated
                # stream is only detectable by position: any non-final
                # stream cut short means the later keyframes are gone)
                if n_done > 1:
                    raise ValueError(
                        f'truncated LZMA stream at keyframe {n_done}')
                short_read('truncated first LZMA stream')
                return  # single truncated stream: return what we have
            rest = dec.unused_data
        else:
            from ..native import lzma_decode_alone
            try:
                chunk, consumed = lzma_decode_alone(rest)
            except ValueError:
                if n_done:
                    raise ValueError(
                        f'corrupt LZMA stream after keyframe {n_done}')
                short_read('corrupt first LZMA stream')
                return
            yield chunk
            n_done += 1
            if consumed <= 0:
                short_read('unterminated LZMA stream')
                return
            rest = rest[consumed:]
    if strict and rest:
        raise ValueError(f'{len(rest)} trailing bytes after the last '
                         'keyframe stream')
    # a clean end is fine even in strict mode; only a missing-stream
    # count (vs the header's kf_count) is an error here
    if expected_count is not None and n_done < expected_count:
        raise ValueError(
            f'truncated GTM body: {n_done} of {expected_count} keyframe '
            'streams decoded')


def lzma_decompress_concat(data: bytes,
                           expected_count: int | None = None) -> bytes:
    """Decompress a concatenation of LZMA-alone streams (one per keyframe)."""
    return b''.join(iter_lzma_streams(data, expected_count=expected_count))
