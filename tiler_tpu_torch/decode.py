"""GTM decoder: command interpreter + tile-blit renderer.

Reproduces the JS/Canvas player semantics
(reference decoders/htmljs/gtm.player.js:274-363): a persistent canvas,
per-frame commands drawing 8x8 tiles through palette LUTs with 4-way
mirroring, SkipBlock leaving previous pixels intact, palettes reloadable per
keyframe. The renderer here is a batched gather: for all drawn cells of a
frame, rgb = palette[attrs>>2][tile_pixels] with mirror flips applied as
array reversals — one fused gather instead of the player's per-pixel blit
loops (gtm.player.js:182-251). The first half of the module is the numpy
decoder, kept equal to tiler_tpu/decode.py; the second half renders on a
torch device (decode_video_torch, decode_video_torch_scan), the
counterparts of that module's JAX renderers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bitstream.gtm import CMD_BITS, GTMCommand, ParsedGTM, parse_gtm

TILE_W = 8


@dataclasses.dataclass
class FrameOps:
    """Drawn cells of one frame, in tilemap order."""
    positions: np.ndarray   # [n] int32 cell index (row-major)
    tile_idx: np.ndarray    # [n] int32
    attrs: np.ndarray       # [n] int32 (pal<<2 | vmir<<1 | hmir)
    kf_end: bool
    # palette snapshot *after* this frame's preceding LoadPalette commands
    palettes: np.ndarray    # [256, pal_size, 4] uint8 (RGBA)


@dataclasses.dataclass
class DecodedStream:
    width: int              # pixels
    height: int
    tilemap_w: int
    tilemap_h: int
    frame_len_ns: int
    tiles: np.ndarray       # [tile_count, 8, 8] uint8
    frames: list[FrameOps]


def interpret_commands(parsed: ParsedGTM) -> DecodedStream:
    """Walk the 16-bit command stream into per-frame draw lists.

    Uses the native C++ parser when available (an order of magnitude
    faster on real streams); the Python walk below is the reference
    fallback and the conformance oracle."""
    from . import native
    if native.available():
        return _interpret_native(parsed)
    return interpret_commands_py(parsed)


def _interpret_native(parsed: ParsedGTM) -> DecodedStream:
    from . import native
    tw, th, ns, _ps, tiles, frames_raw = \
        native.gtm_parse_commands(parsed.commands)
    frames = [FrameOps(positions=pos, tile_idx=tile, attrs=attrs,
                       kf_end=kf_end, palettes=pals)
              for (pos, tile, attrs, kf_end, pals) in frames_raw]
    return DecodedStream(
        width=tw * TILE_W, height=th * TILE_W,
        tilemap_w=tw, tilemap_h=th, frame_len_ns=ns,
        tiles=tiles, frames=frames)


class CommandInterpreter:
    """Stateful command-stream walker: feed() accepts any number of
    whole-command chunks (the per-keyframe LZMA streams of a GTM file) and
    yields the frames they complete, carrying dims/tileset/palettes across
    chunks — the streaming form of the JS player's decodeFrame loop
    (gtm.player.js:274-363). interpret_commands_py() is the feed-everything
    wrapper (the conformance oracle for the native parser)."""

    def __init__(self, width: int = 0, height: int = 0):
        self.tilemap_w = width // TILE_W
        self.tilemap_h = height // TILE_W
        self.frame_len_ns = 0
        self.tiles = None
        self.pal_size = 0
        self.palettes = np.zeros((256, 1, 4), np.uint8)
        self._tm_pos = 0
        self._cur_pos: list[int] = []
        self._cur_tile: list[int] = []
        self._cur_attr: list[int] = []

    def feed(self, data: bytes) -> list[FrameOps]:
        n = len(data) // 2
        words = np.frombuffer(data, np.uint16, count=n)
        pos = 0  # word index
        frames: list[FrameOps] = []
        tm_pos = self._tm_pos
        cur_pos, cur_tile, cur_attr = \
            self._cur_pos, self._cur_tile, self._cur_attr
        tiles, palettes = self.tiles, self.palettes

        def read_dword_at(p):
            return int(words[p]) | (int(words[p + 1]) << 16)

        while pos < n:
            w = int(words[pos]); pos += 1
            cmd = w & ((1 << CMD_BITS) - 1)
            attrs = w >> CMD_BITS

            if cmd == GTMCommand.SET_DIMENSIONS:
                self.tilemap_w = int(words[pos])
                self.tilemap_h = int(words[pos + 1])
                self.frame_len_ns = read_dword_at(pos + 2)
                tile_count = read_dword_at(pos + 4)
                pos += 6
                if tiles is None:
                    tiles = np.zeros((tile_count, TILE_W * TILE_W), np.uint8)
            elif cmd == GTMCommand.TILE_SET:
                tstart = read_dword_at(pos); tend = read_dword_at(pos + 2)
                pos += 4
                self.pal_size = attrs
                cnt = tend - tstart + 1
                byte_off = pos * 2
                blob = np.frombuffer(data, np.uint8, count=cnt * 64,
                                     offset=byte_off).reshape(cnt, 64)
                if tiles is None or tend >= len(tiles):
                    grown = np.zeros((tend + 1, TILE_W * TILE_W), np.uint8)
                    if tiles is not None:
                        grown[:len(tiles)] = tiles
                    tiles = grown
                tiles[tstart:tend + 1] = blob
                pos += cnt * 32  # 64 bytes = 32 words
            elif cmd == GTMCommand.LOAD_PALETTE:
                byte_off = pos * 2
                pal_idx = data[byte_off]
                # data[byte_off+1] is the palette format (0 = RGBA32)
                entries = np.frombuffer(
                    data, np.uint8, count=self.pal_size * 4,
                    offset=byte_off + 2).reshape(self.pal_size, 4)
                if palettes.shape[1] != self.pal_size:
                    grown = np.zeros((256, self.pal_size, 4), np.uint8)
                    grown[:, :palettes.shape[1]] = palettes[:, :self.pal_size]
                    palettes = grown
                palettes = palettes.copy()
                palettes[pal_idx] = entries
                pos += (2 + self.pal_size * 4) // 2
            elif cmd == GTMCommand.SKIP_BLOCK:
                tm_pos += attrs + 1
            elif cmd == GTMCommand.SHORT_TILE_IDX:
                cur_pos.append(tm_pos); cur_tile.append(int(words[pos]))
                cur_attr.append(attrs)
                tm_pos += 1; pos += 1
            elif cmd == GTMCommand.LONG_TILE_IDX:
                cur_pos.append(tm_pos); cur_tile.append(read_dword_at(pos))
                cur_attr.append(attrs)
                tm_pos += 1; pos += 2
            elif cmd == GTMCommand.FRAME_END:
                if tm_pos != self.tilemap_w * self.tilemap_h:
                    raise ValueError(f'incomplete tilemap {tm_pos} != '
                                     f'{self.tilemap_w * self.tilemap_h}')
                frames.append(FrameOps(
                    positions=np.asarray(cur_pos, np.int32),
                    tile_idx=np.asarray(cur_tile, np.int32),
                    attrs=np.asarray(cur_attr, np.int32),
                    kf_end=bool(attrs & 1),
                    palettes=palettes))
                cur_pos, cur_tile, cur_attr = [], [], []
                tm_pos = 0
            else:
                raise ValueError(f'undecoded command {cmd} @{pos}')

        self.tiles, self.palettes = tiles, palettes
        self._tm_pos = tm_pos
        self._cur_pos, self._cur_tile, self._cur_attr = \
            cur_pos, cur_tile, cur_attr
        return frames

    def tiles_3d(self) -> np.ndarray:
        t = self.tiles if self.tiles is not None \
            else np.zeros((0, 64), np.uint8)
        return t.reshape(-1, TILE_W, TILE_W)


def interpret_commands_py(parsed: ParsedGTM) -> DecodedStream:
    interp = CommandInterpreter(parsed.header.width, parsed.header.height)
    frames = interp.feed(parsed.commands)
    return DecodedStream(
        width=interp.tilemap_w * TILE_W, height=interp.tilemap_h * TILE_W,
        tilemap_w=interp.tilemap_w, tilemap_h=interp.tilemap_h,
        frame_len_ns=interp.frame_len_ns,
        tiles=interp.tiles_3d(),
        frames=frames)


def _blit_cells_numpy(canvas: np.ndarray, stream: DecodedStream,
                      ops: FrameOps) -> None:
    """Draw ops onto canvas [H, W, 3] in place."""
    if ops.positions.size == 0:
        return
    tiles = stream.tiles  # [N, 8, 8]
    tpix = tiles[ops.tile_idx]  # [n, 8, 8]
    hm = (ops.attrs & 1).astype(bool)
    vm = (ops.attrs & 2).astype(bool)
    tpix = np.where(hm[:, None, None], tpix[:, :, ::-1], tpix)
    tpix = np.where(vm[:, None, None], tpix[:, ::-1, :], tpix)
    pal = ops.palettes[ops.attrs >> 2]  # [n, S, 4]
    rgb = np.take_along_axis(
        pal[..., :3],
        tpix.reshape(len(tpix), -1, 1).astype(np.int64), axis=1
    ).reshape(len(tpix), TILE_W, TILE_W, 3)
    ys = (ops.positions // stream.tilemap_w) * TILE_W
    xs = (ops.positions % stream.tilemap_w) * TILE_W
    # scatter 8x8 blocks: views per cell (vectorized over pixel dims)
    for i in range(len(ys)):
        canvas[ys[i]:ys[i] + TILE_W, xs[i]:xs[i] + TILE_W] = rgb[i]


def _blit_cells_blocked(canvas_blocks: np.ndarray, stream: DecodedStream,
                        ops: FrameOps) -> None:
    """Same as _blit_cells_numpy but canvas is [TH*TW, 8, 8, 3] blocks —
    a single fancy-index scatter, no per-cell Python loop."""
    if ops.positions.size == 0:
        return
    tpix = stream.tiles[ops.tile_idx]
    hm = (ops.attrs & 1).astype(bool)
    vm = (ops.attrs & 2).astype(bool)
    tpix = np.where(hm[:, None, None], tpix[:, :, ::-1], tpix)
    tpix = np.where(vm[:, None, None], tpix[:, ::-1, :], tpix)
    pal = ops.palettes[ops.attrs >> 2]
    rgb = np.take_along_axis(
        pal[..., :3],
        tpix.reshape(len(tpix), -1, 1).astype(np.int64), axis=1
    ).reshape(len(tpix), TILE_W, TILE_W, 3)
    canvas_blocks[ops.positions] = rgb


def blocks_to_image(blocks: np.ndarray, th: int, tw: int) -> np.ndarray:
    return blocks.reshape(th, tw, TILE_W, TILE_W, 3) \
                 .transpose(0, 2, 1, 3, 4).reshape(th * TILE_W, tw * TILE_W, 3)


def decode_video(data: bytes) -> tuple[np.ndarray, DecodedStream]:
    """Full decode: returns (frames [F, H, W, 3] uint8, stream)."""
    stream = interpret_commands(parse_gtm(data))
    th, tw = stream.tilemap_h, stream.tilemap_w
    blocks = np.zeros((th * tw, TILE_W, TILE_W, 3), np.uint8)
    out = np.zeros((len(stream.frames), stream.height, stream.width, 3),
                   np.uint8)
    for f, ops in enumerate(stream.frames):
        _blit_cells_blocked(blocks, stream, ops)
        out[f] = blocks_to_image(blocks, th, tw)
    return out, stream


# ---------------------------------------------------------------------------
# torch renderer: per-frame scatter of drawn blocks, carried canvas state.
# ---------------------------------------------------------------------------

def render_step(canvas_blocks, tiles, palettes, pos, tile_idx, attrs):
    """Draw one frame's cells on the device: canvas_blocks [cells,8,8,3]
    uint8 (updated in place and returned), tiles [N,8,8] uint8, palettes
    [256,S,3] uint8, and the draw list pos/tile_idx/attrs [n] integer
    tensors. The lists are passed at their own length: torch's scatter
    has no drop mode, so no padding row is ever built."""
    import torch
    tpix = tiles[tile_idx.long()]                       # [n, 8, 8] uint8
    hm = (attrs & 1).bool()
    vm = (attrs & 2).bool()
    tpix = torch.where(hm[:, None, None], tpix.flip(2), tpix)
    tpix = torch.where(vm[:, None, None], tpix.flip(1), tpix)
    pal = palettes[(attrs >> 2).long()]                 # [n, S, 3]
    rgb = torch.take_along_dim(
        pal, tpix.reshape(tpix.shape[0], TILE_W * TILE_W, 1).long(), dim=1
    ).reshape(tpix.shape[0], TILE_W, TILE_W, 3)
    canvas_blocks[pos.long()] = rgb
    return canvas_blocks


def _blocks_to_image_torch(blocks, th: int, tw: int):
    """blocks_to_image on a tensor [..., th*tw, 8, 8, 3], on its device,
    so that what comes down is already the image."""
    lead = blocks.shape[:-4]
    n = len(lead)
    x = blocks.reshape(*lead, th, tw, TILE_W, TILE_W, 3)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, th * TILE_W, tw * TILE_W, 3)


def decode_video_torch_scan(data: bytes, device='cuda') -> np.ndarray:
    """Whole-video device render with ONE upload of the draw lists and ONE
    download of the frames.

    Every frame's draw list goes up in one flat array (each frame reads
    its own slice, so nothing is padded); a host loop enqueues the
    frames' gathers with no synchronize between them into one
    [F, cells, 8, 8, 3] uint8 tensor, each frame starting from the one
    before it (SkipBlock cells keep previous content by construction),
    and the stacked canvases, laid out as images on the device, come down
    once."""
    import torch

    from .pipeline.encoder import resolve_device
    dev = resolve_device(device)
    stream = interpret_commands(parse_gtm(data))
    th, tw = stream.tilemap_h, stream.tilemap_w
    cells = th * tw
    f = len(stream.frames)
    if f == 0:
        return np.zeros((0, stream.height, stream.width, 3), np.uint8)
    counts = [ops.positions.size for ops in stream.frames]
    ends = np.cumsum(counts)
    lists = np.stack([
        np.concatenate([getattr(ops, name) for ops in stream.frames])
        for name in ('positions', 'tile_idx', 'attrs')]).astype(np.int32)
    lists_d = torch.from_numpy(lists).to(dev)
    pals_d = torch.from_numpy(np.stack(
        [ops.palettes[..., :3] for ops in stream.frames])).to(dev)
    tiles_d = torch.from_numpy(np.ascontiguousarray(stream.tiles)).to(dev)
    out = torch.zeros((f, cells, TILE_W, TILE_W, 3), dtype=torch.uint8,
                      device=dev)
    for i in range(f):
        if i:
            out[i].copy_(out[i - 1])
        lo, hi = int(ends[i]) - counts[i], int(ends[i])
        render_step(out[i], tiles_d, pals_d[i], lists_d[0, lo:hi],
                    lists_d[1, lo:hi], lists_d[2, lo:hi])
    return _blocks_to_image_torch(out, th, tw).cpu().numpy()


def decode_video_torch(data: bytes, device='cuda') -> np.ndarray:
    """Decode with the device scatter renderer, one frame at a time: each
    frame's draw list goes up and its canvas comes down, as a player
    would show it. Returns frames [F,H,W,3]."""
    import torch

    from .pipeline.encoder import resolve_device
    dev = resolve_device(device)
    stream = interpret_commands(parse_gtm(data))
    th, tw = stream.tilemap_h, stream.tilemap_w
    cells = th * tw
    tiles_d = torch.from_numpy(np.ascontiguousarray(stream.tiles)).to(dev)
    canvas = torch.zeros((cells, TILE_W, TILE_W, 3), dtype=torch.uint8,
                         device=dev)
    out = np.zeros((len(stream.frames), stream.height, stream.width, 3),
                   np.uint8)
    for i, ops in enumerate(stream.frames):
        canvas = render_step(
            canvas, tiles_d,
            torch.from_numpy(np.ascontiguousarray(
                ops.palettes[..., :3])).to(dev),
            torch.from_numpy(ops.positions).to(dev),
            torch.from_numpy(ops.tile_idx).to(dev),
            torch.from_numpy(ops.attrs).to(dev))
        out[i] = _blocks_to_image_torch(canvas, th, tw).cpu().numpy()
    return out
