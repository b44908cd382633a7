"""Command line: encode / decode / inspect GTM streams — the
counterpart of tiler_tpu/__main__.py, with its verbs (encode, decode,
transcode, info, serve, preview, debug) and its flags.

The reference is GUI-driven (main.lfm); this CLI exposes the same knob set
through flags (SURVEY.md §5.6) plus decode and stream inspection. Every
verb that uses a device takes --device (default cuda) and exits 2 when
that device is missing; nothing carries on on the CPU by itself. The
multi-device encoder: --devices N shards the frame-axis-parallel stages
across a mesh of the first N CUDA cards (N logical shards of the CPU
with --device cpu), --hosts N runs the N-host GOP-sharded encode in
process, --distributed joins a torch.distributed job (gloo) and runs one
host's share of it; each writes the single-device stream.

Examples:
  python -m tiler_tpu_torch encode in_%04d.png out.gtm --palette-count 128
  python -m tiler_tpu_torch encode clip.npy out.gtm --auto-checkpoint ck
  python -m tiler_tpu_torch encode clip.npy out.gtm --stream
  python -m tiler_tpu_torch encode clip.npy out.gtm --hosts 3
  python -m tiler_tpu_torch encode clip.npy out.gtm --device cpu --devices 4
  python -m tiler_tpu_torch decode out.gtm frames_out.npy
  python -m tiler_tpu_torch info out.gtm
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


_DEVICE_HELP = ('torch device the verb runs on; a missing CUDA device '
                'exits 2 (pass cpu to run on the CPU)')


def _add_encode_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument('--device', default='cuda', help=_DEVICE_HELP)
    p.add_argument('--palette-size', type=int, default=16)
    p.add_argument('--palette-count', type=int, default=128)
    p.add_argument('--qb-tiles', type=float, default=2.0)
    p.add_argument('--max-tiles', type=int, default=0)
    p.add_argument('--yliluoma', action='store_true',
                   help='Yliluoma-2 dithering instead of Thomas Knoll')
    p.add_argument('--yil-mix', type=int, default=4)
    p.add_argument('--use-var', action='store_true',
                   help='Value-at-Risk quantizer instead of Dennis Lee v3')
    p.add_argument('--dl-bpc', type=int, default=7)
    p.add_argument('--pal-var', type=float, default=95.0)
    p.add_argument('--no-wavelets', action='store_true')
    p.add_argument('--ft-quality', choices=['fast', 'medium', 'slow'],
                   default='medium')
    p.add_argument('--smoothing', type=float, default=20.0,
                   help='temporal smoothing strength / 1000')
    p.add_argument('--enc-gamma', type=float, default=1.8)  # main.lfm:400
    p.add_argument('--dithering-gamma', action='store_true')
    p.add_argument('--ft-gamma', action='store_true')
    p.add_argument('--fps', type=float, default=24.0)
    p.add_argument('--start-frame', type=int, default=0)
    p.add_argument('--frame-count', type=int, default=0)
    p.add_argument('--scaling', type=float, default=1.0)
    p.add_argument('--reload-gts', default=None,
                   help='reuse a previous GTS tileset instead of KModes')
    p.add_argument('--gts-out', default=None, help='dump tileset as GTS')
    p.add_argument('--start-step', default='load')
    p.add_argument('--end-step', default='save')
    p.add_argument('--checkpoint', default=None,
                   help='write a resumable state checkpoint after encoding')
    p.add_argument('--resume', default=None,
                   help='resume from a state checkpoint')
    p.add_argument('--auto-checkpoint', default=None, metavar='PATH',
                   help='failure recovery: persist the state to PATH after '
                        'every completed step; if PATH already exists, '
                        'resume from the step after the last completed one '
                        '(the file is removed on successful completion)')
    p.add_argument('--fast-lzma', action='store_true')
    p.add_argument('--lzma-mode', choices=('lc3', 'lc8', 'auto', 'best'),
                   default='auto',
                   help="keyframe stream compressor: per-keyframe auto "
                        "(default: min of native optimal-parse lc=8 and "
                        "liblzma lc=3 — smallest measured, lc3 fallback "
                        "without a C++ toolchain), native lc=8 "
                        "(lzma.exe -lc8 parity), liblzma lc=3 only, or "
                        "best (sweeps native (lc,lp,pb) configs too — "
                        "~1% smaller again at ~3x the compression cost)")
    p.add_argument('--stream', action='store_true',
                   help='bounded-memory streaming encode: GOPs are '
                        'detected online, encoded independently (per-GOP '
                        'tilesets, the --hosts container form) and '
                        'appended to disk as they complete — RAM stays '
                        'O(one GOP) regardless of clip length')
    p.add_argument('--devices', type=int, default=1,
                   help='shard the frame-axis-parallel encoder stages '
                        'across the first N local devices (a '
                        "('gop','frame') mesh; byte-identical stream)")
    p.add_argument('--mesh-kmodes', action='store_true',
                   help='with --devices N: run the GlobalTiling KModes '
                        'solves distributed across the mesh too '
                        '(bit-identical; default keeps the vmapped '
                        'single-device batch solver, which measures '
                        'faster when bins are small — see '
                        'EncoderConfig.mesh_kmodes)')
    p.add_argument('--hosts', type=int, default=1,
                   help='N-host GOP-sharded encode (in-process simulation;'
                        ' byte-identical to the single-host stream)')
    p.add_argument('--gop-local-tilesets', action='store_true',
                   help='with --hosts: per-GOP tilesets (zero cross-host'
                        ' tile traffic, larger stream) instead of the'
                        ' exact shared-tileset collectives')
    p.add_argument('--distributed', action='store_true',
                   help='real multi-process encode: run this command on'
                        ' every host of a distributed job')
    p.add_argument('--coordinator', default=None,
                   help='coordinator address host:port of the'
                        ' distributed job')
    p.add_argument('--num-processes', type=int, default=None)
    p.add_argument('--process-id', type=int, default=None)


def _config_from_args(a) -> 'EncoderConfig':
    from .config import EncoderConfig, FTQuality
    return EncoderConfig(
        tile_palette_size=a.palette_size, palette_count=a.palette_count,
        qb_tiles=a.qb_tiles, max_tiles=a.max_tiles,
        use_thomas_knoll=not a.yliluoma, yliluoma_mix=a.yil_mix,
        use_dl3=not a.use_var, dl3_bpc=a.dl_bpc, pal_var=a.pal_var / 100.0,
        use_wavelets=not a.no_wavelets,
        ft_quality=FTQuality[a.ft_quality.upper()],
        smoothing_strength=a.smoothing / 1000.0,
        encoder_gamma=a.enc_gamma, dithering_gamma=a.dithering_gamma,
        ft_gamma=a.ft_gamma, fps=a.fps, start_frame=a.start_frame,
        frame_count=a.frame_count, scaling=a.scaling,
        reload_tileset=a.reload_gts, lzma_mode=a.lzma_mode,
        mesh_kmodes=getattr(a, 'mesh_kmodes', False),
        start_step=a.start_step, end_step=a.end_step)


def _pattern_to_glob(path: str) -> str:
    """in_%04d.png -> in_*.png (any printf-style frame field)."""
    import re
    return re.sub(r'%0?\d*d', '*', path) if '%' in path else path


def _load_input(path: str, a):
    from .pipeline import load as load_mod
    if path.endswith('.npy'):
        return np.load(path), a.fps
    if '%' in path or path.endswith('.png'):
        pattern = _pattern_to_glob(path)
        return load_mod.frames_from_pngs(pattern), a.fps
    return load_mod.frames_from_video(path, a.start_frame, a.frame_count,
                                      a.scaling)


def _refusal(a) -> str | None:
    """Why the parsed command cannot run here, or None: a --device that
    does not exist."""
    if hasattr(a, 'device'):
        from .pipeline.encoder import resolve_device
        try:
            resolve_device(a.device)
        except RuntimeError as e:
            return f'{e} (pass --device cpu to run the port on the CPU)'
    return None


def _mesh_from_args(a):
    """The --devices N mesh, or None for one device: the first N CUDA
    cards, or N logical shards of the CPU with --device cpu."""
    if a.devices <= 1:
        return None
    import torch

    from .parallel.mesh import make_mesh
    from .parallel.mesh_pipeline import mesh_ok
    if torch.device(a.device).type == 'cpu':
        mesh = make_mesh(devices=['cpu'] * a.devices)
    else:
        try:
            mesh = make_mesh(a.devices)
        except ValueError as e:
            raise SystemExit(f'--devices {a.devices}: {e}') from None
    if not mesh_ok(mesh):
        raise SystemExit(f'--devices {a.devices}: device count must be a '
                         'power of two')
    return mesh


def cmd_encode(a) -> int:
    from .pipeline.encoder import Encoder
    from .render import reconstruction_psnr
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    if a.distributed:
        return _cmd_encode_distributed(a)
    if a.hosts > 1:
        return _cmd_encode_hosts(a)
    if a.stream:
        return _cmd_encode_stream(a)
    import dataclasses
    import os

    from .constants import ENCODER_STEPS

    from .utils.checkpoint import checkpoint_path

    cfg = _config_from_args(a)
    resume_from = a.resume
    resume_state = None
    if a.auto_checkpoint and not resume_from and \
            os.path.exists(checkpoint_path(a.auto_checkpoint)):
        # crash recovery: restart from the step after the last completed
        # one (the reference's closest analogue is its start-step run
        # over in-memory state, main.pas:1232-1272 — here it survives
        # the process). A corrupt/unreadable checkpoint must not wedge
        # the encode — warn and start fresh.
        try:
            probe = load_checkpoint(a.auto_checkpoint, a.device)
            done_step = probe.metrics.get('completed_step')
        except Exception as e:  # noqa: BLE001
            print(f'auto-checkpoint: unreadable ({e}); starting fresh',
                  flush=True)
            probe, done_step = None, None
        if done_step in ENCODER_STEPS:
            # resume at the step AFTER the completed one, clamped to
            # end_step: a crash after the final step's hook (or a rerun
            # with an earlier --end-step) re-runs just that final step
            nxt = ENCODER_STEPS[min(ENCODER_STEPS.index(done_step) + 1,
                                    ENCODER_STEPS.index(cfg.end_step))]
            print(f'auto-checkpoint: resuming at step {nxt!r} '
                  f'(completed: {done_step})', flush=True)
            cfg = dataclasses.replace(cfg, start_step=nxt)
            resume_from = a.auto_checkpoint
            resume_state = probe

    mesh = _mesh_from_args(a)
    enc = Encoder(cfg, device=a.device, mesh=mesh)
    if resume_from:
        enc.state = resume_state if resume_state is not None \
            else load_checkpoint(resume_from, enc.device)
        enc.state = dataclass_replace_config(enc.state, enc.config)
        if mesh is not None:
            enc.state.mesh = mesh  # not serialized; re-attach after load
        frames = enc.state.frames_rgb
        fps = enc.state.fps
    else:
        frames, fps = _load_input(a.input, a)

    step_hook = None
    if a.auto_checkpoint:
        def step_hook(step):
            enc.state.metrics['completed_step'] = step
            save_checkpoint(a.auto_checkpoint, enc.state)
            # fault injection for recovery tests: die right after
            # persisting the named step
            if os.environ.get('TILER_CRASH_AFTER_STEP') == step:
                print(f'injected crash after {step!r}', flush=True)
                raise SystemExit(13)
    blob = enc.run_all(frames, fps=fps, fast_lzma=a.fast_lzma,
                       step_hook=step_hook)
    if a.gts_out and enc.state.tile_active is not None:
        from .bitstream.gtm import write_gts
        n_act = int(enc.state.tile_active.sum())
        write_gts(a.gts_out, enc.state.tiles_pal[:n_act],
                  enc.config.tile_palette_size)
    if blob:
        open(a.output, 'wb').write(blob)
    # recovery state is removed only after the outputs are safely on
    # disk — a crash between run_all and the write must stay resumable
    if a.auto_checkpoint and os.path.exists(
            checkpoint_path(a.auto_checkpoint)):
        os.remove(checkpoint_path(a.auto_checkpoint))
    if a.checkpoint:
        save_checkpoint(a.checkpoint, enc.state)
    metrics = {k: v for k, v in enc.state.metrics.items()
               if isinstance(v, (int, float, str, list, dict))}
    try:
        metrics['psnr'] = round(reconstruction_psnr(enc.state), 3)
    except Exception:  # noqa: BLE001
        pass
    metrics['step_times'] = {k: round(v, 3)
                             for k, v in enc.state.step_times.items()}
    metrics['device'] = str(enc.device)
    print(json.dumps(metrics))
    return 0


def _cmd_encode_hosts(a) -> int:
    """In-process N-host GOP-sharded encode (--hosts N): the exact
    shared-tileset form, or per-GOP tilesets with --gop-local-tilesets."""
    frames, fps = _load_input(a.input, a)
    cfg = _config_from_args(a)
    if a.gop_local_tilesets:
        from .parallel.distributed import encode_gop_sharded
        blob = encode_gop_sharded(frames, cfg, n_hosts=a.hosts, fps=fps,
                                  fast_lzma=a.fast_lzma, device=a.device)
    else:
        from .parallel.gop_exact import encode_gop_sharded_exact
        blob = encode_gop_sharded_exact(frames, cfg, n_hosts=a.hosts,
                                        fps=fps, fast_lzma=a.fast_lzma,
                                        device=a.device)
    open(a.output, 'wb').write(blob)
    print(json.dumps(dict(hosts=a.hosts, gtm_bytes=len(blob),
                          exact=not a.gop_local_tilesets)))
    return 0


def _cmd_encode_distributed(a) -> int:
    """Real multi-process encode: run on every process of a
    torch.distributed job (--coordinator host:port, --num-processes,
    --process-id, or the TILER_* environment); process 0 writes the
    stream."""
    import torch.distributed as dist

    from .parallel.distributed import init_distributed
    from .parallel.gop_exact import ProcessComm, encode_multihost
    init_distributed(a.coordinator, a.num_processes, a.process_id)
    try:
        frames, fps = _load_input(a.input, a)
        blob = encode_multihost(frames, _config_from_args(a), fps=fps,
                                fast_lzma=a.fast_lzma, device=a.device)
        job = ProcessComm()
        if job.rank == 0:
            open(a.output, 'wb').write(blob)
            print(json.dumps(dict(processes=job.n_hosts,
                                  gtm_bytes=len(blob))))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def dataclass_replace_config(state, config):
    state.config = config
    return state


def cmd_decode(a) -> int:
    from .decode import decode_video
    data = open(a.input, 'rb').read()
    frames, stream = decode_video(data)
    if a.output.endswith('.npy'):
        np.save(a.output, frames)
    else:
        from PIL import Image
        for i, fr in enumerate(frames):
            Image.fromarray(fr).save(a.output % i if '%' in a.output
                                     else f'{a.output}.{i:04d}.png')
    print(json.dumps(dict(frames=len(frames), width=stream.width,
                          height=stream.height,
                          tiles=int(stream.tiles.shape[0]))))
    return 0


def _cmd_encode_stream(a) -> int:
    """Bounded-memory streaming encode (pipeline.stream): frames arrive
    lazily (.npy memory-mapped / PNGs one file at a time / video through
    a single ffmpeg rawvideo pipe — no PNG spool on disk), GOPs encode as
    they complete."""
    from .pipeline import load as load_mod
    from .pipeline.stream import (encode_streaming, iter_frames_npy,
                                  iter_frames_pngs)
    cfg = _config_from_args(a)
    fps = a.fps
    if a.input.endswith('.npy'):
        frames = iter_frames_npy(a.input)
    elif '%' in a.input or a.input.endswith('.png'):
        frames = iter_frames_pngs(_pattern_to_glob(a.input))
    else:
        # single rawvideo pipe: frames are never all in RAM OR on disk
        frames, fps, _hw = load_mod.open_video_stream(
            a.input, a.start_frame, a.frame_count, a.scaling)
    metrics = encode_streaming(frames, cfg, a.output, fps=fps,
                               fast_lzma=a.fast_lzma, device=a.device,
                               mesh=_mesh_from_args(a))
    print(json.dumps(metrics))
    return 0


def cmd_transcode(a) -> int:
    """Recompress a GTM's keyframe streams with another LZMA mode
    (commands and pixels untouched — the decoded video is identical).
    Useful to shrink existing streams or to produce `lzma.exe -lc8`
    -style files from liblzma-encoded ones."""
    from .bitstream.gtm import transcode_gtm
    data = open(a.input, 'rb').read()
    try:
        out = transcode_gtm(data, lzma_mode=a.lzma_mode)
    except ValueError as e:
        raise ValueError(f'{a.input}: {e}') from e
    with open(a.output, 'wb') as fh:
        fh.write(out)
    print(json.dumps(dict(input_bytes=len(data), output_bytes=len(out),
                          mode=a.lzma_mode,
                          ratio=round(len(out) / max(len(data), 1), 4))))
    return 0


def cmd_info(a) -> int:
    from .bitstream.gtm import parse_gtm
    from .decode import interpret_commands
    data = open(a.input, 'rb').read()
    parsed = parse_gtm(data)
    s = interpret_commands(parsed)
    info = dict(
        width=s.width, height=s.height, frames=len(s.frames),
        tiles=int(s.tiles.shape[0]), frame_len_ns=s.frame_len_ns,
        kf_count=parsed.header.kf_count or
        sum(1 for f in s.frames if f.kf_end),
        file_bytes=len(data),
        commands_bytes=len(parsed.commands),
        avg_bytes_per_sec=parsed.header.average_bytes_per_sec,
        kf_max_bytes_per_sec=parsed.header.kf_max_bytes_per_sec)
    print(json.dumps(info))
    return 0


def cmd_serve(a) -> int:
    """Serve the browser demo page playing a GTM stream
    (decoders/web/index.html?url=stream autoplays)."""
    import functools
    import http.server
    import os
    import shutil
    import tempfile

    webdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'decoders', 'web')
    stage = tempfile.mkdtemp(prefix='tiler_demo_')
    for f in ('index.html', 'gtm_player.js'):
        shutil.copyfile(os.path.join(webdir, f), os.path.join(stage, f))
    shutil.copyfile(a.input, os.path.join(stage, 'stream.gtm'))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=stage)
    with http.server.ThreadingHTTPServer(('127.0.0.1', a.port),
                                         handler) as srv:
        print(f'playing {a.input} at '
              f'http://127.0.0.1:{a.port}/index.html?url=stream.gtm',
              flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
    shutil.rmtree(stage, ignore_errors=True)
    return 0


def cmd_preview(a) -> int:
    """Render the GUI's preview views (source / output / tiles page /
    palette strip, main.pas:3305-3493) from a state checkpoint to PNGs,
    and print the output-vs-source Pearson correlation the GUI shows on
    every scrub (main.pas:3470-3489)."""
    import os

    from PIL import Image

    from .render import (reconstruction_correlation, render_frame,
                         render_palette_strip, render_tiles_page)
    from .utils.checkpoint import load_checkpoint

    state = load_checkpoint(a.checkpoint, a.device)
    os.makedirs(a.outdir, exist_ok=True)
    f = a.frame
    views = a.views.split(',')
    out = {}
    if 'source' in views:
        img = state.frames_rgb[f]
        Image.fromarray(img).save(os.path.join(a.outdir, f'source_{f}.png'))
        out['source'] = f'source_{f}.png'
    if 'output' in views:
        img = render_frame(state, f)
        Image.fromarray(img).save(os.path.join(a.outdir, f'output_{f}.png'))
        out['output'] = f'output_{f}.png'
        out['correlation'] = round(reconstruction_correlation(state, f), 7)
    if 'tiles' in views:
        img = render_tiles_page(state, f, a.page, a.palette)
        Image.fromarray(img).save(
            os.path.join(a.outdir, f'tiles_p{a.page}.png'))
        out['tiles'] = f'tiles_p{a.page}.png'
    if 'palette' in views:
        img = render_palette_strip(state, f)
        Image.fromarray(img).save(os.path.join(a.outdir, 'palette.png'))
        out['palette'] = 'palette.png'
    print(json.dumps(out))
    return 0


def cmd_debug(a) -> int:
    """Debug smoke harness — the F12 button (btnDebugClick,
    main.pas:1274-1315): Yliluoma-2 mixing plans for known colors over a
    seeded random 16-color palette (same Delphi LCG RandInt,
    kmodes.pas:82-87), an integer-HSV round-trip sweep, and a DL3
    quantize of the sweep image. (The reference's dl3quant debug call
    passes misordered arguments; here the quantizer is called sanely:
    64 colors at bpc 6.)"""
    import torch

    from .ops import dither, palette
    from .ops.color import hsv_to_rgb_int_np, rgb_to_hsv_int_np

    # seeded random palette via the reference's LCG
    seed = np.uint32(42)
    pal = np.zeros((16, 3), np.uint8)
    for i in range(16):
        seed = np.uint32(
            (np.uint64(seed) * np.uint64(0x08088405) + 1) & 0xffffffff)
        v = int((np.uint64(seed) * np.uint64(1 << 24)) >> np.uint64(32))
        pal[i] = [(v >> 16) & 0xff, (v >> 8) & 0xff, v & 0xff]
    print('palette:', [f'{r:02x}{g:02x}{b:02x}' for r, g, b in pal])

    cols = np.array([[0xff, 0xff, 0xff], [0xff, 0x80, 0x00],
                     [0x80, 0x80, 0x80], [0x00, 0x00, 0x00]], np.uint8)
    tiles = np.repeat(cols[:, None, None, :], 8, 1).repeat(8, 2)
    pals = np.repeat(pal[None], 4, 0)
    dev = torch.device(a.device)
    out = dither.yliluoma_dither_tiles(
        torch.from_numpy(tiles).to(dev), torch.from_numpy(pals).to(dev),
        mixed_colors=4).cpu().numpy()
    for c, t in zip(cols, out):
        used = sorted(set(int(v) for v in t.ravel()))
        print(f'yliluoma {c[0]:02x}{c[1]:02x}{c[2]:02x} -> plan entries '
              f'{used} ({[f"{pal[u][0]:02x}{pal[u][1]:02x}{pal[u][2]:02x}" for u in used]})')

    # HSV round-trip sweep (h, s in 0..255, v=255), as the GUI draws
    hh, ss = np.meshgrid(np.arange(256), np.arange(256), indexing='ij')
    rgb = hsv_to_rgb_int_np(hh, ss, np.full_like(hh, 255))
    h2, s2, v2 = rgb_to_hsv_int_np(rgb)
    rgb2 = hsv_to_rgb_int_np(h2, s2, v2)
    exact = int((rgb2 == rgb).all(-1).sum())
    print(f'hsv roundtrip: {exact}/65536 pixels stable '
          f'(max channel delta {int(np.abs(rgb2.astype(int) - rgb).max())})')

    pal64 = palette.dl3_palette(rgb.reshape(-1, 3), 64, 6, 0)
    print('dl3 sweep palette (64 colors, bpc 6):')
    for r, g, b in np.asarray(pal64):
        print(f'{r}\t{g}\t{b}')
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='tiler_tpu_torch')
    sub = ap.add_subparsers(dest='cmd', required=True)

    pe = sub.add_parser('encode', help='encode video to GTM')
    pe.add_argument('input', help='.npy clip, PNG pattern, or video file')
    pe.add_argument('output', help='output .gtm path')
    _add_encode_flags(pe)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser('decode', help='decode GTM to frames')
    pd.add_argument('input')
    pd.add_argument('output', help='.npy or PNG pattern with %%d')
    pd.set_defaults(fn=cmd_decode)

    pt = sub.add_parser('transcode',
                        help='recompress keyframe streams (video bytes '
                             'decode identically)')
    pt.add_argument('input')
    pt.add_argument('output')
    pt.add_argument('--lzma-mode', choices=('lc3', 'lc8', 'auto', 'best'),
                    default='auto')
    pt.set_defaults(fn=cmd_transcode)

    pi = sub.add_parser('info', help='inspect a GTM stream')
    pi.add_argument('input')
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser('serve', help='play a GTM in the browser demo page')
    ps.add_argument('input', help='.gtm stream to play')
    ps.add_argument('--port', type=int, default=8711)
    ps.set_defaults(fn=cmd_serve)

    pp = sub.add_parser(
        'preview', help='render GUI preview views from a state checkpoint')
    pp.add_argument('checkpoint', help='state checkpoint (.npz)')
    pp.add_argument('outdir', help='directory for PNGs')
    pp.add_argument('--frame', type=int, default=0)
    pp.add_argument('--views', default='source,output,tiles,palette',
                    help='comma list: source,output,tiles,palette')
    pp.add_argument('--page', type=int, default=0,
                    help='tiles-page index (tilemap_size tiles per page)')
    pp.add_argument('--palette', type=int, default=0,
                    help='palette index for the tiles page')
    pp.add_argument('--device', default='cuda', help=_DEVICE_HELP)
    pp.set_defaults(fn=cmd_preview)

    pdbg = sub.add_parser('debug', help='smoke harness (the F12 button)')
    pdbg.add_argument('--device', default='cuda', help=_DEVICE_HELP)
    pdbg.set_defaults(fn=cmd_debug)
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    why = _refusal(a)
    if why:
        print(f'error: {why}', file=sys.stderr)
        return 2
    try:
        return a.fn(a)
    except BrokenPipeError:
        # stdout consumer went away (e.g. `... | head`): exit quietly
        # like standard Unix tools instead of tracebacking
        import os
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
        return 0


if __name__ == '__main__':
    sys.exit(main())
