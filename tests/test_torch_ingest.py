"""Ingestion in the port (ffmpeg argv, the fps scrape, the faked ffmpeg
flows, PNG sequences, and EncoderConfig's ingestion fields start_frame,
frame_count, scaling and fps): equal to the JAX package's on the same
inputs. No ffmpeg binary is needed."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import os
import shutil

import numpy as np
import numpy.testing  # noqa: F401  (load before shutil.which is patched)
import pytest

from tiler_tpu.pipeline import load as J
from tiler_tpu_torch.pipeline import load as L


@pytest.mark.parametrize('args', [
    ('in.mp4', 'x/%04d.png', 10, 5, 0.5), ('v.avi', 'o/%04d.png'),
    ('a b.mkv', '%06d.png', 0, 1, 2.0), ('v.avi', 'o.png', 3)])
def test_ffmpeg_argv_is_the_original(args):
    got = L.ffmpeg_args(*args)
    assert got == J.ffmpeg_args(*args)
    assert got[-1] == args[1] and got[got.index('-pix_fmt') + 1] == 'rgb24'
    raw = L.ffmpeg_rawvideo_args(args[0], *args[2:])
    assert raw == J.ffmpeg_rawvideo_args(args[0], *args[2:])
    assert raw[-3:] == ['-f', 'rawvideo', '-']


def test_ffmpeg_args_range_and_scale():
    args = L.ffmpeg_args('in.mp4', 'x/%04d.png', start_frame=10,
                         frame_count=5, scale=0.5)
    vf = args[args.index('-vf') + 1]
    assert 'between(n\\,10\\,14)' in vf
    assert 'scale=iw*0.5:ih*0.5:flags=lanczos' in vf
    assert args[args.index('-frames:v') + 1] == '5'
    assert '-frames:v' not in L.ffmpeg_args('v.avi', 'o/%04d.png')


@pytest.mark.parametrize('stderr,expect', [
    ('Stream #0:0: Video: h264, yuv420p, 1280x720, 1074 kb/s, '
     '29.97 fps, 30 tbr, 90k tbn', 29.97),
    ('Stream #0:0(und): Video: mpeg4, 352x288 [SAR 1:1], 25 fps, '
     '25 tbr, 25 tbn', 25.0),
    ('Video: rawvideo, rgb24, 160x96, 23.976 fps, 23.98 tbr', 23.976),
    ('no rate info anywhere', 24.0),
    ('Video: h264, 640x480, 30 tbr, 90k tbn', 30.0),      # tbr fallback
    ('Duration: 00:00:10.00, start: 0.000000', 24.0),
    ('0 fps, 12.5 tbr', 12.5),
])
def test_parse_ffmpeg_fps(stderr, expect):
    assert L.parse_ffmpeg_fps(stderr) == J.parse_ffmpeg_fps(stderr) == expect


def test_frames_from_video_with_fake_ffmpeg(monkeypatch, rng):
    from PIL import Image
    from tiler_tpu_torch.utils import progress
    monkeypatch.setattr(shutil, 'which', lambda name: '/fake/ffmpeg')
    src = rng.integers(0, 255, (3, 32, 48, 3)).astype(np.uint8)
    seen = {}

    def fake_run(argv, echo=False, text=True, timeout=None):
        assert argv[0] == '/fake/ffmpeg'
        outdir = os.path.dirname(argv[-1])
        seen['dir'] = outdir
        for i, fr in enumerate(src):
            Image.fromarray(fr).save(
                os.path.join(outdir, '%04d.png' % (i + 1)))
        return 0, '', 'Stream #0:0: Video: h264, 48x32, 29.97 fps, 30 tbr'

    monkeypatch.setattr(progress, 'run_command', fake_run)
    frames, fps = L.frames_from_video('whatever.mp4', frame_count=3)
    assert fps == 29.97
    np.testing.assert_array_equal(frames, src)
    assert not os.path.exists(seen['dir'])    # the PNG spool is removed


def test_frames_from_video_ffmpeg_failure(monkeypatch):
    from tiler_tpu_torch.utils import progress
    monkeypatch.setattr(shutil, 'which', lambda name: '/fake/ffmpeg')
    monkeypatch.setattr(
        progress, 'run_command',
        lambda argv, echo=False, text=True, timeout=None:
        (1, '', 'in.mp4: No such file or directory'))
    with pytest.raises(RuntimeError, match='ffmpeg failed'):
        L.frames_from_video('in.mp4')


def test_no_ffmpeg_binary(monkeypatch):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='not available'):
        L.frames_from_video('in.mp4')
    with pytest.raises(RuntimeError, match='not available'):
        L.open_video_stream('in.mp4')


_FAKE = """#!/usr/bin/env python3
import os, re, sys
import numpy as np
frames = np.load({src!r})
args = sys.argv[1:]
m = re.search(r'between\\(n\\\\,(\\d+)\\\\,(\\d+)\\)', ' '.join(args))
lo, hi = int(m.group(1)), int(m.group(2))
sel = frames[lo:hi + 1]
sys.stderr.write('Stream #0:0: Video: rawvideo, rgb24, 40x24, '
                 '25 fps, 25 tbr\\n')
if args[-1] == '-':
    sys.stdout.buffer.write(sel.tobytes(){cut})
    {die}
else:
    from PIL import Image
    for i, fr in enumerate(sel):
        Image.fromarray(fr).save(args[-1] % (i + 1))
"""


def _fake_ffmpeg(tmp_path, monkeypatch, src, cut='', die='pass'):
    src_npy = str(tmp_path / 'src.npy')
    np.save(src_npy, src)
    fake = tmp_path / 'ffmpeg'
    fake.write_text(_FAKE.format(src=src_npy, cut=cut, die=die))
    fake.chmod(0o755)
    monkeypatch.setattr(shutil, 'which', lambda name: str(fake))


def test_open_video_stream_with_fake_ffmpeg(monkeypatch, tmp_path, rng):
    src = rng.integers(0, 255, (5, 24, 40, 3)).astype(np.uint8)
    _fake_ffmpeg(tmp_path, monkeypatch, src)
    it, fps, (h, w) = L.open_video_stream('whatever.mp4')
    assert (h, w) == (24, 40) and fps == 25.0
    np.testing.assert_array_equal(np.stack(list(it)), src)
    it2, _, _ = L.open_video_stream('x.mp4', start_frame=1, frame_count=3)
    np.testing.assert_array_equal(np.stack(list(it2)), src[1:4])
    # an abandoned iterator ends its process and does not raise
    it3, _, _ = L.open_video_stream('x.mp4')
    next(it3)
    it3.close()


@pytest.mark.parametrize('cut,die,match', [
    ('[:2 * 24 * 40 * 3]',
     "sys.stderr.write('boom: decoder exploded\\n'); sys.exit(1)", 'boom'),
    ('[:-7]', 'pass', 'mid-frame')])
def test_open_video_stream_failure_raises(monkeypatch, tmp_path, rng, cut,
                                          die, match):
    src = rng.integers(0, 255, (4, 24, 40, 3)).astype(np.uint8)
    _fake_ffmpeg(tmp_path, monkeypatch, src, cut=cut, die=die)
    it, _fps, _hw = L.open_video_stream('x.mp4')
    with pytest.raises(RuntimeError, match=match):
        list(it)


def test_png_order_is_numeric_past_9999(tmp_path, rng):
    from PIL import Image
    nums = [999, 2000, 9999, 10000, 10001, 123456]
    for n in nums:
        Image.fromarray(np.full((8, 8, 3), n % 251, np.uint8)).save(
            tmp_path / f'{n:04d}.png')
    pattern = str(tmp_path / '*.png')
    got = L.sorted_frame_paths(pattern)
    assert got == J.sorted_frame_paths(pattern)
    assert [int(os.path.basename(p)[:-4]) for p in got] == nums
    frames = L.frames_from_pngs(pattern)
    assert frames.shape == (6, 8, 8, 3)
    assert [int(f[0, 0, 0]) for f in frames] == [n % 251 for n in nums]
    with pytest.raises(FileNotFoundError):
        L.sorted_frame_paths(str(tmp_path / 'none*.png'))


@pytest.mark.parametrize('start,count,scale', [(0, 0, 1.0), (1, 3, 0.5),
                                               (2, 0, 2.0)])
def test_ingestion_fields_select_the_jax_frames(monkeypatch, tmp_path, rng,
                                                start, count, scale):
    """start_frame, frame_count and scaling, as the CLI hands them from
    the config to both readers: the same frames and fps as the JAX
    package's readers, from one faked ffmpeg."""
    src = rng.integers(0, 255, (5, 24, 40, 3)).astype(np.uint8)
    _fake_ffmpeg(tmp_path, monkeypatch, src)
    got, fps = L.frames_from_video('x.mp4', start, count, scale)
    want, jfps = J.frames_from_video('x.mp4', start, count, scale)
    assert fps == jfps == 25.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, src[start:][:count or None])
    it, fps, hw = L.open_video_stream('x.mp4', start, count, scale)
    jit, jfps, jhw = J.open_video_stream('x.mp4', start, count, scale)
    assert (fps, hw) == (jfps, jhw)
    np.testing.assert_array_equal(np.stack(list(it)), np.stack(list(jit)))


def test_fps_reaches_the_stream_as_in_jax(rng):
    """The fps handed to run_all (the CLI's --fps, EncoderConfig.fps)
    lands in the stream as the JAX package writes it."""
    from tiler_tpu.config import EncoderConfig as JaxConfig
    from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.pipeline.encoder import Encoder
    frames = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    kw = dict(palette_count=2, tile_palette_size=4)
    want = JaxEncoder(JaxConfig(**kw)).run_all(frames, fps=30.0,
                                               fast_lzma=True)
    enc = Encoder(EncoderConfig(**kw), device='cpu')
    assert enc.run_all(frames, fps=30.0, fast_lzma=True) == want
    assert Encoder(EncoderConfig(**kw), device='cpu').run_all(
        frames, fps=24.0, fast_lzma=True) != want
