"""The streaming encode and the in-process GOP-sharded encode of the port
against each other and against the JAX package's streaming file, byte for
byte, with the port on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from tiler_tpu.config import EncoderConfig as JaxConfig
from tiler_tpu.parallel import distributed as jdist
from tiler_tpu.pipeline import stream as jstream
from tiler_tpu_torch.bitstream.gtm import write_gts
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.parallel import distributed as pdist
from tiler_tpu_torch.pipeline import stream as pstream
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.pipeline.load import detect_keyframes

# the shapes here are tiny and several test processes share the cores:
# one thread each keeps them from spinning on each other
torch.set_num_threads(1)

KW = dict(palette_count=8, tile_palette_size=16, max_tiles=120)


def _multishot(rng, f=14, h=48, w=64):
    """Three hard cuts -> 3-4 keyframes; enough frames that the online
    detector crosses chunk boundaries mid-GOP."""
    frames = np.zeros((f, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(f):
        shot = i // 5
        if shot == 0:
            pat = ((xx * 4 + i * 7) % 256)[..., None] * np.array([1, .7, .4])
        elif shot == 1:
            pat = ((yy * 5 + i * 9) % 256)[..., None] * np.array([.3, .5, 1])
        else:
            pat = (((xx + yy) * 3 + i * 5) % 256)[..., None] \
                * np.array([.8, 1, .3])
        frames[i] = np.clip(pat + rng.normal(0, 5, (h, w, 3)), 0, 255)
    return frames


@pytest.fixture(scope='module')
def clip():
    return _multishot(np.random.default_rng(42381337))


@pytest.fixture(scope='module')
def streamed(clip, tmp_path_factory):
    """The port's streaming file of the clip and its metrics."""
    out = str(tmp_path_factory.mktemp('s') / 's.gtm')
    metrics = pstream.encode_streaming(
        iter(clip), EncoderConfig(**KW), out, fps=24.0, fast_lzma=True,
        chunk=4, device='cpu')
    return open(out, 'rb').read(), metrics


@pytest.mark.parametrize('chunk', [1, 3, 24])
def test_online_detector_matches_batch(chunk):
    frames = _multishot(np.random.default_rng(42381337), f=24)
    cells = (48 // 8) * (64 // 8)
    want = detect_keyframes(frames, cells)
    assert len(want) >= 3
    dets = [pstream.OnlineKeyframeDetector(cells),
            jstream.OnlineKeyframeDetector(cells)]
    for det in dets:
        starts = [0]
        for lo in range(0, len(frames), chunk):
            starts.extend(det.feed(frames[lo:lo + chunk]))
        got = np.array([[starts[k], (starts + [len(frames)])[k + 1] - 1]
                        for k in range(len(starts))], np.int32)
        np.testing.assert_array_equal(got, want)


def test_streaming_matches_gop_sharded(clip, streamed):
    got, metrics = streamed
    want = pdist.encode_gop_sharded(clip, EncoderConfig(**KW), n_hosts=1,
                                    fps=24.0, fast_lzma=True, device='cpu')
    assert got == want
    assert metrics['n_frames'] == 14 and metrics['n_keyframes'] >= 3
    assert metrics['gtm_bytes'] == len(got)
    assert metrics['max_buffered_frames'] < len(clip)
    assert len(metrics['ft_nn_calls']) == metrics['n_keyframes']
    dec, stream = decode_video(got)
    assert dec.shape == clip.shape and stream.width == 64


def test_streaming_matches_jax_streaming_file(clip, streamed, tmp_path):
    out = str(tmp_path / 'j.gtm')
    jm = jstream.encode_streaming(iter(clip), JaxConfig(**KW), out,
                                  fps=24.0, fast_lzma=True, chunk=4)
    got, metrics = streamed
    assert open(out, 'rb').read() == got
    for k in ('n_frames', 'n_keyframes', 'gtm_bytes', 'max_buffered_frames'):
        assert jm[k] == metrics[k], k


def test_gop_sharded_is_host_count_invariant(clip, streamed):
    cfg = EncoderConfig(**KW)
    assert pdist.encode_gop_sharded(clip, cfg, n_hosts=3, fps=24.0,
                                    fast_lzma=True, device='cpu') \
        == streamed[0]


@pytest.mark.parametrize('sizes,n', [([5, 5, 4], 2), ([1, 9, 3, 3], 3),
                                     ([7], 4)])
def test_assign_gops_to_hosts_is_the_original(sizes, n):
    ends = np.cumsum(sizes)
    kf = np.stack([ends - sizes, ends - 1], 1).astype(np.int32)
    got = pdist.assign_gops_to_hosts(kf, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jdist.assign_gops_to_hosts(kf, n))


def test_gop_partition_states_hold_no_device_tensor(clip):
    cfg = EncoderConfig(**KW)
    probe = Encoder(cfg, device='cpu')
    probe.load(clip)
    kf = probe.state.keyframes
    owner = pdist.assign_gops_to_hosts(kf, 2)
    res = pdist.encode_gop_partition(clip, kf, owner, 1, cfg, device='cpu')
    assert [r['kf_index'] for r in res] == list(np.flatnonzero(owner == 1))
    for r in res:
        st = r['state']
        assert st._tiles_pal_dev is None and not st._src_tiles
        assert r['tiles_pal'].shape[1:] == (8, 8)
        assert st.n_frames == r['end'] - r['start'] + 1


def test_streaming_shared_gts_mode(clip, tmp_path):
    """config.reload_tileset: every GOP maps onto one fixed tileset that
    is emitted once; the file equals the JAX package's."""
    first = Encoder(EncoderConfig(**KW), device='cpu')
    first.run_all(clip, fps=24, fast_lzma=True)
    gts = str(tmp_path / 'pass1.gts')
    n = int(first.state.tile_active.sum())
    write_gts(gts, first.state.tiles_pal[:n], 16)
    cfg = EncoderConfig(reload_tileset=gts, **KW)
    out, jout = str(tmp_path / 'r.gtm'), str(tmp_path / 'jr.gtm')
    m = pstream.encode_streaming(iter(clip), cfg, out, fps=24.0,
                                 fast_lzma=True, chunk=5, device='cpu')
    jm = jstream.encode_streaming(
        iter(clip), JaxConfig(reload_tileset=gts, **KW), jout, fps=24.0,
        fast_lzma=True, chunk=5)
    blob = open(out, 'rb').read()
    assert blob == open(jout, 'rb').read()
    assert m['shared_tileset'] == jm['shared_tileset'] == n
    dec, stream = decode_video(blob)
    assert dec.shape == clip.shape and len(stream.tiles) == n


def test_streaming_frame_size_not_a_multiple_of_8(tmp_path):
    frames = _multishot(np.random.default_rng(7), f=7, h=45, w=70)
    cfg = EncoderConfig(**KW)
    out = str(tmp_path / 'odd.gtm')
    pstream.encode_streaming(iter(frames), cfg, out, fps=24.0,
                             fast_lzma=True, chunk=2, device='cpu')
    blob = open(out, 'rb').read()
    assert blob == pdist.encode_gop_sharded(frames, cfg, n_hosts=1, fps=24.0,
                                            fast_lzma=True, device='cpu')
    dec, _ = decode_video(blob)
    assert dec.shape == (7, 40, 64, 3)


def test_streaming_empty_iterator_raises_and_leaves_nothing(tmp_path):
    with pytest.raises(ValueError, match='no frames'):
        pstream.encode_streaming(iter([]), EncoderConfig(**KW),
                                 str(tmp_path / 'e.gtm'), device='cpu')
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError, match='smaller than one tile'):
        pstream.encode_streaming(
            iter([np.zeros((4, 4, 3), np.uint8)]), EncoderConfig(**KW),
            str(tmp_path / 'e.gtm'), device='cpu')
    assert list(tmp_path.iterdir()) == []


def test_frame_iterators(clip, tmp_path):
    from PIL import Image
    np.save(tmp_path / 'c.npy', clip[:3])
    got = list(pstream.iter_frames_npy(str(tmp_path / 'c.npy')))
    assert len(got) == 3 and np.array_equal(np.stack(got), clip[:3])
    for i in (9, 10, 100):
        Image.fromarray(clip[i % 14]).save(tmp_path / f'f{i}.png')
    got = list(pstream.iter_frames_pngs(str(tmp_path / 'f*.png')))
    assert np.array_equal(np.stack(got), clip[[9, 10, 100 % 14]])


def test_streaming_needs_its_device(clip, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(RuntimeError, match='cuda'):
        pstream.encode_streaming(iter(clip), EncoderConfig(**KW),
                                 str(tmp_path / 'x.gtm'))
    assert list(tmp_path.iterdir()) == []


def test_encoder_max_tiles_is_the_original(clip):
    from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
    for kw in (dict(max_tiles=120), dict(max_tiles=10 ** 9), dict(),
               dict(qb_tiles=0.5)):
        enc = Encoder(EncoderConfig(**kw), device='cpu')
        jenc = JaxEncoder(JaxConfig(**kw))
        assert enc.max_tiles() == jenc.max_tiles() == 0
        enc.load(clip[:4])
        jenc.load(clip[:4])
        assert enc.max_tiles() == jenc.max_tiles() > 0
