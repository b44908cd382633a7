"""Checkpoint and resume in the port: the npz layout is shared with the JAX
package, so a checkpoint written by either package resumes in the other.
Every comparison is exact (bytes or equal arrays) except the float32
k-means centroids stored in the two packages' checkpoints (rtol and atol
1e-4); the port runs on the CPU."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from bench import synthetic_clip_v2
from tiler_tpu.config import EncoderConfig as JaxConfig
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.utils import checkpoint as jck
from tiler_tpu_torch import __main__ as cli
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.pipeline.state import ARRAY_FIELDS
from tiler_tpu_torch.utils import checkpoint as pck

# the shapes here are tiny and several test processes share the cores:
# one thread each keeps them from spinning on each other
torch.set_num_threads(1)

KW = dict(palette_count=16, max_tiles=400)


@pytest.fixture(scope='module')
def frames():
    return synthetic_clip_v2(8, 120, 160)


@pytest.fixture(scope='module')
def runs(frames, tmp_path_factory):
    """One uninterrupted encode per package; each leaves its checkpoint of
    the state after GlobalTiling behind."""
    d = tmp_path_factory.mktemp('ck')
    out = {}
    for name, enc, mod in (
            ('jax', JaxEncoder(JaxConfig(**KW)), jck),
            ('port', Encoder(EncoderConfig(**KW), device='cpu'), pck)):
        path = str(d / f'{name}.npz')

        def hook(step, enc=enc, mod=mod, path=path):
            if step == 'global_tiling':
                mod.save_checkpoint(path, enc.state)
        blob = enc.run_all(frames, fps=24, fast_lzma=True, step_hook=hook)
        out[name] = dict(blob=blob, ck=path, state=enc.state)
    return out


def test_round_trip_keeps_every_field(runs, tmp_path):
    st = runs['port']['state']
    st.metrics['completed_step'] = 'save'
    path = str(tmp_path / 'full')          # .npz is appended
    pck.save_checkpoint(path, st)
    assert os.path.exists(path + '.npz')
    back = pck.load_checkpoint(path, 'cpu')
    assert back.config == st.config and back.device == torch.device('cpu')
    assert (back.fps, back.tilemap_w, back.tilemap_h) == (24, 20, 15)
    for f in ARRAY_FIELDS:
        a, b = getattr(st, f), getattr(back, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert back.metrics['completed_step'] == 'save'
    assert back.metrics['gtm_bytes'] == len(runs['port']['blob'])
    assert set(back.step_times) == set(st.step_times)


def test_both_checkpoints_hold_the_same_arrays(runs):
    with np.load(runs['jax']['ck']) as a, np.load(runs['port']['ck']) as b:
        assert set(a.files) == set(b.files) >= {'__meta__', 'tiles_pal'}
        for f in a.files:
            if f != '__meta__':
                assert a[f].dtype == b[f].dtype, f
                if f == 'palette_centroids':
                    # k-means centroids: float32 sums in another order
                    np.testing.assert_allclose(a[f], b[f], rtol=1e-4,
                                               atol=1e-4)
                else:
                    assert np.array_equal(a[f], b[f]), f
        ma, mb = (json.loads(bytes(z['__meta__']).decode()) for z in (a, b))
    assert ma['config'] == mb['config']
    assert {k: ma[k] for k in ('fps', 'tilemap_w', 'tilemap_h')} == \
        {k: mb[k] for k in ('fps', 'tilemap_w', 'tilemap_h')}


def test_jax_checkpoint_resumes_in_the_port(runs):
    state = pck.load_checkpoint(runs['jax']['ck'], 'cpu')
    cfg = dataclasses.replace(state.config, start_step='frame_tiling')
    enc = Encoder(cfg, device='cpu')
    state.config = cfg
    enc.state = state
    blob = enc.run_all(state.frames_rgb, fps=state.fps, fast_lzma=True)
    assert blob == runs['port']['blob']
    assert set(enc.state.step_times) >= {'frame_tiling', 'save'}


def test_port_checkpoint_resumes_in_the_jax_package(runs):
    state = jck.load_checkpoint(runs['port']['ck'])
    cfg = dataclasses.replace(state.config, start_step='frame_tiling')
    enc = JaxEncoder(cfg)
    state.config = cfg
    enc.state = state
    blob = enc.run_all(state.frames_rgb, fps=state.fps, fast_lzma=True)
    assert blob == runs['jax']['blob']


def test_save_between_dither_and_reindex_keeps_the_device_tensor(
        frames, tmp_path, monkeypatch):
    enc = Encoder(EncoderConfig(**KW), device='cpu')
    enc.load(frames[:3])
    enc.dither()
    st = enc.state
    dev = st.device_tiles_pal()
    assert st._tiles_pal_host is None       # the device side owns it
    pck.save_checkpoint(str(tmp_path / 'mid'), st)
    assert st._tiles_pal_host is None and st.device_tiles_pal() is dev

    def no_upload(*a, **k):
        raise AssertionError('tiles_pal uploaded a second time')
    monkeypatch.setattr(torch, 'from_numpy', no_upload)
    assert st.device_tiles_pal() is dev
    monkeypatch.undo()
    back = pck.load_checkpoint(str(tmp_path / 'mid'), 'cpu')
    assert np.array_equal(back.tiles_pal, dev.numpy())
    # a loaded state uploads once, on first use
    assert back.device_tiles_pal() is back.device_tiles_pal()


def test_peek_does_not_cache_and_release_device_keeps_the_host(frames):
    enc = Encoder(EncoderConfig(**KW), device='cpu')
    enc.load(frames[:2])
    enc.dither()
    st = enc.state
    snap = st.peek_tiles_pal()
    assert st._tiles_pal_host is None and st._tiles_pal_dev is not None
    st.device_source_tiles()
    st.release_device()
    assert st._tiles_pal_dev is None and not st._src_tiles
    assert np.array_equal(st.tiles_pal, snap)
    assert st.peek_tiles_pal() is st.tiles_pal


def test_checkpoint_tmp_unique_and_crash_safe(frames, tmp_path, monkeypatch):
    enc = Encoder(EncoderConfig(palette_count=4), device='cpu')
    enc.load(frames[:2])
    p = str(tmp_path / 'ck.npz')
    stale = str(tmp_path / 'ck.npz.tmp.stale.npz')
    with open(stale, 'wb') as fh:
        fh.write(b'garbage')
    pck.save_checkpoint(p, enc.state)
    st = pck.load_checkpoint(p, 'cpu')
    np.testing.assert_array_equal(st.frames_rgb, enc.state.frames_rgb)
    assert os.path.exists(stale)  # untouched
    tmps = [f for f in os.listdir(tmp_path)
            if '.tmp.' in f and f != os.path.basename(stale)]
    assert tmps == []
    # a write that dies leaves the earlier checkpoint and no tmp
    before = open(p, 'rb').read()

    def dies(fh, **kw):
        fh.write(b'half')
        raise KeyboardInterrupt
    monkeypatch.setattr(np, 'savez_compressed', dies)
    with pytest.raises(KeyboardInterrupt):
        pck.save_checkpoint(p, enc.state)
    assert open(p, 'rb').read() == before
    assert sorted(os.listdir(tmp_path)) == ['ck.npz', 'ck.npz.tmp.stale.npz']


@pytest.mark.parametrize('path,want', [('a', 'a.npz'), ('a.npz', 'a.npz'),
                                       ('d/x.ck', 'd/x.ck.npz')])
def test_checkpoint_path_is_the_original(path, want):
    assert pck.checkpoint_path(path) == jck.checkpoint_path(path) == want


def test_load_checkpoint_needs_its_device(runs):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(RuntimeError, match='cuda'):
        pck.load_checkpoint(runs['port']['ck'])


def test_corrupt_auto_checkpoint_starts_fresh(frames, tmp_path, capsys):
    clip = str(tmp_path / 'clip.npy')
    np.save(clip, frames[:3, :64, :96])
    ck = tmp_path / 'auto.npz'
    ck.write_bytes(b'not an npz at all')
    args = ['encode', clip, None, '--device', 'cpu', '--palette-count', '8',
            '--max-tiles', '100', '--fast-lzma']
    args[2] = str(tmp_path / 'a.gtm')
    assert cli.main(args + ['--auto-checkpoint', str(ck)]) == 0
    out = capsys.readouterr().out
    assert 'auto-checkpoint: unreadable' in out and 'starting fresh' in out
    assert 'Step: load' in out and not ck.exists()
    args[2] = str(tmp_path / 'b.gtm')
    assert cli.main(args) == 0
    assert (tmp_path / 'a.gtm').read_bytes() == \
        (tmp_path / 'b.gtm').read_bytes()
