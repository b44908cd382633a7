"""KModes restarts, palettes of more than 32 colours and GTS reload: the
port's GlobalTiling against the JAX package's from the same state, and
the KModes solver against the JAX package's on the same signatures. All
integer math, so byte-identical."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip_v2
from test_torch_steps import _same
from tiler_tpu.bitstream.gtm import write_gts
from tiler_tpu.config import EncoderConfig
from tiler_tpu.ops import kmodes as jkmodes
from tiler_tpu.pipeline import global_tiling as jgt
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.ops import kmodes
from tiler_tpu_torch.pipeline import global_tiling
from tiler_tpu_torch.pipeline.state import (from_reference_state,
                                            to_reference_state)

BASE = EncoderConfig(palette_count=16, max_tiles=400)
FIELDS = ['tiles_pal', 'tiles_rgb', 'tm_tile', 'tile_use', 'tile_active',
          'tile_dpi']


def _before_gt(cfg):
    """The JAX package's state after MakeUnique for cfg."""
    cfg = dataclasses.replace(cfg, end_step='make_unique')
    enc = JaxEncoder(cfg)
    enc.run_all(synthetic_clip_v2(8, 120, 160), fps=24, fast_lzma=True)
    return enc.state


@pytest.fixture(scope='module')
def states():
    return {16: _before_gt(BASE),
            64: _before_gt(dataclasses.replace(BASE, tile_palette_size=64))}


def _gts(tmp_path):
    """A GTS tileset from a different clip's JAX encode at 8 palette
    colours (reload rescales its indices)."""
    cfg = EncoderConfig(palette_count=8, max_tiles=150, tile_palette_size=8,
                        end_step='global_tiling')
    enc = JaxEncoder(cfg)
    enc.run_all(synthetic_clip_v2(4, 64, 96, seed=5), fps=24)
    path = str(tmp_path / 'prev.gts')
    n = int(enc.state.tile_active.sum())
    write_gts(path, enc.state.tiles_pal[:n], cfg.tile_palette_size)
    return path


@pytest.mark.parametrize('case', ['restarts3', 'palette64', 'reload',
                                  'palette64_broadcast'])
def test_global_tiling_parity(states, case, tmp_path, monkeypatch):
    """GlobalTiling from the JAX package's state, byte-identical:
    kmodes_restarts=3 (three golden-ratio lanes per bin, the lowest cost
    wins), tile_palette_size=64 (64 modalities; the JAX package takes its
    broadcast dissimilarity there), the same with every lane too large
    for the solve budget, so on the port's broadcast path too, and the
    reload of a previous GTS tileset."""
    if case == 'restarts3':
        cfg, st = dataclasses.replace(BASE, kmodes_restarts=3), states[16]
    elif case.startswith('palette64'):
        cfg, st = dataclasses.replace(BASE, tile_palette_size=64), states[64]
        if case == 'palette64_broadcast':
            _broadcast_only(monkeypatch)
    else:
        cfg = dataclasses.replace(BASE, reload_tileset=_gts(tmp_path))
        st = states[16]
    port = from_reference_state(st, 'cpu')
    port.config = cfg
    # the JAX package's step runs on its own copy of the same arrays
    want = to_reference_state(from_reference_state(st, 'cpu'))
    want.config = cfg
    jgt.run_global_tiling(want)
    global_tiling.run_global_tiling(port)
    _same(port, want, FIELDS)
    if case != 'reload':
        assert port.metrics['global_tiling_merged'] == \
            want.metrics['global_tiling_merged'] > 0


def _broadcast_only(monkeypatch) -> list:
    """A solve budget no lane of the matmul path fits: every lane takes
    the broadcast path. Returns the list each broadcast solve appends its
    modality count to."""
    seen = []

    class Spy(kmodes._Broadcast):
        def __init__(self, xi, m):
            seen.append(m)
            super().__init__(xi, m)
    monkeypatch.setattr(kmodes, '_SOLVE_BYTES', 1)
    monkeypatch.setattr(kmodes, '_Broadcast', Spy)
    monkeypatch.setattr(kmodes, '_Encodings', None)   # must not be built
    return seen


def test_golden_ratio_starts_match_jax():
    for n, r in [(1000, 7), (50, 7), (8, 3), (4096, 5), (7, 7), (1, 3)]:
        assert kmodes.golden_ratio_starts(n, r) == \
            jkmodes.golden_ratio_starts(n, r)
    assert kmodes.golden_ratio_starts(1000, 7) == [0, 2, 6, 18, 51, 138, 372]


@pytest.mark.parametrize('m,starts', [(16, [-3, 5, -2]), (32, [-4, 0, 1]),
                                      (33, [1, 1, -4]), (64, [2, -3, 0])])
def test_kmodes_batch_gather_matches_jax(rng, m, starts):
    """Labels and winners equal the JAX package's for single starts and
    restart lanes, on both sides of the JAX package's 32-modality switch;
    bins with duplicated rows make ties."""
    tiles = rng.integers(0, m, (400, 8, 8)).astype(np.uint8)
    tiles[200:260] = tiles[0:60]
    sigs = jgt.tile_signatures(tiles, m)
    sels = [np.arange(0, 150), np.arange(150, 320), np.arange(320, 400)]
    ks = [12, 20, 7]
    want = jkmodes.kmodes_batch_gather(
        jnp.asarray(sigs), [s.astype(np.int32) for s in sels], ks, starts, m)
    iters = []
    got = kmodes.kmodes_batch_gather(torch.from_numpy(sigs), sels, ks,
                                     starts, m, iters_out=iters)
    for (jl, _jc, jw), (tl, tw) in zip(want, got):
        np.testing.assert_array_equal(tl, np.asarray(jl, np.int64))
        np.testing.assert_array_equal(tw, np.asarray(jw))
    lanes = sum(-s if s < 0 else 1 for s in starts)
    assert len(iters) == lanes


@pytest.mark.parametrize('m', [16, 64, 256])
def test_kmodes_broadcast_path_matches_jax(rng, m, monkeypatch):
    """Lanes too large for the matmul's encodings take the broadcast
    path, one lane per solve: labels and winners still equal the JAX
    package's, restart lanes and ties included."""
    tiles = rng.integers(0, m, (300, 8, 8)).astype(np.uint8)
    tiles[150:200] = tiles[0:50]
    sigs = jgt.tile_signatures(tiles, m)
    sels, ks, starts = [np.arange(0, 120), np.arange(120, 300)], [9, 14], \
        [-3, 4]
    want = jkmodes.kmodes_batch_gather(
        jnp.asarray(sigs), [s.astype(np.int32) for s in sels], ks, starts, m)
    seen = _broadcast_only(monkeypatch)
    got = kmodes.kmodes_batch_gather(torch.from_numpy(sigs), sels, ks,
                                     starts, m)
    assert seen == [m] * 4                     # 3 restart lanes + 1
    for (jl, _jc, jw), (tl, tw) in zip(want, got):
        np.testing.assert_array_equal(tl, np.asarray(jl, np.int64))
        np.testing.assert_array_equal(tw, np.asarray(jw))


def test_restart_lanes_do_not_depend_on_grouping(rng, monkeypatch):
    """A solve budget of one lane per solve gives the same result as one
    solve for every lane (padding is masked), and the broadcast path the
    same as the matmul path."""
    tiles = rng.integers(0, 64, (300, 8, 8)).astype(np.uint8)
    sigs = torch.from_numpy(jgt.tile_signatures(tiles, 64))
    sels = [np.arange(0, 90), np.arange(90, 300)]
    one = kmodes.kmodes_batch_gather(sigs, sels, [9, 15], [-3, -2], 64)
    monkeypatch.setattr(kmodes, '_SOLVE_BYTES', 1)
    monkeypatch.setattr(kmodes, '_BLOCK_ELEMS', 1)
    many = kmodes.kmodes_batch_gather(sigs, sels, [9, 15], [-3, -2], 64)
    for (la, wa), (lb, wb) in zip(one, many):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(wa, wb)
