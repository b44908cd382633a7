"""The port's compile-check entry points (tiler_tpu_torch.graft_entry) against
the JAX package's (__graft_entry__) on the CPU: entry()'s example
arguments byte for byte and its forward step within the PsyV features'
tolerance (tests/test_torch_features.py), and dryrun_multichip's stream
equal to tiler_tpu's 1-device encode of the dryrun clip. Without a card
and without devices= both raise: nothing falls back to the CPU."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from tiler_tpu.config import EncoderConfig as JaxConfig
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch import graft_entry
from tiler_tpu_torch.ops import features

torch.set_num_threads(1)

# the features' tolerance (tests/test_torch_features.py); a winner may
# differ only where the two candidates' float64 distances lie within
# NEAR_TIE of each other
RTOL, ATOL, NEAR_TIE = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope='module')
def jax_stream():
    """tiler_tpu's 1-device stream of the dryrun clip at the dryrun's
    config (mesh_kmodes does nothing without a mesh)."""
    cfg = JaxConfig(palette_count=8, tile_palette_size=16, max_tiles=120,
                    mesh_kmodes=True)
    return JaxEncoder(cfg).run_all(jentry._dryrun_clip(), fast_lzma=True)


def test_example_args_are_the_jax_entrys():
    _, (tiles, cands) = graft_entry.entry('cpu')
    _, (jtiles, jcands) = jentry.entry()
    assert tiles.dtype == torch.uint8 and tiles.shape == (256, 8, 8, 3)
    assert cands.dtype == torch.float32 and cands.shape == (512, 192)
    assert tiles.device.type == cands.device.type == 'cpu'
    assert tiles.numpy().tobytes() == jtiles.tobytes()
    assert cands.numpy().tobytes() == jcands.tobytes()


def test_ft_forward_matches_jax():
    fn, args = graft_entry.entry('cpu')
    idx, err = fn(*args)
    jfn, jargs = jentry.entry()
    jidx, jerr = (np.asarray(a) for a in jfn(*jargs))
    assert idx.dtype == torch.int32 and err.dtype == torch.float32
    assert idx.shape == err.shape == (256,)
    np.testing.assert_allclose(err.numpy(), jerr, rtol=RTOL, atol=ATOL)
    bad = np.flatnonzero(idx.numpy() != jidx)
    if bad.size:
        q = features.psyv_features_rgb(args[0][bad], use_wavelets=True)
        c = args[1].double()
        da = ((q.double() - c[idx[bad].long()]) ** 2).sum(1)
        db = ((q.double() - c[torch.from_numpy(jidx[bad]).long()]) ** 2
              ).sum(1)
        gap = (da - db).abs() / torch.maximum(da, db)
        assert bool((gap <= NEAR_TIE).all()), gap
    assert bad.size <= 2


@pytest.mark.parametrize('n', [1, 8])
def test_dryrun_multichip_writes_the_jax_stream(jax_stream, n, capsys):
    got = graft_entry.dryrun_multichip(n, devices=['cpu'] * n)
    assert got == jax_stream
    shape = {1: {'gop': 1, 'frame': 1}, 8: {'gop': 2, 'frame': 4}}[n]
    out = capsys.readouterr().out
    assert f'dryrun_multichip OK: mesh={shape}, ' in out
    assert f'gtm_bytes={len(jax_stream)}, ' in out


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match='CUDA'):
        graft_entry.dryrun_multichip(2)
