"""The whole slice: the same clip through both packages, the port's CLI,
and the port running with JAX made unimportable."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench import synthetic_clip_v2
from tiler_tpu.config import EncoderConfig
from tiler_tpu.decode import decode_video
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.ops.stats import psnr
from tiler_tpu_torch.pipeline.encoder import Encoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600, **kw)


def test_slice_matches_jax_package():
    frames = synthetic_clip_v2(8, 120, 160, seed=3)
    cfg = EncoderConfig(palette_count=16, max_tiles=400)
    jblob = JaxEncoder(cfg).run_all(frames, fps=24, fast_lzma=True)
    enc = Encoder(cfg, device='cpu')
    blob = enc.run_all(frames, fps=24, fast_lzma=True)
    dec, stream = decode_video(blob)
    assert dec.shape == frames.shape and stream.width == 160
    p_port = psnr(dec, frames)
    p_jax = psnr(decode_video(jblob)[0], frames)
    assert abs(p_port - p_jax) <= 0.05, (p_port, p_jax)
    m = enc.state.metrics
    assert m['n_keyframes'] == 3 and m['gtm_bytes'] == len(blob)
    assert set(enc.state.step_times) == {
        'load', 'dither', 'make_unique', 'global_tiling', 'frame_tiling',
        'reindex', 'smooth', 'save'}
    assert {'mark', 'cand_feats', 'assign'} <= set(m['ft_phases'])
    assert 0 < m['ft_q_changed_frac'] < 1


def test_cli_encode_decode_on_cpu(tmp_path):
    clip = tmp_path / 'clip.npy'
    np.save(clip, synthetic_clip_v2(4, 64, 96, seed=1))
    out = _run(['-m', 'tiler_tpu_torch', 'encode', str(clip),
                str(tmp_path / 'o.gtm'), '--device', 'cpu',
                '--palette-count', '8', '--max-tiles', '100',
                '--gts-out', str(tmp_path / 't.gts')])
    assert out.returncode == 0, out.stderr
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics['device'] == 'cpu' and metrics['psnr'] > 15
    from tiler_tpu.bitstream.gtm import read_gts
    tiles, pal_size = read_gts(str(tmp_path / 't.gts'))
    assert pal_size == 16 and tiles.shape[1:] == (8, 8)
    assert len(tiles) == metrics['reindexed_tiles']
    out = _run(['-m', 'tiler_tpu_torch', 'decode', str(tmp_path / 'o.gtm'),
                str(tmp_path / 'd.npy')])
    assert out.returncode == 0, out.stderr
    assert np.load(tmp_path / 'd.npy').shape == (4, 64, 96, 3)


def test_cli_refuses_missing_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    clip = tmp_path / 'clip.npy'
    np.save(clip, synthetic_clip_v2(2, 16, 16))
    out = _run(['-m', 'tiler_tpu_torch', 'encode', str(clip),
                str(tmp_path / 'o.gtm')])
    assert out.returncode != 0
    assert 'cuda' in out.stderr.lower()
    assert not (tmp_path / 'o.gtm').exists()


def test_bare_encoder_state_runs_on_the_card():
    """An EncoderState built without a device is on 'cuda', as Encoder:
    without a card it raises instead of running on the CPU; a step
    function given such a state never falls back on its own."""
    import torch

    from tiler_tpu_torch.config import EncoderConfig as Config
    from tiler_tpu_torch.pipeline.state import EncoderState
    if torch.cuda.is_available():
        assert EncoderState(config=Config()).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            EncoderState(config=Config())
    st = EncoderState(config=Config(), device='cpu')
    assert st.device == torch.device('cpu') and st.mesh.flat == [st.device]


@pytest.mark.parametrize('clip', ['noise', 'constant'])
def test_port_runs_without_jax(clip):
    """The port encodes with jax, the JAX package and its benchmark
    script unimportable; the constant clip (one
    distinct tile, fewer candidates than the 8-NN asks for) is one the
    JAX package cannot encode."""
    code = (
        "import sys\n"
        "for m in ('jax', 'tiler_tpu', 'bench'): sys.modules[m] = None\n"
        "import numpy as np, tiler_tpu_torch\n"
        "from tiler_tpu_torch.pipeline.encoder import Encoder\n"
        "from tiler_tpu_torch.config import EncoderConfig\n"
        "from tiler_tpu_torch.decode import decode_video\n"
        "rng = np.random.default_rng(0)\n"
        "fr = rng.integers(0, 255, (3, 32, 48, 3)).astype(np.uint8)\n"
        "fr[1:, 16:] = fr[0, 16:]\n"
        f"if {clip!r} == 'constant': fr[:] = 77\n"
        "enc = Encoder(EncoderConfig(palette_count=4, max_tiles=40), "
        "device='cpu')\n"
        "blob = enc.run_all(fr, fps=24, fast_lzma=True)\n"
        "assert decode_video(blob)[0].shape == fr.shape\n"
        "assert not any(m.split('.')[0] in ('jax', 'tiler_tpu', 'bench') "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', len(blob))\n")
    out = _run(['-c', code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith('ok')
