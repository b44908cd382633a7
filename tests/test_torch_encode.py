"""The whole slice: the same clip through both packages, the benchmark's
configurations and clips through both, the port's CLI, and the port
running with JAX made unimportable."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from bench import synthetic_clip_v2
from gtmbench.cells import encoder_config
from tiler_tpu.config import EncoderConfig
from tiler_tpu.decode import decode_video
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.utils import checkpoint as jckpt
from tiler_tpu_torch.config import EncoderConfig as PortConfig
from tiler_tpu_torch.decode import decode_video as port_decode
from tiler_tpu_torch.ops import nn_kernels
from tiler_tpu_torch.ops.stats import psnr
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.tools import common
from tiler_tpu_torch.utils import checkpoint as pckpt

# the port's CPU threads would contend with the JAX package's and with
# the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'decoders', 'web', 'sample.gtm')
with open(os.path.join(REPO, 'BENCHMARK.json')) as _fh:
    CONFIG_FILES = {c['name']: os.path.join(REPO, c['file'])
                    for c in json.load(_fh)['configs']}
# each benchmark configuration: the fields in which it differs from
# gtm_default, and the first step that reads them, where its encodes
# resume from each package's own checkpoint of the default encode (None:
# whole encodes)
CONFIGS = {'gtm_default': (set(), None),
           'gtm_kmodes_restarts7': ({'kmodes_restarts'}, 'make_unique'),
           'gtm_ft_slow': ({'ft_quality'}, 'frame_tiling')}
CHECKPOINTED = {'make_unique': 'dither', 'frame_tiling': 'global_tiling'}


def _run(args, **kw):
    # one thread: the shapes are tiny and test processes share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
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


def _fields(name: str) -> dict:
    """A benchmark configuration's encoder fields at 16 palettes."""
    with open(CONFIG_FILES[name]) as fh:
        return dict(json.load(fh)['encoder'], palette_count=16)


def _launches() -> dict:
    return {k: v for k, v in vars(nn_kernels).items()
            if k.startswith('LAUNCHES')}


def _default_encodes(clip: str, d) -> dict:
    """The clip at 8 x 120 x 160; gtm_default's encode by the port and by
    the JAX package's benchmark script (bench.encode_once), each package
    checkpointing its state after the steps in CHECKPOINTED."""
    frames = getattr(common, clip)(8, 120, 160)
    fields = _fields('gtm_default')
    paths = {(pkg, step): str(d / f'{pkg}_{step}.npz')
             for pkg in ('jax', 'port') for step in CHECKPOINTED.values()}

    def hook(pkg, enc, save):
        def step_hook(step):
            if (pkg, step) in paths:
                save(paths[pkg, step], enc.state)
        return step_hook
    enc = Encoder(encoder_config(PortConfig, fields), device='cpu')
    port = enc.run_all(frames, fps=24, fast_lzma=True,
                       step_hook=hook('port', enc, pckpt.save_checkpoint))
    # the script encodes at its own config: gtm_default's at PAL palettes
    assert encoder_config(EncoderConfig, fields) == EncoderConfig(
        palette_count=16, tile_palette_size=16)
    run_all = JaxEncoder.run_all
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbench, 'PAL', 16)
        mp.setattr(JaxEncoder, 'run_all', lambda self, *a, **kw: run_all(
            self, *a, step_hook=hook('jax', self, jckpt.save_checkpoint),
            **kw))
        _, _, jax = jbench.encode_once(frames, warm=False)
    return {'frames': frames, 'port': port, 'jax': jax, 'paths': paths}


@pytest.fixture(scope='module')
def defaults(tmp_path_factory):
    """_default_encodes of a clip, made at its first use."""
    made = {}

    def get(clip):
        if clip not in made:
            d = tmp_path_factory.mktemp(clip)
            made[clip] = _default_encodes(clip, d)
        return made[clip]
    return get


def _resumed(pkg: str, cfg, path: str) -> bytes:
    """An encode from a package's own checkpoint, at cfg.start_step."""
    if pkg == 'jax':
        enc, st = JaxEncoder(cfg), jckpt.load_checkpoint(path)
    else:
        enc, st = Encoder(cfg, device='cpu'), pckpt.load_checkpoint(path,
                                                                     'cpu')
    st.config = cfg
    enc.state = st
    return enc.run_all(st.frames_rgb, fps=st.fps, fast_lzma=True)


@pytest.mark.parametrize('clip', ['synthetic_clip_v2', 'synthetic_clip'])
@pytest.mark.parametrize('config', list(CONFIGS))
def test_two_encoders_write_the_reference_stream(defaults, config, clip):
    """Each benchmark configuration on each benchmark clip, cut to 8 x 120
    x 160 at 16 palettes: two consecutive port Encoders on the CPU write
    one stream, launch no kernel, and write the JAX package's bytes (for
    gtm_default, those of its benchmark script). A configuration that
    differs from gtm_default only from a later step on resumes both
    packages there from their own checkpoint of the default encode, so
    that Dither runs once per clip and package."""
    differs, resume = CONFIGS[config]
    fields = _fields(config)
    assert {k for k, v in _fields('gtm_default').items()
            if fields[k] != v} == differs
    before = _launches()
    ref = defaults(clip)
    if resume is None:
        cfg = encoder_config(PortConfig, fields)
        got = [ref['port'], Encoder(cfg, device='cpu').run_all(
            ref['frames'], fps=24, fast_lzma=True)]
        want = ref['jax']
    else:
        fields['start_step'] = resume
        path = ref['paths']['port', CHECKPOINTED[resume]]
        got = [_resumed('port', encoder_config(PortConfig, fields), path)
               for _ in range(2)]
        want = _resumed('jax', encoder_config(EncoderConfig, fields),
                        ref['paths']['jax', CHECKPOINTED[resume]])
    assert _launches() == before
    assert got[0] == got[1]
    assert got[0] == want, (len(got[0]), len(want))


def test_release_device_drops_the_device_tensors():
    """After run_all, EncoderState.release_device() drops the source tiles
    and the device side of tiles_pal, and keeps the step times, the
    metrics and the tiles on the host (the benchmark releases each
    encode's state so that no later encode's peak counts it)."""
    enc = Encoder(PortConfig(palette_count=8), device='cpu')
    enc.run_all(synthetic_clip_v2(2, 48, 64), fps=24, fast_lzma=True)
    st = enc.state
    assert st._src_tiles and st._tiles_pal_dev is not None
    kept = (dict(st.step_times), dict(st.metrics), st.peek_tiles_pal().copy())
    st.release_device()
    assert st._src_tiles == {} and st._tiles_pal_dev is None
    assert st.step_times == kept[0] and st.metrics == kept[1]
    assert np.array_equal(st.peek_tiles_pal(), kept[2])


def test_sample_stream_reencodes():
    """Frames decoded from the web player's sample stream (the first 8 of
    its 48) re-encode on the CPU to a stream that decodes to their shape,
    at a PSNR against them in (10, 99)."""
    with open(SAMPLE, 'rb') as fh:
        frames = port_decode(fh.read())[0][:8]
    blob = Encoder(PortConfig(palette_count=16), device='cpu').run_all(
        frames, fps=24, fast_lzma=True)
    dec = port_decode(blob)[0]
    assert dec.shape == frames.shape
    assert 10 < psnr(dec, frames) < 99
