"""The experiment tools (tiler_tpu_torch.tools) at tiny sizes on the CPU,
where they run the kernels' plain versions, the decode benchmark and
what the tools share, and the encoder flags of the port's CLI."""
import dataclasses
import glob
import hashlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench import synthetic_clip_v2
from tiler_tpu.bitstream.gtm import read_gts
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.constants import ENCODER_STEPS
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.ops import nn_kernels as nk
from tiler_tpu_torch.pipeline import frame_tiling
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.tools import (assign_opt_bench, common, decode_bench,
                                   nn_prec_bench, profile_encode,
                                   stage3_precision)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'decoders', 'web', 'sample.gtm')


def _run(args):
    # one thread: the shapes are tiny and test processes share the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)


def test_nn_prec_bench_on_cpu(capsys):
    before = (nk.LAUNCHES, nk.LAUNCHES_BF16)
    res = nn_prec_bench.main(['100', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert res['n_c'] == 4096 and res['n_q'] == 16384  # n_c rounds up
    assert 0.5 < res['agree_f32_bf16'] <= res['agree_f32_bf16_rounded'] <= 1
    for line in ('device: cpu', 'nn1_f32:', 'nn1_bf16:',
                 'winner agreement f32 vs bf16:', 'nn1_bf16_rounded:',
                 'winner agreement f32 vs bf16-rounded:'):
        assert line in out
    assert (nk.LAUNCHES, nk.LAUNCHES_BF16) == before


def test_assign_opt_bench_on_cpu(capsys, monkeypatch):
    monkeypatch.setenv('AOB_Q', '96')
    monkeypatch.setenv('AOB_C', '3000')
    monkeypatch.setenv('AOB_N', '512')
    res = assign_opt_bench.main(['--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'shapes: Q=96 C=3000 D=192' in out
    assert res['agree_f32_aug'] == 1.0 and res['differ_f32_aug'] == 0
    assert res['truth_agree_f32'] == res['truth_agree_aug'] == 1.0
    assert res['lut_bit_equal'] is True
    monkeypatch.setenv('AOB_SKIP_NN', '1')
    res = assign_opt_bench.main(['--quick', '--device', 'cpu'])
    assert 'nn1_ms' not in res and res['lut_n'] == 512


def test_stage3_precision_on_cpu():
    """Both encodes of the stage-3 tool at a tiny size: the K1 route is
    the encoder's own stream, the K3 route parts from it, the winners of
    every stage-3 query are compared, and stage 3 is the encoder's again
    after the tool."""
    res = stage3_precision.main(['--frames', '4', '--height', '48',
                                 '--width', '64', '--palettes', '8',
                                 '--device', 'cpu'])
    want = Encoder(EncoderConfig(palette_count=8), device='cpu').run_all(
        synthetic_clip_v2(4, 48, 64), fps=24, fast_lzma=True)
    assert res['k1']['sha256'] == hashlib.sha256(want).hexdigest()
    assert res['k1']['gtm_bytes'] == len(want)
    assert res['k3']['sha256'] != res['k1']['sha256']
    assert res['k1']['ft_nn_calls'] == res['k3']['ft_nn_calls'] > 0
    assert res['stage3_queries'] > 0 and 0 < res['winner_agreement'] < 1
    assert res['psnr_drop_db'] == res['k1']['psnr'] - res['k3']['psnr']
    assert res['tiler_tpu_psnr_of_record'] == 29.282
    for run in ('k1', 'k3'):          # the plain versions: no launch
        assert set(res[run]['launches'].values()) == {0}
    assert frame_tiling.nn_kernels is nk


def test_run_all_profile_dir_writes_a_trace(tmp_path):
    """run_all takes the JAX package's arguments in its order; with
    profile_dir the run is traced and one Chrome trace holding every
    step's annotation appears there; the stream is the untraced one."""
    from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
    assert list(inspect.signature(Encoder.run_all).parameters) == \
        list(inspect.signature(JaxEncoder.run_all).parameters)
    frames = synthetic_clip_v2(2, 16, 24)
    cfg = EncoderConfig(palette_count=2, tile_palette_size=4)
    want = Encoder(cfg, device='cpu').run_all(frames, fast_lzma=True)
    prof = str(tmp_path / 'prof')
    assert Encoder(cfg, device='cpu').run_all(frames, None, True, prof) == want
    trace, = glob.glob(os.path.join(prof, '*.pt.trace.json'))
    with open(trace) as fh:
        names = {e['name'] for e in json.load(fh)['traceEvents']
                 if e.get('cat') == 'user_annotation'}
    assert {f'step:{s}' for s in ENCODER_STEPS} <= names


def test_profile_encode_on_cpu():
    """The profiling tool reads run_all's trace: every step with its
    wall time; on the CPU the card is busy for none of it."""
    res = profile_encode.main(['--frames', '2', '--height', '16',
                               '--width', '24', '--palettes', '2',
                               '--device', 'cpu'])
    assert set(res['steps']) == set(ENCODER_STEPS)
    assert all(s['wall_s'] > 0 for s in res['steps'].values())
    assert res['busy_s'] == 0 and res['top_kernels'] == []


@pytest.mark.parametrize('tool', ['nn_prec_bench', 'assign_opt_bench',
                                  'stage3_precision', 'profile_encode',
                                  'decode_bench'])
def test_tools_refuse_missing_cuda(tool):
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    argv = [SAMPLE] if tool == 'decode_bench' else []
    with pytest.raises(RuntimeError, match='cuda'):
        globals()[tool].main(argv)


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_card_line(monkeypatch, device):
    """The device type off a card; on one, the first line nvidia-smi
    prints for the card's name and power limit (stubbed here: no card is
    touched)."""
    def run(argv, **kw):
        assert argv == ['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader']
        return subprocess.CompletedProcess(
            argv, 0, 'NVIDIA H100 80GB HBM3, 700.00 W\nsecond card\n', '')
    monkeypatch.setattr(common.subprocess, 'run', run)
    want = 'cpu' if device == 'cpu' else 'NVIDIA H100 80GB HBM3, 700.00 W'
    assert common.card_line(device) == want


def test_default_stream_lies_inside_the_checkout():
    """decode_bench reads its default stream from the repository and
    nowhere around it; while the repository does not hold city_cif.gtm,
    decode_bench names the path."""
    assert os.path.commonpath([common.REF, REPO]) == REPO
    assert common.ROOT == REPO
    if not os.path.exists(common.REF):   # until the stream is committed
        with pytest.raises(SystemExit) as e:
            decode_bench.main(['--device', 'cpu'])
        assert common.REF in str(e.value.code)


def test_decode_bench_on_the_sample_stream(capsys):
    res = decode_bench.main([SAMPLE, '--device', 'cpu'])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    assert res['frames'] == 48 and res['stream'] == 'sample.gtm'
    for key in ('numpy_fps', 'player_fps', 'player_first_frame_ms',
                'torch_scan_fps', 'torch_fps'):
        assert res[key] > 0, key
    assert res['same_frames'] is True
    assert (res['device'], res['card']) == ('cpu', 'cpu')
    data = open(SAMPLE, 'rb').read()
    from tiler_tpu_torch.decode import decode_video_torch_scan
    assert np.array_equal(decode_video_torch_scan(data, 'cpu'),
                          decode_video(data)[0])


def test_decode_bench_names_a_missing_stream(tmp_path):
    path = str(tmp_path / 'none.gtm')
    with pytest.raises(SystemExit) as e:
        decode_bench.main([path, '--device', 'cpu'])
    assert path in str(e.value.code)


@pytest.mark.parametrize('flags', [
    ['--yliluoma', '--yil-mix', '2', '--use-var', '--pal-var', '90'],
    ['--no-wavelets', '--enc-gamma', '2.2', '--dithering-gamma',
     '--ft-gamma', '--dl-bpc', '6', '--reload-gts', 'prev.gts'],
])
def test_cli_config_flags_map_as_jax_cli(flags):
    """Each encoder flag sets the EncoderConfig field that the JAX
    package's CLI sets from it."""
    import argparse

    from tiler_tpu import __main__ as jcli
    from tiler_tpu_torch import __main__ as cli
    jp = argparse.ArgumentParser()
    jcli._add_encode_flags(jp)
    want = jcli._config_from_args(jp.parse_args(flags))
    got = cli._config_from_args(cli.build_parser().parse_args(
        ['encode', 'in.npy', 'out.gtm'] + flags))
    assert type(got) is not type(want)     # each package has its own
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != cli._config_from_args(cli.build_parser().parse_args(
        ['encode', 'in.npy', 'out.gtm']))


def test_cli_yliluoma_var_then_reload_on_cpu(tmp_path):
    """A Yliluoma + VAR encode writes its tileset (--gts-out), and a
    second encode reloads it (--reload-gts); both decode."""
    clip = tmp_path / 'clip.npy'
    np.save(clip, synthetic_clip_v2(4, 64, 96, seed=1))
    common = ['-m', 'tiler_tpu_torch', 'encode', str(clip), '--device',
              'cpu', '--palette-count', '8', '--max-tiles', '100']
    out = _run(common[:4] + [str(tmp_path / 'a.gtm')] + common[4:]
               + ['--yliluoma', '--use-var', '--gts-out',
                  str(tmp_path / 'a.gts')])
    assert out.returncode == 0, out.stderr
    first = json.loads(out.stdout.strip().splitlines()[-1])
    tiles, _ = read_gts(str(tmp_path / 'a.gts'))
    assert len(tiles) == first['reindexed_tiles']
    out = _run(common[:4] + [str(tmp_path / 'b.gtm')] + common[4:]
               + ['--reload-gts', str(tmp_path / 'a.gts')])
    assert out.returncode == 0, out.stderr
    second = json.loads(out.stdout.strip().splitlines()[-1])
    assert first['psnr'] > 15 and second['psnr'] > 15
    assert 'global_tiling_merged' in first
    assert 'global_tiling_merged' not in second


def test_new_paths_run_without_jax(tmp_path):
    """Yliluoma + VAR with KModes restarts at a 40-colour tile palette,
    then a GTS reload without wavelets, and a tool, with jax, the JAX
    package and its benchmark script unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'tiler_tpu', 'bench'): sys.modules[m] = None\n"
        "import dataclasses, numpy as np, tiler_tpu_torch\n"
        "from tiler_tpu_torch.pipeline.encoder import Encoder\n"
        "from tiler_tpu_torch.tools import nn_prec_bench\n"
        "from tiler_tpu_torch.config import EncoderConfig\n"
        "from tiler_tpu_torch.bitstream.gtm import write_gts\n"
        "fr = np.random.default_rng(0).integers(0, 255, (3, 32, 48, 3))"
        ".astype(np.uint8)\n"
        "base = EncoderConfig(palette_count=4, max_tiles=40)\n"
        "e = Encoder(dataclasses.replace(base, use_thomas_knoll=False, "
        "use_dl3=False, kmodes_restarts=2, tile_palette_size=40), "
        "device='cpu')\n"
        "e.run_all(fr, fps=24, fast_lzma=True)\n"
        "n = int(e.state.tile_active.sum())\n"
        f"write_gts({str(tmp_path / 't.gts')!r}, e.state.tiles_pal[:n], "
        "40)\n"
        "Encoder(dataclasses.replace(base, use_wavelets=False, "
        f"reload_tileset={str(tmp_path / 't.gts')!r}), device='cpu')"
        ".run_all(fr, fps=24, fast_lzma=True)\n"
        "nn_prec_bench.main(['100', '--device', 'cpu'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'tiler_tpu', 'bench') "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = _run(['-c', code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'ok'
