"""The experiment tools (tiler_tpu_torch.tools) at tiny sizes on the CPU,
where they run the kernels' plain versions, and the encoder flags of the
port's CLI."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench import synthetic_clip_v2
from tiler_tpu.bitstream.gtm import read_gts
from tiler_tpu_torch.ops import nn_kernels as nk
from tiler_tpu_torch.tools import assign_opt_bench, nn_prec_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = dict(os.environ, PYTHONPATH=REPO)
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


def test_tools_refuse_missing_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    for tool in (nn_prec_bench, assign_opt_bench):
        with pytest.raises(RuntimeError, match='cuda'):
            tool.main([])


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
    assert got == want
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
    then a GTS reload without wavelets, and a tool, with jax
    unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import dataclasses, numpy as np, tiler_tpu_torch\n"
        "from tiler_tpu_torch.pipeline.encoder import Encoder\n"
        "from tiler_tpu_torch.tools import nn_prec_bench\n"
        "from tiler_tpu.config import EncoderConfig\n"
        "from tiler_tpu.bitstream.gtm import write_gts\n"
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
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = _run(['-c', code])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'ok'
