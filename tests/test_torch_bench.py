"""The port's measurement entry points (tiler_tpu_torch.bench and
tools.decode_bench, bench720, bench1080) at tiny sizes on the CPU, held
against the JAX package's benchmark script where they compute the same
thing: the bench's stream is bench.encode_once's, byte for byte."""
import json
import os
import subprocess
import types

import numpy as np
import pytest
import torch

import bench as jbench
from tiler_tpu_torch import bench
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.tools import bench720, bench1080, decode_bench
from tiler_tpu_torch.tools.common import synthetic_clip_v2

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, 'decoders', 'web', 'sample.gtm')
# the keys the port adds to every entry beside the JAX package's round
# trips (n_dispatches, dispatches)
PORT_KEYS = {'ft_nn_calls', 'k1_launches', 'k1_prepare_launches',
             'peak_bytes', 'sha256'}
# the full line's keys in bench.py's main, and what the port adds there
JAX_FULL_KEYS = {'metric', 'value', 'unit', 'clip', 'runs_fps',
                 'vs_baseline', 'psnr', 'gtm_bytes', 'real_content',
                 'continuity', 'n_dispatches', 'dispatches', 'step_times',
                 'phases', 'ft_pair_dedup', 'ft_q_changed_frac',
                 'mesh_sharded_wall'}
FULL_ADDED = PORT_KEYS | {'runs_wall_s', 'cpu_fps', 'baseline_wall_s',
                          'baseline_error', 'card'}
JAX_HEADLINE_KEYS = {'metric', 'value', 'unit', 'clip', 'vs_baseline',
                     'runs_fps', 'psnr', 'n_keyframes', 'q_changed',
                     'load_s', 'quantize_s', 'real_wall_s', 'real_fps',
                     'continuity_fps'}
# bench.py:201-221, the real-content entry's keys
JAX_REAL_KEYS = {'metric', 'wall_s', 'fps', 'psnr', 'gtm_bytes',
                 'ref_gtm_bytes', 'n_keyframes', 'ft_q_changed_frac',
                 'ft_pair_dedup', 'n_dispatches', 'dispatches',
                 'step_times', 'phases', 'mesh_sharded_wall'}
# tools/bench720.py and bench1080.py
JAX_WALL_KEYS = {'metric', 'value', 'fps', 'psnr', 'gtm_bytes',
                 'step_times', 'dither_phases', 'ft_phases', 'gt_phases',
                 'ft_knn_sizes'}
TUNNEL = {'n_dispatches', 'dispatches'}


def _tiny(monkeypatch, f=2, h=48, w=64, pal=8):
    monkeypatch.setattr(bench, 'F', f)
    monkeypatch.setattr(bench, 'F_CPU', f)
    monkeypatch.setattr(bench, 'H', h)
    monkeypatch.setattr(bench, 'W', w)
    monkeypatch.setattr(bench, 'PAL', pal)


def test_encode_once_writes_the_jax_bench_stream(monkeypatch):
    """Two timed runs on the CPU write one stream, and it is the bytes of
    the JAX package's bench.encode_once on the same clip and PAL."""
    monkeypatch.setattr(bench, 'PAL', 16)
    monkeypatch.setattr(jbench, 'PAL', 16)
    monkeypatch.delenv('TILER_BENCH_DEVICES', raising=False)
    frames = synthetic_clip_v2(8, 120, 160)
    all_fps, enc, blob, recs = bench.encode_once(frames, warm=False, runs=2,
                                                 device='cpu')
    assert len(all_fps) == len(recs) == 2 and min(all_fps) > 0
    assert len({r['sha256'] for r in recs}) == 1
    # the plain 1-NN runs on the CPU: no kernel launch, no device memory
    assert [(r['k1_launches'], r['k1_prepare_launches'], r['peak_bytes'])
            for r in recs] == [(0, 0, None)] * 2
    assert enc.state.metrics['ft_nn_calls'] > 0
    _, _, jblob = jbench.encode_once(frames, warm=False, runs=1)
    assert blob == jblob


def test_encode_once_raises_when_a_run_writes_other_bytes(monkeypatch):
    _tiny(monkeypatch)
    real = Encoder.run_all
    calls = []

    def flaky(self, *a, **kw):
        calls.append(1)
        blob = real(self, *a, **kw)
        return blob + b'x' if len(calls) == 2 else blob
    monkeypatch.setattr(Encoder, 'run_all', flaky)
    with pytest.raises(RuntimeError, match='timed run 0 wrote'):
        bench.encode_once(synthetic_clip_v2(2, 48, 64), warm=True, runs=2,
                          device='cpu')


def test_each_run_releases_its_device_tiles(monkeypatch):
    """No encoder of the bench holds its device tensors past its run, so
    that a run's peak memory never counts the one before it: when each
    encode starts, every earlier encoder has released its source tiles
    and its device tiles_pal, and so has the one encode_once returns."""
    _tiny(monkeypatch)
    monkeypatch.delenv('TILER_BENCH_DEVICES', raising=False)
    made = []

    def held(enc):
        return bool(enc.state._src_tiles) or \
            enc.state._tiles_pal_dev is not None

    class Tracked(Encoder):
        def run_all(self, *a, **kw):
            assert not any(held(e) for e in made)
            made.append(self)
            blob = super().run_all(*a, **kw)
            assert held(self)   # what the release has to drop
            return blob
    monkeypatch.setattr(bench, 'Encoder', Tracked)
    _, enc, _, _ = bench.encode_once(synthetic_clip_v2(2, 48, 64),
                                     warm=True, runs=2, device='cpu')
    assert len(made) == 3 and enc is made[-1]
    assert not any(held(e) for e in made)
    assert enc.state.step_times and enc.state.metrics['ft_nn_calls'] > 0


def test_wall_entry_raises_when_the_timed_run_writes_other_bytes(
        monkeypatch):
    """The 720p/1080p tools hold their timed stream to the warm-up's, as
    encode_once does."""
    real = Encoder.run_all
    calls = []

    def flaky(self, *a, **kw):
        calls.append(1)
        blob = real(self, *a, **kw)
        return blob + b'x' if len(calls) == 2 else blob
    monkeypatch.setattr(Encoder, 'run_all', flaky)
    with pytest.raises(RuntimeError, match='timed run 0 wrote'):
        bench.wall_entry(2, 32, 48, '720p24', True, device='cpu')
    assert len(calls) == 2


def test_default_streams_lie_inside_the_checkout(monkeypatch):
    """The real-content entry and decode_bench read their default stream
    from the repository and nowhere around it; while the repository does
    not hold city_cif.gtm, the entry is None and decode_bench names the
    path."""
    monkeypatch.delenv('TILER_BENCH_NO_REAL', raising=False)
    assert os.path.commonpath([bench.REF, REPO]) == REPO
    assert bench.ROOT == REPO
    if not os.path.exists(bench.REF):   # until the stream is committed
        assert bench.real_content_entry(device='cpu') is None
        with pytest.raises(SystemExit) as e:
            decode_bench.main(['--device', 'cpu'])
        assert bench.REF in str(e.value.code)


def test_cpu_mode_prints_cpu_fps(monkeypatch, capsys):
    _tiny(monkeypatch)
    monkeypatch.setenv('TILER_BENCH_CPU', '1')
    bench.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == ['cpu_fps'] and got['cpu_fps'] > 0


def test_main_without_a_card_exits_and_names_it(monkeypatch):
    monkeypatch.delenv('TILER_BENCH_CPU', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert 'no CUDA card' in str(e.value.code)


@pytest.mark.parametrize('n,cards,said', [
    (2, 0, 'only 0 device(s) available'),
    (4, 2, 'only 2 device(s) available'),
    (3, 4, 'must be a power of two'),
    (2, 4, None),
    (1, 0, None)])
def test_bench_mesh(monkeypatch, n, cards, said):
    """TILER_BENCH_DEVICES: a mesh of the first N cards, never a silent
    fallback. Cards are counted, never touched, so none is needed."""
    monkeypatch.setenv('TILER_BENCH_DEVICES', str(n))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    if said:
        with pytest.raises(SystemExit) as e:
            bench._bench_mesh()
        assert said in str(e.value.code)
    elif n == 1:
        assert bench._bench_mesh() is None
    else:
        mesh = bench._bench_mesh()
        assert mesh.flat == [torch.device('cuda', i) for i in range(n)]


def _fixed_state():
    return types.SimpleNamespace(
        step_times={'load': 0.5, 'dither': 4.25, 'save': 0.375},
        metrics={'dither_phases': {'quantize': 0.125}, 'gt_phases': {},
                 'ft_phases': {'assign': 4.0}, 'n_keyframes': 3,
                 'ft_q_changed_frac': 0.6931, 'ft_pair_dedup': [1.25],
                 'ft_nn_calls': 22, 'mesh_sharded_wall': {'frac': 0.9},
                 'dispatches': {
                     'load': {'h2d': 0, 'd2h': 0, 'sync': 1, 'kernel': 0,
                              'total': 1},
                     'dither': {'h2d': 118, 'd2h': 124, 'sync': 4,
                                'kernel': 0, 'total': 246},
                     'save': {'h2d': 0, 'd2h': 1, 'sync': 1, 'kernel': 0,
                              'total': 2}}})


def _fixed_recs(n=3):
    return [{'wall_s': 12.0 + i, 'k1_launches': 22,
             'k1_prepare_launches': 3, 'peak_bytes': 8 << 30,
             'sha256': 'ab' * 32} for i in range(n)]


def test_report_lines(capsys):
    """The full line has bench.py's keys, its round trips the sum of the
    steps' totals, plus the port's; the compact headline is printed last;
    the value is the median of the runs; every number stands beside the
    card."""
    st, recs = _fixed_state(), _fixed_recs()
    base = {'cpu_fps': 0.02, 'wall_s': 300.0, 'error': None}
    full, head = bench.report([1.0, 1.5, 1.25], st, b'x' * 100, recs, 29.9,
                              base, None, {'fps': 1.1}, 'H100, 700.00 W',
                              'cuda')
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in lines] == [full, head]
    assert set(full) == JAX_FULL_KEYS | FULL_ADDED
    assert full['n_dispatches'] == 1 + 246 + 2
    assert full['dispatches'] == st.metrics['dispatches']
    assert set(head) == JAX_HEADLINE_KEYS | {'card'}
    assert head['metric'] == full['metric'] == \
        f'encode_fps_{bench.W}x{bench.H}_cuda'
    assert head['value'] == full['value'] == 1.25
    assert full['runs_fps'] == [1.0, 1.5, 1.25]
    assert full['vs_baseline'] == round(1.25 / 0.02, 3)
    assert full['k1_launches'] == [22] * 3 and full['gtm_bytes'] == 100
    assert full['card'] == head['card'] == 'H100, 700.00 W'
    assert head['continuity_fps'] == 1.1 and head['real_fps'] is None


@pytest.mark.parametrize('child', ['timeout', 'exit', 'no_line', 'off'])
def test_failed_baseline_gives_null(monkeypatch, capsys, child):
    """A baseline child that times out, fails, prints no cpu_fps or is
    switched off gives vs_baseline null and says why: an unmeasured
    ratio is never printed as 1."""
    def run(argv, **kw):
        assert argv[1:] == ['-m', 'tiler_tpu_torch.bench']
        assert kw['env']['TILER_BENCH_CPU'] == '1'
        assert kw['env']['CUDA_VISIBLE_DEVICES'] == ''
        assert kw['cwd'] == REPO and kw['timeout'] == 1200
        if child == 'timeout':
            raise subprocess.TimeoutExpired(argv, kw['timeout'])
        return subprocess.CompletedProcess(
            argv, 1 if child == 'exit' else 0, 'step lines\n', 'Boom')
    monkeypatch.setattr(bench.subprocess, 'run', run)
    if child == 'off':
        monkeypatch.setenv('TILER_BENCH_NO_CPU', '1')
    else:
        monkeypatch.delenv('TILER_BENCH_NO_CPU', raising=False)
    base = bench.cpu_baseline()
    want = {'timeout': 'timed out after 1200 s', 'exit': 'exit 1: Boom',
            'no_line': 'no cpu_fps line', 'off': 'TILER_BENCH_NO_CPU=1'}
    assert base['cpu_fps'] is None and want[child] in base['error']
    full, head = bench.report([1.0], _fixed_state(), b'', _fixed_recs(1),
                              30.0, base, None, None, 'card', 'cuda')
    assert full['vs_baseline'] is None and head['vs_baseline'] is None
    assert full['baseline_error'] == base['error']
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == head


def test_baseline_reads_the_child_line(monkeypatch):
    def run(argv, **kw):
        return subprocess.CompletedProcess(
            argv, 0, 'Step: load\n{"cpu_fps": 0.25}\n', '')
    monkeypatch.delenv('TILER_BENCH_NO_CPU', raising=False)
    monkeypatch.setattr(bench.subprocess, 'run', run)
    base = bench.cpu_baseline()
    assert base['cpu_fps'] == 0.25 and base['error'] is None
    assert base['wall_s'] >= 0


@pytest.mark.parametrize('why', ['absent', 'switched_off'])
def test_real_content_entry_skips(tmp_path, monkeypatch, why):
    path = tmp_path / 'city.gtm'
    if why == 'absent':
        monkeypatch.delenv('TILER_BENCH_NO_REAL', raising=False)
    else:
        path.write_bytes(open(SAMPLE, 'rb').read())
        monkeypatch.setenv('TILER_BENCH_NO_REAL', '1')
    assert bench.real_content_entry(str(path), device='cpu') is None


def test_real_content_entry_on_a_small_stream(tmp_path, monkeypatch):
    monkeypatch.delenv('TILER_BENCH_NO_REAL', raising=False)
    monkeypatch.delenv('TILER_BENCH_REAL_FRAMES', raising=False)
    src = Encoder(EncoderConfig(palette_count=8), device='cpu').run_all(
        synthetic_clip_v2(4, 48, 64, seed=3), fps=30.0, fast_lzma=True)
    path = tmp_path / 'city.gtm'
    path.write_bytes(src)
    got = bench.real_content_entry(str(path), device='cpu')
    assert set(got) == JAX_REAL_KEYS | PORT_KEYS
    assert got['n_dispatches'] == sum(
        v['total'] for v in got['dispatches'].values()) > 0
    assert got['ref_gtm_bytes'] == len(src) and got['gtm_bytes'] > 0
    assert np.isfinite(got['psnr']) and 10 < got['psnr'] < 99
    assert got['fps'] > 0 and got['n_keyframes'] >= 1
    assert got['k1_launches'] == [0] and len(got['sha256']) == 1


def test_continuity_entry(monkeypatch):
    _tiny(monkeypatch, f=3)
    monkeypatch.delenv('TILER_BENCH_NO_CONT', raising=False)
    got = bench.continuity_entry(device='cpu')
    assert set(got) == {'metric', 'fps', 'step_times', 'psnr',
                        'gtm_bytes'} | PORT_KEYS | TUNNEL
    assert got['metric'] == 'encode_fps_64x48_noise16_r1_clip'
    assert got['fps'] > 0 and 10 < got['psnr'] < 99
    monkeypatch.setenv('TILER_BENCH_NO_CONT', '1')
    assert bench.continuity_entry(device='cpu') is None


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


@pytest.mark.parametrize('tool,tag', [(bench720, '720p24'),
                                      (bench1080, '1080p16')])
@pytest.mark.parametrize('warm', [False, True])
def test_wall_tools_at_a_tiny_size(monkeypatch, capsys, tool, tag, warm):
    monkeypatch.setattr(tool, 'F', 2)
    monkeypatch.setattr(tool, 'H', 32)
    monkeypatch.setattr(tool, 'W', 48)
    res = tool.main((['--warm'] if warm else []) + ['--device', 'cpu'])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    assert set(res) == JAX_WALL_KEYS | {'card'}
    assert res['metric'] == f'encode_{tag}_wall_s' + ('_warm' if warm
                                                      else '')
    assert res['fps'] > 0 and 10 < res['psnr'] < 99 and res['card'] == 'cpu'
