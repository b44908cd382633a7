"""A tiny cell end to end on the CPU, the command's refusals, and the
modules a run loads."""
import json
import os
import shutil
import subprocess
import sys

from gtmbench import run

from conftest import ROOT

DEVICE_METRICS = {'encode_fps', 'setup_s', 'peak_device_gib'}
FORBIDDEN = {'jax', 'jaxlib', 'tiler_tpu'}


def _line(result):
    """The result line as the command prints it."""
    return json.loads(json.dumps(
        {k: v for k, v in result.items() if not k.startswith('_')}))


def test_tiny_cell_untraced_on_cpu(tiny_cell):
    r = run.run_cell(tiny_cell(), 2**31 + 11, 0.0, False, device='cpu')
    line = _line(r)
    assert line['correct'] is True
    assert line['attempted'] >= 2 and line['failed'] == 0
    assert list(line)[-1] == 'checks'
    names = {m['name'] for m in tiny_cell().end_to_end}
    assert set(line['metrics']) == names
    for name, m in line['metrics'].items():
        if name in DEVICE_METRICS:
            assert m['value'] == 'not measured'
        else:
            assert isinstance(m['value'], float)
    assert line['device']['memory_peak_bytes'] == 'not measured'
    checks = line['checks']
    # the sampled queries of the captured keyframe were judged
    assert checks['k1_gap']['queries'] > 0
    assert checks['k1_gap']['value'] <= 3e-5
    # GlobalTiling's sampled bins solve as the reference's, exactly
    assert checks['kmodes_gap']['bins'] > 0
    assert checks['kmodes_gap']['value'] == 0.0
    # Dither's grouping is a finished Lloyd's k-means
    assert checks['kmeans_gap']['rows'] > 0
    assert checks['kmeans_step_gain']['value'] <= 1e-3
    assert r['_info']['capture_encode_s'] > 0


def test_tiny_cell_traced_on_cpu(tiny_cell):
    r = run.run_cell(tiny_cell(), 5, 0.0, True, device='cpu')
    line = _line(r)
    assert line['correct'] is True
    per_layer = {m['name']: m for m in tiny_cell().per_layer}
    assert set(line['metrics']) == set(per_layer)
    for name, m in line['metrics'].items():
        if per_layer[name]['source'] == 'program_counter':
            assert m['value'] > 0
        else:
            assert m['value'] == 'not measured'
    assert line['device']['busy_s'] == 'not measured'
    assert 'breakdown' not in line


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, '-m', 'gtmbench', '--workload', 'default.cuts1080',
         '--seed', '3', '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES='', **(env or {})))


def test_command_refuses_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA card' in out.stderr


def test_command_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'gtmbench'), tmp_path / 'gtmbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _command(tmp_path, env={'PYTHONPATH': ''})
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_a_run_loads_no_jax_module():
    """A whole run in a fresh process; every loaded module's top-level
    name compared whole (tiler_tpu_torch begins with tiler_tpu)."""
    code = (
        'import sys, json\n'
        'sys.path.insert(0, ".")\n'
        'import torch; torch.set_num_threads(2)\n'
        'from gtmbench import cells, run\n'
        'c = cells.load("kmodes_restarts7.cuts1080")\n'
        'c.traffic = dict(c.traffic, frames=4, height=48, width=64)\n'
        'c.limits = dict.fromkeys(c.limits, 1.0)\n'
        'r = run.run_cell(c, 1, 0.0, False, device="cpu")\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))\n'
        'print(json.dumps(run.forbidden_modules()))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded, found = [json.loads(x) for x in out.stdout.splitlines()[-2:]]
    assert 'tiler_tpu_torch' in loaded
    assert not FORBIDDEN & set(loaded)
    assert found == []


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'tiler_tpu_torch_x', sys)
    assert run.forbidden_modules() == sorted(
        FORBIDDEN & {m.split('.')[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, 'jaxlib.xla', sys)
    assert 'jaxlib' in run.forbidden_modules()


def test_trace_reduction():
    """Busy union, window, idle gaps by step, on made-up intervals (ns)."""
    from gtmbench import trace
    ms = 1_000_000
    steps = [(0, 100 * ms, 'step:dither'), (110 * ms, 200 * ms,
                                            'step:frame_tiling')]
    dev = [(10 * ms, 30 * ms, 'k1'), (20 * ms, 40 * ms, 'k1'),
           (150 * ms, 190 * ms, 'copy'), (250 * ms, 260 * ms, 'late')]
    r = trace.reduce(dev, steps)
    assert r['window_s'] == 0.2
    assert abs(r['busy_s'] - 0.07) < 1e-12
    gaps = dict(r['idle_gaps'])
    assert abs(gaps['dither__2_gaps_'] - 0.070) < 1e-12
    assert abs(gaps['between_steps__1_gaps_'] - 0.010) < 1e-12
    assert abs(gaps['frame_tiling__2_gaps_'] - 0.050) < 1e-12
    assert dict(r['device_ops']) == {'k1': 0.04, 'copy': 0.04, 'late': 0.01}
    assert trace.reduce([], steps) is None
