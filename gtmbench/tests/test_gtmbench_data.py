"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries only: the harness finds each by its name."""
import hashlib
import json
import os
import shutil

from gtmbench import cells, run

from conftest import ROOT, TINY_LIMITS


def _digests(root):
    out = {}
    for base, dirs, files in os.walk(os.path.join(root, 'gtmbench')):
        dirs[:] = [d for d in dirs if d != '__pycache__']
        for f in files:
            p = os.path.join(base, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_without_an_edit(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, 'gtmbench'),
                    os.path.join(root, 'gtmbench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        bench = json.load(fh)
    before = _digests(root)
    g = os.path.join(root, 'gtmbench')
    with open(os.path.join(g, 'configs', 'gtm_restarts.json'), 'w') as fh:
        json.dump({'source': 'a test', 'encoder': {
            'palette_count': 8, 'kmodes_restarts': 2,
            'ft_quality': 'FAST'}, 'save': {'fast_lzma': True}}, fh)
    with open(os.path.join(g, 'traffic', 'tiny.json'), 'w') as fh:
        json.dump({'generator': 'cuts_v2', 'clip_seed': 3, 'frames': 6,
                   'height': 48, 'width': 64, 'fps': 30.0, 'who': 'a test'},
                  fh)
    with open(os.path.join(g, 'limits', 'restarts.tiny.json'), 'w') as fh:
        json.dump(TINY_LIMITS, fh)
    with open(os.path.join(g, 'metrics', 'encodes_run.py'), 'w') as fh:
        fh.write('def read(window):\n    return len(window.encodes)\n')
    bench['configs'].append({'name': 'gtm_restarts', 'source': 'a test',
                             'file': 'gtmbench/configs/gtm_restarts.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'restarts.tiny',
                               'config': 'gtm_restarts', 'traffic': 'tiny',
                               'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({
        'name': 'encodes_run', 'unit': '1', 'better': 'higher',
        'source': 'program_counter', 'layer': 'Entry',
        'moves': 'encode_fps', 'workloads': ['restarts.tiny']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fh:
        json.dump(bench, fh)

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

    cell = cells.load('restarts.tiny', root=root)
    assert cell.traffic['width'] == 64
    assert cell.config['encoder']['kmodes_restarts'] == 2
    assert [m['name'] for m in cell.per_layer] == ['encodes_run']
    r = run.run_cell(cell, 9, 0.0, True, device='cpu')
    assert r['correct'] is True, r['checks']
    assert r['metrics']['encodes_run']['value'] == r['attempted'] >= 2
    # the other cells do not report the new metric
    assert 'encodes_run' not in {
        m['name'] for m in cells.load('default.cuts1080', root).per_layer}


def test_enum_fields_by_name():
    from tiler_tpu_torch.config import EncoderConfig, FTQuality
    cfg = cells.encoder_config(EncoderConfig, {'ft_quality': 'SLOW'})
    assert cfg.ft_quality is FTQuality.SLOW
    try:
        cells.encoder_config(EncoderConfig, {'no_such_field': 1})
    except ValueError as exc:
        assert 'no_such_field' in str(exc)
    else:
        raise AssertionError('an unknown field was taken')
