"""BENCHMARK.json's rules: keys, names, units,
and a data file or reader for every entry."""
import json
import os
import re

import pytest

from gtmbench import cells

from conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.rstrip('/').endswith('_torch')
    assert len(bench['command']) <= 32 and all(map(_line, bench['command']))
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 65536


def test_configs(bench):
    assert 1 <= len(bench['configs']) <= 24
    used = {w['config'] for w in bench['workloads']}
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['name'] in used
        assert _line(c['source']) and _line(c['why'])
        assert any(c['file'].startswith(p.rstrip('/') + '/')
                   for p in bench['paths'])
        assert os.path.exists(os.path.join(ROOT, c['file']))
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
    files = [c['file'] for c in bench['configs']]
    assert len(set(files)) == len(files)


def test_workloads(bench):
    ws = bench['workloads']
    assert 1 <= len(ws) <= 24
    assert len({w['name'] for w in ws}) == len(ws)
    assert len({(w['config'], w['traffic']) for w in ws}) == len(ws)
    assert sum(w['chips'] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and _line(w['why'])
        c = cells.load(w['name'])      # every data file is there
        assert set(c.limits) == {'k1_gap', 'kmodes_gap', 'kmeans_gap',
                                 'kmeans_step_gain'}


def test_metrics(bench):
    e2e, pl = bench['end_to_end'], bench['per_layer']
    names = [m['name'] for m in e2e + pl]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    assert 'setup_s' in {m['name'] for m in e2e}
    cell_names = {w['name'] for w in bench['workloads']}
    for m in e2e:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in pl:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert _line(m['layer'])
        assert m['moves'] in {x['name'] for x in e2e}
        assert set(m.get('workloads', cell_names)) <= cell_names
        assert callable(cells.reader(m['name']))
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for m in e2e + pl:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for w in cell_names:
        c = cells.load(w)
        got = {m['name'] for m in c.end_to_end}
        assert 'setup_s' in got and len(got) >= 2 and c.per_layer


def test_files_under_paths_are_named_by_names(bench):
    for p in bench['paths']:
        for base, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d != '__pycache__']
            for f in files:
                rel = os.path.relpath(os.path.join(base, f), ROOT)
                assert PATH.match(rel), rel
