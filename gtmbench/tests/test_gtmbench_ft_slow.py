"""The cells ft_slow.cuts1080 and default.noise1080, the configuration
gtm_ft_slow, and the readers of FrameTiling's stage-2 spans: their value
on a synthetic window, None where the program does not clock the phase,
and their reading of a real encode."""
import json
import os

import pytest

from gtmbench import cells
from gtmbench.run import Window

from conftest import ROOT

NEW_CELLS = ('ft_slow.cuts1080', 'default.noise1080')
READERS = {'ft_cand_feats_ms_per_frame': 'cand_feats',
           'ft_cand_set_ms_per_frame': 'cand_set'}


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


@pytest.mark.parametrize('name', NEW_CELLS)
def test_new_cells_load(name):
    c = cells.load(name)
    assert c.chips == 1
    assert (c.traffic['frames'], c.traffic['height'],
            c.traffic['width']) == (16, 1080, 1920)
    assert c.limits == cells.load('default.cuts1080').limits
    got = {m['name'] for m in c.per_layer}
    assert set(READERS) <= got
    # every per-layer metric of the accepted cells reads in the new ones
    assert {m['name'] for m in cells.load('default.cuts1080').per_layer} \
        <= got
    assert {m['name'] for m in c.end_to_end} >= {'encode_fps', 'setup_s'}


def test_ft_slow_is_the_default_but_for_its_quality():
    slow = _json('gtmbench', 'configs', 'gtm_ft_slow.json')
    default = _json('gtmbench', 'configs', 'gtm_default.json')
    assert slow['encoder'].pop('ft_quality') == 'SLOW'
    assert default['encoder'].pop('ft_quality') == 'MEDIUM'
    assert slow['encoder'] == default['encoder']
    assert slow['save'] == default['save']
    bench = _json('BENCHMARK.json')
    conf = {c['name']: c for c in bench['configs']}['gtm_ft_slow']
    assert conf['reduced'] == [] and conf['source'] == slow['source']
    assert cells.load('ft_slow.cuts1080').config_name == 'gtm_ft_slow'
    assert cells.load('default.noise1080').config_name == 'gtm_default'


def _window(phases):
    recs = [{'wall_s': 18.0, 'step_times': {'frame_tiling': 9.0},
             'metrics': {'ft_phases': dict(phases)}} for _ in range(2)]
    return Window(encodes=recs, frames=32, calls=[], trace=None,
                  on_card=True)


@pytest.mark.parametrize('metric,phase', sorted(READERS.items()))
@pytest.mark.parametrize('phases,sums', [
    ({'mark': 0.4, 'cand_feats': 2.5, 'cand_set': 1.1, 'assign': 5.0},
     {'cand_feats': 5.0, 'cand_set': 2.2}),
    # a program that does not clock the set logic (the parent's)
    ({'mark': 0.4, 'cand_feats': 2.5, 'assign': 5.0},
     {'cand_feats': 5.0, 'cand_set': None}),
    ({}, {'cand_feats': None, 'cand_set': None}),
])
def test_readers_on_a_synthetic_window(metric, phase, phases, sums):
    got = cells.reader(metric)(_window(phases))
    want = sums[phase]
    assert got == (None if want is None else pytest.approx(1e3 * want / 32))


def test_readers_read_a_real_encode(tiny_cell):
    """A tiny encode on the CPU at FT Slow: the set logic is part of
    stage 2."""
    from gtmbench import run
    prog = run.setup(tiny_cell('ft_slow.cuts1080'), 'cpu', 0.0)
    _, rec = run.encode(prog)
    w = Window(encodes=[rec], frames=len(prog.frames), calls=[],
               trace=None, on_card=False)
    cand_set = cells.reader('ft_cand_set_ms_per_frame')(w)
    assert 0 < cand_set <= cells.reader('ft_cand_feats_ms_per_frame')(w)
