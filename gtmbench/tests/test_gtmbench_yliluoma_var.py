"""The cells yliluoma_var.cuts1080 and default.cuts_cif, the configuration
gtm_yliluoma_var, the readers of Dither's VAR and Yliluoma spans (their
value on a synthetic window, None where the program does not clock the
phase, their reading of a real encode), and dither_probe's comparison
with the plain VAR and Yliluoma references, with planted faults that
have to fail it."""
import contextlib
import json
import os

import pytest

from gtmbench import cells, dither_probe
from gtmbench.run import Window

from conftest import ROOT

NEW_CELLS = ('yliluoma_var.cuts1080', 'default.cuts_cif')
READERS = {'var_ms_per_frame': 'var', 'yliluoma_ms_per_frame': 'yliluoma'}


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


@pytest.mark.parametrize('name', NEW_CELLS)
def test_new_cells_load(name):
    c = cells.load(name)
    assert c.chips == 1
    size = (c.traffic['frames'], c.traffic['height'], c.traffic['width'])
    assert size == {'yliluoma_var.cuts1080': (16, 1080, 1920),
                    'default.cuts_cif': (16, 288, 352)}[name]
    assert c.traffic['generator'] == 'cuts_v2' and c.traffic['clip_seed'] == 0
    assert c.limits == cells.load('default.cuts1080').limits
    got = {m['name'] for m in c.per_layer}
    # every per-layer metric of the accepted cells reads in the new ones
    assert {m['name'] for m in cells.load('default.cuts1080').per_layer} \
        <= got
    assert (set(READERS) <= got) == (name == 'yliluoma_var.cuts1080')
    assert {m['name'] for m in c.end_to_end} >= {'encode_fps', 'setup_s'}


def test_yliluoma_var_is_the_default_but_for_its_dither():
    yv = _json('gtmbench', 'configs', 'gtm_yliluoma_var.json')
    default = _json('gtmbench', 'configs', 'gtm_default.json')
    for key, want in (('use_thomas_knoll', True), ('use_dl3', True)):
        assert yv['encoder'].pop(key) is False
        assert default['encoder'].pop(key) is want
    assert yv['encoder'] == default['encoder']
    assert (yv['encoder']['yliluoma_mix'], yv['encoder']['pal_var']) == \
        (4, 0.95)
    assert yv['save'] == default['save'] == {'fast_lzma': False}
    bench = _json('BENCHMARK.json')
    conf = {c['name']: c for c in bench['configs']}['gtm_yliluoma_var']
    assert conf['reduced'] == [] and conf['source'] == yv['source']
    assert cells.load('yliluoma_var.cuts1080').config_name == \
        'gtm_yliluoma_var'
    assert cells.load('default.cuts_cif').config_name == 'gtm_default'


def _window(phases):
    recs = [{'wall_s': 18.0, 'step_times': {'dither': 4.0},
             'metrics': {'dither_phases': dict(phases)}} for _ in range(2)]
    return Window(encodes=recs, frames=32, calls=[], trace=None,
                  on_card=True)


@pytest.mark.parametrize('metric,phase', sorted(READERS.items()))
@pytest.mark.parametrize('phases,sums', [
    ({'dither': 2.0, 'var': 1.5, 'yliluoma': 1.1},
     {'var': 3.0, 'yliluoma': 2.2}),
    # a program that does not clock them (the parent's)
    ({'dither': 2.0, 'quantize': 0.5}, {'var': None, 'yliluoma': None}),
    ({}, {'var': None, 'yliluoma': None}),
])
def test_readers_on_a_synthetic_window(metric, phase, phases, sums):
    got = cells.reader(metric)(_window(phases))
    want = sums[phase]
    assert got == (None if want is None else pytest.approx(1e3 * want / 32))


def test_readers_read_a_real_encode(tiny_cell):
    """A tiny encode of the new configuration on the CPU: both phases are
    clocked, the scan inside the Dither step."""
    from gtmbench import run
    prog = run.setup(tiny_cell('yliluoma_var.cuts1080'), 'cpu', 0.0)
    _, rec = run.encode(prog)
    w = Window(encodes=[rec], frames=len(prog.frames), calls=[],
               trace=None, on_card=False)
    assert cells.reader('var_ms_per_frame')(w) > 0
    assert 0 < cells.reader('yliluoma_ms_per_frame')(w) \
        <= cells.reader('dither_ms_per_frame')(w)


def _encode(probe, planted=None):
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.tools.common import synthetic_clip_v2
    cfg = EncoderConfig(palette_count=16, max_tiles=400,
                        use_thomas_knoll=False, use_dl3=False)
    with contextlib.ExitStack() as stack:
        if planted:
            stack.enter_context(dither_probe.plant(planted))
        stack.enter_context(probe)
        enc = Encoder(cfg, device='cpu')
        enc.run_all(synthetic_clip_v2(8, 120, 160), fps=24.0, fast_lzma=True)
    return cfg, enc.state


@pytest.mark.parametrize('case', ['every', 'sampled', 'var_no_merges',
                                  'plan_mix_2'])
def test_the_probe_holds_the_program_to_the_references(case):
    every = case != 'sampled'
    probe = dither_probe.DitherProbe(seed=3126, plan_keys=256, every=every)
    planted = case if case in ('var_no_merges', 'plan_mix_2') else None
    cfg, state = _encode(probe, planted)
    rec = dither_probe.compare(probe, cfg)
    n_kf = len(state.keyframes)
    assert rec['var_palettes'] == cfg.palette_count * (n_kf if every else 1)
    assert rec['plans'] == (state.metrics['dither_plan_keys'] if every
                            else 256)
    if case in ('every', 'sampled'):
        assert dither_probe.passes(rec), rec
    else:
        field = {'var_no_merges': 'var_palettes_differing',
                 'plan_mix_2': 'plans_differing'}[case]
        assert rec[field] > 0 and not dither_probe.passes(rec), rec
