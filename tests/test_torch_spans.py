"""The port's step and phase spans (utils.dispatch.span) on the CPU: each
label on the profiler's clock inside its step's annotation on the encode
thread, the phase dicts written from the spans' seconds with the keys
they always had, the stream the same with and without the profiler, and
tools.profile_encode's reading of spans, idle gaps, launches and host
waits from a trace."""
from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.constants import ENCODER_STEPS
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.tools import profile_encode
from tiler_tpu_torch.tools.common import synthetic_clip_v2
from tiler_tpu_torch.utils import dispatch

torch.set_num_threads(1)

CFG = EncoderConfig(palette_count=8, max_tiles=300)
# phase dict: (step, the keys it always had, the keys the spans added)
PHASES = {
    'dither_phases': ('dither', ('prepare_kmeans', 'quantize', 'dither'),
                      ('features', 'kmeans_pp', 'lloyd', 'mirrors')),
    'mu_phases': ('make_unique', ('queue', 'sync'), ()),
    'gt_phases': ('global_tiling', ('sigs_bins', 'solve', 'merge_host',
                                    'gt_unique', 'gt_reindex',
                                    'unique_reindex'), ()),
    'ft_phases': ('frame_tiling', ('dataset', 'upload', 'mark',
                                   'cand_feats', 'assign'),
                  ('prepare', 'search', 'cand_set')),
    'save_phases': ('save', (), ('pack', 'lzma')),
}
LABELS = [f'{step}/{k}' for step, old, new in PHASES.values()
          for k in old + new]
# MakeUnique runs once more inside GlobalTiling
ALSO_IN = {'make_unique': 'global_tiling'}
# a span and the spans that it holds, one after the other
NESTED = [
    ('dither/prepare_kmeans', ('dither/features', 'dither/kmeans_pp',
                               'dither/lloyd')),
    ('frame_tiling/assign', ('frame_tiling/prepare', 'frame_tiling/search')),
    ('frame_tiling/cand_feats', ('frame_tiling/cand_set',)),
    ('global_tiling/unique_reindex', ('global_tiling/gt_unique',
                                      'global_tiling/gt_reindex')),
    ('save/pack', ()),
] + [(f'step:{step}', tuple(f'{step}/{k}' for k in keys))
     for step, keys in (
         ('dither', ('prepare_kmeans', 'quantize', 'dither', 'mirrors')),
         ('frame_tiling', ('dataset', 'upload', 'mark', 'cand_feats',
                           'assign')),
         ('save', ('pack', 'lzma')))]


@pytest.fixture(scope='module')
def encodes(tmp_path_factory):
    """The same clip encoded without and with the profiler; the span
    seconds the first encode added."""
    frames = synthetic_clip_v2(6, 48, 64)
    plain = Encoder(CFG, device='cpu')
    before = dispatch.spans()
    blob = plain.run_all(frames, fps=24, fast_lzma=True)
    after = dispatch.spans()
    delta = {k: v - before.get(k, 0.0) for k, v in after.items()
             if v != before.get(k, 0.0)}
    prof = str(tmp_path_factory.mktemp('prof'))
    traced = Encoder(CFG, device='cpu')
    traced_blob = traced.run_all(frames, fps=24, fast_lzma=True,
                                 profile_dir=prof)
    trace, = glob.glob(os.path.join(prof, '*.pt.trace.json'))
    with open(trace) as fh:
        events = json.load(fh)['traceEvents']
    ann = [e for e in events if e.get('ph') == 'X'
           and e.get('cat') == 'user_annotation']
    return dict(frames=frames, blob=blob, traced_blob=traced_blob,
                state=plain.state, delta=delta, events=events, ann=ann)


def test_the_profiler_leaves_the_stream(encodes):
    assert len(encodes['state'].keyframes) >= 2
    assert encodes['traced_blob'] == encodes['blob']


@pytest.mark.parametrize('label', LABELS)
def test_each_span_lies_in_its_step_on_the_encode_thread(encodes, label):
    steps = [e for e in encodes['ann'] if e['name'].startswith('step:')]
    assert {e['name'][5:] for e in steps} == set(ENCODER_STEPS)
    thread = {(e['pid'], e['tid']) for e in steps}
    assert len(thread) == 1
    mine = [e for e in encodes['ann'] if e['name'] == label]
    assert mine, f'no span {label}'
    step = label.split('/')[0]
    for e in mine:
        assert (e['pid'], e['tid']) in thread
        holders = [s['name'][5:] for s in steps
                   if s['ts'] <= e['ts']
                   and e['ts'] + e['dur'] <= s['ts'] + s['dur']]
        assert holders and holders[0] in {step, ALSO_IN.get(step)}, holders
    assert any(s['name'] == f'step:{step}' and s['ts'] <= e['ts']
               for s in steps for e in mine)


@pytest.mark.parametrize('key', sorted(PHASES))
def test_phase_dicts_keep_their_keys_and_read_the_spans(encodes, key):
    step, old, new = PHASES[key]
    got = encodes['state'].metrics[key]
    assert set(old) | set(new) <= set(got)
    for k in old + new:
        spent = encodes['delta'].get(f'{step}/{k}', 0.0)
        if key == 'mu_phases':
            # the dict holds the last of MakeUnique's two runs
            assert 0.0 <= got[k] <= round(spent, 3) + 1e-3
        else:
            assert got[k] == round(spent, 3), k
    if key == 'mu_phases':
        assert got['rows'] > 0
        assert encodes['state'].metrics['gt_phases']['gt_mu'] is got


@pytest.mark.parametrize('outer,inner', NESTED)
def test_nested_spans_fit_inside(encodes, outer, inner):
    d = encodes['delta']
    assert d[outer] > 0
    assert d[outer] + 1e-9 >= sum(d[k] for k in inner)


def test_cand_set_lies_inside_cand_feats(encodes):
    """Stage 2's host set logic is clocked inside stage 2, on the
    profiler's clock too, and is no longer than it."""
    ann = encodes['ann']
    outer = [e for e in ann if e['name'] == 'frame_tiling/cand_feats']
    inner = [e for e in ann if e['name'] == 'frame_tiling/cand_set']
    assert len(outer) == len(encodes['state'].keyframes)
    assert len(inner) >= len(outer)
    for e in inner:
        assert any(o['ts'] <= e['ts'] and e['ts'] + e['dur'] <= o['ts']
                   + o['dur'] for o in outer), e
    got = encodes['state'].metrics['ft_phases']
    assert 0.0 < encodes['delta']['frame_tiling/cand_set'] \
        <= encodes['delta']['frame_tiling/cand_feats']
    assert got['cand_set'] <= got['cand_feats']


def test_feature_rows_are_the_candidates_on_the_direct_path(encodes):
    """metrics['ft_feat_rows']: per keyframe the rows whose features
    stage 2 computed, every candidate where the pair dedup is under 2 and
    the features are computed directly."""
    m = encodes['state'].metrics
    assert len(m['ft_knn_sizes']) == len(encodes['state'].keyframes)
    assert all(d < 2.0 for d in m['ft_pair_dedup'][-len(m['ft_knn_sizes']):])
    assert m['ft_feat_rows'] == m['ft_knn_sizes']


def test_step_times_are_the_step_spans(encodes):
    st = encodes['state'].step_times
    assert set(st) == set(ENCODER_STEPS)
    for name, t in st.items():
        assert t == pytest.approx(encodes['delta'][f'step:{name}'],
                                  abs=1e-9)


def test_the_tool_reads_the_spans_of_a_trace(encodes):
    out = profile_encode.span_summary(encodes['events'],
                                      len(encodes['frames']))
    spans = out['spans']
    assert set(LABELS) <= set(spans)
    assert {f'step:{s}' for s in ENCODER_STEPS} <= set(spans)
    for label, r in spans.items():
        assert r['count'] >= 1 and r['host_s'] > 0, label
        # no card: the whole window is idle and nothing is launched
        assert r['busy_s'] == pytest.approx(0.0, abs=1e-9)
        assert r['kernels'] == 0 and r['host_wait_s'] == 0.0
    named = {n.rsplit(' (', 1)[0] for n, _ in out['idle_gaps']}
    assert named <= set(LABELS) | set(ENCODER_STEPS) | {'between_steps'}
    assert sum(v for _, v in out['idle_gaps']) <= out['window_s'] + 1e-9
    assert out['per_frame']['launches'] == 0
    assert out['per_frame']['kmeans_pp_idle_pct'] == pytest.approx(100.0)


def _x(name, ts, dur, cat, tid=1, corr=None):
    e = {'ph': 'X', 'name': name, 'ts': ts, 'dur': dur, 'cat': cat,
         'pid': 1, 'tid': tid}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


SYNTHETIC = [
    # the encode thread's spans, nested; another thread's span
    _x('step:dither', 0, 100, 'user_annotation'),
    _x('dither/prepare_kmeans', 10, 80, 'user_annotation'),
    _x('dither/kmeans_pp', 20, 40, 'user_annotation'),
    _x('step:save', 110, 10, 'user_annotation'),
    _x('dither/kmeans_pp', 0, 120, 'user_annotation', tid=2),
    # launches, a copy and a wait on the encode thread
    _x('cudaLaunchKernel', 22, 1, 'cuda_runtime', corr=1),
    _x('cudaStreamSynchronize', 40, 15, 'cuda_runtime'),
    _x('cudaLaunchKernel', 65, 1, 'cuda_runtime', corr=2),
    _x('cudaMemcpyAsync', 78, 8, 'cuda_runtime', corr=3),
    # the card: two kernels and the copy
    _x('k1', 25, 5, 'kernel', tid=7, corr=1),
    _x('k2', 70, 5, 'kernel', tid=7, corr=2),
    _x('Memcpy DtoH', 80, 5, 'gpu_memcpy', tid=7, corr=3),
]


@pytest.mark.parametrize('label,want', [
    ('dither/kmeans_pp', dict(count=1, host_s=40e-6, busy_s=5e-6,
                              idle_s=35e-6, idle_gaps=2, kernels=1,
                              host_wait_s=15e-6)),
    ('dither/prepare_kmeans', dict(count=1, host_s=80e-6, busy_s=15e-6,
                                   idle_s=65e-6, idle_gaps=4, kernels=2,
                                   host_wait_s=23e-6)),
    ('step:save', dict(count=1, host_s=10e-6, busy_s=0.0, idle_s=10e-6,
                       idle_gaps=1, kernels=0, host_wait_s=0.0)),
])
def test_the_tool_reads_a_synthetic_trace(label, want):
    """Idle gaps of the card, kernels by their launch call and host waits,
    each inside a span's interval; another thread's span is not read."""
    got = profile_encode.span_summary(SYNTHETIC, 1)['spans'][label]
    assert got == pytest.approx(want, abs=1e-12)


def test_an_idle_gap_goes_to_the_innermost_span():
    out = profile_encode.span_summary(SYNTHETIC, 1)
    gaps = {n: v for n, v in out['idle_gaps']}
    assert gaps == pytest.approx({
        'dither/kmeans_pp (2 gaps)': 35e-6,
        'dither/prepare_kmeans (4 gaps)': 30e-6,
        'dither (2 gaps)': 20e-6,
        'between_steps (1 gaps)': 10e-6,
        'save (1 gaps)': 10e-6}, abs=1e-12)
    assert out['idle_gaps'][0][0] == 'dither/kmeans_pp (2 gaps)'
    assert out['window_s'] == pytest.approx(120e-6)
    assert out['per_frame'] == pytest.approx({
        'launches': 2, 'host_wait_ms': 23e-3, 'kmeans_pp_ms': 40e-3,
        'kmeans_pp_idle_pct': 87.5})
