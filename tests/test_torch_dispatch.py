"""The port's round-trip counter (tiler_tpu_torch.utils.dispatch) against
tiler_tpu.utils.dispatch, and the per-step counts an encode records in
metrics['dispatches'] and the benchmark reads, on the CPU."""
from __future__ import annotations

import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from gtmbench.metrics import round_trips_per_frame
from tiler_tpu.utils import dispatch as jdispatch
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.constants import ENCODER_STEPS
from tiler_tpu_torch.ops import kmeans, nn_kernels
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.pipeline.stream import _encode_gop
from tiler_tpu_torch.tools.common import synthetic_clip_v2
from tiler_tpu_torch.utils import dispatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {'h2d', 'd2h', 'sync', 'kernel', 'total'}
SHARED = ('h2d', 'd2h')       # the kinds both packages count
CFG = EncoderConfig(palette_count=16, max_tiles=400)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_the_api_counts_as_the_jax_module(seed):
    """The same sequence of note / snapshot / delta / reset through both
    modules gives the same numbers for the kinds they share."""
    rng = np.random.default_rng(seed)
    dispatch.reset()
    jdispatch.reset()
    mark = mark_j = None
    for i in range(200):
        op = rng.integers(0, 10)
        if op < 7:
            kind, n = SHARED[rng.integers(0, 2)], int(rng.integers(1, 5))
            dispatch.note(kind, n)
            jdispatch.note(kind, n)
        elif op < 9:
            mark, mark_j = dispatch.snapshot(), jdispatch.snapshot()
        elif i % 3 == 0:
            dispatch.reset()
            jdispatch.reset()
        now, now_j = dispatch.snapshot(), jdispatch.snapshot()
        assert {k: now[k] for k in SHARED} == {k: now_j[k] for k in SHARED}
        assert now['total'] == now['h2d'] + now['d2h'] + now['sync']
        if mark is not None:
            d, d_j = dispatch.delta(mark), jdispatch.delta(mark_j)
            assert {k: d[k] for k in SHARED} == {k: d_j[k] for k in SHARED}
    assert set(dispatch.snapshot()) == KINDS


def test_notes_from_threads_all_count():
    """The count is process-wide and locked: notes from the quantize pool
    and the host threads of the exact GOP-sharded encode all land."""
    n_threads = 4 * (os.cpu_count() or 1)
    before = dispatch.snapshot()

    def work():
        for _ in range(2000):
            dispatch.note('d2h')
            dispatch.note('h2d', 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    d = dispatch.delta(before)
    assert (d['d2h'], d['h2d'], d['sync']) == \
        (2000 * n_threads, 4000 * n_threads, 0)


def test_kernel_reads_the_launch_counters(monkeypatch):
    """`kernel` is the nn_kernels.LAUNCHES* counters' delta, not a count
    of its own; note() takes no `kernel`."""
    before = dispatch.snapshot()
    monkeypatch.setattr(nn_kernels, 'LAUNCHES', nn_kernels.LAUNCHES + 22)
    monkeypatch.setattr(nn_kernels, 'LAUNCHES_PREP',
                        nn_kernels.LAUNCHES_PREP + 3)
    monkeypatch.setattr(nn_kernels, 'LAUNCHES_BF16_PREP',
                        nn_kernels.LAUNCHES_BF16_PREP + 1)
    d = dispatch.delta(before)
    assert d['kernel'] == 26 and d['total'] == 0
    with pytest.raises(KeyError):
        dispatch.note('kernel')


def test_kernel_counts_the_seeding_kernel(monkeypatch):
    """The k-means++ seeding kernel's launches (one a draw) are in
    `kernel` too."""
    before = dispatch.snapshot()
    launches = dispatch._launches()
    monkeypatch.setattr(nn_kernels, 'LAUNCHES_KPP',
                        nn_kernels.LAUNCHES_KPP + 381)
    assert dispatch._launches() == launches + 381
    d = dispatch.delta(before)
    assert d['kernel'] == 381 and d['total'] == 0


@pytest.fixture(scope='module')
def two_encodes():
    """Two encodes of the small clip; each encoder's `seedings` holds the
    round trips of each of its k-means++ seedings."""
    frames = synthetic_clip_v2(8, 120, 160)
    out = []
    real = kmeans._plus_plus_init
    for _ in range(2):
        seedings = []

        def counted(*a, **kw):
            before = dispatch.snapshot()
            cents = real(*a, **kw)
            seedings.append(dispatch.delta(before))
            return cents
        launches = (nn_kernels.LAUNCHES, nn_kernels.LAUNCHES_PREP)
        enc = Encoder(CFG, device='cpu')
        kmeans._plus_plus_init = counted
        try:
            blob = enc.run_all(frames, fps=24, fast_lzma=True)
        finally:
            kmeans._plus_plus_init = real
        enc.seedings = seedings
        out.append((enc, blob, (nn_kernels.LAUNCHES - launches[0],
                                nn_kernels.LAUNCHES_PREP - launches[1])))
    return out


def test_every_step_has_its_round_trips(two_encodes):
    """Every step, Save included, has its dict; each step's timer
    synchronizes once; total is the round trips; Load and Save move only
    what they must (Save brings the tiles to the host)."""
    d = two_encodes[0][0].state.metrics['dispatches']
    assert list(d) == list(ENCODER_STEPS)
    for step, c in d.items():
        assert set(c) == KINDS, step
        assert c['total'] == c['h2d'] + c['d2h'] + c['sync'], step
        assert c['sync'] >= 1 and min(c.values()) >= 0, step
    assert d['load'] == dict(h2d=0, d2h=0, sync=1, kernel=0, total=1)
    assert (d['save']['h2d'], d['save']['d2h']) == (0, 1)
    # the k-means++ seeding of every keyframe uploads its keys once and
    # waits on none of its draws
    n_kf = two_encodes[0][0].state.metrics['n_keyframes']
    assert two_encodes[0][0].seedings == [
        dict(h2d=1, d2h=0, sync=0, kernel=0, total=1)] * n_kf


def test_two_encodes_count_alike(two_encodes):
    (a, blob_a, _), (b, blob_b, _) = two_encodes
    assert blob_a == blob_b
    assert a.state.metrics['dispatches'] == b.state.metrics['dispatches']


def test_kernel_counts_the_launches_of_the_run(two_encodes):
    """`kernel` over the steps equals the run's launch-counter deltas: 0
    on the CPU, where the wrappers run their plain versions."""
    for enc, _, launches in two_encodes:
        d = enc.state.metrics['dispatches']
        assert sum(c['kernel'] for c in d.values()) == sum(launches) == 0


def test_round_trips_total_is_the_sum_of_the_steps(two_encodes):
    """The benchmark's round_trips_per_frame over a window of the two
    encodes is one run's h2d + d2h + sync over all its steps, per frame,
    and positive (test_every_step_has_its_round_trips holds each step's
    total)."""
    enc = two_encodes[0][0]
    total = sum(c['h2d'] + c['d2h'] + c['sync']
                for c in enc.state.metrics['dispatches'].values())
    n_frames = len(enc.state.frames_rgb)
    window = types.SimpleNamespace(
        encodes=[{'metrics': e.state.metrics} for e, _, _ in two_encodes],
        frames=2 * n_frames)
    assert round_trips_per_frame.read(window) == total / n_frames > 0


def test_a_gop_keeps_the_per_step_layout():
    """The streaming and GOP-sharded encodes run each GOP's steps through
    the Encoder, so each GOP's state has the batch encode's layout (no
    Save: the stream writer assembles the GOPs)."""
    st, _ = _encode_gop(EncoderConfig(palette_count=8),
                        synthetic_clip_v2(3, 48, 64), 24.0, device='cpu')
    d = st.metrics['dispatches']
    assert list(d) == [s for s in ENCODER_STEPS if s != 'save']
    assert all(set(c) == KINDS and c['sync'] >= 1 for c in d.values())


def test_every_jax_module_has_a_counterpart():
    """Each module of tiler_tpu has one of the same path in the port, but
    ops/pallas_kernels.py, whose kernels are ops/nn_kernels.py + csrc/."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith('.py')}
    missing = modules('tiler_tpu') - modules('tiler_tpu_torch')
    assert missing == {os.path.join('ops', 'pallas_kernels.py')}
    assert os.path.exists(os.path.join(REPO, 'tiler_tpu_torch', 'ops',
                                       'nn_kernels.py'))
