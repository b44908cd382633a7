"""Save's LZMA as one thread-pool job per (keyframe stream, encoder):
tiler_tpu_torch.bitstream.gtm.compress_keyframe_streams against the JAX
package's serial compress_keyframe_stream, byte for byte, in every mode
and at any pool size; the jobs it runs and the order it submits them in;
the fallback to liblzma where no C++ toolchain builds the native encoder."""
from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import pytest

import tiler_tpu.bitstream.gtm as jgtm
import tiler_tpu_torch.bitstream.gtm as gtm
from tiler_tpu_torch import native
from tiler_tpu_torch.bitstream.lzma_codec import iter_lzma_streams
from tiler_tpu_torch.utils import dispatch

MODES = ('lc3', 'lc8', 'auto', 'best')
SAMPLE = os.path.join(os.path.dirname(__file__), '..', 'decoders', 'web',
                      'sample.gtm')


def _markov(n=20000, p=0.7, seed=1):
    """Bytes whose next byte is mostly a fixed function of the last one:
    lc8's full-byte literal context beats liblzma's lc3 on them."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(256)
    flip, noise = rng.random(n) < p, rng.integers(0, 256, n)
    out = np.empty(n, np.uint8)
    out[0] = 0
    for i in range(1, n):
        out[i] = perm[out[i - 1]] if flip[i] else noise[i]
    return out.tobytes()


@functools.lru_cache(maxsize=None)
def _streams() -> tuple:
    """(name, raw) of the streams compressed: empty, the sample's
    keyframe streams, one liblzma wins, one the native parse wins, random
    bytes."""
    data = open(SAMPLE, 'rb').read()
    hdr = gtm.GTMHeader.unpack(data)
    whole = hdr.whole_header_size or (gtm.HEADER_SIZE
                                      + gtm.KFINFO_SIZE * hdr.kf_count)
    kfs = list(iter_lzma_streams(data[whole:],
                                 expected_count=hdr.kf_count, strict=True))
    return (('empty', b''),
            *((f'sample_kf{i}', raw) for i, raw in enumerate(kfs)),
            ('liblzma_wins', bytes(range(256)) * 64),
            ('native_wins', _markov()),
            ('random', bytes(np.random.default_rng(0).integers(
                0, 256, 4096).astype(np.uint8))))


@functools.lru_cache(maxsize=None)
def _serial(mode: str, fast: bool) -> tuple:
    """The JAX package's serial bytes of each stream."""
    return tuple(jgtm.compress_keyframe_stream(raw, fast_lzma=fast,
                                               lzma_mode=mode)
                 for _, raw in _streams())


def test_the_streams_reach_both_sides_of_auto():
    """'auto' keeps liblzma's bytes on one stream and the native parse's
    on another, with either parse."""
    names = [n for n, _ in _streams()]
    assert len(names) >= 6
    for fast in (False, True):
        lib, lc8 = _serial('lc3', fast), _serial('lc8', fast)
        got = dict(zip(names, _serial('auto', fast)))
        i, j = names.index('liblzma_wins'), names.index('native_wins')
        assert len(lib[i]) < len(lc8[i]) and got['liblzma_wins'] == lib[i]
        assert len(lc8[j]) < len(lib[j]) and got['native_wins'] == lc8[j]


@pytest.mark.parametrize('workers', [1, 2, 8])
@pytest.mark.parametrize('fast', [False, True], ids=['optimal', 'fast'])
@pytest.mark.parametrize('mode', MODES)
def test_the_pool_gives_the_serial_bytes(monkeypatch, mode, fast, workers):
    monkeypatch.setattr(os, 'cpu_count', lambda: workers)
    raws = [raw for _, raw in _streams()]
    got = gtm.compress_keyframe_streams(raws, fast_lzma=fast,
                                        lzma_mode=mode)
    assert got == list(_serial(mode, fast))


@pytest.mark.parametrize('fast', [False, True], ids=['optimal', 'fast'])
@pytest.mark.parametrize('mode', MODES)
def test_one_stream_gives_the_serial_bytes(mode, fast):
    for (name, raw), want in zip(_streams(), _serial(mode, fast)):
        assert gtm.compress_keyframe_stream(
            raw, fast_lzma=fast, lzma_mode=mode) == want, name


@pytest.mark.parametrize('mode,native_jobs,liblzma_jobs', [
    ('lc3', 0, 3), ('lc8', 3, 0), ('auto', 3, 3), ('best', 9, 3)])
def test_jobs_per_stream_and_encoder(mode, native_jobs, liblzma_jobs):
    """The writer's count of jobs and the spans' seconds: one job per
    stream and encoder configuration, each under its encoder's span."""
    raws = [raw for name, raw in _streams()
            if name in ('liblzma_wins', 'native_wins', 'random')]
    jobs = {}
    before = dispatch.spans()
    gtm.compress_keyframe_streams(raws, lzma_mode=mode, jobs=jobs)
    spent = _spent(before)
    assert jobs == {'native': native_jobs, 'liblzma': liblzma_jobs}
    assert (spent['native'] > 0) == (native_jobs > 0)
    assert (spent['liblzma'] > 0) == (liblzma_jobs > 0)


def _spent(before):
    """Host seconds of each encoder's job spans since `before`."""
    now = dispatch.spans()
    return {k: now.get(f'save/lzma_{k}', 0.0)
            - before.get(f'save/lzma_{k}', 0.0)
            for k in ('native', 'liblzma')}


def _recording(monkeypatch, calls):
    """Replaces both encoders with ones that note their calls and return
    bytes whose length the test sets: per raw stream, a liblzma length
    and the native lengths per (lc, lp, pb)."""
    def lib(raw, fast=False):
        calls.append((raw, 'liblzma'))
        return b'L' * LENGTHS[raw]['liblzma']

    def nat(raw, lc, lp, pb, **_):
        calls.append((raw, (lc, lp, pb)))
        return bytes([10 * lp + pb]) * LENGTHS[raw][(lc, lp, pb)]
    monkeypatch.setattr(gtm, 'lzma_compress_alone', lib)
    monkeypatch.setattr(native, 'lzma_encode_alone', nat)


LENGTHS = {
    # liblzma ties the shortest native result: liblzma is kept
    b'a': {'liblzma': 2, (8, 0, 2): 3, (8, 0, 4): 2, (8, 1, 2): 2},
    # two native configs tie below liblzma: the first in order is kept
    b'bbb': {'liblzma': 5, (8, 0, 2): 4, (8, 0, 4): 3, (8, 1, 2): 3},
    b'cc': {'liblzma': 1, (8, 0, 2): 1, (8, 0, 4): 1, (8, 1, 2): 1},
}


def test_largest_stream_first_native_jobs_first(monkeypatch):
    """With one worker the jobs run in the order they are submitted:
    the streams from the largest, each with its native configs in order
    and then liblzma. The results come back in stream order, each the
    shortest, liblzma on a tie, else the first native config."""
    monkeypatch.setattr(os, 'cpu_count', lambda: 1)
    calls = []
    _recording(monkeypatch, calls)
    raws = [b'a', b'bbb', b'cc']
    got = gtm.compress_keyframe_streams(raws, lzma_mode='best')
    cfgs = [(8, 0, 2), (8, 0, 4), (8, 1, 2), 'liblzma']
    assert calls == [(r, c) for r in (b'bbb', b'cc', b'a') for c in cfgs]
    assert got == [b'LL', b'\x04' * 3, b'L']


def test_an_encode_failure_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError('lzma encode failed (status 3)')
    monkeypatch.setattr(native, 'lzma_encode_alone', broken)
    with pytest.raises(ValueError, match='status 3'):
        gtm.compress_keyframe_streams([b'abc', b'de'], lzma_mode='auto')


def test_no_toolchain_runs_liblzma_jobs_alone(monkeypatch):
    """Without a C++ toolchain 'auto' and 'best' submit only liblzma
    jobs, warn once and give the bytes of 'lc3'; 'lc8' raises before
    any job."""
    def no_toolchain():
        raise native.NoToolchainError('g++ not found on this host')
    raws = [raw for _, raw in _streams()]
    want = list(_serial('lc3', False))
    monkeypatch.setattr(gtm, '_warned_no_native_lzma', False)
    monkeypatch.setattr(native, 'get_lib', no_toolchain)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        for mode in ('auto', 'best'):
            jobs = {}
            assert gtm.compress_keyframe_streams(
                raws, lzma_mode=mode, jobs=jobs) == want
            assert jobs == {'native': 0, 'liblzma': len(raws)}
    assert sum('falls back to liblzma' in str(x.message) for x in w) == 1
    jobs = {}
    before = dispatch.spans()
    with pytest.raises(native.NoToolchainError):
        gtm.compress_keyframe_streams(raws, lzma_mode='lc8', jobs=jobs)
    assert jobs == {}
    assert _spent(before) == {'native': 0.0, 'liblzma': 0.0}


def test_job_spans_add_up_across_workers(monkeypatch):
    """1,024 jobs on 8 workers under a short switch interval, with a
    clock that gives each span exactly one second: each job adds one
    span of its encoder to the shared sums, and none of those updates is
    lost."""
    import sys
    import threading
    import time
    clock = threading.local()

    class Clock:
        @staticmethod
        def perf_counter():
            clock.n = getattr(clock, 'n', 0) + 1
            return float(clock.n % 2 == 0)
    monkeypatch.setattr(dispatch, 'time', Clock)
    monkeypatch.setattr(os, 'cpu_count', lambda: 64)
    raws = [bytes([i]) * (1 + i % 3) for i in range(256)]

    def lib(raw, fast):
        time.sleep(1e-4)    # both encoders release the interpreter lock
        return raw

    def nat(raw, **kwargs):
        time.sleep(1e-4)
        return raw + b'.'
    monkeypatch.setattr(gtm, 'lzma_compress_alone', lib)
    monkeypatch.setattr(native, 'lzma_encode_alone', nat)
    jobs = {}
    before = dispatch.spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = gtm.compress_keyframe_streams(raws, lzma_mode='best',
                                            jobs=jobs)
    finally:
        sys.setswitchinterval(interval)
    assert got == raws
    assert jobs == {'native': 768, 'liblzma': 256}
    assert _spent(before) == {'native': 768.0, 'liblzma': 256.0}
