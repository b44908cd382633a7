"""The native Value-at-Risk quantizer (native/var_quant.cc) against the
plain host version (ops.palette.var_palette) and the JAX package's, byte
for byte, on seeded histograms; its tile form against the histogram of
the gathered pixels; and its calls off the interpreter lock."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import ctypes
import threading
import time

import numpy as np
import pytest

from tiler_tpu.ops import palette as jpalette
from tiler_tpu_torch import native
from tiler_tpu_torch.constants import palette_pattern
from tiler_tpu_torch.ops import palette

PAL_VARS = (0.5, 0.95, 1.0)
# (tile_palette_size, palette_count)
SIZES = ((16, 8), (16, 128), (4, 2), (8, 1))


def _histogram(seed: int):
    """A seeded histogram: on even seeds colours on a coarse grid (equal
    hues and values, so that two successive minima soon agree), on odd
    seeds few colours of the whole cube (distinct distances, so that the
    merges run on to the CmlPct position); greys and colours whose hue
    wraps below 0; counts with many ties; a budget below, at or above the
    pixels counted."""
    rng = np.random.default_rng([seed, 26])
    n = int(rng.integers(2, 600 if seed % 2 else 5000))
    step = 1 if seed % 2 else int(rng.choice([8, 32, 64, 128]))
    rgb = rng.integers(0, 256 // step, (n, 3)) * step
    m = 2 if seed % 2 else n // 10
    rgb[:m] = rng.integers(0, 256, (m, 1))                   # greys
    rgb[m:2 * m, 0] = 255                                    # r max ...
    rgb[m:2 * m, 2] = 200                                    # ... with b > g
    cols = np.unique(palette.rgb_to_packed(np.minimum(rgb, 255)))
    counts = rng.choice([1, 1, 2, 3, 7, 64], len(cols)) \
        * rng.integers(1, 3, len(cols))
    total = int(counts.sum())
    budget = int(rng.choice([total // 3 + 1, total, 2 * total]))
    tps, pc = SIZES[seed % len(SIZES)]
    row = palette_pattern(pc, tps)[int(rng.integers(pc))]
    return cols, counts.astype(np.int64), budget, \
        PAL_VARS[seed % len(PAL_VARS)], tps, pc, row


def _special(name: str):
    rng = np.random.default_rng(2601)
    row = palette_pattern(8, 16)[3]
    if name == 'empty':
        return np.zeros(0, np.uint32), np.zeros(0, np.int64), 10, 0.95, 16, \
            8, row
    if name == 'one_colour':
        return np.array([0x203040], np.uint32), np.array([5], np.int64), \
            640, 0.95, 16, 8, row
    if name == 'large':
        cols = np.unique(rng.integers(0, 1 << 24, 70000).astype(np.uint32))
        counts = rng.integers(1, 4, len(cols)).astype(np.int64)
        return cols, counts, int(counts.sum()), 0.95, 16, 128, \
            palette_pattern(128, 16)[77]
    # every count equal and every hue equal: the sort falls to val, sat and
    # the packed value
    v = np.arange(0, 256, 4)
    rgb = np.stack([v, v // 2, v // 4], 1)
    cols = np.unique(palette.rgb_to_packed(rgb))
    return cols, np.full(len(cols), 3, np.int64), 3 * len(cols), \
        {'ties_pal_var_0.5': 0.5, 'ties_pal_var_1.0': 1.0}[name], 4, 2, \
        palette_pattern(2, 4)[1]


CASES = [f'seed{i}' for i in range(42)] + [
    'empty', 'one_colour', 'large', 'ties_pal_var_0.5', 'ties_pal_var_1.0']


@pytest.mark.parametrize('case', CASES)
def test_native_var_is_the_host_and_jax_palette(case):
    args = _histogram(int(case[4:])) if case.startswith('seed') \
        else _special(case)
    want = palette.var_palette(*args)
    got, colours, merges = native.var_quant(*args)
    assert got.dtype == np.uint32 and got.shape == (args[4],)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jpalette.var_palette(*args), want)
    assert colours == len(args[0])
    assert 0 <= merges < max(colours, 1)


@pytest.mark.parametrize('n_sel', [0, 1, 37, 400])
def test_tile_form_is_the_histogram_of_the_gathered_pixels(rng, n_sel):
    tiles = (rng.integers(0, 16, (500, 8, 8, 3)) * 17).astype(np.uint8)
    tiles[100:300] = tiles[0]
    sel = np.sort(rng.choice(500, n_sel, replace=False)).astype(np.int32)
    row = palette_pattern(128, 16)[5]
    budget = 6 * 500 * 64
    cols, counts = np.unique(
        palette.rgb_to_packed(tiles[sel].reshape(-1, 3)), return_counts=True)
    want = palette.var_palette(cols, counts.astype(np.int64), budget, 0.95,
                               16, 128, row)
    got, colours, merges = native.var_quant_tiles(tiles, sel, budget, 0.95,
                                                  16, 128, row)
    np.testing.assert_array_equal(got, want)
    assert colours == len(cols)
    assert (got, colours, merges)[1:] == native.var_quant(
        cols, counts, budget, 0.95, 16, 128, row)[1:]


def _stalls(fn, calls=6):
    """Runs fn() `calls` times on a worker thread while this thread
    stamps the clock as fast as it can. Per call, the longest stretch of
    it in which this thread made no progress, over the call's length:
    near 1 for a call that holds the interpreter lock."""
    windows, stamps = [], []

    def work():
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            windows.append((t0, time.perf_counter()))
    t = threading.Thread(target=work)
    t.start()
    while t.is_alive():
        stamps.append(time.perf_counter())
    t.join()
    s = np.array(stamps)
    out = []
    for a, b in windows:
        inner = s[(s > a) & (s < b)]
        out.append(float(np.diff(np.concatenate([[a], inner, [b]])).max()
                         / (b - a)))
    return out


def test_the_native_call_releases_the_interpreter_lock():
    """The binding's call (ctypes.CDLL) lets this thread run while a
    worker quantizes 400,000 colours; the same function called with the
    lock held (ctypes.PyDLL) stalls it for most of each call, which shows
    that the reading can tell the two apart."""
    _, _, _, pal_var, tps, pc, row = _special('large')
    cols = np.unique(np.random.default_rng(7).integers(
        0, 1 << 24, 400000).astype(np.uint32))
    counts = np.ones(len(cols), np.int64)
    budget = len(cols)
    out = np.zeros(tps, np.uint32)
    stats = np.zeros(2, np.int64)
    args = [a.ctypes.data_as(ctypes.c_void_p) for a in (cols, counts)] + [
        len(cols), budget, pal_var, tps, pc,
        row.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        stats.ctypes.data_as(ctypes.c_void_p)]
    held = ctypes.PyDLL(native._SO_PATH).tiler_var_quant
    held.argtypes = native.get_lib().tiler_var_quant.argtypes
    held.restype = None
    assert min(_stalls(lambda: held(*args))) > 0.5
    assert stats[0] == len(cols)
    assert np.median(_stalls(lambda: native.var_quant(
        cols, counts, budget, pal_var, tps, pc, row))) < 0.5


@pytest.mark.parametrize('bad', ['sel_past_tiles', 'negative_sel',
                                 'count_too_large', 'lengths_differ',
                                 'pattern_row_short'])
def test_the_binding_refuses_what_the_native_call_cannot_take(bad):
    tiles = np.zeros((10, 8, 8, 3), np.uint8)
    row = palette_pattern(8, 16)[0]
    cols = np.array([1, 2, 3], np.uint32)
    counts = np.array([1, 1, 1], np.int64)
    call = {
        'sel_past_tiles': lambda: native.var_quant_tiles(
            tiles, np.array([0, 10]), 640, 0.95, 16, 8, row),
        'negative_sel': lambda: native.var_quant_tiles(
            tiles, np.array([-1]), 640, 0.95, 16, 8, row),
        'count_too_large': lambda: native.var_quant(
            cols, np.array([1, 1 << 40, 1]), 640, 0.95, 16, 8, row),
        'lengths_differ': lambda: native.var_quant(
            cols, counts[:2], 640, 0.95, 16, 8, row),
        'pattern_row_short': lambda: native.var_quant(
            cols, counts, 640, 0.95, 16, 8, row[:8]),
    }[bad]
    with pytest.raises((ValueError, IndexError)):
        call()
