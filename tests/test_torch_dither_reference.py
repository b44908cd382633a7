"""Dither's VAR palettes and Yliluoma-2 plans held exactly against the
plain references (gtmbench/reference/var.py, upstream's
DoValueAtRiskBased in NumPy; gtmbench/reference/yliluoma.py, its mixing
plans in int64 torch) on the encode that Encoder.run_all runs on the CPU,
through gtmbench.dither_probe, every palette and every plan key and then
the benchmark's sample of them. Planted faults, VAR stopped before its
merges and plans of 2 mixed colours in place of 4, have to fail the
comparison."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from gtmbench import dither_probe
from gtmbench.reference import var as var_ref
from gtmbench.reference import yliluoma as yl_ref
from tiler_tpu_torch.config import EncoderConfig
from tiler_tpu_torch.constants import DITHERING_MAP, palette_pattern
from tiler_tpu_torch.ops import dither, palette
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.tools.common import synthetic_clip_v2

torch.set_num_threads(1)

CFG = EncoderConfig(palette_count=16, max_tiles=400, use_thomas_knoll=False,
                    use_dl3=False, yliluoma_mix=4)


def _encode(probe, planted=None):
    with contextlib.ExitStack() as stack:
        if planted:
            stack.enter_context(dither_probe.plant(planted))
        stack.enter_context(probe)
        enc = Encoder(CFG, device='cpu')
        enc.run_all(synthetic_clip_v2(8, 120, 160), fps=24.0, fast_lzma=True)
    return enc.state


@pytest.fixture(scope='module')
def every():
    probe = dither_probe.DitherProbe(seed=2601, every=True)
    state = _encode(probe)
    return probe, state, dither_probe.compare(probe, CFG)


def test_every_var_palette_and_plan_is_the_references(every):
    probe, state, rec = every
    assert len(state.keyframes) >= 2
    assert rec['var_palettes'] == CFG.palette_count * len(state.keyframes) \
        == state.metrics['dither_var']['groups']
    assert rec['plans'] == state.metrics['dither_plan_keys'] > 0
    assert rec['var_palettes_differing'] == 0, rec
    assert rec['plans_differing'] == 0, rec
    assert dither_probe.passes(rec)
    # the clip's groups merge (so the merges were compared too)
    assert state.metrics['dither_var']['merges'] > 0


def test_the_palettes_are_the_encodes(every):
    """What the probe kept is what the encode wrote: each keyframe's
    palettes, LHS-sorted, are its groups' VAR palettes in some order."""
    probe, state, _ = every
    for k in range(len(state.keyframes)):
        want = sorted(palette.sort_palette_lhs(g['palette']).tobytes()
                      for g in probe.groups if g['keyframe'] == k)
        got = sorted(palette.rgb_to_packed(p).astype(np.uint32).tobytes()
                     for p in state.palettes_rgb[k])
        assert got == want, k


@pytest.mark.parametrize('seed', [3126000101, 7])
def test_the_sampled_comparison_reads_zero(seed):
    probe = dither_probe.DitherProbe(seed=seed, plan_keys=512)
    state = _encode(probe)
    rec = dither_probe.compare(probe, CFG)
    assert 0 <= rec['keyframe'] < len(state.keyframes)
    assert rec['var_palettes'] == CFG.palette_count
    assert rec['plans'] == 512
    assert dither_probe.passes(rec), rec


@pytest.mark.parametrize('planted,field', [
    ('var_no_merges', 'var_palettes_differing'),
    ('plan_mix_2', 'plans_differing')])
def test_a_planted_fault_fails_the_comparison(planted, field):
    probe = dither_probe.DitherProbe(seed=11, every=True)
    _encode(probe, planted)
    rec = dither_probe.compare(probe, CFG)
    assert rec[field] > 0, rec
    other = ({'var_palettes_differing', 'plans_differing'} - {field}).pop()
    if planted == 'plan_mix_2':
        # the palettes come before the scan: the fault leaves them
        assert rec[other] == 0, rec
    assert not dither_probe.passes(rec)


def test_the_references_pick_the_ports_pixels(rng):
    """reference/yliluoma's plans and Bayer pick give the port's plain
    per-pixel Yliluoma dither, and reference/var's palette of a histogram
    is ops.palette.var_palette's."""
    tiles = rng.integers(0, 256, (40, 8, 8, 3)).astype(np.uint8)
    pals = rng.integers(0, 256, (40, 16, 3)).astype(np.uint8)
    want = dither.yliluoma_dither_tiles(torch.from_numpy(tiles),
                                        torch.from_numpy(pals), 4)
    cols = torch.from_numpy(tiles.reshape(-1, 3))
    px_pals = torch.from_numpy(pals).repeat_interleave(64, 0)
    plans, counts = yl_ref.plans(cols, px_pals, 4)
    bayer = torch.from_numpy(DITHERING_MAP.astype(np.int64)).repeat(40)
    got = yl_ref.pick(plans, counts, bayer).reshape(40, 8, 8)
    assert torch.equal(got.to(torch.uint8), want)
    px = (rng.integers(0, 40, (4000, 3)) * 6).astype(np.uint8)
    cols, counts = var_ref.histogram(px)
    row = palette_pattern(4, 16)[2]
    np.testing.assert_array_equal(
        var_ref.palette(px, 9000, 0.95, 16, 4, row),
        palette.var_palette(cols.astype(np.uint32), counts, 9000, 0.95, 16,
                            4, row))
