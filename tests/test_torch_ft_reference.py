"""FrameTiling's stage 1 and stage 2's candidate lists held exactly against
the plain reference (gtmbench/reference/frame_tiling.py, upstream's UseOne
and BuildPaletteCorrTriangle in float64) at FAST, MEDIUM and SLOW, on
the encode that Encoder.run_all runs on the CPU, with stage 3's winners
within a float32 tie of the float64 best (gtmbench/reference/nn.py). A
planted fault, SLOW marked as MEDIUM, has to fail the comparison."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from gtmbench import ft_probe
from gtmbench.probe import Capture
from gtmbench.reference import frame_tiling as ref
from gtmbench.reference import nn
from tiler_tpu_torch.config import EncoderConfig, FTQuality
from tiler_tpu_torch.pipeline.encoder import Encoder

torch.set_num_threads(1)

# the tie scale of tests/test_torch_configs_fields.py: a gap over
# |q|^2 + |c|^2 at which the f32 1-NN can part from the float64 one
K1_GAP = 1e-6


def _clip():
    """6 x 64 x 96: two scenes of seeded noise, each cell's noise tinted
    by one of three colour families of its scene, so that some palette
    centroids lie near each other (MEDIUM's mask holds more than the
    diagonal), and a few cells redrawn every frame (two keyframes,
    changed and static cells)."""
    rng = np.random.default_rng(2202)
    frames = np.empty((6, 64, 96, 3), np.uint8)
    for s0 in (0, 3):
        fam = rng.uniform(0.3, 1.0, (3, 3))
        tint = np.repeat(np.repeat(fam[rng.integers(3, size=(8, 12))], 8, 0),
                         8, 1)
        base = (rng.integers(0, 256, (64, 96, 3)) * tint).astype(np.uint8)
        for f in range(s0, s0 + 3):
            frames[f] = base
            for _ in range(6):
                y, x = 8 * rng.integers(8), 8 * rng.integers(12)
                frames[f, y:y + 8, x:x + 8] = (
                    rng.integers(0, 256, (8, 8, 3)) * fam[rng.integers(3)])
    return frames


@pytest.mark.parametrize('case', ['FAST', 'MEDIUM', 'SLOW',
                                  'SLOW_planted_as_MEDIUM'])
def test_marks_and_candidates_equal_the_reference(case):
    quality = FTQuality[case.split('_')[0]]
    cfg = EncoderConfig(palette_count=8, tile_palette_size=16, max_tiles=160,
                        ft_quality=quality)
    planted = case.endswith('MEDIUM') and quality is FTQuality.SLOW
    frames = _clip()
    probe = ft_probe.MarkProbe()
    cap = Capture()
    with contextlib.ExitStack() as stack:
        if planted:
            stack.enter_context(ft_probe.plant('slow_as_medium'))
        stack.enter_context(probe)
        cap.install()
        stack.callback(cap.uninstall)
        enc = Encoder(cfg, device='cpu')
        enc.run_all(frames, fps=24.0, fast_lzma=True)
    assert len(enc.state.keyframes) == 2
    records = ft_probe.compare(probe, cfg, 'cpu')
    assert [r['keyframe'] for r in records] == [0, 1]
    if planted:
        assert not ft_probe.passes(records), records
        assert not any(r['marks_equal'] for r in records), records
        return
    assert ft_probe.passes(records), records
    if quality is FTQuality.MEDIUM:
        # the centroid mask joins palettes on this clip
        assert any(ref.palette_near(torch.from_numpy(kf['centroids']),
                                    cfg.ft_palette_tol).sum() > 8
                   for kf in probe.keyframes.values())
    if quality is FTQuality.SLOW:
        assert all(r['candidates'] > r['medium_candidates']
                   for r in records), records
    sizes = enc.state.metrics['ft_knn_sizes']
    assert [r['candidates'] for r in records] == sizes
    for kf, size in zip(cap.k1, sizes):
        assert len(kf['cands']) == size
        g, _, n_q = nn.gap(torch.cat(kf['queries']), kf['cands'],
                           torch.cat(kf['winners']))
        assert n_q > 0 and g <= K1_GAP
