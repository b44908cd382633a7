"""FrameTiling's stage 1 and stage 2's candidate lists held against the
plain reference (reference/frame_tiling.py), exactly, keyframe by
keyframe, on the encode that the program runs (`Encoder.run_all`).

`MarkProbe`, installed over one encode, wraps the program's
`pipeline.frame_tiling._mark_from_knn` and `candidate_features` (looked
up on their module at every call, as probe.py's are) and keeps, per
keyframe, the tilemap that the marking read, the keyframe's palette
centroids, the program's marks and its candidate list; the first call
also keeps the tiles' PalPixels and the active set. `compare` runs the
reference on what was kept and returns one record a keyframe.

`plant(name)` breaks the program's stage 1 for as long as it is open,
for showing that the comparison fails: 'slow_as_medium' marks a SLOW
encode as MEDIUM does, 'no_equal_skip' drops UseOne's consecutive-equal
skip from the 8-NN.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .reference import frame_tiling as ref


class MarkProbe:
    def __init__(self):
        from tiler_tpu_torch.pipeline import frame_tiling
        self.ft = frame_tiling
        self.keyframes = {}   # k -> what the program read and gave
        self.tiles_pal = self.active = None
        self._orig = None

    def install(self):
        self._orig = (self.ft._mark_from_knn, self.ft.candidate_features)
        self.ft._mark_from_knn = self._mark
        self.ft.candidate_features = self._cands
        return self

    def uninstall(self):
        if self._orig is not None:
            self.ft._mark_from_knn, self.ft.candidate_features = self._orig
            self._orig = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _mark(self, state, k, *args):
        if self.tiles_pal is None:
            self.tiles_pal = state.device_tiles_pal().clone()
            self.active = np.array(state.tile_active, bool)
        s, e = state.keyframes[k]
        used = self._orig[0](state, k, *args)
        self.keyframes[k] = {
            'tm_tile': np.array(state.tm_tile[s:e + 1]),
            'tm_pal': np.array(state.tm_pal[s:e + 1]),
            'centroids': np.array(state.palette_centroids[k]),
            'used': np.array(used, bool)}
        return used

    def _cands(self, state, k, *args):
        out = self._orig[1](state, k, *args)
        self.keyframes[k]['cands'] = tuple(np.asarray(a, np.int64)
                                           for a in out[1:])
        return out


def compare(probe: MarkProbe, cfg, dev) -> list:
    """Per keyframe the program's marks and candidate list against the
    reference's at the quality of `cfg`, the encode's EncoderConfig: each
    equal or not, the candidate counts and, for SLOW, whether its marks
    hold the reference's MEDIUM marks; marks_differing counts the entries
    of the two used matrices that differ."""
    quality = cfg.ft_quality.name
    qualities = (quality, 'MEDIUM') if quality == 'SLOW' else (quality,)
    tiles = probe.tiles_pal.to(dev)
    active = torch.from_numpy(probe.active).to(dev)
    out = []
    for k in sorted(probe.keyframes):
        kf = probe.keyframes[k]
        used, tile_of, attrs_of = ref.keyframe(
            qualities, torch.from_numpy(kf['tm_tile']).to(dev),
            torch.from_numpy(kf['tm_pal']).to(dev), tiles, active,
            cfg.palette_count, torch.from_numpy(kf['centroids']),
            cfg.ft_palette_tol)
        want = [a.cpu().numpy() for a in
                ref.candidates(used[quality], tile_of, attrs_of)]
        mine = used[quality].cpu().numpy()
        same_shape = kf['used'].shape == mine.shape
        rec = {'keyframe': k,
               'marks_equal': bool(np.array_equal(kf['used'], mine)),
               'marks_differing': int((kf['used'] != mine).sum())
               if same_shape else None,
               'candidates_equal': 'cands' in kf and all(
                   np.array_equal(a, b) for a, b in zip(kf['cands'], want)),
               'candidates': len(kf['cands'][0]) if 'cands' in kf else None,
               'reference_candidates': len(want[0])}
        if quality == 'SLOW':
            med = used['MEDIUM'].cpu().numpy()
            rec['medium_candidates'] = int(med.sum())
            rec['holds_medium'] = bool(
                kf['used'].shape == med.shape and not (med & ~kf['used'])
                .any())
        out.append(rec)
    return out


def passes(records: list) -> bool:
    return bool(records) and all(
        r['marks_equal'] and r['candidates_equal']
        and r.get('holds_medium', True) for r in records)


def _slow_as_medium(orig, ft):
    def mark(state, k, idxs, keep, tile_inv, n_uq, n_ds, pal_mask):
        cfg = state.config
        if cfg.ft_quality.name != 'SLOW':
            return orig(state, k, idxs, keep, tile_inv, n_uq, n_ds, pal_mask)
        state.config = dataclasses.replace(
            cfg, ft_quality=type(cfg.ft_quality)['MEDIUM'])
        try:
            return orig(state, k, idxs, keep, tile_inv, n_uq, n_ds,
                        ft.palette_similarity_mask(state, k))
        finally:
            state.config = cfg
    return mark


def _no_equal_skip(orig, ft):
    def nearest(*args, **kw):
        idx, keep = orig(*args, **kw)
        return idx, torch.ones_like(keep)
    return nearest


@contextlib.contextmanager
def plant(name: str):
    """The program's stage 1 broken as `name` says while open."""
    from tiler_tpu_torch.ops import knn
    from tiler_tpu_torch.pipeline import frame_tiling as ft
    module, attr, make = {
        'slow_as_medium': (ft, '_mark_from_knn', _slow_as_medium),
        'no_equal_skip': (knn, 'nearest_k_keepmask', _no_equal_skip),
    }[name]
    orig = getattr(module, attr)
    setattr(module, attr, make(orig, ft))
    try:
        yield
    finally:
        setattr(module, attr, orig)
