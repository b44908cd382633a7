"""The benchmark's wrappers around the program's functions that its
checks and its roofline read. Each is looked up on its module at every
call, so a wrapper set on the module takes the program's place:

- FrameTiling's stage-3 search, `ops.nn_kernels.prepare` and
  `ops.nn_kernels.nearest_1` (K1 and its prepare on the card);
- GlobalTiling's KModes, `pipeline.global_tiling.kmodes_batch_gather`;
- Dither's palette clustering, `pipeline.dither_step.kmeans_core`.

`Calls`, installed over the timed window, records the shape (Q, C, D) of
every search call, which fixes the search's work for `nn1_roofline`, and
does nothing else. `Capture`, installed over one more encode after the
window has closed, also keeps on the encode's device everything the
checks judge: each keyframe's candidate features and every search call's
queries with K1's winners; the KModes lines with each bin's cluster
count and the program's labels and winners; each keyframe's clustered
features with the program's labels. With `control` set, that function
takes the search's place (the TF32 control), with the candidates passed
as raw rows.
"""
from __future__ import annotations

import weakref

import torch


class Calls:
    def __init__(self, control=None):
        from tiler_tpu_torch.ops import nn_kernels
        self.nk = nn_kernels
        self.control = control
        self.calls = []            # (Q, C, D) of every search call
        self._orig = None

    def install(self):
        self._orig = (self.nk.prepare, self.nk.nearest_1)
        self.nk.prepare, self.nk.nearest_1 = self._prepare, self._nearest_1
        return self

    def uninstall(self):
        if self._orig is not None:
            self.nk.prepare, self.nk.nearest_1 = self._orig
            self._orig = None

    def _prepare(self, c):
        return c if self.control is not None else self._orig[0](c)

    def _nearest_1(self, q, c):
        n_c = len(c) if isinstance(c, torch.Tensor) else c.n_c
        self.calls.append((int(q.shape[0]), int(n_c), int(q.shape[1])))
        if self.control is not None:
            return self.control(q, c)
        return self._orig[1](q, c)


class Capture(Calls):
    def __init__(self, control=None):
        super().__init__(control)
        from tiler_tpu_torch.pipeline import dither_step, global_tiling
        self.gt, self.ds = global_tiling, dither_step
        self.k1 = []       # per keyframe: ref, cands, queries, winners
        self.kmodes = []   # per solve call: sigs, bins, m
        self.kmeans = []   # per keyframe: x, k, labels

    def install(self):
        super().install()
        self._orig_gt = self.gt.kmodes_batch_gather
        self._orig_ds = self.ds.kmeans_core
        self.gt.kmodes_batch_gather = self._kmodes
        self.ds.kmeans_core = self._kmeans
        return self

    def uninstall(self):
        if self._orig is not None:
            self.gt.kmodes_batch_gather = self._orig_gt
            self.ds.kmeans_core = self._orig_ds
        super().uninstall()

    def _prepare(self, c):
        out = super()._prepare(c)
        self.k1.append({'ref': weakref.ref(out), 'cands': c.detach().clone(),
                        'queries': [], 'winners': []})
        return out

    def _nearest_1(self, q, c):
        idx, err = super()._nearest_1(q, c)
        for kf in self.k1:
            if kf['ref']() is c:
                kf['queries'].append(q.detach().clone())
                kf['winners'].append(idx.detach().clone())
        return idx, err

    def _kmodes(self, sigs, bins_sel, bins_k, *args, **kw):
        out = self._orig_gt(sigs, bins_sel, bins_k, *args, **kw)
        m = args[1] if len(args) > 1 else kw['n_modalities']
        self.kmodes.append({
            'sigs': sigs.detach().clone(), 'm': int(m),
            'bins': [(sel.copy(), int(k), res[0].copy(), res[-1].copy())
                     for sel, k, res in zip(bins_sel, bins_k, out)]})
        return out

    def _kmeans(self, x, k, *args, **kw):
        out = self._orig_ds(x, k, *args, **kw)
        self.kmeans.append({'x': x.detach().clone(), 'k': int(k),
                            'labels': out[0].detach().clone()})
        return out
