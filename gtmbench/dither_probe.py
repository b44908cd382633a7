"""Dither's VAR palettes and Yliluoma-2 plans held against the plain
references (reference/var.py, reference/yliluoma.py), exactly, on the
encode that the program runs (`Encoder.run_all`).

`DitherProbe(seed)`, installed over one encode, wraps the program's
`pipeline.dither_step.quantize_keyframe_palettes` (to know the keyframe),
`native.var_quant_tiles` (the native VAR call of one group) and
`ops.dither.yliluoma_plans` (the plans of a chunk of unique keys), each
looked up on its module at every call, as probe.py's are. It keeps every
group's VAR inputs and palette of one keyframe drawn from the seed, and a
uniform sample, drawn from the seed, of `plan_keys` plan keys (a colour
and its group's palette) over the whole encode with their plans and
counts. With `every=True` it keeps every keyframe's groups and every key.
`compare(probe, cfg)` runs the references at the configuration's settings
on what was kept and counts what differs.

`plant(name)` breaks the program's Dither for as long as it is open, for
showing that the comparison fails: 'var_no_merges' stops VAR before its
merges, 'plan_mix_2' plans with 2 mixed colours in place of the stated.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import var as var_ref
from .reference import yliluoma as yl_ref

PLAN_KEYS = 4096


class DitherProbe:
    def __init__(self, seed: int, plan_keys: int = PLAN_KEYS,
                 every: bool = False):
        from tiler_tpu_torch import native
        from tiler_tpu_torch.ops import dither
        from tiler_tpu_torch.pipeline import dither_step
        self.mods = (dither_step, native, dither)
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 26])
        self.gen = torch.Generator()
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.plan_keys = plan_keys
        self.every = every
        self.keyframe = None          # the sampled keyframe
        self._k = None                # the keyframe being quantized
        self.tiles_rgb = None
        self.groups = []              # per VAR call: inputs and palette
        self.keys = []                # per plans call: the kept keys
        self._orig = None

    def install(self):
        ds, nat, dith = self.mods
        self._orig = (ds.quantize_keyframe_palettes, nat.var_quant_tiles,
                      dith.yliluoma_plans)
        ds.quantize_keyframe_palettes = self._quantize
        nat.var_quant_tiles = self._var
        dith.yliluoma_plans = self._plans
        return self

    def uninstall(self):
        if self._orig is not None:
            ds, nat, dith = self.mods
            (ds.quantize_keyframe_palettes, nat.var_quant_tiles,
             dith.yliluoma_plans) = self._orig
            self._orig = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _quantize(self, state, k):
        if self.keyframe is None:
            self.keyframe = int(self.rng.integers(len(state.keyframes)))
        self._k = k
        return self._orig[0](state, k)

    def _var(self, tiles_rgb, sel, total_budget, *args):
        out = self._orig[1](tiles_rgb, sel, total_budget, *args)
        if self.every or self._k == self.keyframe:
            self.tiles_rgb = tiles_rgb
            # list.append is atomic: the quantize pool's threads share it
            self.groups.append({'keyframe': self._k,
                                'sel': np.array(sel, np.int64),
                                'budget': int(total_budget),
                                'pattern_row': np.array(args[-1]),
                                'palette': np.array(out[0])})
        return out

    def _plans(self, cols, pal, luma_pal, mixed_colors):
        plans, counts = self._orig[2](cols, pal, luma_pal, mixed_colors)
        m = cols.shape[0]
        if self.every:
            rows = torch.arange(m)
            prio = torch.zeros(m)
        else:
            # a uniform sample over every call: the keys of least priority
            prio, rows = torch.sort(torch.rand(m, generator=self.gen))
            prio, rows = prio[:self.plan_keys], rows[:self.plan_keys]
        at = rows.to(cols.device)
        self.keys.append({'prio': prio, 'cols': cols[at].cpu(),
                          'pal': pal[at].cpu(), 'plans': plans[at].cpu(),
                          'counts': counts[at].cpu()})
        return plans, counts

    def sampled_keys(self) -> dict:
        """The kept keys: over every call, the plan_keys of least
        priority (all of them with every=True)."""
        if not self.keys:
            return {}
        got = {k: torch.cat([c[k] for c in self.keys]) for k in self.keys[0]}
        if not self.every:
            keep = torch.sort(got['prio']).indices[:self.plan_keys]
            got = {k: v[keep] for k, v in got.items()}
        return got


def compare(probe: DitherProbe, cfg) -> dict:
    """The kept VAR palettes and plans against the references' at the
    settings of `cfg`, the encode's EncoderConfig: how many were compared
    and how many differ. A plan differs where its count or one of its
    first `count` entries does."""
    var_differing = 0
    for g in probe.groups:
        want = var_ref.palette(
            probe.tiles_rgb[g['sel']], g['budget'], cfg.pal_var,
            cfg.tile_palette_size, cfg.palette_count, g['pattern_row'])
        var_differing += int(not np.array_equal(g['palette'], want))
    keys = probe.sampled_keys()
    plans_differing = n_keys = 0
    if keys:
        n_keys = len(keys['counts'])
        plans, counts = yl_ref.plans(keys['cols'], keys['pal'],
                                     cfg.yliluoma_mix)
        got = keys['plans'].to(torch.int64)
        width = max(got.shape[1], plans.shape[1])
        got = torch.nn.functional.pad(got, (0, width - got.shape[1]))
        plans = torch.nn.functional.pad(plans, (0, width - plans.shape[1]))
        valid = torch.arange(width)[None] < counts[:, None]
        same = (keys['counts'].to(torch.int64) == counts) & \
            ((got == plans) | ~valid).all(1)
        plans_differing = int((~same).sum())
    return {'keyframe': probe.keyframe,
            'var_palettes': len(probe.groups),
            'var_palettes_differing': var_differing,
            'plans': n_keys, 'plans_differing': plans_differing}


def passes(record: dict) -> bool:
    return record['var_palettes_differing'] == 0 \
        and record['plans_differing'] == 0


def _var_no_merges(orig):
    def var(tiles_rgb, sel, total_budget, pal_var, tile_palette_size,
            palette_count, pattern_row):
        # a CmlPct at or past every colour: the merges never start
        return orig(tiles_rgb, sel, total_budget, pal_var, tile_palette_size,
                    1 << 24, pattern_row)
    return var


def _plan_mix_2(orig):
    def plans(cols, pal, luma_pal, mixed_colors):
        return orig(cols, pal, luma_pal, 2)
    return plans


@contextlib.contextmanager
def plant(name: str):
    """The program's Dither broken as `name` says while open."""
    from tiler_tpu_torch import native
    from tiler_tpu_torch.ops import dither
    module, attr, make = {
        'var_no_merges': (native, 'var_quant_tiles', _var_no_merges),
        'plan_mix_2': (dither, 'yliluoma_plans', _plan_mix_2),
    }[name]
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)
