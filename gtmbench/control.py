"""The readings that a cell's correctness limits are set from, in one
process (the benchmark's own runs do not run this):

    python3 -m gtmbench.control --workload default.cuts1080 \
        --seeds 11,12,13,14 --variants program,tf32,kmeans_no_lloyd \
        [--other-seeds 11,12,13] [--out readings.jsonl]

Set-up runs once. Each variant is one encode of the cell's clip under
probe.Capture, judged for every seed as a run judges its own (run.judge),
one JSON line per variant and seed (`--seeds` for `program`,
`--other-seeds`, by default the first three of them, for the rest).
`program` is the program as the
benchmark runs it (the lower readings). The others give the upper ones:
`tf32` puts the reference's 1-NN computed in TF32 (reference/nn.
nearest_tf32), one step below the stated float32, in the stage-3
search's place (the control); the faults break one step of the timed
path underneath: `kmeans_no_lloyd` stops Dither's palette k-means after
its k-means++ seeding, `kmeans_uniform_start` seeds it with k rows
drawn uniformly instead of by k-means++, `kmodes_no_iters` stops
GlobalTiling's KModes after its farthest-first start, `kmodes_first_start` solves every KModes
bin once, from its first line (one restart where the configuration
states seven, or the wrong start where it states the smallest byte
sum's). It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time

import torch

from . import cells, run
from .reference import nn


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _first_start(orig):
    def solve(sigs, bins_sel, bins_k, bins_start, *args, **kw):
        return orig(sigs, bins_sel, bins_k, [0] * len(bins_start), *args,
                    **kw)
    return solve


def _uniform_start(orig):
    def start(x, x2, k, key):
        gen = torch.Generator(device=x.device)
        gen.manual_seed(0)
        rows = torch.randperm(len(x), generator=gen, device=x.device)[:k]
        return x[rows].clone()
    return start


def variant(name: str):
    """(the stage-3 control or None, a context that plants the fault)."""
    from tiler_tpu_torch.ops import kmeans
    from tiler_tpu_torch.pipeline import dither_step, global_tiling
    if name == 'tf32':
        return nn.nearest_tf32, contextlib.nullcontext()
    if name == 'kmeans_no_lloyd':
        return None, _patched(dither_step, 'kmeans_core', lambda f:
                              functools.partial(f, max_iters=0))
    if name == 'kmeans_uniform_start':
        return None, _patched(kmeans, '_plus_plus_init', _uniform_start)
    if name == 'kmodes_no_iters':
        return None, _patched(global_tiling, 'kmodes_batch_gather',
                              lambda f: functools.partial(f, max_iters=0))
    if name == 'kmodes_first_start':
        return None, _patched(global_tiling, 'kmodes_batch_gather',
                              _first_start)
    if name == 'program':
        return None, contextlib.nullcontext()
    raise ValueError(f'unknown variant {name}')


VARIANTS = ('program', 'tf32', 'kmeans_no_lloyd', 'kmeans_uniform_start',
            'kmodes_no_iters', 'kmodes_first_start')


def readings(cell, names, seeds, other_seeds=None, device='cuda',
             out=sys.stdout):
    """One captured encode per variant, judged for each of its seeds."""
    other_seeds = seeds[:3] if other_seeds is None else other_seeds
    prog = run.setup(cell, device, time.perf_counter())
    run.encode(prog, prog.frames[:run.WARM_FRAMES])
    lines = []
    for name in names:
        control, fault = variant(name)
        t = time.perf_counter()
        with fault:
            blob, cap = run.capture(prog, control=control)
        enc_s = time.perf_counter() - t
        for seed in seeds if name == 'program' else other_seeds:
            t = time.perf_counter()
            checks = run.judge(cell, cap, seed, prog.dev)
            line = {'workload': cell.name, 'variant': name, 'seed': seed,
                    'correct': all(map(run.passes, checks.values())),
                    'checks': checks, 'stream_bytes': len(blob),
                    'encode_s': enc_s,
                    'judge_s': time.perf_counter() - t}
            lines.append(line)
            print(json.dumps(line), file=out, flush=True)
        del cap
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog='python3 -m gtmbench.control')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--variants', default='program')
    p.add_argument('--other-seeds')
    p.add_argument('--out')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('gtmbench.control: no CUDA card', file=sys.stderr)
        return 2
    names = args.variants.split(',')
    bad = set(names) - set(VARIANTS)
    if bad:
        p.error(f'unknown variants {sorted(bad)}')
    seeds = [int(s) for s in args.seeds.split(',')]
    other = None if args.other_seeds is None else [
        int(s) for s in args.other_seeds.split(',')]
    lines = readings(cells.load(args.workload), names, seeds, other)
    if args.out:
        with open(args.out, 'a') as fh:
            fh.writelines(json.dumps(x) + '\n' for x in lines)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
