"""Stage-3 1-NN precision experiment on the card: the counterpart of
tools/nn_prec_bench.py.

The f32 1-NN kernel (nn_kernels.nearest_1, FP32 FFMA) against the bf16
one (nn_kernels.nearest_1_bf16: the dot's operands rounded to bf16 and
multiplied on the tensor cores with f32 accumulation, the norms in f32).
It measures the time per variant and the winner-index agreement between
the f32 and bf16 paths on PsyV features of random tiles (wavelet
coefficients of YUV tiles, the stage-3 distribution), and the bf16
kernel on features rounded to bf16 once (searching exactly in the
rounded space) with its agreement. Each candidate set is prepared once
(nn_kernels.prepare, prepare_bf16) outside the timed batches, as an
encoder prepares a keyframe's candidates once for all its query chunks;
the prepare's own time is printed beside the per-batch time.

Usage: python -m tiler_tpu_torch.tools.nn_prec_bench [n_c] [--device cuda]
  n_c   candidates (default 262144), rounded up to a multiple of 4096 as
        the JAX tool does, so both search the same candidate count.
Queries: 4 batches of 16384. Times come from CUDA events on a card
(mean over the 4 batches, after one warm-up call); with --device cpu
the plain torch versions run and the host clock times them. --device
defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import nn_kernels as nk
from .common import device_from, device_name, psyv_of_tiles, time_ms

_D = 192
_BC = 4096   # the JAX tool's candidate block; n_c rounds up to it
_NQ = 16384
_REPS = 4     # query batches of _NQ


def make_features(n: int, seed: int, dev: torch.device) -> torch.Tensor:
    """PsyV features of n random uint8 tiles (the JAX tool's draws)."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    return psyv_of_tiles(tiles, dev)


def run_batches(fn, prepare, qs, c, dev) -> tuple[float, float, list]:
    """Prepare the candidates c (one untimed call first: it builds and
    loads the kernels; then one timed), one untimed warm-up call of fn,
    then fn on every query batch against the prepared set: (mean ms per
    batch, the prepare's ms, winner indices per batch)."""
    prepare(c)
    prep_ms, prep = time_ms(lambda: prepare(c), dev)
    fn(qs[0], prep)
    times, winners = [], []
    for q in qs:
        ms, (idx, _err) = time_ms(lambda: fn(q, prep), dev)
        times.append(ms)
        winners.append(idx)
    return float(np.mean(times)), prep_ms, winners


def agreement(a: list, b: list) -> float:
    """Mean over the batches of the share of equal winners."""
    return float(np.mean([(x == y).double().mean().item()
                          for x, y in zip(a, b)]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='nn_prec_bench')
    ap.add_argument('n_c', nargs='?', type=int, default=262144)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    dev = device_from(a.device)
    print(f'device: {device_name(dev)}', flush=True)

    n_c = -(-a.n_c // _BC) * _BC
    n_q = _NQ
    cands = make_features(n_c, 1, dev)
    qs = [make_features(n_q, 10 + r, dev) for r in range(_REPS)]
    flops = 2.0 * n_q * n_c * _D

    res = {'n_q': n_q, 'n_c': n_c, 'device': device_name(dev)}
    winners = {}
    for name, fn, prepare in (
            ('nn1_f32', nk.nearest_1, nk.prepare),
            ('nn1_bf16', nk.nearest_1_bf16, nk.prepare_bf16)):
        ms, prep_ms, winners[name] = run_batches(fn, prepare, qs, cands,
                                                 dev)
        res[f'{name}_ms'] = ms
        res[f'{name}_prepare_ms'] = prep_ms
        res[f'{name}_tflops'] = flops / (ms * 1e-3) / 1e12
        print(f'{name}: {ms:8.2f} ms  {res[f"{name}_tflops"]:6.1f} TF/s  '
              f'(prepare {prep_ms:.3f} ms)', flush=True)
    agree = agreement(winners['nn1_f32'], winners['nn1_bf16'])
    res['agree_f32_bf16'] = agree
    print(f'winner agreement f32 vs bf16: {agree * 100:.4f}%', flush=True)

    # bf16-rounded features on both sides: round once, search exactly in
    # the rounded space (the quality-neutral variant)
    ms, prep_ms, rounded = run_batches(
        nk.nearest_1_bf16, nk.prepare_bf16, [nk.bf16_round(q) for q in qs],
        nk.bf16_round(cands), dev)
    res['nn1_bf16_rounded_ms'] = ms
    res['nn1_bf16_rounded_prepare_ms'] = prep_ms
    print(f'nn1_bf16_rounded: {ms:8.2f} ms  (prepare {prep_ms:.3f} ms)',
          flush=True)
    agree = agreement(winners['nn1_f32'], rounded)
    res['agree_f32_bf16_rounded'] = agree
    print(f'winner agreement f32 vs bf16-rounded: {agree * 100:.4f}%',
          flush=True)
    return res


if __name__ == '__main__':
    main()
