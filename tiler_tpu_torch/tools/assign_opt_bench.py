"""On-card A/B for the stage-3 assign variants: the counterpart of
tools/assign_opt_bench.py.

Experiments, in one process:
  1. nn_kernels.nearest_1 (K1: the norms added in the kernel's epilogue)
     against nn_kernels.nearest_1_aug (K2: the norms folded into
     augmented operands, one dot of width D + 8) on PsyV features of
     random tiles. Prints ms per call, TF/s (2*Q*C*192 operations), the
     winner agreement between the two, each one's winner agreement with
     a float64 ground truth on the first 512 queries (a float64 matmul on
     the same device), and the largest err difference there.
  2. Candidate-feature chunk build: the palette lookup by gather (the
     production form, features.pal_tiles_to_cpn) against a one-hot
     matmul lookup, both in torch, with a bit-equality check.

Left out: the JAX tool's sweep over the TPU kernel's candidate block
(bc 2048 and 8192); the CUDA kernels' tiles are fixed.

Usage: python -m tiler_tpu_torch.tools.assign_opt_bench [--quick]
           [--device cuda]
  Q=16384, C=1048576 (--quick: 4096, 262144); experiment 2 at n=262144
  tiles (--quick: 65536). AOB_Q, AOB_C and AOB_N override the sizes;
  AOB_SKIP_NN=1 skips experiment 1. Times come from CUDA events on a
  card (the fastest of 5 calls after a warm-up); with --device cpu the
  plain torch versions run and the host clock times them. --device
  defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import features, nn_kernels as nk
from .common import device_from, device_name, psyv_of_tiles, time_ms

_D = 192


def realistic_features(n: int, seed: int, dev: torch.device):
    """PsyV features of random tiles at the default-config scale (wavelets
    on, no gamma, YUV), drawn as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    chunk = 1 << 17
    tiles = np.concatenate([rng.integers(0, 256, (min(chunk, n - lo), 8, 8,
                                                  3), np.uint8)
                            for lo in range(0, n, chunk)])
    return psyv_of_tiles(tiles, dev)


def best_of(fn, dev, reps: int = 5):
    """(fastest ms of reps calls after a warm-up call, last result)."""
    fn()
    best, out = float('inf'), None
    for _ in range(reps):
        ms, out = time_ms(fn, dev)
        best = min(best, ms)
    return best, out


def f64_truth(q: torch.Tensor, c: torch.Tensor, chunk: int = 1 << 16):
    """Float64 nearest candidate of each query row (first index on ties
    within a chunk, strict `<` across chunks)."""
    q64 = q.double()
    q2 = (q64 ** 2).sum(1)
    best = torch.full((len(q),), float('inf'), dtype=torch.float64,
                      device=q.device)
    besti = torch.zeros(len(q), dtype=torch.int64, device=q.device)
    for lo in range(0, len(c), chunk):
        cc = c[lo:lo + chunk].double()
        d = q2[:, None] + (cc ** 2).sum(1)[None, :] - 2.0 * (q64 @ cc.T)
        v, j = torch.min(d, dim=1)
        take = v < best
        besti = torch.where(take, j + lo, besti)
        best = torch.where(take, v, best)
    return besti


def experiment_nn(dev, n_q: int, n_c: int, res: dict) -> None:
    flops = 2.0 * n_q * n_c * _D
    q = realistic_features(n_q, 1, dev)
    c = realistic_features(n_c, 2, dev)
    t_f32, (i1, e1) = best_of(lambda: nk.nearest_1(q, c), dev)
    print(f'f32 kernel:  {t_f32:8.1f} ms  {flops / t_f32 / 1e9:6.1f} TF/s',
          flush=True)
    t_aug, (i2, e2) = best_of(lambda: nk.nearest_1_aug(q, c), dev)
    print(f'aug kernel:  {t_aug:8.1f} ms  {flops / t_aug / 1e9:6.1f} TF/s',
          flush=True)
    differ = int((i1 != i2).sum())
    agree = 1.0 - differ / n_q
    print(f'winner agreement f32 vs aug: {agree:.6f} ({differ} differ)',
          flush=True)
    m = min(512, n_q)
    truth = f64_truth(q[:m], c)
    a1 = float((i1[:m].long() == truth).double().mean())
    a2 = float((i2[:m].long() == truth).double().mean())
    print(f'vs f64 truth: f32 {a1:.4f}  aug {a2:.4f} (n={m})', flush=True)
    err_diff = float((e2[:m] - e1[:m]).abs().max())
    print(f'err abs diff (aug vs f32): {err_diff:.3f}', flush=True)
    res.update(n_q=n_q, n_c=n_c, nn1_ms=t_f32, nn1_aug_ms=t_aug,
               nn1_tflops=flops / t_f32 / 1e9,
               nn1_aug_tflops=flops / t_aug / 1e9, agree_f32_aug=agree,
               differ_f32_aug=differ, truth_agree_f32=a1,
               truth_agree_aug=a2, err_abs_diff=err_diff)


def experiment_lut(dev, n: int, res: dict) -> None:
    rng = np.random.default_rng(3)
    tp = torch.from_numpy(rng.integers(0, 16, (n, 8, 8), np.uint8)).to(dev)
    pals = torch.from_numpy(rng.integers(0, 256, (n, 16, 3),
                                         np.uint8)).to(dev)

    def cur():
        cpn = features.pal_tiles_to_cpn(tp, pals, None, False)
        return features.psyv_from_cpn(cpn, use_wavelets=True)

    def onehot():
        oh = F.one_hot(tp.reshape(n, 64).long(), 16).to(torch.float32)
        rgb = torch.einsum('nps,nst->npt', oh, pals.to(torch.float32))
        rgb = rgb.reshape(n, 8, 8, 3).to(torch.uint8)
        cpn = features.rgb_tiles_to_cpn(rgb, None, False)
        return features.psyv_from_cpn(cpn, use_wavelets=True)

    t_cur, r_cur = best_of(cur, dev)
    t_oh, r_oh = best_of(onehot, dev)
    same = bool(torch.equal(r_cur, r_oh))
    print(f'cand_feats n={n}: take_along {t_cur:7.1f} ms | '
          f'one-hot {t_oh:7.1f} ms | bit-equal {same}', flush=True)
    res.update(lut_n=n, lut_gather_ms=t_cur, lut_onehot_ms=t_oh,
               lut_bit_equal=same)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog='assign_opt_bench')
    ap.add_argument('--quick', action='store_true')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    dev = device_from(a.device)
    print(f'device: {device_name(dev)}', flush=True)
    n_q = int(os.environ.get('AOB_Q', 4096 if a.quick else 16384))
    n_c = int(os.environ.get('AOB_C', (1 << 18) if a.quick else (1 << 20)))
    n = int(os.environ.get('AOB_N', (1 << 16) if a.quick else (1 << 18)))
    print(f'shapes: Q={n_q} C={n_c} D={_D}', flush=True)
    res = {'device': device_name(dev)}
    if os.environ.get('AOB_SKIP_NN') != '1':
        experiment_nn(dev, n_q, n_c, res)
    experiment_lut(dev, n, res)
    return res


if __name__ == '__main__':
    main()
