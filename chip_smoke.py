"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

It imports torch, numpy and tiler_tpu_torch only. Phases (each prints one
JSON line; any failure raises and exits non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: both CUDA sources of the 1-NN kernels (tiler_tpu_torch/csrc/
     nn1.cu with K1, its augmented mode K2 and the prepare kernel,
     nn1_bf16.cu with K3 and its prepare kernel) from this checkout, one
     nvcc each, started together, and the package's C++ library (g++);
     ptxas must report no spills;
  3. each kernel vs its plain torch version on the card at the main
     path's shapes (Q=16384 queries, C=262144 candidates, D=192), with
     the tolerance stated per case; kernel, plain version and the
     library call that computes the same product timed with CUDA events
     in turns, also at a keyframe's short last chunks, at one query tile
     per SM and at C=1,048,576; each kernel's bound from these shapes;
  4. the paths, each with the launch counts set to 0 just before it and
     read just after:
     a. the experiment tools (tiler_tpu_torch.tools.nn_prec_bench and
        assign_opt_bench) at their full shapes: K1, K2, K3 and both
        prepare kernels;
     b. the configurations on the 8x120x160 clip (default, Yliluoma +
        VAR, KModes restarts, a 64-colour tile palette, no wavelets, and
        the reload of the tileset the Yliluoma + VAR encode wrote), each
        encoded on the card and on the CPU, whose PSNRs must agree;
     c. the slice: Encoder(device='cuda').run_all on the 1080p 16-frame
        cuts_v2 clip at 128 palettes, once untimed and once timed, with
        K1's launches in the timed run equal to the stage-3 1-NN calls
        and the prepare's equal to the keyframes;
     d. the same clip with Yliluoma + VAR, encoded once;
  5. decode: both 1080p streams through the package's numpy decoder,
     each with PSNR >= 29 dB.
The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}; nothing is printed as a
result without a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

Q, C, D = 16384, 262144, 192
C_BIG = 1 << 20                 # the assign tool's candidates
Q_SHORT = (2000, 9000, 12000)   # a keyframe's last, short query chunk
# NVIDIA's data sheet for the H100 SXM at 700 W: device memory bytes/s and
# dense operations/s, f32 outside the tensor cores and bf16 inside
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
PSNR_FLOOR = 29.0
AGREE_FLOOR = 0.998   # K1/K2 winner agreement: at most 1 in 512 apart


def say(phase: str, **kv) -> None:
    print(json.dumps({'phase': phase, **kv}, default=float), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 7, calls: int = 1) -> float:
    """Median milliseconds of fn() over `runs` timings, CUDA events
    around `calls` calls in a row (more than one for a kernel shorter
    than the host's time to enqueue it, which a single call would time
    instead)."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def build_kernels() -> None:
    """Phase 2: every CUDA source from this checkout, one nvcc each, all
    started together, and the C++ library; prints each kernel's registers
    and spills, and fails on any spill."""
    from tiler_tpu_torch import native
    from tiler_tpu_torch.ops import nn_kernels as nk
    t0 = time.perf_counter()
    libs = nk.build(force=True)
    t_cuda = time.perf_counter() - t0
    native.get_lib()
    ptxas = {}
    for name, so in libs.items():
        with open(so.replace('.so', '.ptxas.txt')) as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if 'registers' in ln or 'spill' in ln]
    say('build', seconds=time.perf_counter() - t0, nvcc_seconds=t_cuda,
        libraries=libs, native=native._SO_PATH, ptxas=ptxas)
    spilled = [ln for lines in ptxas.values() for ln in lines
               if 'spill' in ln and '0 bytes spill stores, 0 bytes spill '
               'loads' not in ln]
    if spilled:
        raise AssertionError(f'ptxas spilled: {spilled}')


def bound(n_q: int, n_c: int, dim: int, peak_ops: float) -> dict:
    """The least time the card could take for a 1-NN of n_q queries among
    n_c candidates of width dim: each input read and each output written
    once over the memory rate, or 2*Q*C*D operations over peak_ops."""
    t_bytes = 4.0 * (n_q * dim + n_c * dim + 2 * n_q) / PEAK_BYTES
    t_ops = 2.0 * n_q * n_c * dim / peak_ops
    return {'bound_ms': 1e3 * max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes > t_ops else 'operations'}


def gemm_f32(q, c, c_chunk: int = 8192):
    """K1's and K2's yardstick: the product q @ c.T alone as f32 matmuls
    (TF32 off) per candidate chunk, without norms or argmin."""
    for cs in range(0, c.shape[0], c_chunk):
        q @ c[cs:cs + c_chunk].T


def turns(fns: dict, runs: int = 7, calls: int = 1) -> dict:
    """Each fn timed twice, in turns (a, b, c, c, b, a); the lower median
    of each and both readings. The one named 'kernel' is timed over
    `calls` calls in a row."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(time_ms(fns[k], runs, calls if k == 'kernel' else 1))
    return {k: {'ms': min(v), 'all': v} for k, v in got.items()}


def check_prepare(card: str) -> dict:
    """Phase 3, the prepare kernel against its plain version: the
    transposed tiles bit for bit always; the norms bit for bit on integer
    features (exact sums) and on normal ones but for the plain version's
    double rounding (at most 2 norms may differ, by one ulp). Timed at
    C x D; its bound is its bytes. Returns its JSON record."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    dev = torch.device('cuda')
    rng = np.random.default_rng(5)
    worst = 0.0
    for n, d, ints in ((5013, 3, True), (20000, 100, True), (C, D, True),
                       (5013, 200, True), (100001, 200, False),
                       (C, D, False)):       # the last one is timed
        x = rng.integers(0, 16, (n, d)).astype(np.float32) if ints else \
            rng.standard_normal((n, d), np.float32)
        c = torch.from_numpy(x).to(dev)
        got, want = nk.prepare(c), nk.nn1_prepare_plain(c)
        torch.cuda.synchronize()
        if not torch.equal(got.ct[:, :-1], want.ct[:, :-1]):
            raise AssertionError(f'nn1_prepare {n}x{d}: tiles differ')
        differ = int((got.ct[:, -1] != want.ct[:, -1]).sum())
        gap = (got.norms() - want.norms()).abs().max().item()
        worst = max(worst, gap)
        if differ > (0 if ints else 2) or \
                gap > 1e-6 * want.norms().max().item():
            raise AssertionError(f'nn1_prepare {n}x{d}: {differ} norms '
                                 f'differ, by up to {gap}')
        say('nn1_prepare_check', candidates=n, dim=d, integers=ints,
            tiles='bit-equal', norms_differ=differ)
    t = turns({'plain': lambda: nk.nn1_prepare_plain(c),
               'kernel': lambda: nk.prepare(c)})
    t_bytes = 4.0 * (C * D + C * (D + 1)) / PEAK_BYTES
    rec = {'name': 'nn1_prepare', 'route': 'cuda',
           'source': 'tiler_tpu_torch/csrc/nn1.cu',
           'replaces': 'tiler_tpu/ops/pallas_kernels.py:50',
           'launches': 0, 'max_abs_err': worst, 'ms': t['kernel']['ms'],
           'plain_ms': t['plain']['ms'], 'bound_ms': 1e3 * t_bytes,
           'bound_by': 'bytes', 'library_ms': None}
    say('nn1_prepare_time', card=card, candidates=C, dim=D, **t)
    return rec


def check_prepare_bf16(card: str) -> dict:
    """Phase 3, the bf16 prepare kernel against its plain version at
    check_prepare's shapes: the tiles' feature bytes (rounded, padded,
    cut into K-chunks and swizzled) equal always, and rows() gives the
    rounded rows back; the norms bit for bit on integer features and on
    normal ones but for the plain version's double rounding (at most 2
    norms may differ, by one ulp). Timed at C x D over 4 launches in a
    row; its bound is its bytes. Returns its JSON record."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    dev = torch.device('cuda')
    rng = np.random.default_rng(5)
    worst = 0.0
    for n, d, ints in ((5013, 3, True), (20000, 100, True), (C, D, True),
                       (5013, 200, True), (100001, 200, False),
                       (C, D, False)):       # the last one is timed
        x = rng.integers(-64, 64, (n, d)).astype(np.float32) if ints else \
            rng.standard_normal((n, d), np.float32)
        c = torch.from_numpy(x).to(dev)
        got, want = nk.prepare_bf16(c), nk.nn1_bf16_prepare_plain(c)
        torch.cuda.synchronize()
        cut = 2 * got.dim_pad * nk._BC_BF16         # a tile's feature bytes
        if got.ct.shape != want.ct.shape or \
                not torch.equal(got.ct[:, :cut], want.ct[:, :cut]) or \
                not torch.equal(got.rows(), nk.bf16_round(c)):
            raise AssertionError(f'nn1_bf16_prepare {n}x{d}: tiles differ')
        differ = int((got.ct[:, cut:] != want.ct[:, cut:])
                     .reshape(-1, 4).any(1).sum())  # padding norms too
        gap = (got.norms() - want.norms()).abs().max().item()
        worst = max(worst, gap)
        if differ > (0 if ints else 2) or \
                gap > 1e-6 * want.norms().max().item():
            raise AssertionError(f'nn1_bf16_prepare {n}x{d}: {differ} norms '
                                 f'differ, by up to {gap}')
        say('nn1_bf16_prepare_check', candidates=n, dim=d, integers=ints,
            tiles='bit-equal', norms_differ=differ)
    t = turns({'plain': lambda: nk.nn1_bf16_prepare_plain(c),
               'kernel': lambda: nk.prepare_bf16(c)}, calls=4)
    t_bytes = (4.0 * C * D + 2.0 * C * got.dim_pad + 4.0 * C) / PEAK_BYTES
    rec = {'name': 'nn1_bf16_prepare', 'route': 'cuda',
           'source': 'tiler_tpu_torch/csrc/nn1_bf16.cu',
           'replaces': 'tiler_tpu/ops/pallas_kernels.py:212',
           'launches': 0, 'max_abs_err': worst, 'ms': t['kernel']['ms'],
           'plain_ms': t['plain']['ms'], 'bound_ms': 1e3 * t_bytes,
           'bound_by': 'bytes', 'library_ms': None}
    say('nn1_bf16_prepare_time', card=card, candidates=C, dim=D, **t)
    return rec


def check_kernel(card: str) -> dict:
    """Phase 3, K1: the checks every kernel gets (check_variant), feature
    widths that fill no slice, and times of kernel, plain version and the
    bare f32 product in turns at a full 16384-query chunk, at a
    keyframe's short last chunks (with the candidate ranges the kernel
    splits each into) and at one query tile per SM, on prepared
    candidates as the encoder calls it. Returns its JSON record (launches
    filled later)."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    rec = check_variant('nn1', nk.nearest_1, nk.nearest_1_plain, (0, 16),
                        1.0, (1e-5, 1e-4), _l2_64)
    rec.update(source='tiler_tpu_torch/csrc/nn1.cu',
               replaces='tiler_tpu/ops/pallas_kernels.py:35')
    dev = torch.device('cuda')
    rng = np.random.default_rng(7)
    for kern, plain, name in (
            (nk.nearest_1, nk.nearest_1_plain, 'nn1'),
            (lambda q, c: nk.nearest_1(q, nk.prepare(c)),
             nk.nearest_1_plain, 'nn1 prepared'),
            (nk.nearest_1_aug, nk.nearest_1_aug_plain, 'nn1_aug')):
        for d in (3, 100, 192):
            _exact(name, kern, plain,
                   torch.from_numpy(rng.integers(0, 16, (999, d))
                                    .astype(np.float32)).to(dev),
                   torch.from_numpy(rng.integers(0, 16, (20000, d))
                                    .astype(np.float32)).to(dev),
                   f'width {d}')
    say('nn1_widths', widths=[3, 100, 192], queries=999, candidates=20000,
        ranges=nk.candidate_ranges(999, 20000, 132)[0])

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    q_sm = nk.full_chunk(dev)
    qf = torch.from_numpy(rng.standard_normal((max(Q, q_sm), D),
                                              np.float32)).to(dev)
    cf = torch.from_numpy(rng.standard_normal((C, D), np.float32)).to(dev)
    prep = nk.prepare(cf)
    rows = []
    for n in (Q,) + Q_SHORT + (q_sm,):
        qs = qf[:n].contiguous()
        t = turns({'plain': lambda: nk.nearest_1_plain(qs, cf),
                   'kernel': lambda: nk.nearest_1(qs, prep),
                   'library': lambda: gemm_f32(qs, cf)})
        rows.append({'queries': n,
                     'ranges': nk.candidate_ranges(n, C, n_sm)[0],
                     'kernel_ms': t['kernel'], 'plain_ms': t['plain'],
                     'library_ms': t['library'],
                     **bound(n, C, D, PEAK_F32)})
    main = rows[0]
    rec.update(ms=main['kernel_ms']['ms'], plain_ms=main['plain_ms']['ms'],
               library_ms=main['library_ms']['ms'],
               bound_ms=main['bound_ms'], bound_by=main['bound_by'])
    say('nn1_time', card=card, candidates=C, dim=D,
        kernel_tflops=2.0 * Q * C * D / (rec['ms'] * 1e-3) / 1e12,
        share_of_bound=rec['bound_ms'] / rec['ms'], rows=rows)
    return rec


def _near_ties_only(q, c, ka, kb, dist, rtol: float = 1e-4) -> int:
    """Where two winners differ, their float64 distances (dist(q, c) of
    the rows involved) agree to rtol. Returns how many differ."""
    import torch
    bad = torch.nonzero(ka != kb)[:, 0]
    if bad.numel():
        da = dist(q[bad], c[ka[bad].long()])
        db = dist(q[bad], c[kb[bad].long()])
        gap = (da - db).abs() / da.abs().maximum(db.abs())
        if bool((gap > rtol).any()):
            raise AssertionError('idx differs beyond a near tie')
    return int(bad.numel())


def _l2_64(a, b):
    return ((a.double() - b.double()) ** 2).sum(1)


def _bf16_l2_64(a, b):
    """The bf16 kernel's distance in float64: f32-row norms, bf16 dot."""
    from tiler_tpu_torch.ops import nn_kernels as nk
    dot = (nk.bf16_round(a).double() * nk.bf16_round(b).double()).sum(1)
    return (a.double() ** 2).sum(1) + (b.double() ** 2).sum(1) - 2 * dot


def _both(kern, plain, q, c):
    import torch
    ki, ke = kern(q, c)
    pi, pe = plain(q, c)
    torch.cuda.synchronize()
    return ki, ke, pi, pe


def _exact(name, kern, plain, q, c, what):
    """Kernel and plain version bit-identical on q, c; returns the
    kernel's (idx, err)."""
    import torch
    ki, ke, pi, pe = _both(kern, plain, q, c)
    if not (torch.equal(ki, pi) and torch.equal(ke, pe)):
        raise AssertionError(f'{name} {what}: kernel != plain '
                             f'({int((ki != pi).sum())} idx differ)')
    return ki, ke


def check_variant(name: str, kern, plain, ints: tuple, normal_std: float,
                  tol: tuple, dist) -> dict:
    """Phase 3, one kernel against its plain version on the card: integer
    features (every dot exact) bit-identical at the main shapes, with
    duplicates resolving to the lowest index (also across the candidate
    ranges of a short query chunk), 1e9 padding that never wins and
    ragged sizes; random normal features within rtol/atol, winners
    different only at near ties. Returns the kernel's JSON record."""
    import torch
    dev = torch.device('cuda')
    rng = np.random.default_rng(11)

    def exact(q, c, what):
        return _exact(name, kern, plain, q, c, what)

    lo, hi = ints
    qn = rng.integers(lo, hi, (Q, D)).astype(np.float32)
    cn = rng.integers(lo, hi, (C, D)).astype(np.float32)
    cn[C // 2:C // 2 + Q // 2] = qn[:Q // 2]       # exact matches
    q, c = torch.from_numpy(qn).to(dev), torch.from_numpy(cn).to(dev)
    ki0, ke0 = exact(q, c, 'integer features')
    cd = cn.copy()
    cd[C - 1000:] = cd[0:1000]
    ki, _ = exact(torch.from_numpy(cd[0:1000].copy()).to(dev),
                  torch.from_numpy(cd).to(dev), 'duplicates')
    if not torch.equal(ki.cpu(), torch.arange(1000, dtype=torch.int32)):
        raise AssertionError(f'{name} duplicated candidates: lowest index '
                             'lost')
    cp = np.concatenate([cn, np.full((4096, D), 1e9, np.float32)])
    ki, ke = exact(q, torch.from_numpy(cp).to(dev), 'padding')
    if not (torch.equal(ki, ki0) and torch.equal(ke, ke0)):
        raise AssertionError(f'{name}: 1e9 padding changed the result')
    exact(q[:1037].contiguous(), c[:5013].contiguous(), 'ragged shapes')
    say(f'{name}_exact', queries=Q, candidates=C, dim=D, ints=[lo, hi],
        duplicates='lowest index', padding='never wins',
        ragged=[1037, 5013])

    qf = torch.from_numpy(rng.normal(0, normal_std, (Q, D))
                          .astype(np.float32)).to(dev)
    cf = torch.from_numpy(rng.normal(0, normal_std, (C, D))
                          .astype(np.float32)).to(dev)
    ki, ke, pi, pe = _both(kern, plain, qf, cf)
    rtol, atol = tol
    torch.testing.assert_close(ke, pe, rtol=rtol, atol=atol)
    differ = _near_ties_only(qf, cf, ki, pi, dist)
    max_abs = float((ke - pe).abs().max())
    say(f'{name}_random', std=normal_std, idx_differ=differ,
        max_abs_err=max_abs, rtol=rtol, atol=atol)
    return {'name': name, 'route': 'cuda', 'launches': 0,
            'max_abs_err': max_abs}


def gemm_bf16(q, c, c_chunk: int = 8192):
    """K3's yardstick: the product of operands already rounded to bf16,
    per candidate chunk, as torch.mm with an f32 result, without norms or
    argmin. It raises where torch.mm takes no out_dtype, so that
    library_ms always times this one call."""
    import torch
    for cs in range(0, c.shape[0], c_chunk):
        torch.mm(q, c[cs:cs + c_chunk].T, out_dtype=torch.float32)


def check_bf16(card: str, rec: dict) -> None:
    """Phase 3, what K3 gets beyond check_variant: the prepared form and
    widths that fill no K-chunk at split candidate ranges, bit equal on
    integer features; kernel (prepared candidates, 4 launches in a row),
    plain version and library call timed in turns at a full 16384-query
    chunk, at a keyframe's short last chunks with the ranges taken, and at
    one query tile per SM; at 1,048,576 candidates held against the plain
    version (err within rtol/atol, winners apart only at near ties in
    the bf16 metric) and timed. Fills rec's times and bound."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    dev = torch.device('cuda')
    rng = np.random.default_rng(17)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def ints(n, d):
        return torch.from_numpy(rng.integers(-64, 64, (n, d))
                                .astype(np.float32)).to(dev)
    for kern, name in (
            (nk.nearest_1_bf16, 'nn1_bf16'),
            (lambda q, c: nk.nearest_1_bf16(q, nk.prepare_bf16(c)),
             'nn1_bf16 prepared')):
        for d in (3, 100, 192):
            _exact(name, kern, nk.nearest_1_bf16_plain, ints(999, d),
                   ints(20000, d), f'width {d}')
    say('nn1_bf16_widths', widths=[3, 100, 192], queries=999,
        candidates=20000,
        ranges=nk.candidate_ranges_bf16(999, 20000, n_sm)[0])
    qi, ci = ints(max(Q_SHORT), D), ints(C, D)
    ci[C // 2:C // 2 + 1000] = qi[:1000]            # exact matches
    pi = nk.prepare_bf16(ci)
    for n in Q_SHORT:
        _exact('nn1_bf16 prepared', lambda q, c: nk.nearest_1_bf16(q, pi),
               nk.nearest_1_bf16_plain, qi[:n].contiguous(), ci,
               f'{n} queries')
    del qi, ci, pi

    q_sm = nk._BQ_BF16 * n_sm
    qf = torch.from_numpy(rng.standard_normal((max(Q, q_sm), D),
                                              np.float32)).to(dev)
    cf = torch.from_numpy(rng.standard_normal((C, D), np.float32)).to(dev)
    cb = cf.to(torch.bfloat16)
    prep = nk.prepare_bf16(cf)
    rows = []
    for n in (Q,) + Q_SHORT + (q_sm,):
        qs = qf[:n].contiguous()
        qb = qs.to(torch.bfloat16)
        t = turns({'plain': lambda: nk.nearest_1_bf16_plain(qs, cf),
                   'kernel': lambda: nk.nearest_1_bf16(qs, prep),
                   'library': lambda: gemm_bf16(qb, cb)}, calls=4)
        b = bound(n, C, D, PEAK_BF16)
        rows.append({'queries': n,
                     'ranges': nk.candidate_ranges_bf16(n, C, n_sm)[0],
                     'kernel_ms': t['kernel'], 'plain_ms': t['plain'],
                     'library_ms': t['library'], **b,
                     'share_of_bound': b['bound_ms'] / t['kernel']['ms']})
    main = rows[0]
    rec.update(ms=main['kernel_ms']['ms'], plain_ms=main['plain_ms']['ms'],
               library_ms=main['library_ms']['ms'],
               bound_ms=main['bound_ms'], bound_by=main['bound_by'])
    say('nn1_bf16_time', card=card, candidates=C, dim=D,
        library_call='torch.mm out_dtype=float32',
        kernel_tflops=2.0 * Q * C * D / (rec['ms'] * 1e-3) / 1e12,
        share_of_bound=rec['bound_ms'] / rec['ms'], rows=rows)
    del cf, cb, prep

    c_big = torch.from_numpy(rng.standard_normal((C_BIG, D), np.float32)
                             ).to(dev)
    qs = qf[:Q].contiguous()
    ki, ke, pi, pe = _both(nk.nearest_1_bf16, nk.nearest_1_bf16_plain, qs,
                           c_big)
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=1e-4)
    differ = _near_ties_only(qs, c_big, ki, pi, _bf16_l2_64)
    p_big, qb, cb = nk.prepare_bf16(c_big), qs.to(torch.bfloat16), \
        c_big.to(torch.bfloat16)
    t = turns({'plain': lambda: nk.nearest_1_bf16_plain(qs, c_big),
               'kernel': lambda: nk.nearest_1_bf16(qs, p_big),
               'library': lambda: gemm_bf16(qb, cb)}, runs=5, calls=2)
    b = bound(Q, C_BIG, D, PEAK_BF16)
    say('nn1_bf16_1m', card=card, queries=Q, candidates=C_BIG,
        idx_differ=differ, max_abs_err=float((ke - pe).abs().max()), **t,
        **b, share_of_bound=b['bound_ms'] / t['kernel']['ms'])


def check_variants(card: str) -> list:
    """Phase 3, K2 and K3: checks, then kernel, plain version and library
    call timed at Q x C x D in turns (K3's in check_bf16); K2 and K1 also
    held against their plain versions (err within rtol/atol, winners
    apart only at near ties) and timed at the assign tool's 1,048,576
    candidates. K2's library call is its plain version (one matmul and an
    argmin per chunk). Returns their JSON records."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    aug = check_variant('nn1_aug', nk.nearest_1_aug, nk.nearest_1_aug_plain,
                        (0, 16), 5.0, (1e-4, 1e-2), _l2_64)
    aug.update(source='tiler_tpu_torch/csrc/nn1.cu',
               replaces='tiler_tpu/ops/pallas_kernels.py:116')
    bf16 = check_variant('nn1_bf16', nk.nearest_1_bf16,
                         nk.nearest_1_bf16_plain, (-64, 64), 1.0,
                         (1e-5, 1e-4), _bf16_l2_64)
    bf16.update(source='tiler_tpu_torch/csrc/nn1_bf16.cu',
                replaces='tiler_tpu/ops/pallas_kernels.py:198')

    rng = np.random.default_rng(13)
    dev = torch.device('cuda')
    qf = torch.from_numpy(rng.standard_normal((Q, D), np.float32)).to(dev)
    cf = torch.from_numpy(rng.standard_normal((C, D), np.float32)).to(dev)
    t = turns({'plain': lambda: nk.nearest_1_aug_plain(qf, cf),
               'kernel': lambda: nk.nearest_1_aug(qf, cf)})
    aug.update(ms=t['kernel']['ms'], plain_ms=t['plain']['ms'],
               library_ms=t['plain']['ms'],
               **bound(Q, C, D + 8, PEAK_F32))
    say('nn1_aug_time', card=card, queries=Q, candidates=C, **t,
        kernel_tflops=2.0 * Q * C * (D + 8) / (aug['ms'] * 1e-3) / 1e12,
        share_of_bound=aug['bound_ms'] / aug['ms'])
    check_bf16(card, bf16)

    c_big = torch.from_numpy(rng.standard_normal((C_BIG, D), np.float32)
                             ).to(dev)
    big = {}
    for name, kern, plain, tol, width, lib in (
            ('nn1_aug', nk.nearest_1_aug, nk.nearest_1_aug_plain,
             (1e-4, 1e-2), D + 8, None),
            ('nn1', nk.nearest_1, nk.nearest_1_plain, (1e-5, 1e-4), D,
             gemm_f32)):
        ki, ke, pi, pe = _both(kern, plain, qf, c_big)
        torch.testing.assert_close(ke, pe, rtol=tol[0], atol=tol[1])
        fns = {'plain': lambda: plain(qf, c_big),
               'kernel': lambda: kern(qf, c_big)}
        if lib is not None:
            fns['library'] = lambda: lib(qf, c_big)
        big[name] = {'idx_differ': _near_ties_only(qf, c_big, ki, pi, _l2_64),
                     'max_abs_err': float((ke - pe).abs().max()),
                     **turns(fns), **bound(Q, C_BIG, width, PEAK_F32)}
    say('nn1_1m', card=card, queries=Q, candidates=C_BIG, **big)
    return [aug, bf16]


def run_tools() -> dict:
    """The path of K2, K3 and K3's prepare: both experiment tools at
    their default (full) shapes, in this process, with the launch counts
    set to 0 before and read after; the assign tool's LUTs bit-equal and
    its K1/K2 and float64 winner agreements at least AGREE_FLOOR."""
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.tools import assign_opt_bench, nn_prec_bench
    nk.LAUNCHES = nk.LAUNCHES_PREP = nk.LAUNCHES_AUG = nk.LAUNCHES_BF16 = 0
    nk.LAUNCHES_BF16_PREP = 0
    prec = nn_prec_bench.main([])
    aob = assign_opt_bench.main([])
    counts = {'nn1': nk.LAUNCHES, 'nn1_prepare': nk.LAUNCHES_PREP,
              'nn1_aug': nk.LAUNCHES_AUG, 'nn1_bf16': nk.LAUNCHES_BF16,
              'nn1_bf16_prepare': nk.LAUNCHES_BF16_PREP}
    say('tools', nn_prec_bench=prec, assign_opt_bench=aob, launches=counts)
    if min(counts.values()) <= 0:
        raise AssertionError(f'a kernel of the tools path never launched: '
                             f'{counts}')
    if not aob['lut_bit_equal']:
        raise AssertionError('assign tool: one-hot LUT != gather LUT')
    # K1 and K2 are both exact f32 1-NN: winners part only at near ties
    low = {k: aob[k] for k in ('agree_f32_aug', 'truth_agree_f32',
                               'truth_agree_aug') if aob[k] < AGREE_FLOOR}
    if low:
        raise AssertionError(f'assign tool: agreement below {AGREE_FLOOR}: '
                             f'{low}')
    return counts


def encode_counted(frames, cfg, phase: str, card: str, **extra):
    """Encode on the card with the launch counts of K1 and of the prepare
    kernel set to 0 just before and read just after; they must equal the
    stage-3 1-NN calls and the keyframes. Prints the run's times, sizes
    and counts as `phase`. Returns (encoder, stream, {kernel: launches})."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    nk.LAUNCHES = nk.LAUNCHES_PREP = 0
    enc, blob, wall = encode(frames, cfg, 'cuda')
    launches, prepares = nk.LAUNCHES, nk.LAUNCHES_PREP
    m = enc.state.metrics
    say(phase, card=card, wall_s=wall, fps=len(frames) / wall,
        step_times=enc.state.step_times, ft_phases=m['ft_phases'],
        dither_phases=m['dither_phases'], gt_phases=m['gt_phases'],
        gtm_bytes=m['gtm_bytes'], n_keyframes=m['n_keyframes'],
        ft_q_changed_frac=m['ft_q_changed_frac'],
        ft_knn_sizes=m['ft_knn_sizes'], ft_pair_dedup=m['ft_pair_dedup'],
        ft_nn_calls=m['ft_nn_calls'],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches, prepare_launches=prepares, **extra)
    if launches <= 0 or launches != m['ft_nn_calls']:
        raise AssertionError(f'{phase}: kernel launches {launches} != '
                             f'stage-3 1-NN calls {m["ft_nn_calls"]}')
    if prepares != m['n_keyframes']:
        raise AssertionError(f'{phase}: {prepares} prepare launches for '
                             f'{m["n_keyframes"]} keyframes')
    return enc, blob, {'nn1': launches, 'nn1_prepare': prepares}


def check_configs() -> None:
    """Path b: each configuration on the small clip, on the card and on
    the CPU; PSNRs within 0.05 dB (the streams may part at float near
    ties). The reload encodes read the tileset that the card's Yliluoma
    + VAR encode wrote."""
    import tempfile

    from tiler_tpu_torch.bitstream.gtm import write_gts
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.ops.stats import psnr
    from tiler_tpu_torch.tools.common import synthetic_clip_v2
    small = synthetic_clip_v2(8, 120, 160)
    base = EncoderConfig(palette_count=16, max_tiles=400)
    with tempfile.TemporaryDirectory() as tmp:
        gts = f'{tmp}/yliluoma_var.gts'
        cases = {
            'default': base,
            'yliluoma_var': dataclasses.replace(
                base, use_thomas_knoll=False, use_dl3=False),
            'kmodes_restarts3': dataclasses.replace(base, kmodes_restarts=3),
            'palette64': dataclasses.replace(base, tile_palette_size=64),
            'no_wavelets': dataclasses.replace(base, use_wavelets=False),
            'reload_gts': dataclasses.replace(base, reload_tileset=gts)}
        for name, cfg in cases.items():
            nk.LAUNCHES = nk.LAUNCHES_PREP = 0
            enc, blob_g, _ = encode(small, cfg, 'cuda')
            launches, prepares = nk.LAUNCHES, nk.LAUNCHES_PREP
            if name == 'yliluoma_var':
                n = int(enc.state.tile_active.sum())
                write_gts(gts, enc.state.tiles_pal[:n],
                          cfg.tile_palette_size)
            _, blob_c, _ = encode(small, cfg, 'cpu')
            p_g = psnr(decode_video(blob_g)[0], small)
            p_c = psnr(decode_video(blob_c)[0], small)
            say(f'small_clip_{name}', psnr_cuda=p_g, psnr_cpu=p_c,
                bytes_cuda=len(blob_g), bytes_cpu=len(blob_c),
                same_stream=blob_g == blob_c, launches=launches,
                prepare_launches=prepares)
            if abs(p_g - p_c) > 0.05:
                raise AssertionError(f'small clip {name}: cuda {p_g} vs '
                                     f'cpu {p_c} dB')
            if launches != enc.state.metrics['ft_nn_calls'] or \
                    prepares != enc.state.metrics['n_keyframes']:
                raise AssertionError(f'small clip {name}: {launches} K1 and '
                                     f'{prepares} prepare launches')


def encode(frames, cfg, device):
    from tiler_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(cfg, device=device)
    t0 = time.perf_counter()
    blob = enc.run_all(frames, fps=24, fast_lzma=True)
    return enc, blob, time.perf_counter() - t0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on a card',
              file=sys.stderr)
        return 1
    import tiler_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.ops.stats import psnr
    from tiler_tpu_torch.tools.common import synthetic_clip_v2

    card = card_line()
    say('env', python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=card,
        tf32=[torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32])

    build_kernels()
    prep = check_prepare(card)
    record = check_kernel(card)
    variants = check_variants(card) + [check_prepare_bf16(card)]

    counts = run_tools()
    for rec in variants:
        rec['launches'] = counts[rec['name']]
    check_configs()

    frames = synthetic_clip_v2(16, 1080, 1920)
    cfg = EncoderConfig(palette_count=128, tile_palette_size=16)
    _, _, warm_s = encode(frames, cfg, 'cuda')
    torch.cuda.reset_peak_memory_stats()
    _, blob, counts = encode_counted(frames, cfg, 'slice', card,
                                     warm_s=warm_s)
    record['launches'], prep['launches'] = counts['nn1'], counts['nn1_prepare']
    decoded, stream = decode_video(blob)
    if decoded.shape != frames.shape:
        raise AssertionError(f'decoded {decoded.shape} != {frames.shape}')
    p = psnr(decoded, frames)
    say('decode', frames=len(decoded), width=stream.width,
        height=stream.height, psnr=p)
    if not p >= PSNR_FLOOR:
        raise AssertionError(f'PSNR {p} dB < {PSNR_FLOOR}')

    cfg_yv = dataclasses.replace(cfg, use_thomas_knoll=False, use_dl3=False)
    _, blob, _ = encode_counted(frames, cfg_yv, 'slice_yliluoma_var', card)
    decoded, _ = decode_video(blob)
    p = psnr(decoded, frames)
    say('decode_yliluoma_var', psnr=p)
    if decoded.shape != frames.shape or not p >= PSNR_FLOOR:
        raise AssertionError(f'Yliluoma + VAR: {decoded.shape}, {p} dB')

    print(json.dumps({'kernels': [record, prep] + variants}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
