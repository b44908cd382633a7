"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

It imports torch, numpy, tiler_tpu_torch and, for phase 4k, the
benchmark's clip generator, probes and plain references (gtmbench).
Phases (each prints one JSON line; any failure raises and exits
non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: the CUDA sources (tiler_tpu_torch/csrc/nn1.cu with K1, its
     augmented mode K2 and the prepare kernel, nn1_bf16.cu with K3 and
     its prepare kernel, kmeans_pp.cu with the k-means++ seeding) from
     this checkout, one nvcc each, started together, and the package's
     C++ library (g++); ptxas must report no spills;
  3. each kernel vs its plain torch version on the card at the main
     path's shapes (Q=16384 queries, C=262144 candidates, D=192), with
     the tolerance stated per case; kernel, plain version and the
     library call that computes the same product timed with CUDA events
     in turns, also at a keyframe's short last chunks, at one query tile
     per SM and at C=1,048,576; each kernel's bound from these shapes;
  4. the paths, each with the launch counts set to 0 just before it and
     read just after:
     a. the experiment tools (tiler_tpu_torch.tools.nn_prec_bench,
        assign_opt_bench and stage3_precision) at their full shapes: K1,
        K2, K3 and both prepare kernels; stage3_precision encodes the
        1080p slice (below) with stage 3 through K1 and through K3 and
        prints PSNR, bytes and winner agreement of both;
     b. the configurations on the 8x120x160 clip (default, Yliluoma +
        VAR, KModes restarts, a 64-colour tile palette, no wavelets, the
        reload of the tileset the Yliluoma + VAR encode wrote, and every
        EncoderConfig field of tests/test_torch_configs_fields.py) and
        the edge-case clips of tests/test_edge_cases.py, each encoded on
        the card and on the CPU: the same bytes, or PSNRs within 0.05 dB
        for a case whose streams part at a recorded near tie;
     c. the slice: Encoder(device='cuda').run_all on the 1080p 16-frame
        cuts_v2 clip at 128 palettes, once untimed and once timed, with
        K1's launches in the timed run equal to the stage-3 1-NN calls
        and the prepare's equal to the keyframes; the two streams and the
        stage-3 tool's K1 stream byte-identical; then run_all with
        profile_dir on the small clip writes a trace holding every step
        and each K1 launch;
     d. the same clip with Yliluoma + VAR, encoded once;
     e. the other entry points on that clip (3 GOPs): encode_streaming
        and encode_gop_sharded(n_hosts=1) write the same bytes, with K1's
        launches equal to the GOPs' stage-3 calls and one prepare a GOP,
        and the peak device memory beside the batch encode's; a
        checkpoint after GlobalTiling, loaded again, resumes at
        FrameTiling to the uninterrupted run's bytes; both torch
        renderers decode the 1080p stream to the numpy decoder's frames;
        render.reconstruction_psnr equals the decoded stream's PSNR; the
        CLI in child processes on the small clip: an injected crash
        (exit 13) and its resumed rerun, info, transcode and
        encode --stream;
     f. the multi-device encoder on that clip, each phase under its own
        time limit: encode_gop_sharded_exact at 3 hosts (threads sharing
        the card; 1 host as its baseline) and Encoder(mesh=['cuda:0'] *
        4).run_all with and without mesh_kmodes all write the batch
        encode's bytes, K1 and its prepare launched as often as in the
        batch encode, the mesh's K1 calls split over its 4 shards;
        wall, peak device memory and mesh_sharded_wall beside the batch
        encode's; then the CLI on the small clip: --distributed in two child processes on the card
        (gloo on a free localhost port) writes the one-device CLI's
        bytes, and --devices 2 exits naming the one device there is;
     g. the measurement entry points, under a time limit of their own:
        python -m tiler_tpu_torch.bench as a child at the 320x240 size
        with 3 timed runs, its CPU baseline child and its continuity
        entry (the metric's name, 3 runs, a measured vs_baseline, one
        stream over the runs, K1 launched once per stage-3 call), and
        tiler_tpu_torch.tools.decode_bench on decoders/web/sample.gtm and
        on the 1080p slice stream on the card;
     h. the compile-check entry points (tiler_tpu_torch.graft_entry), under a
        time limit of their own: entry('cuda')'s forward step (PsyV
        features of 256 tiles, a 1-NN over 512 candidates) launches K1
        and its prepare once each and agrees with the plain 1-NN on the
        card and with the step on the CPU; dryrun_multichip(8) on 8
        logical shards of cuda:0 writes the 1-device card stream, K1
        launched once per stage-3 call of each encode (the mesh's split
        over its 8 shards) and the prepare once per keyframe; its stream
        beside the CPU port's;
     i. the round-trip counter (tiler_tpu_torch.utils.dispatch), right
        after path c: what torch.cuda.set_sync_debug_mode('warn') flags
        for one call of each kind of operation, then the slice encoded
        once under that check, the flagged syncs split per step beside
        the step's noted h2d/d2h/sync/kernel counts with their top
        file:line locations; a step with more flagged syncs than noted
        h2d + d2h + sync fails (the check flags uploads too), as do
        other bytes than path c's or other launches than K1 22 and its
        prepare 3 and the seeding 381; then the small clip on the CPU and
        on the card, the same noted counts per step;
     j. the k-means++ seeding kernel (csrc/kmeans_pp.cu), before path c:
        the slice's keyframe features captured from one encode of it
        (127 launches a keyframe, all in Dither); at those shapes, at
        N=16,384, at k=2, at an N no multiple of the kernel's block and
        at one below a block, the drawn indices and centroids equal to
        the plain version's on the card, or, at most once, the first
        index that differs a float64 near tie between two rows far from
        every centroid drawn before; k-1 launches a seeding; one seeding
        noting one upload and no wait; a draw timed beside its bound, the
        plain version and a GEMV over the same rows; the kernel's record
        joins the kernels' line, with its launches on every driven path;
     k. FT quality SLOW at full size: the benchmark cell
        ft_slow.cuts1080's clip (16 x 1080 x 1920) encoded with
        gtm_ft_slow through run_all; every keyframe's FrameTiling marks
        and candidate list equal to gtmbench/reference/frame_tiling.py's
        exactly and holding its MEDIUM marks, K1's winners for every
        changed cell of keyframe 0 within 3e-5 of the float64 best
        (gtmbench/reference/nn.py), the stream decoding to the clip;
        then two planted faults (SLOW marked as MEDIUM, the 8-NN's
        consecutive-equal skip dropped), each of which must fail that
        comparison;
  5. decode: both 1080p streams through the package's numpy decoder,
     each with PSNR >= 29 dB.
Then the script's total wall. The last three lines are the kernels'
JSON record, the card's name and power limit, and {"ok": true,
"device": {...}}; nothing is printed as a result without a CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
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
# the source tiles of the bench's TILER_BENCH_SMALL clip (16 x 240 x 320
# RGB bytes), which every encode holds on the card until it is released
BENCH_SMALL_CLIP_BYTES = 16 * 240 * 320 * 3


def say(phase: str, **kv) -> None:
    print(json.dumps({'phase': phase, **kv}, default=float), flush=True)


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
    C x D in turns with its plain version and the one library call that
    gives the norms, torch.linalg.vecdot(c, c) (which writes no k-major
    copy); its bound is its bytes. Returns its JSON record."""
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
               'kernel': lambda: nk.prepare(c),
               'library': lambda: torch.linalg.vecdot(c, c)})
    t_bytes = 4.0 * (C * D + C * (D + 1)) / PEAK_BYTES
    rec = {'name': 'nn1_prepare', 'route': 'cuda',
           'source': 'tiler_tpu_torch/csrc/nn1.cu',
           'replaces': 'tiler_tpu/ops/pallas_kernels.py:50',
           'launches': 0, 'max_abs_err': worst, 'ms': t['kernel']['ms'],
           'plain_ms': t['plain']['ms'], 'bound_ms': 1e3 * t_bytes,
           'bound_by': 'bytes', 'library_ms': t['library']['ms']}
    say('nn1_prepare_time', card=card, candidates=C, dim=D, **t)
    return rec


def check_prepare_bf16(card: str) -> dict:
    """Phase 3, the bf16 prepare kernel against its plain version at
    check_prepare's shapes: the tiles' feature bytes (rounded, padded,
    cut into K-chunks and swizzled) equal always, and rows() gives the
    rounded rows back; the norms bit for bit on integer features and on
    normal ones but for the plain version's double rounding (at most 2
    norms may differ, by one ulp). Timed at C x D over 4 launches in a
    row, in turns with its plain version and with
    torch.linalg.vecdot(c, c), the norms alone (no rounded, swizzled
    copy); its bound is its bytes. Returns its JSON record."""
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
               'kernel': lambda: nk.prepare_bf16(c),
               'library': lambda: torch.linalg.vecdot(c, c)}, calls=4)
    t_bytes = (4.0 * C * D + 2.0 * C * got.dim_pad + 4.0 * C) / PEAK_BYTES
    rec = {'name': 'nn1_bf16_prepare', 'route': 'cuda',
           'source': 'tiler_tpu_torch/csrc/nn1_bf16.cu',
           'replaces': 'tiler_tpu/ops/pallas_kernels.py:212',
           'launches': 0, 'max_abs_err': worst, 'ms': t['kernel']['ms'],
           'plain_ms': t['plain']['ms'], 'bound_ms': 1e3 * t_bytes,
           'bound_by': 'bytes', 'library_ms': t['library']['ms']}
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


# A near tie where the kernel's and the plain version's draws part: both
# rows' f32 D^2 within this share of their float64 value (the bound of the
# cancellation in |x|^2 + |c|^2 - 2 x.c over D^2), and at most one such
# draw over all of phase j's shapes.
KPP_TIE_REL, KPP_TIES = 1e-3, 1


def _kpp_near_tie(x, x2, sched, idx_a, idx_b) -> dict:
    """Where two seedings of the same rows under the same schedule first
    draw differently: the draw, the two rows, and the float64 gap between
    their scores there (the f32 gumbel of each row plus log of its D^2 to
    the centroids both drew before, in float64) beside the bound of f32
    rounding on each score (D^2 formed by cancellation from |x|^2 + |c|^2,
    and the logs' own rounding). A near tie only where both rows' D^2 is
    far above the cancellation's error (its share at most KPP_TIE_REL)
    and the gap within the bound: a row at or near a centroid already
    drawn never is one."""
    import torch

    from tiler_tpu_torch.ops import prng
    i = int(np.flatnonzero(idx_a != idx_b)[0])
    a, b = int(idx_a[i]), int(idx_b[i])
    rows = torch.tensor([a, b], device=x.device)
    x64 = x.index_select(0, rows).double()
    c64 = x.index_select(0, torch.as_tensor(idx_a[:i], device=x.device)
                         ).double()
    d2 = torch.cdist(x64, c64).square().min(dim=1).values.cpu().numpy()
    g = prng.gumbel((sched[i, 0], sched[i, 1]), x.shape[0], x.device)
    g = g.index_select(0, rows).double().cpu().numpy()
    log_d2 = np.log(np.maximum(d2, 1e-30))
    score = g + log_d2
    eps = float(np.finfo(np.float32).eps)
    big = x2.index_select(0, rows).double().cpu().numpy() + float(
        (c64 * c64).sum(dim=1).max())
    cancel = np.where(d2 > 0, 64 * eps * big / np.where(d2 > 0, d2, 1),
                      np.inf)
    bound = float((cancel + 4 * eps * (np.abs(g) + np.abs(log_d2))).sum())
    gap = abs(float(score[0] - score[1]))
    return {'draw': i, 'rows': [a, b], 'd2': d2.tolist(),
            'cancel_share': cancel.tolist(), 'gap': gap, 'bound': bound,
            'near_tie': bool((cancel <= KPP_TIE_REL).all() and gap <= bound)}


def capture_keyframe_features(card: str, frames, cfg) -> list:
    """The feature rows of each keyframe's seeding, captured from one
    encode of the clip on the card, which must launch the seeding kernel
    palette_count - 1 times a keyframe, all in Dither."""
    from tiler_tpu_torch.pipeline import dither_step
    feats, orig = [], dither_step.kmeans_core

    def grab(x, k, *a, **kw):
        feats.append(x.detach().clone())
        return orig(x, k, *a, **kw)
    dither_step.kmeans_core = grab
    _counts_zero()
    try:
        enc, _, wall = encode(frames, cfg, 'cuda')
    finally:
        dither_step.kmeans_core = orig
    m = enc.state.metrics
    got = _counts()['kmeans_pp']
    want = _seeding_launches(m, cfg)
    say('kmeans_pp_encode', card=card, wall_s=wall, keyframes=len(feats),
        rows=[f.shape[0] for f in feats], launches=got,
        dither_dispatches=m['dispatches']['dither'],
        dither_phases=m['dither_phases'])
    if len(feats) != m['n_keyframes'] or got != want or \
            m['dispatches']['dither']['kernel'] != want:
        raise AssertionError(f'slice: {got} seeding launches, '
                             f'{m["dispatches"]["dither"]["kernel"]} in '
                             f'Dither, for {want} draws')
    return feats


def kmeans_pp_cases(feats, k: int) -> list:
    """Phase j's shapes, (name, rows, k): each captured keyframe at k, its
    first 16,384 rows (parallel.sharded_kmeans), k=2, an N that is no
    multiple of the kernel's 256-row blocks and one below a block."""
    cases = [(f'keyframe{i}', f, k) for i, f in enumerate(feats)]
    return cases + [('sharded_16384', feats[0][:16384], k),
                    ('k2', feats[0], 2), ('n1000', feats[1][:1000], k),
                    ('n100', feats[-1][:100], 16)]


def compare_kmeans_pp(card: str, cases) -> dict:
    """The seeding kernel against its plain version on the card at each
    case: the drawn indices and centroids equal, k-1 launches a seeding.
    Where the indices part, the centroids before the first index that
    differs must be equal and that index a near tie (_kpp_near_tie), at
    most KPP_TIES times over all cases. Returns {case: record}; raises
    on the first case that fails."""
    import torch

    from tiler_tpu_torch.ops import kmeans, prng
    key = prng.prng_key(kmeans._SEED)
    out, ties = {}, 0
    for name, x, k in cases:
        x = x.contiguous()
        x2 = torch.sum(x * x, dim=1)
        sched = torch.tensor(kmeans.key_schedule(key, x.shape[0], k),
                             dtype=torch.int64, device=x.device)
        before = _counts()['kmeans_pp']
        ck, ik = kmeans.plus_plus(x, x2, sched)
        launches = _counts()['kmeans_pp'] - before
        cp, ip = kmeans.plus_plus_plain(x, x2, sched)
        ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
        rec = {'n': x.shape[0], 'k': k, 'launches': launches,
               'same_idx': bool((ik == ip).all()),
               'same_cents': bool(torch.equal(ck, cp))}
        upto = k
        if not rec['same_idx']:
            tie = rec['first_diff'] = _kpp_near_tie(x, x2, sched, ik, ip)
            upto = tie['draw']
            rec['same_cents_before'] = bool(
                torch.equal(ck[:upto], cp[:upto]))
            ties += 1
        rec['max_abs_err'] = float((ck[:upto] - cp[:upto]).abs().max())
        say('kmeans_pp_case', card=card, case=name, **rec)
        out[name] = rec
        if launches != k - 1:
            raise AssertionError(f'kmeans_pp {name}: {launches} launches '
                                 f'for {k - 1} draws')
        if rec['same_idx'] and not rec['same_cents']:
            raise AssertionError(f'kmeans_pp {name}: the same rows drawn, '
                                 f'other centroids')
        if not rec['same_idx'] and not (rec['first_diff']['near_tie'] and
                                        rec['same_cents_before']):
            raise AssertionError(f'kmeans_pp {name}: the draws part at no '
                                 f'near tie: {rec["first_diff"]}')
        if ties > KPP_TIES:
            raise AssertionError(f'kmeans_pp {name}: {ties} near ties, '
                                 f'more than {KPP_TIES}')
    return out


def check_kmeans_pp(card: str, frames, cfg) -> dict:
    """Phase j, the k-means++ seeding kernel (csrc/kmeans_pp.cu): the
    slice's keyframe features captured from one encode of it, the kernel
    held to its plain version at kmeans_pp_cases' shapes
    (compare_kmeans_pp). One seeding through _plus_plus_init: one noted
    upload, no download or wait, the runtime's sync check flagging at
    most that upload. The time of a draw beside its bound (the rows,
    their norms and D^2 read, D^2 written, over the memory rate), the
    plain version's and a GEMV's over the same rows. Returns the kernel's
    JSON record."""
    import torch

    from tiler_tpu_torch.ops import kmeans, prng
    from tiler_tpu_torch.utils import dispatch

    feats = capture_keyframe_features(card, frames, cfg)
    cases = compare_kmeans_pp(card, kmeans_pp_cases(feats,
                                                    cfg.palette_count))
    key = prng.prng_key(kmeans._SEED)
    x = feats[0].contiguous()
    n, k = x.shape[0], cfg.palette_count
    x2 = torch.sum(x * x, dim=1)
    before = dispatch.snapshot()
    got = {}

    def seed(rec):
        got['cents'] = kmeans._plus_plus_init(x, x2, k, key)
    flagged = _flagged(seed)
    noted = dispatch.delta(before)
    sched = torch.tensor(kmeans.key_schedule(key, n, k), dtype=torch.int64,
                         device=x.device)
    c = x[0].clone()
    times = turns({'kernel': lambda: kmeans.plus_plus(x, x2, sched),
                   'plain': lambda: kmeans.plus_plus_plain(x, x2, sched),
                   'library': lambda: torch.mv(x, c)}, runs=5)
    draw_bytes = 4.0 * n * (x.shape[1] + 3)
    ties = [r['first_diff'] for r in cases.values() if 'first_diff' in r]
    rec = {'name': 'kmeans_pp', 'route': 'cuda',
           'source': 'tiler_tpu_torch/csrc/kmeans_pp.cu', 'replaces': 'none',
           'launches': 0,
           'max_abs_err': max(r['max_abs_err'] for r in cases.values()),
           'ms': times['kernel']['ms'] / (k - 1),
           'plain_ms': times['plain']['ms'] / (k - 1),
           'bound_ms': 1e3 * draw_bytes / PEAK_BYTES, 'bound_by': 'bytes',
           'library_ms': times['library']['ms'], 'per': 'draw', 'rows': n,
           'ms_per_seeding': times['kernel']['ms'],
           'near_ties': len(ties),
           'widest_gap': max([t['gap'] for t in ties], default=0.0)}
    say('kmeans_pp', card=card, noted=noted, flagged_syncs=len(flagged),
        flagged_at=[_where(w) for w in flagged],
        share_of_bound=rec['bound_ms'] / rec['ms'],
        timings={name: t['all'] for name, t in times.items()}, **rec)
    if (noted['h2d'], noted['d2h'], noted['sync'], noted['kernel']) != \
            (1, 0, 0, k - 1) or len(flagged) > 1:
        raise AssertionError(f'the seeding waited: noted {noted}, flagged '
                             f'{[_where(w) for w in flagged]}')
    return rec


def run_tools(card: str) -> tuple[dict, dict]:
    """The path of K2, K3 and K3's prepare: the three experiment tools at
    their default (full) shapes, in this process, with the launch counts
    set to 0 before and read after; the assign tool's LUTs bit-equal and
    its K1/K2 and float64 winner agreements at least AGREE_FLOOR; the
    stage-3 precision tool's K1 encode through K1 alone and its K3 encode
    through K3 alone, once per stage-3 call, its line printed as it is.
    Returns the counts and that tool's result."""
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.tools import (assign_opt_bench, nn_prec_bench,
                                       stage3_precision)
    nk.LAUNCHES = nk.LAUNCHES_PREP = nk.LAUNCHES_AUG = nk.LAUNCHES_BF16 = 0
    nk.LAUNCHES_BF16_PREP = 0
    prec = nn_prec_bench.main([])
    aob = assign_opt_bench.main([])
    s3 = stage3_precision.main([])
    counts = {'nn1': nk.LAUNCHES, 'nn1_prepare': nk.LAUNCHES_PREP,
              'nn1_aug': nk.LAUNCHES_AUG, 'nn1_bf16': nk.LAUNCHES_BF16,
              'nn1_bf16_prepare': nk.LAUNCHES_BF16_PREP}
    say('tools', card=card, nn_prec_bench=prec, assign_opt_bench=aob,
        launches=counts)
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
    for route, used, unused in (('k1', 'nn1', 'nn1_bf16'),
                                ('k3', 'nn1_bf16', 'nn1')):
        got = s3[route]['launches']
        if got[used] != s3[route]['ft_nn_calls'] or got[unused] != 0:
            raise AssertionError(f'stage3_precision {route}: launches {got} '
                                 f'for {s3[route]["ft_nn_calls"]} calls')
    return counts, s3


def encode_counted(frames, cfg, phase: str, card: str, **extra):
    """Encode on the card with the launch counts of K1, of the prepare
    kernel and of the seeding kernel set to 0 just before and read just
    after; they must equal the stage-3 1-NN calls, the keyframes and the
    seeding's draws. Prints the run's times, sizes and counts as `phase`.
    Returns (encoder, stream, _counts())."""
    import torch

    _counts_zero()
    enc, blob, wall = encode(frames, cfg, 'cuda')
    counts = _counts()
    launches, prepares = counts['nn1'], counts['nn1_prepare']
    m = enc.state.metrics
    say(phase, card=card, wall_s=wall, fps=len(frames) / wall,
        step_times=enc.state.step_times, ft_phases=m['ft_phases'],
        dither_phases=m['dither_phases'], gt_phases=m['gt_phases'],
        gtm_bytes=m['gtm_bytes'], n_keyframes=m['n_keyframes'],
        ft_q_changed_frac=m['ft_q_changed_frac'],
        ft_knn_sizes=m['ft_knn_sizes'], ft_pair_dedup=m['ft_pair_dedup'],
        ft_nn_calls=m['ft_nn_calls'],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches, prepare_launches=prepares,
        seeding_launches=counts['kmeans_pp'], **extra)
    if launches <= 0 or launches != m['ft_nn_calls']:
        raise AssertionError(f'{phase}: kernel launches {launches} != '
                             f'stage-3 1-NN calls {m["ft_nn_calls"]}')
    if prepares != m['n_keyframes']:
        raise AssertionError(f'{phase}: {prepares} prepare launches for '
                             f'{m["n_keyframes"]} keyframes')
    if counts['kmeans_pp'] != _seeding_launches(m, cfg) or \
            m['dispatches']['dither']['kernel'] != counts['kmeans_pp']:
        raise AssertionError(f'{phase}: {counts["kmeans_pp"]} seeding '
                             f'launches for {m["n_keyframes"]} keyframes')
    return enc, blob, counts


# Path b beyond the six configurations: every EncoderConfig field that
# tests/test_torch_configs_fields.py holds against the JAX package, as
# fields over the small clip's base config ...
FIELD_CASES = {
    'ft_quality_slow': dict(ft_quality=2),             # FTQuality.SLOW
    'ft_gamma': dict(ft_gamma=True),
    'ft_palette_tol_0.3': dict(ft_palette_tol=0.3),
    'dithering_gamma': dict(dithering_gamma=True),
    'dl3_bpc_6': dict(dl3_bpc=6),
    'dl3_bin_cap_256': dict(dl3_bin_cap=256),
    'dl3_bpc_6_bin_cap_256': dict(dl3_bpc=6, dl3_bin_cap=256),
    'yliluoma_mix_8': dict(yliluoma_mix=8, use_thomas_knoll=False),
    'encoder_gamma_2.2_visual_gamma_1': dict(
        encoder_gamma=2.2, visual_gamma=1.0, dithering_gamma=True,
        ft_gamma=True),
    'smoothing_strength_0': dict(smoothing_strength=0.0),
    'smoothing_strength_0.2': dict(smoothing_strength=0.2),
    'qb_tiles_1_max_tiles_0': dict(qb_tiles=1.0, max_tiles=0),
    'lzma_mode_lc8': dict(lzma_mode='lc8'),
    'lzma_mode_lc3': dict(lzma_mode='lc3'),
    'lzma_mode_best': dict(lzma_mode='best')}
# the field cases that neither Load nor Dither reads: each device resumes
# them from its own state after the base config's Dither, as that test
# does, so that the dither runs once per device
AFTER_DITHER = {'ft_quality_slow', 'ft_gamma', 'ft_palette_tol_0.3',
                'smoothing_strength_0', 'smoothing_strength_0.2',
                'qb_tiles_1_max_tiles_0', 'lzma_mode_lc8', 'lzma_mode_lc3',
                'lzma_mode_best'}
_SMALL = dict(palette_count=2, tile_palette_size=4)
# ... and the clips of tests/test_edge_cases.py (shape, value bound, config)
EDGE_CLIPS = {
    'edge_single_frame': ((1, 16, 16, 3), 256, _SMALL),
    'edge_single_tile': ((2, 8, 8, 3), 256, _SMALL),
    'edge_crop_21x13': ((2, 13, 21, 3), 256, _SMALL),
    'edge_grayscale': ((2, 16, 16, 1), 256, _SMALL),
    'edge_palette_count_256': ((2, 32, 48, 3), 255, dict(
        palette_count=256, tile_palette_size=4, max_tiles=20)),
    'edge_tile_palette_size_64': ((2, 32, 48, 3), 255, dict(
        palette_count=4, tile_palette_size=64, max_tiles=20))}
# the cases whose card and CPU streams part at a FrameTiling near tie (K1
# and its plain version sum in different orders; on an H100 these part by
# 0.0003-0.0006 dB): PSNRs within 0.05 dB; every other case writes the
# same bytes on both
NEAR_TIES = {'yliluoma_var', 'ft_palette_tol_0.3', 'dl3_bpc_6',
             'dl3_bpc_6_bin_cap_256'}


def check_configs() -> None:
    """Path b: each configuration on the small clip, and each edge-case
    clip, encoded on the card and on the CPU: the same bytes, or for a
    case of NEAR_TIES PSNRs within 0.05 dB; K1 launched once per stage-3
    call and its prepare once per keyframe. The reload encodes read the
    tileset that the card's Yliluoma + VAR encode wrote; the cases of
    AFTER_DITHER resume from a checkpoint after Dither."""
    import tempfile

    from tiler_tpu_torch.bitstream.gtm import write_gts
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.ops.stats import psnr
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.tools.common import synthetic_clip_v2
    from tiler_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    small = synthetic_clip_v2(8, 120, 160)
    base = EncoderConfig(palette_count=16, max_tiles=400)
    with tempfile.TemporaryDirectory() as tmp:
        dithered = {}
        for dev in ('cuda', 'cpu'):
            enc = Encoder(dataclasses.replace(base, end_step='dither'),
                          device=dev)
            enc.run_all(small, fps=24)
            dithered[dev] = os.path.join(tmp, f'dither_{dev}')
            save_checkpoint(dithered[dev], enc.state)

        def run(name, clip, cfg, dev, fast):
            if name not in AFTER_DITHER:
                return encode(clip, cfg, dev, fast)[:2]
            cfg = dataclasses.replace(cfg, start_step='make_unique')
            enc = Encoder(cfg, device=dev)
            enc.state = load_checkpoint(dithered[dev], dev)
            enc.state.config = cfg
            return enc, enc.run_all(enc.state.frames_rgb, fps=24,
                                    fast_lzma=fast)
        gts = f'{tmp}/yliluoma_var.gts'
        cases = {
            'default': base,
            'yliluoma_var': dataclasses.replace(
                base, use_thomas_knoll=False, use_dl3=False),
            'kmodes_restarts3': dataclasses.replace(base, kmodes_restarts=3),
            'palette64': dataclasses.replace(base, tile_palette_size=64),
            'no_wavelets': dataclasses.replace(base, use_wavelets=False),
            'reload_gts': dataclasses.replace(base, reload_tileset=gts)}
        cases = {n: (small, c, True) for n, c in cases.items()}
        for name, kw in FIELD_CASES.items():
            cases[name] = (small, dataclasses.replace(base, **kw),
                           not name.startswith('lzma_mode'))
        for name, (shape, hi, kw) in EDGE_CLIPS.items():
            clip = np.random.default_rng(42381337).integers(0, hi, shape)
            clip = np.repeat(clip, 3 // shape[3], axis=3).astype(np.uint8)
            cases[name] = (clip, EncoderConfig(**kw), True)
        for name, (clip, cfg, fast) in cases.items():
            t0 = time.perf_counter()
            nk.LAUNCHES = nk.LAUNCHES_PREP = 0
            enc, blob_g = run(name, clip, cfg, 'cuda', fast)
            launches, prepares = nk.LAUNCHES, nk.LAUNCHES_PREP
            if name == 'yliluoma_var':
                n = int(enc.state.tile_active.sum())
                write_gts(gts, enc.state.tiles_pal[:n],
                          cfg.tile_palette_size)
            _, blob_c = run(name, clip, cfg, 'cpu', fast)
            # the tilemap drops what lies beyond the last whole tile
            dec_g, dec_c = decode_video(blob_g)[0], decode_video(blob_c)[0]
            seen = clip[:, :dec_g.shape[1], :dec_g.shape[2]]
            p_g, p_c = psnr(dec_g, seen), psnr(dec_c, seen)
            say(f'small_clip_{name}', psnr_cuda=p_g, psnr_cpu=p_c,
                bytes_cuda=len(blob_g), bytes_cpu=len(blob_c),
                same_stream=blob_g == blob_c, launches=launches,
                prepare_launches=prepares,
                seconds=time.perf_counter() - t0)
            if blob_g != blob_c and (name not in NEAR_TIES
                                     or abs(p_g - p_c) > 0.05):
                raise AssertionError(f'small clip {name}: cuda {len(blob_g)} '
                                     f'B, {p_g} dB vs cpu {len(blob_c)} B, '
                                     f'{p_c} dB')
            if launches != enc.state.metrics['ft_nn_calls'] or \
                    prepares != enc.state.metrics['n_keyframes']:
                raise AssertionError(f'small clip {name}: {launches} K1 and '
                                     f'{prepares} prepare launches')


def check_profiled(card: str) -> None:
    """Path c, Encoder.run_all(profile_dir=) on the card, on the small
    clip: one Chrome trace appears in the directory, with the annotation
    of every step and the card's kernels, K1 among them."""
    import glob

    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.constants import ENCODER_STEPS
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.tools.common import synthetic_clip_v2
    enc = Encoder(EncoderConfig(palette_count=16, max_tiles=400),
                  device='cuda')
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        enc.run_all(synthetic_clip_v2(8, 120, 160), fps=24, fast_lzma=True,
                    profile_dir=tmp)
        wall = time.perf_counter() - t0
        files = glob.glob(os.path.join(tmp, '*.pt.trace.json'))
        size = [os.path.getsize(f) for f in files]
        events = []
        if files:
            with open(files[0]) as fh:
                events = json.load(fh)['traceEvents']
    steps = sorted({e['name'][5:] for e in events
                    if e.get('cat') == 'user_annotation'
                    and e['name'].startswith('step:')})
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    k1 = sum('nn1_kernel' in n for n in kernels)
    say('profiled', card=card, wall_s=wall, trace_files=len(files),
        trace_bytes=size, steps=steps, kernels=len(kernels), nn1_kernels=k1,
        ft_nn_calls=enc.state.metrics['ft_nn_calls'])
    if len(files) != 1 or set(steps) != set(ENCODER_STEPS) or \
            k1 != enc.state.metrics['ft_nn_calls']:
        raise AssertionError(f'profiled encode: {len(files)} trace files, '
                             f'steps {steps}, {k1} K1 kernels')


# the message of torch.cuda.set_sync_debug_mode('warn')'s warnings
SYNC_WARNING = 'called a synchronizing CUDA operation'


def _flagged(fn) -> list:
    """fn() under torch.cuda.set_sync_debug_mode('warn'), every warning
    kept ('always': they are deduplicated by location otherwise). Returns
    the flagged syncs' warnings."""
    import warnings

    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter('always')
            fn(rec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [w for w in rec if SYNC_WARNING in str(w.message)]


def _where(w) -> str:
    """A warning's file:line, relative to the checkout or to the Python
    library it is in."""
    path = w.filename
    root = os.path.dirname(os.path.abspath(__file__))
    if path.startswith(root + os.sep):
        path = os.path.relpath(path, root)
    elif 'site-packages' + os.sep in path:
        path = path.split('site-packages' + os.sep, 1)[1]
    return f'{path}:{w.lineno}'


def sync_flags() -> dict:
    """How many syncs the runtime's check flags for one call of each
    operation the counter's kinds name, in this torch on this card."""
    import torch
    dev = torch.device('cuda')
    x = torch.arange(4096, dtype=torch.float32, device=dev).reshape(512, 8)
    i0 = torch.tensor(3, device=dev)
    ids = torch.arange(3, device=dev)
    host = np.ones(64, np.float32)
    cases = {
        'torch.cuda.synchronize()': lambda: torch.cuda.synchronize(dev),
        'Event.synchronize()': lambda: torch.cuda.Event().synchronize(),
        'Stream.synchronize()':
            lambda: torch.cuda.current_stream(dev).synchronize(),
        'x.cpu()': lambda: x.cpu(),
        'int(x.argmax())': lambda: int(x.argmax()),
        'bool(t.any())': lambda: bool((x > 5).any()),
        'x[mask]': lambda: x[x[:, 0] > 5],
        'torch.nonzero': lambda: torch.nonzero(x[:, 0] > 5),
        'torch.unique': lambda: torch.unique(x[:, 0] // 7),
        'torch.unique(dim=0)':
            lambda: torch.unique(x // 64, dim=0, return_inverse=True),
        'torch.bincount': lambda: torch.bincount(ids),
        'x[0-d card tensor]': lambda: x[i0],
        'x[card index] = -1': lambda: x.__setitem__((ids,), -1.0),
        'from_numpy(a).to(card)': lambda: torch.from_numpy(host).to(dev),
        'torch.tensor(1.5, device=card)':
            lambda: torch.tensor(1.5, device=dev),
        'x[host index]': lambda: x[np.arange(3)],
    }
    return {name: len(_flagged(lambda rec, fn=fn: fn()))
            for name, fn in cases.items()}


def check_dispatch(frames, cfg, card: str, want: bytes) -> None:
    """Phase i: the slice encoded once under the runtime's sync check,
    the flagged syncs split per step (run_all's step_hook) beside the
    step's noted round trips (metrics['dispatches']). A step with more
    flagged syncs than noted uploads + downloads + waits has a sync the
    counter misses, and fails the run: the check flags every synchronous
    copy, uploads too (sync_flags). Kernel launches: K1 22 and its
    prepare 3 in FrameTiling, the k-means++ seeding 381 (127 draws of 3
    keyframes) in Dither. Then the small clip on the CPU and on the card:
    the same noted counts per step, `kernel` 0 on the CPU and the
    launches on the card."""
    import collections

    import torch

    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.tools.common import synthetic_clip_v2
    say('sync_flags', card=card, flagged=sync_flags())
    enc = Encoder(cfg, device='cuda')
    per_step, out = {}, {}

    def run(rec):
        mark = [0]

        def hook(step):
            ws = [w for w in rec[mark[0]:] if SYNC_WARNING in str(w.message)]
            mark[0] = len(rec)
            per_step[step] = collections.Counter(_where(w) for w in ws)
        out['blob'] = enc.run_all(frames, fps=24, fast_lzma=True,
                                  step_hook=hook)
    _counts_zero()
    t0 = time.perf_counter()
    flagged = _flagged(run)
    wall = time.perf_counter() - t0
    launches = _counts()
    noted = enc.state.metrics['dispatches']
    over = {}
    for step, c in noted.items():
        n = sum(per_step[step].values())
        say('dispatch_step', card=card, step=step, h2d=c['h2d'],
            d2h=c['d2h'], sync=c['sync'], kernel=c['kernel'],
            total=c['total'], flagged=n,
            flagged_minus_d2h_sync=n - c['d2h'] - c['sync'],
            top=per_step[step].most_common(6))
        if n > c['total']:
            over[step] = (n, c['total'])
    say('dispatch', card=card, wall_s=wall, flagged=len(flagged),
        noted=sum(c['total'] for c in noted.values()),
        kernel=sum(c['kernel'] for c in noted.values()), launches=launches,
        same_bytes=out['blob'] == want)
    if over:
        raise AssertionError(f'steps with syncs the counter misses '
                             f'(flagged, noted): {over}')
    if out['blob'] != want:
        raise AssertionError('the slice under the sync check wrote other '
                             'bytes')
    if launches != {'nn1': 22, 'nn1_prepare': 3, 'kmeans_pp': 381} or \
            sum(c['kernel'] for c in noted.values()) != 406 or \
            noted['frame_tiling']['kernel'] != 25 or \
            noted['dither']['kernel'] != 381:
        raise AssertionError(f'slice launches {launches}, per step '
                             f'{ {s: c["kernel"] for s, c in noted.items()} }')
    small = synthetic_clip_v2(8, 120, 160)
    small_cfg = EncoderConfig(palette_count=16, max_tiles=400)
    got = {}
    for device in ('cpu', 'cuda'):
        _counts_zero()
        e = Encoder(small_cfg, device=device)
        e.run_all(small, fps=24, fast_lzma=True)
        got[device] = (e.state.metrics['dispatches'], _counts())
    (cpu, cpu_l), (gpu, gpu_l) = got['cpu'], got['cuda']
    kinds = ('h2d', 'd2h', 'sync', 'total')
    same = all({k: cpu[s][k] for k in kinds} == {k: gpu[s][k] for k in kinds}
               for s in cpu) and list(cpu) == list(gpu)
    say('dispatch_small', card=card, cpu=cpu, cuda=gpu, same=same,
        launches=gpu_l)
    if not same or any(c['kernel'] for c in cpu.values()) or \
            sum(c['kernel'] for c in gpu.values()) != sum(gpu_l.values()) or \
            sum(cpu_l.values()):
        raise AssertionError('the small clip counts otherwise on the CPU '
                             'and on the card')


def _counts_zero() -> None:
    from tiler_tpu_torch.ops import nn_kernels as nk
    nk.LAUNCHES = nk.LAUNCHES_PREP = nk.LAUNCHES_KPP = 0


def _counts() -> dict:
    """The launches of K1, its prepare kernel and the seeding kernel."""
    from tiler_tpu_torch.ops import nn_kernels as nk
    return {'nn1': nk.LAUNCHES, 'nn1_prepare': nk.LAUNCHES_PREP,
            'kmeans_pp': nk.LAUNCHES_KPP}


def _seeding_launches(metrics: dict, cfg) -> int:
    """The seeding kernel's launches in an encode: palette_count - 1 for
    each keyframe (every keyframe of these clips holds more than one
    tile)."""
    return metrics['n_keyframes'] * max(cfg.palette_count - 1, 0)


def check_streaming(frames, cfg, card: str, batch: dict, tmp: str) -> dict:
    """Path e, the streaming and the GOP-sharded encode of the 1080p clip
    on the card: equal bytes, fewer than all frames buffered, K1 launched
    once per stage-3 call and the prepare once per GOP, PSNR at the
    floor; wall, bytes, PSNR and peak device memory printed beside the
    batch encode's. Returns the streaming run's launch counts."""
    import torch

    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.ops.stats import psnr
    from tiler_tpu_torch.parallel.distributed import encode_gop_sharded
    from tiler_tpu_torch.pipeline.stream import encode_streaming
    path = os.path.join(tmp, 'stream.gtm')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    t0 = time.perf_counter()
    m = encode_streaming(iter(frames), cfg, path, fps=24, fast_lzma=True,
                         chunk=4, device='cuda')
    wall = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(path, 'rb') as fh:
        blob = fh.read()
    decoded, stream = decode_video(blob)
    p = psnr(decoded, frames)
    say('streaming', card=card, wall_s=wall, fps=len(frames) / wall,
        psnr=p, tiles=len(stream.tiles), max_memory_allocated=peak,
        launches=counts, batch=batch, **m)
    if m['gtm_bytes'] != len(blob):
        raise AssertionError(f'streaming: {m["gtm_bytes"]} bytes reported, '
                             f'{len(blob)} written')
    if m['max_buffered_frames'] >= len(frames):
        raise AssertionError(f'streaming buffered {m["max_buffered_frames"]} '
                             f'of {len(frames)} frames')
    if counts['nn1'] <= 0 or counts['nn1'] != sum(m['ft_nn_calls']) or \
            counts['nn1_prepare'] != m['n_keyframes'] or \
            counts['kmeans_pp'] != _seeding_launches(m, cfg):
        raise AssertionError(f'streaming: launches {counts} against stage-3 '
                             f'calls {m["ft_nn_calls"]} in '
                             f'{m["n_keyframes"]} GOPs')
    if decoded.shape != frames.shape or not p >= PSNR_FLOOR:
        raise AssertionError(f'streaming: {decoded.shape}, {p} dB')

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    t0 = time.perf_counter()
    sharded = encode_gop_sharded(frames, cfg, n_hosts=1, fps=24,
                                 fast_lzma=True, device='cuda')
    wall = time.perf_counter() - t0
    say('gop_sharded', card=card, wall_s=wall, gtm_bytes=len(sharded),
        same_bytes=sharded == blob, launches=_counts(),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    if sharded != blob:
        raise AssertionError('streaming file != encode_gop_sharded bytes')
    if _counts() != counts:
        raise AssertionError(f'GOP-sharded launches {_counts()} != the '
                             f"streaming encode's {counts}")
    return counts


def check_resume(frames, cfg, card: str, want: bytes, tmp: str) -> None:
    """Path e, checkpoint and resume on the card: run to GlobalTiling,
    save, load into a new Encoder that starts at FrameTiling; its stream
    equals the uninterrupted run's bytes."""
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                  load_checkpoint,
                                                  save_checkpoint)
    path = os.path.join(tmp, 'state')
    first = Encoder(dataclasses.replace(cfg, end_step='global_tiling'),
                    device='cuda')
    first.run_all(frames, fps=24, fast_lzma=True)
    dev_tiles = first.state.device_tiles_pal()
    t0 = time.perf_counter()
    save_checkpoint(path, first.state)
    save_s = time.perf_counter() - t0
    if first.state.device_tiles_pal() is not dev_tiles:
        raise AssertionError('saving dropped the device tiles')
    del first, dev_tiles
    t0 = time.perf_counter()
    state = load_checkpoint(path, 'cuda')
    load_s = time.perf_counter() - t0
    rest = dataclasses.replace(cfg, start_step='frame_tiling')
    enc = Encoder(rest, device='cuda')
    state.config = rest
    enc.state = state
    _counts_zero()
    t0 = time.perf_counter()
    blob = enc.run_all(state.frames_rgb, fps=state.fps, fast_lzma=True)
    wall = time.perf_counter() - t0
    counts = _counts()
    say('checkpoint_resume', card=card, save_s=save_s, load_s=load_s,
        checkpoint_bytes=os.path.getsize(checkpoint_path(path)),
        resumed_wall_s=wall, same_bytes=blob == want, launches=counts,
        step_times={k: enc.state.step_times[k]
                    for k in ('frame_tiling', 'reindex', 'smooth', 'save')})
    if blob != want:
        raise AssertionError('resumed stream != uninterrupted stream')
    if counts['nn1'] != enc.state.metrics['ft_nn_calls'] or \
            counts['nn1_prepare'] != enc.state.metrics['n_keyframes'] or \
            counts['kmeans_pp'] != 0:
        raise AssertionError(f'resumed encode: launches {counts}')


def check_renderers(blob: bytes, enc, frames, card: str) -> None:
    """Path e, decode and render: both torch renderers on the card give
    the numpy decoder's frames byte for byte (each timed twice: the first
    call also sets the card's allocations up; all three include the LZMA
    decode and the command walk, timed alone as parse_only), and the
    preview renderer's
    PSNR from the encoder state equals the decoded stream's to 1e-6."""
    import torch

    from tiler_tpu_torch import render
    from tiler_tpu_torch.decode import (decode_video, decode_video_torch,
                                        decode_video_torch_scan)
    from tiler_tpu_torch.bitstream.gtm import parse_gtm
    from tiler_tpu_torch.decode import interpret_commands
    from tiler_tpu_torch.ops.stats import psnr
    times = {}

    def timed(name, fn):
        out = None
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    timed('parse_only', lambda: interpret_commands(parse_gtm(blob)))
    want = timed('numpy', lambda: decode_video(blob)[0])
    per_frame = timed('torch', lambda: decode_video_torch(blob, 'cuda'))
    scan = timed('torch_scan', lambda: decode_video_torch_scan(blob, 'cuda'))
    same = {'torch': per_frame.tobytes() == want.tobytes(),
            'torch_scan': scan.tobytes() == want.tobytes()}
    t0 = time.perf_counter()
    p_state = render.reconstruction_psnr(enc.state)
    render_s = time.perf_counter() - t0
    p_stream = psnr(want, frames)
    say('renderers', card=card, frames=len(want), seconds=times, same=same,
        psnr_state=p_state, psnr_stream=p_stream, render_s=render_s)
    if not all(same.values()):
        raise AssertionError(f'torch renderer != numpy decoder: {same}')
    if abs(p_state - p_stream) > 1e-6:
        raise AssertionError(f'reconstruction_psnr {p_state} != decoded '
                             f'{p_stream}')


def check_cli(card: str, tmp: str) -> None:
    """Path e, the command line in child processes on the small clip, on
    the card: a crash injected after GlobalTiling exits 13 and leaves the
    checkpoint; the rerun resumes at FrameTiling, removes it and writes
    the bytes of an uninterrupted encode; then info, transcode (decodes
    to the same frames) and encode --stream."""
    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.tools.common import synthetic_clip_v2
    root = os.path.dirname(os.path.abspath(__file__))
    clip = os.path.join(tmp, 'clip.npy')
    np.save(clip, synthetic_clip_v2(8, 120, 160))
    flags = ['--device', 'cuda', '--palette-count', '16', '--max-tiles',
             '400', '--fast-lzma']
    seconds = {}

    def cli(name, *argv, code=0, **env):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, '-m', 'tiler_tpu_torch', *argv],
            capture_output=True, text=True, cwd=root, timeout=300,
            env=dict(os.environ, PYTHONPATH=root, **env))
        seconds[name] = time.perf_counter() - t0
        if out.returncode != code:
            raise AssertionError(f'CLI {name}: exit {out.returncode}, '
                                 f'{out.stderr[-2000:]}')
        return out.stdout

    def path(name):
        return os.path.join(tmp, name)

    def read(name):
        with open(path(name), 'rb') as fh:
            return fh.read()
    cli('encode', 'encode', clip, path('ref.gtm'), *flags)
    auto = ['encode', clip, path('crash.gtm'), *flags, '--auto-checkpoint',
            path('auto')]
    out = cli('crash', *auto, code=13, TILER_CRASH_AFTER_STEP='global_tiling')
    if "injected crash after 'global_tiling'" not in out or \
            not os.path.exists(path('auto.npz')) or \
            os.path.exists(path('crash.gtm')):
        raise AssertionError(f'CLI crash left {sorted(os.listdir(tmp))}')
    out = cli('resume', *auto)
    if "resuming at step 'frame_tiling'" not in out or \
            os.path.exists(path('auto.npz')):
        raise AssertionError('CLI rerun did not resume at frame_tiling')
    same = read('crash.gtm') == read('ref.gtm')
    info = json.loads(cli('info', 'info', path('ref.gtm')).splitlines()[-1])
    cli('transcode', 'transcode', path('ref.gtm'), path('lc3.gtm'),
        '--lzma-mode', 'lc3')
    want = decode_video(read('ref.gtm'))[0]
    same_frames = decode_video(read('lc3.gtm'))[0].tobytes() == want.tobytes()
    out = cli('stream', 'encode', clip, path('s.gtm'), *flags, '--stream')
    streamed = json.loads(out.splitlines()[-1])
    say('cli', card=card, seconds=seconds, resumed_same_bytes=same,
        info=info, transcode_same_frames=same_frames,
        lc3_bytes=len(read('lc3.gtm')), stream=streamed)
    if not same:
        raise AssertionError('CLI resumed stream != uninterrupted stream')
    if info['frames'] != 8 or (info['width'], info['height']) != (160, 120):
        raise AssertionError(f'CLI info: {info}')
    if not same_frames:
        raise AssertionError('CLI transcode changed the decoded frames')
    if streamed['n_frames'] != 8 or \
            decode_video(read('s.gtm'))[0].shape != want.shape:
        raise AssertionError(f'CLI encode --stream: {streamed}')


@contextlib.contextmanager
def time_limit(seconds: int, what: str):
    """Raise TimeoutError in the main thread if the block runs longer."""
    def expired(signum, frame):
        raise TimeoutError(f'{what}: over {seconds} s')
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def check_gop_exact(frames, cfg, card: str, batch: dict, want: bytes,
                    counts: dict) -> dict:
    """Path f, the exact GOP-sharded encode at 1 and at 3 hosts, the host
    threads sharing the card: the batch encode's bytes, and K1 and its
    prepare launched as often as the batch encode launched them (the
    same keyframes' stage 3, split over the hosts). Returns the 3-host
    run's counts."""
    import torch

    from tiler_tpu_torch.parallel.gop_exact import encode_gop_sharded_exact
    for hosts in (1, 3):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _counts_zero()
        t0 = time.perf_counter()
        with time_limit(600, f'gop_exact {hosts} hosts'):
            blob = encode_gop_sharded_exact(frames, cfg, n_hosts=hosts,
                                            fps=24, fast_lzma=True,
                                            device='cuda', timeout=540)
        wall = time.perf_counter() - t0
        got = _counts()
        say('gop_exact', card=card, hosts=hosts, wall_s=wall,
            gtm_bytes=len(blob), same_bytes=blob == want, launches=got,
            batch_launches=counts,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            batch=batch)
        if blob != want:
            raise AssertionError(f'{hosts}-host exact encode != batch bytes')
        if got != counts:
            raise AssertionError(f'{hosts}-host launches {got} != batch '
                                 f'{counts}')
    return got


def check_mesh(frames, cfg, card: str, batch: dict, want: bytes) -> dict:
    """Path f, Encoder(mesh=['cuda:0'] * 4).run_all with and without
    mesh_kmodes: the batch encode's bytes, K1 launched once per stage-3
    call of each shard and the prepare once per keyframe (the four
    shards share one card, so one Prepared set). Returns the launch
    counts of both runs."""
    import torch

    from tiler_tpu_torch.parallel.mesh import make_mesh
    from tiler_tpu_torch.pipeline.encoder import Encoder
    mesh = make_mesh(devices=['cuda:0'] * 4)
    out = {}
    for mesh_kmodes in (False, True):
        name = 'mesh4_kmodes' if mesh_kmodes else 'mesh4'
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _counts_zero()
        enc = Encoder(dataclasses.replace(cfg, mesh_kmodes=mesh_kmodes),
                      mesh=mesh)
        t0 = time.perf_counter()
        with time_limit(600, name):
            blob = enc.run_all(frames, fps=24, fast_lzma=True)
        wall = time.perf_counter() - t0
        got = _counts()
        m = enc.state.metrics
        say(name, card=card, wall_s=wall, gtm_bytes=len(blob),
            same_bytes=blob == want, launches=got,
            launches_per_shard=m['ft_nn_calls_shards'],
            mesh_sharded_wall=m['mesh_sharded_wall'],
            step_times=enc.state.step_times, gt_phases=m['gt_phases'],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            batch=batch)
        if blob != want:
            raise AssertionError(f'{name} stream != batch encode bytes')
        if got['nn1'] <= 0 or got['nn1'] != m['ft_nn_calls'] or \
                got['nn1'] != sum(m['ft_nn_calls_shards']) or \
                len(m['ft_nn_calls_shards']) != 4 or \
                got['nn1_prepare'] != m['n_keyframes'] or \
                got['kmeans_pp'] != _seeding_launches(m, cfg):
            raise AssertionError(f'{name}: launches {got}, per shard '
                                 f'{m["ft_nn_calls_shards"]}')
        out[name] = dict(got, per_shard=m['ft_nn_calls_shards'])
        del enc
    return out


def check_cli_multi(card: str, tmp: str) -> None:
    """Path f, the CLI's multi-device forms on the small clip (check_cli's
    clip and one-device stream): two --distributed children on the card,
    joined by gloo on a free localhost port, write the one-device bytes
    (rank 0 writes); --devices 2 on this one-card machine exits non-zero
    with the JAX CLI's 'only 1 device(s) available'."""
    root = os.path.dirname(os.path.abspath(__file__))
    clip = os.path.join(tmp, 'clip.npy')
    flags = ['--device', 'cuda', '--palette-count', '16', '--max-tiles',
             '400', '--fast-lzma']
    env = dict(os.environ, PYTHONPATH=root)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, 'dist.gtm')
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'tiler_tpu_torch', 'encode', clip,
         out if pid == 0 else os.devnull, *flags, '--distributed',
         '--coordinator', f'localhost:{port}', '--num-processes', '2',
         '--process-id', str(pid)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    dist_s = time.perf_counter() - t0
    for pid, (p, (_, err)) in enumerate(zip(procs, results)):
        if p.returncode != 0:
            raise AssertionError(f'--distributed rank {pid}: exit '
                                 f'{p.returncode}, {err[-2000:]}')
    with open(out, 'rb') as fh:
        dist = fh.read()
    with open(os.path.join(tmp, 'ref.gtm'), 'rb') as fh:
        ref = fh.read()
    t0 = time.perf_counter()
    two = subprocess.run(
        [sys.executable, '-m', 'tiler_tpu_torch', 'encode', clip,
         os.path.join(tmp, 'two.gtm'), *flags, '--devices', '2'],
        capture_output=True, text=True, cwd=root, env=env, timeout=300)
    say('cli_multi', card=card, distributed_s=dist_s,
        distributed=json.loads(results[0][0].strip().splitlines()[-1]),
        distributed_same_bytes=dist == ref,
        devices2_exit=two.returncode, devices2_said=two.stderr.strip()[-200:],
        devices2_s=time.perf_counter() - t0)
    if dist != ref:
        raise AssertionError('--distributed stream != one-device CLI bytes')
    if two.returncode == 0 or 'only 1 device(s) available' not in two.stderr:
        raise AssertionError(f'--devices 2: exit {two.returncode}, '
                             f'{two.stderr[-500:]}')


def check_bench(card: str, slice_blob: bytes, tmp: str) -> dict:
    """Phase g, the measurement entry points on the card: python -m
    tiler_tpu_torch.bench as a child at the 320x240 size with 3 timed runs,
    its CPU baseline and its continuity entry on, must name its metric
    encode_fps_320x240_cuda, list 3 runs, measure vs_baseline, write one
    stream in every run, reach peaks of device memory that differ by less
    than one copy of the clip's source tiles (which a run holding an
    earlier run's encoder would add; the caching allocator's block
    slack may move a peak by less), launch K1 once per stage-3 call
    in each and print its round trips (n_dispatches the sum of the
    steps' totals; the bench itself raises when a timed run's differ
    from the first's); then
    tools.decode_bench on the web sample and on the 1080p slice stream on
    the card (each renderer's frames equal to the numpy decoder's).
    Returns the bench's full line."""
    from tiler_tpu_torch.tools import decode_bench
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, TILER_BENCH_SMALL='1',
               TILER_BENCH_RUNS='3')
    for name in ('TILER_BENCH_CPU', 'TILER_BENCH_NO_CPU',
                 'TILER_BENCH_NO_CONT', 'TILER_BENCH_DEVICES'):
        env.pop(name, None)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, '-m', 'tiler_tpu_torch.bench'],
                         capture_output=True, text=True, cwd=root, env=env,
                         timeout=480)
    bench_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f'bench: exit {out.returncode}, '
                             f'{out.stderr[-2000:]}')
    full, head = [json.loads(ln) for ln in
                  out.stdout.strip().splitlines()[-2:]]
    path = os.path.join(tmp, 'slice.gtm')
    with open(path, 'wb') as fh:
        fh.write(slice_blob)
    root_sample = os.path.join(root, 'decoders', 'web', 'sample.gtm')
    t0 = time.perf_counter()
    decoded = {name: decode_bench.main([p, '--device', 'cuda'])
               for name, p in (('sample', root_sample), ('slice', path))}
    say('bench', card=card, bench_s=bench_s,
        decode_bench_s=time.perf_counter() - t0, headline=head, full=full,
        decode_bench=decoded)
    ok = (head['metric'] == full['metric'] == 'encode_fps_320x240_cuda'
          and len(head['runs_fps']) == len(full['sha256']) == 3
          and isinstance(head['vs_baseline'], float)
          and len(set(full['sha256'])) == 1
          and max(full['peak_bytes']) - min(full['peak_bytes'])
          < BENCH_SMALL_CLIP_BYTES
          and full['k1_launches'] == [full['ft_nn_calls']] * 3
          and full['n_dispatches'] == sum(
              c['total'] for c in full['dispatches'].values()) > 0
          and full['continuity'] is not None
          and decoded['sample']['frames'] == 48
          and decoded['slice']['frames'] == 16
          and all(d['same_frames'] for d in decoded.values()))
    if not ok:
        raise AssertionError(f'bench: {head}; decode_bench: {decoded}')
    return full


def check_graft_entry(card: str) -> dict:
    """Phase h, the compile-check entry points (tiler_tpu_torch.graft_entry):
    entry('cuda')'s ft_forward launches K1 once and its prepare once, and
    agrees with the plain 1-NN on the same card features and with the
    whole step on the CPU from the same numpy arrays (err within rtol
    1e-5 / atol 1e-4, winners apart only at near ties); then
    dryrun_multichip(8) on 8 logical shards of cuda:0 writes the 1-device
    card stream, each of its two encodes launching K1 once per stage-3
    call (the mesh's split over its 8 shards) and the prepare once per
    keyframe; the card stream beside the CPU port's (the same bytes, or
    PSNRs within 0.05 dB where they part at a near tie). Returns the
    launch counts of both."""
    import io

    import torch

    from tiler_tpu_torch import graft_entry
    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.ops import features
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.ops.stats import psnr
    rtol, atol = 1e-5, 1e-4
    fn, args = graft_entry.entry('cuda')
    _counts_zero()
    idx, err = fn(*args)
    torch.cuda.synchronize()
    entry_counts = _counts()
    if entry_counts != {'nn1': 1, 'nn1_prepare': 1, 'kmeans_pp': 0}:
        raise AssertionError(f'entry: launches {entry_counts}')
    q = features.psyv_features_rgb(args[0], use_wavelets=True)
    pidx, perr = nk.nearest_1_plain(q, args[1])
    torch.testing.assert_close(err, perr, rtol=rtol, atol=atol)
    ties_plain = _near_ties_only(q, args[1], idx, pidx, _l2_64)
    cfn, cargs = graft_entry.entry('cpu')
    cidx, cerr = cfn(*cargs)
    torch.testing.assert_close(err.cpu(), cerr, rtol=rtol, atol=atol)
    ties_cpu = _near_ties_only(q, args[1], idx, cidx.to(idx.device), _l2_64)
    ms = time_ms(lambda: fn(*args))
    prep = nk.prepare(args[1])
    t = turns({'plain': lambda: nk.nearest_1_plain(q, args[1]),
               'kernel': lambda: nk.nearest_1(q, prep)}, calls=4)
    say('graft_entry', card=card, queries=len(idx), candidates=len(args[1]),
        launches=entry_counts, ft_forward_ms=ms, k1_ms=t['kernel'],
        plain_ms=t['plain'], **bound(len(idx), len(args[1]), q.shape[1],
                                     PEAK_F32), rtol=rtol, atol=atol,
        idx_differ_plain=ties_plain, idx_differ_cpu=ties_cpu,
        max_abs_err_plain=float((err - perr).abs().max()),
        max_abs_err_cpu=float((err.cpu() - cerr).abs().max()))

    # each encode of the dryrun with its stream, metrics and launches
    runs = []
    plain_encoder = graft_entry.Encoder

    class Counted(plain_encoder):
        def run_all(self, *a, **kw):
            before = _counts()
            blob = super().run_all(*a, **kw)
            runs.append((blob, self.state, {k: v - before[k]
                                            for k, v in _counts().items()}))
            return blob
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by the phases before this one
    _counts_zero()
    said = io.StringIO()
    graft_entry.Encoder = Counted
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(said):
            blob = graft_entry.dryrun_multichip(8)
    finally:
        graft_entry.Encoder = plain_encoder
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # the mesh encode runs first, then the 1-device one
    (mesh_blob, mst, mesh_counts), (one_blob, ost, one_counts) = runs
    shards = mst.metrics['ft_nn_calls_shards']
    for st, got in ((mst, mesh_counts), (ost, one_counts)):
        if got['nn1'] <= 0 or got['nn1'] != st.metrics['ft_nn_calls'] or \
                got['nn1_prepare'] != st.metrics['n_keyframes'] or \
                got['kmeans_pp'] != _seeding_launches(st.metrics,
                                                      st.config):
            raise AssertionError(f'dryrun: launches {got} for '
                                 f'{st.metrics["ft_nn_calls"]} calls, '
                                 f'{st.metrics["n_keyframes"]} keyframes')
    if not (blob == mesh_blob == one_blob) or len(shards) != 8 or \
            sum(shards) != mst.metrics['ft_nn_calls']:
        raise AssertionError(f'dryrun: streams differ or shards {shards}')
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_blob = graft_entry.dryrun_multichip(1, devices=['cpu'])
    frames = graft_entry._dryrun_clip()
    p_card = psnr(decode_video(blob)[0], frames)
    p_cpu = psnr(decode_video(cpu_blob)[0], frames)
    ok_line = [ln for ln in said.getvalue().splitlines()
               if ln.startswith('dryrun_multichip OK')]
    say('dryrun8', card=card, said=ok_line, wall_s=wall,
        gtm_bytes=len(blob), sha256=hashlib.sha256(blob).hexdigest(),
        launches=mesh_counts, launches_per_shard=shards,
        launches_one_device=one_counts, max_memory_allocated=peak,
        memory_allocated_before=held,
        cpu_gtm_bytes=len(cpu_blob),
        cpu_sha256=hashlib.sha256(cpu_blob).hexdigest(),
        same_as_cpu=blob == cpu_blob, psnr=p_card, cpu_psnr=p_cpu)
    if blob != cpu_blob and not abs(p_card - p_cpu) <= 0.05:
        raise AssertionError(f'dryrun: card {p_card} dB, CPU {p_cpu} dB')
    return {'entry': entry_counts,
            'dryrun8': dict(mesh_counts, per_shard=shards)}


# phase k: the stage-3 gap of K1's winners over the float64 best, as the
# benchmark's k1_gap limit (gtmbench/limits/ft_slow.cuts1080.json)
FT_SLOW_K1_GAP = 3e-5
FT_SLOW_FAULTS = ('slow_as_medium', 'no_equal_skip')


def _ft_slow_encode(cell, cfg, frames, fault=None, capture=False):
    """One run_all of the cell's clip on the card under gtmbench's
    MarkProbe (and probe.Capture for K1): (stream, keyframe records,
    Capture or None, encoder)."""
    from gtmbench import ft_probe
    from gtmbench.probe import Capture
    from tiler_tpu_torch.pipeline.encoder import Encoder
    probe = ft_probe.MarkProbe()
    cap = Capture() if capture else None
    with contextlib.ExitStack() as stack:
        if fault is not None:
            stack.enter_context(ft_probe.plant(fault))
        stack.enter_context(probe)
        if cap is not None:
            cap.install()
            stack.callback(cap.uninstall)
        enc = Encoder(cfg, device='cuda')
        blob = enc.run_all(frames, fps=cell.traffic['fps'],
                           **cell.config['save'])
    records = ft_probe.compare(probe, cfg, 'cuda')
    del probe
    return blob, records, cap, enc


def check_ft_slow(card: str) -> dict:
    """Phase k: the benchmark cell ft_slow.cuts1080's clip encoded with
    gtm_ft_slow through run_all on the card. Every keyframe's marks and
    candidate list equal to the plain reference's
    (gtmbench/reference/frame_tiling.py), SLOW's marks holding the
    reference's MEDIUM ones, K1's winners for every changed cell of
    keyframe 0 within FT_SLOW_K1_GAP of the float64 best
    (gtmbench/reference/nn.py, in blocks), the stream decoding to the
    clip's shape; then each planted fault of gtmbench.ft_probe (SLOW
    marked as MEDIUM, UseOne's consecutive-equal skip dropped) must fail
    the comparison at its first keyframe."""
    import torch
    from gtmbench import cells, ft_probe
    from gtmbench.reference import gtm
    from gtmbench.reference import nn as ref_nn
    from gtmbench.traffic import generators
    from tiler_tpu_torch.config import EncoderConfig
    cell = cells.load('ft_slow.cuts1080')
    cfg = cells.encoder_config(EncoderConfig, cell.config['encoder'])
    frames = generators.make(cell.traffic)
    t0 = time.perf_counter()
    blob, records, cap, enc = _ft_slow_encode(cell, cfg, frames,
                                              capture=True)
    wall = time.perf_counter() - t0
    sizes = enc.state.metrics['ft_knn_sizes']
    t = time.perf_counter()
    kf = cap.k1[0]
    gap, moved, n_q = ref_nn.gap(torch.cat(kf['queries']), kf['cands'],
                                 torch.cat(kf['winners']))
    gap_s = time.perf_counter() - t
    decoded = gtm.decode(blob)
    out = {'card': card, 'wall_s': wall, 'keyframes': records,
           'ft_knn_sizes': sizes,
           'ft_feat_rows': enc.state.metrics['ft_feat_rows'],
           'ft_pair_dedup': enc.state.metrics['ft_pair_dedup'],
           'ft_phases': enc.state.metrics['ft_phases'],
           'k1_gap': gap, 'k1_moved': moved, 'k1_queries': n_q,
           'k1_candidates': len(kf['cands']), 'k1_gap_s': gap_s,
           'gtm_bytes': len(blob), 'psnr': gtm.psnr(decoded, frames)}
    del cap, enc, kf
    torch.cuda.empty_cache()
    say('ft_slow', **out)
    if not ft_probe.passes(records):
        raise AssertionError(f'ft_slow: marks or candidates differ from the '
                             f'reference: {records}')
    if [r['candidates'] for r in records] != sizes:
        raise AssertionError(f'ft_slow: candidate lists {records} are not '
                             f"stage 3's {sizes}")
    if not gap <= FT_SLOW_K1_GAP:
        raise AssertionError(f'ft_slow: K1 gap {gap} > {FT_SLOW_K1_GAP}')
    if decoded.shape != frames.shape:
        raise AssertionError(f'ft_slow: decoded {decoded.shape}')
    faults = {}
    for fault in FT_SLOW_FAULTS:
        stop = dataclasses.replace(cfg, end_step='frame_tiling')
        _, got, _, _ = _ft_slow_encode(cell, stop, frames, fault=fault)
        faults[fault] = got
        say('ft_slow_fault', fault=fault, keyframes=got)
        if ft_probe.passes(got) or got[0]['marks_equal']:
            raise AssertionError(f'ft_slow: the planted fault {fault} '
                                 f'passed at keyframe 0: {got}')
    out['faults'] = faults
    return out


def encode(frames, cfg, device, fast_lzma: bool = True):
    from tiler_tpu_torch.pipeline.encoder import Encoder
    enc = Encoder(cfg, device=device)
    t0 = time.perf_counter()
    blob = enc.run_all(frames, fps=24, fast_lzma=fast_lzma)
    return enc, blob, time.perf_counter() - t0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port is checked on a card',
              file=sys.stderr)
        return 1
    import tiler_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from tiler_tpu_torch.bench import card_line
    from tiler_tpu_torch.config import EncoderConfig
    from tiler_tpu_torch.decode import decode_video
    from tiler_tpu_torch.ops.stats import psnr
    from tiler_tpu_torch.tools.common import synthetic_clip_v2

    t_start = time.perf_counter()
    card = card_line()
    say('env', python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=card,
        tf32=[torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32])

    build_kernels()
    prep = check_prepare(card)
    record = check_kernel(card)
    variants = check_variants(card) + [check_prepare_bf16(card)]

    counts, s3 = run_tools(card)
    for rec in variants:
        rec['launches'] = counts[rec['name']]
    say('stage3_precision', card=card, **s3)
    check_configs()

    frames = synthetic_clip_v2(16, 1080, 1920)
    cfg = EncoderConfig(palette_count=128, tile_palette_size=16)
    kpp = check_kmeans_pp(card, frames, cfg)
    _, untimed, warm_s = encode(frames, cfg, 'cuda')
    torch.cuda.reset_peak_memory_stats()
    enc, blob, counts = encode_counted(frames, cfg, 'slice', card,
                                       warm_s=warm_s)
    record['launches'], prep['launches'] = counts['nn1'], counts['nn1_prepare']
    kpp['launches'] = counts['kmeans_pp']
    counts_batch = counts
    sha = hashlib.sha256(blob).hexdigest()
    say('slice_streams', gtm_bytes=len(blob), sha256=sha,
        timed_equals_untimed=blob == untimed,
        stage3_tool_k1_equals=sha == s3['k1']['sha256'])
    if blob != untimed or sha != s3['k1']['sha256']:
        raise AssertionError('the untimed, the timed and the stage-3 '
                             "tool's K1 slice streams differ")
    del untimed
    decoded, stream = decode_video(blob)
    batch = {'wall_s': sum(enc.state.step_times.values()),
             'gtm_bytes': len(blob), 'tiles': len(stream.tiles),
             'max_memory_allocated': torch.cuda.max_memory_allocated()}
    if decoded.shape != frames.shape:
        raise AssertionError(f'decoded {decoded.shape} != {frames.shape}')
    p = psnr(decoded, frames)
    say('decode', frames=len(decoded), width=stream.width,
        height=stream.height, psnr=p)
    if not p >= PSNR_FLOOR:
        raise AssertionError(f'PSNR {p} dB < {PSNR_FLOOR}')
    batch['psnr'] = p
    del decoded
    check_profiled(card)
    check_dispatch(frames, cfg, card, blob)

    with tempfile.TemporaryDirectory() as tmp:
        check_renderers(blob, enc, frames, card)
        del enc
        counts = check_streaming(frames, cfg, card, batch, tmp)
        record['launches_streaming'] = counts['nn1']
        prep['launches_streaming'] = counts['nn1_prepare']
        kpp['launches_streaming'] = counts['kmeans_pp']
        check_resume(frames, cfg, card, blob, tmp)
        check_cli(card, tmp)
        got = check_gop_exact(frames, cfg, card, batch, blob, counts_batch)
        record['launches_gop_exact_3hosts'] = got['nn1']
        prep['launches_gop_exact_3hosts'] = got['nn1_prepare']
        kpp['launches_gop_exact_3hosts'] = got['kmeans_pp']
        for name, got in check_mesh(frames, cfg, card, batch, blob).items():
            record[f'launches_{name}'] = got['nn1']
            record[f'launches_{name}_per_shard'] = got['per_shard']
            prep[f'launches_{name}'] = got['nn1_prepare']
            kpp[f'launches_{name}'] = got['kmeans_pp']
        check_cli_multi(card, tmp)
        with time_limit(600, 'measurement entry points'):
            full = check_bench(card, blob, tmp)
        record['launches_bench_small'] = full['k1_launches'][0]
        prep['launches_bench_small'] = full['k1_prepare_launches'][0]

    with time_limit(600, 'compile-check entry points'):
        got = check_graft_entry(card)
    record['launches_graft_entry'] = got['entry']['nn1']
    prep['launches_graft_entry'] = got['entry']['nn1_prepare']
    record['launches_dryrun8'] = got['dryrun8']['nn1']
    record['launches_dryrun8_per_shard'] = got['dryrun8']['per_shard']
    prep['launches_dryrun8'] = got['dryrun8']['nn1_prepare']
    kpp['launches_graft_entry'] = got['entry']['kmeans_pp']
    kpp['launches_dryrun8'] = got['dryrun8']['kmeans_pp']

    cfg_yv = dataclasses.replace(cfg, use_thomas_knoll=False, use_dl3=False)
    _, blob, _ = encode_counted(frames, cfg_yv, 'slice_yliluoma_var', card)
    decoded, _ = decode_video(blob)
    p = psnr(decoded, frames)
    say('decode_yliluoma_var', psnr=p)
    if decoded.shape != frames.shape or not p >= PSNR_FLOOR:
        raise AssertionError(f'Yliluoma + VAR: {decoded.shape}, {p} dB')

    check_ft_slow(card)

    say('wall', card=card, seconds=time.perf_counter() - t_start)
    print(json.dumps({'kernels': [record, prep] + variants + [kpp]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
