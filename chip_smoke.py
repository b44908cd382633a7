"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits
non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: both CUDA sources of the 1-NN kernels (tiler_tpu_torch/csrc/
     nn1.cu with K1 and its augmented mode K2, nn1_bf16.cu with K3) from
     this checkout, one nvcc each, started together;
  3. each kernel vs its plain torch version on the card at the main
     path's shapes (Q=16384 queries, C=262144 candidates, D=192), with
     the tolerance stated per case, and both timed with CUDA events in
     turns;
  4. the paths, each with the launch counts set to 0 just before it and
     read just after:
     a. the experiment tools (tiler_tpu_torch.tools.nn_prec_bench and
        assign_opt_bench) at their full shapes: K1, K2 and K3;
     b. the configurations on the 8x120x160 clip (default, Yliluoma +
        VAR, KModes restarts, a 64-colour tile palette, no wavelets, and
        the reload of the tileset the Yliluoma + VAR encode wrote), each
        encoded on the card and on the CPU, whose PSNRs must agree;
     c. the slice: Encoder(device='cuda').run_all on the 1080p 16-frame
        cuts_v2 clip at 128 palettes, once untimed and once timed, with
        K1's launches in the timed run equal to the stage-3 1-NN calls;
     d. the same clip with Yliluoma + VAR, encoded once;
  5. decode: both 1080p streams through the shared numpy decoder, each
     with PSNR >= 29 dB.
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
Q_SHORT = (2000, 9000, 12000)   # a keyframe's last, short query chunk
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


def time_ms(fn, runs: int = 7) -> float:
    """Median milliseconds of fn() over `runs` launches, CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def build_kernels() -> None:
    """Phase 2: every CUDA source from this checkout, one nvcc each, all
    started together; prints each library's registers and spills."""
    from tiler_tpu_torch.ops import nn_kernels as nk
    t0 = time.perf_counter()
    libs = nk.build(force=True)
    ptxas = {}
    for name, so in libs.items():
        with open(so.replace('.so', '.ptxas.txt')) as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if 'registers' in ln or 'spill' in ln]
    say('build', seconds=time.perf_counter() - t0, libraries=libs,
        ptxas=ptxas)


def check_kernel(card: str) -> dict:
    """Phase 3, K1: the checks every kernel gets (check_variant), feature
    widths that fill no shared-memory slice, and times at a full
    16384-query chunk and at a keyframe's short last chunks, with the
    candidate ranges the kernel splits each into. Returns its JSON
    record (launches filled later)."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    rec = check_variant('nn1', nk.nearest_1, nk.nearest_1_plain, (0, 16),
                        1.0, (1e-5, 1e-4), _l2_64)
    rec.update(source='tiler_tpu_torch/csrc/nn1.cu',
               replaces='tiler_tpu/ops/pallas_kernels.py:35')
    dev = torch.device('cuda')
    rng = np.random.default_rng(7)
    for d in (3, 100):
        _exact('nn1', nk.nearest_1, nk.nearest_1_plain,
               torch.from_numpy(rng.integers(0, 16, (999, d))
                                .astype(np.float32)).to(dev),
               torch.from_numpy(rng.integers(0, 16, (20000, d))
                                .astype(np.float32)).to(dev), f'width {d}')
    say('nn1_widths', widths=[3, 100])

    qf = torch.from_numpy(rng.standard_normal((Q, D), np.float32)).to(dev)
    cf = torch.from_numpy(rng.standard_normal((C, D), np.float32)).to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    t_plain = time_ms(lambda: nk.nearest_1_plain(qf, cf))
    t_kern = time_ms(lambda: nk.nearest_1(qf, cf))
    short = []
    for n in Q_SHORT:
        qs = qf[:n].contiguous()
        short.append({
            'queries': n, 'ranges': nk.candidate_ranges(n, C, n_sm)[0],
            'kernel_ms': time_ms(lambda: nk.nearest_1(qs, cf)),
            'plain_ms': time_ms(lambda: nk.nearest_1_plain(qs, cf))})
    t_plain2 = time_ms(lambda: nk.nearest_1_plain(qf, cf))
    t_kern2 = time_ms(lambda: nk.nearest_1(qf, cf))
    rec['ms'], rec['plain_ms'] = min(t_kern, t_kern2), min(t_plain, t_plain2)
    say('nn1_time', card=card, kernel_ms=[t_kern, t_kern2],
        plain_ms=[t_plain, t_plain2],
        kernel_tflops=2.0 * Q * C * D / (rec['ms'] * 1e-3) / 1e12,
        ranges=nk.candidate_ranges(Q, C, n_sm)[0], short=short)
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


def time_in_turns(kern, plain, q, c) -> tuple:
    """(kernel ms, plain ms, both lists): plain, kernel, kernel, plain."""
    t = [time_ms(lambda: plain(q, c)), time_ms(lambda: kern(q, c)),
         time_ms(lambda: kern(q, c)), time_ms(lambda: plain(q, c))]
    return min(t[1], t[2]), min(t[0], t[3]), [t[1], t[2]], [t[0], t[3]]


def check_variants(card: str) -> list:
    """Phase 3, K2 and K3: checks, then each timed against its plain
    version at Q x C x D in turns; K2 and K1 also held against their
    plain versions (err within rtol/atol, winners apart only at near
    ties) and timed at the assign tool's 1,048,576 candidates. Returns
    their JSON records."""
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
    for rec, kern, plain in ((aug, nk.nearest_1_aug, nk.nearest_1_aug_plain),
                             (bf16, nk.nearest_1_bf16,
                              nk.nearest_1_bf16_plain)):
        rec['ms'], rec['plain_ms'], k_all, p_all = time_in_turns(
            kern, plain, qf, cf)
        say(f'{rec["name"]}_time', card=card, queries=Q, candidates=C,
            kernel_ms=k_all, plain_ms=p_all,
            kernel_tflops=2.0 * Q * C * D / (rec['ms'] * 1e-3) / 1e12)
    c_big = torch.from_numpy(rng.standard_normal((1 << 20, D), np.float32)
                             ).to(dev)
    big = {}
    for name, kern, plain, tol in (
            ('nn1_aug', nk.nearest_1_aug, nk.nearest_1_aug_plain,
             (1e-4, 1e-2)),
            ('nn1', nk.nearest_1, nk.nearest_1_plain, (1e-5, 1e-4))):
        ki, ke, pi, pe = _both(kern, plain, qf, c_big)
        torch.testing.assert_close(ke, pe, rtol=tol[0], atol=tol[1])
        big[name] = {'idx_differ': _near_ties_only(qf, c_big, ki, pi, _l2_64),
                     'max_abs_err': float((ke - pe).abs().max())}
        big[name]['ms'], big[name]['plain_ms'], _, _ = time_in_turns(
            kern, plain, qf, c_big)
    say('nn1_aug_1m', card=card, queries=Q, candidates=1 << 20, **big)
    return [aug, bf16]


def run_tools() -> dict:
    """The path of K2 and K3: both experiment tools at their default
    (full) shapes, in this process, with the launch counts set to 0
    before and read after; the assign tool's LUTs bit-equal and its
    K1/K2 and float64 winner agreements at least AGREE_FLOOR."""
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.tools import assign_opt_bench, nn_prec_bench
    nk.LAUNCHES = nk.LAUNCHES_AUG = nk.LAUNCHES_BF16 = 0
    prec = nn_prec_bench.main([])
    aob = assign_opt_bench.main([])
    counts = {'nn1': nk.LAUNCHES, 'nn1_aug': nk.LAUNCHES_AUG,
              'nn1_bf16': nk.LAUNCHES_BF16}
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
    """Encode on the card with K1's launch count set to 0 just before and
    read just after; it must equal the stage-3 1-NN calls. Prints the
    run's times, sizes and counts as `phase`. Returns (encoder, stream,
    launches)."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    nk.LAUNCHES = 0
    enc, blob, wall = encode(frames, cfg, 'cuda')
    launches = nk.LAUNCHES
    m = enc.state.metrics
    say(phase, card=card, wall_s=wall, fps=len(frames) / wall,
        step_times=enc.state.step_times, ft_phases=m['ft_phases'],
        dither_phases=m['dither_phases'], gt_phases=m['gt_phases'],
        gtm_bytes=m['gtm_bytes'], n_keyframes=m['n_keyframes'],
        ft_q_changed_frac=m['ft_q_changed_frac'],
        ft_knn_sizes=m['ft_knn_sizes'], ft_pair_dedup=m['ft_pair_dedup'],
        ft_nn_calls=m['ft_nn_calls'],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches, **extra)
    if launches <= 0 or launches != m['ft_nn_calls']:
        raise AssertionError(f'{phase}: kernel launches {launches} != '
                             f'stage-3 1-NN calls {m["ft_nn_calls"]}')
    return enc, blob, launches


def check_configs() -> None:
    """Path b: each configuration on the small clip, on the card and on
    the CPU; PSNRs within 0.05 dB (the streams may part at float near
    ties). The reload encodes read the tileset that the card's Yliluoma
    + VAR encode wrote."""
    import tempfile

    from bench import synthetic_clip_v2
    from tiler_tpu.bitstream.gtm import write_gts
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.decode import decode_video
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.ops.stats import psnr
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
            nk.LAUNCHES = 0
            enc, blob_g, _ = encode(small, cfg, 'cuda')
            launches = nk.LAUNCHES
            if name == 'yliluoma_var':
                n = int(enc.state.tile_active.sum())
                write_gts(gts, enc.state.tiles_pal[:n],
                          cfg.tile_palette_size)
            _, blob_c, _ = encode(small, cfg, 'cpu')
            p_g = psnr(decode_video(blob_g)[0], small)
            p_c = psnr(decode_video(blob_c)[0], small)
            say(f'small_clip_{name}', psnr_cuda=p_g, psnr_cpu=p_c,
                bytes_cuda=len(blob_g), bytes_cpu=len(blob_c),
                same_stream=blob_g == blob_c, launches=launches)
            if abs(p_g - p_c) > 0.05:
                raise AssertionError(f'small clip {name}: cuda {p_g} vs '
                                     f'cpu {p_c} dB')
            if launches != enc.state.metrics['ft_nn_calls']:
                raise AssertionError(f'small clip {name}: {launches} K1 '
                                     'launches')


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
    from bench import synthetic_clip_v2
    from tiler_tpu.config import EncoderConfig
    from tiler_tpu.decode import decode_video
    from tiler_tpu_torch.ops.stats import psnr

    card = card_line()
    say('env', python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=card,
        tf32=[torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32])

    build_kernels()
    record = check_kernel(card)
    variants = check_variants(card)

    counts = run_tools()
    for rec in variants:
        rec['launches'] = counts[rec['name']]
    check_configs()

    frames = synthetic_clip_v2(16, 1080, 1920)
    cfg = EncoderConfig(palette_count=128, tile_palette_size=16)
    _, _, warm_s = encode(frames, cfg, 'cuda')
    torch.cuda.reset_peak_memory_stats()
    _, blob, record['launches'] = encode_counted(frames, cfg, 'slice', card,
                                                 warm_s=warm_s)
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

    print(json.dumps({'kernels': [record] + variants}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
