"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: the hand-written 1-NN kernel (tiler_tpu_torch/csrc/nn1.cu)
     from this checkout's sources;
  3. kernel vs its plain torch version on the card at the main path's
     shapes (Q=16384 queries, C=262144 candidates, D=192), with the
     tolerance stated per case, and both timed with CUDA events;
  4. the slice: Encoder(device='cuda').run_all on the 1080p 16-frame
     cuts_v2 clip at 128 palettes, once untimed and once timed, counting
     the kernel's launches in the timed run; plus a small clip encoded on
     the card and on the CPU, whose PSNRs must agree;
  5. decode: the stream through the shared numpy decoder, PSNR >= 29 dB.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}; nothing is printed as a result without a
CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

Q, C, D = 16384, 262144, 192
Q_SHORT = (2000, 9000, 12000)   # a keyframe's last, short query chunk
PSNR_FLOOR = 29.0


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


def check_kernel(card: str) -> dict:
    """Phase 3. Returns the kernel's JSON record (launches filled later)."""
    import torch

    from tiler_tpu_torch.ops import nn_kernels as nk
    dev = torch.device('cuda')
    rng = np.random.default_rng(7)

    def both(q, c):
        qi, qe = nk.nearest_1(q, c)
        pi, pe = nk.nearest_1_plain(q, c)
        torch.cuda.synchronize()
        return qi, qe, pi, pe

    # integer-valued features: every distance is exact in f32
    qn = rng.integers(0, 16, (Q, D)).astype(np.float32)
    cn = rng.integers(0, 16, (C, D)).astype(np.float32)
    cn[C // 2:C // 2 + Q // 2] = qn[:Q // 2]       # exact matches
    q, c = torch.from_numpy(qn).to(dev), torch.from_numpy(cn).to(dev)
    ki, ke, pi, pe = both(q, c)
    if not (torch.equal(ki, pi) and torch.equal(ke, pe)):
        raise AssertionError('integer features: kernel != plain '
                             f'({int((ki != pi).sum())} idx differ)')
    say('kernel_integer', exact=True, queries=Q, candidates=C, dim=D)

    # random f32 features: err to rtol 1e-5; idx equal unless a near tie
    qf = torch.from_numpy(rng.standard_normal((Q, D), np.float32)).to(dev)
    cf = torch.from_numpy(rng.standard_normal((C, D), np.float32)).to(dev)
    ki, ke, pi, pe = both(qf, cf)
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=1e-4)
    bad = torch.nonzero(ki != pi)[:, 0]
    if bad.numel():
        q64 = qf[bad].double()
        dk = ((q64 - cf[ki[bad].long()].double()) ** 2).sum(1)
        dp = ((q64 - cf[pi[bad].long()].double()) ** 2).sum(1)
        gap = (dk - dp).abs() / torch.maximum(dk, dp)
        if bool((gap > 1e-4).any()):
            raise AssertionError('random features: idx differs beyond a '
                                 'near tie')
    max_abs = float((ke - pe).abs().max())
    say('kernel_random', idx_differ=int(bad.numel()), max_abs_err=max_abs,
        rtol=1e-5)

    # duplicated candidates: the lowest index wins, also when the copies
    # lie in different candidate ranges of a short query chunk
    cd = cn.copy()
    cd[C - 1000:] = cd[0:1000]
    qd = torch.from_numpy(cd[0:1000].copy()).to(dev)
    ki, ke, pi, pe = both(qd, torch.from_numpy(cd).to(dev))
    if not (torch.equal(ki.cpu(), torch.arange(1000, dtype=torch.int32))
            and torch.equal(ki, pi) and torch.equal(ke, pe)):
        raise AssertionError('duplicated candidates: lowest index lost')
    # 1e9 padding rows never win, and change nothing
    cp = np.concatenate([cn, np.full((4096, D), 1e9, np.float32)])
    ki2, ke2, _, _ = both(q, torch.from_numpy(cp).to(dev))
    ki0, ke0 = nk.nearest_1(q, c)
    if not (torch.equal(ki2, ki0) and torch.equal(ke2, ke0)):
        raise AssertionError('1e9 padding changed the result')
    # ragged Q and C
    qr = q[:1037].contiguous()
    cr = c[:5013].contiguous()
    ki, ke, pi, pe = both(qr, cr)
    if not (torch.equal(ki, pi) and torch.equal(ke, pe)):
        raise AssertionError('ragged shapes: kernel != plain')
    # feature widths that fill no shared-memory slice
    for d in (3, 100):
        qw = torch.from_numpy(qn[:999, :d].copy()).to(dev)
        cw = torch.from_numpy(cn[:20000, :d].copy()).to(dev)
        ki, ke, pi, pe = both(qw, cw)
        if not (torch.equal(ki, pi) and torch.equal(ke, pe)):
            raise AssertionError(f'width {d}: kernel != plain')
    say('kernel_edges', duplicates='lowest index', padding='never wins',
        ragged=[1037, 5013], widths=[3, 100])

    # times at the main path's shapes, kernel and plain in turns: a full
    # 16384-query chunk, and short last chunks of a keyframe, with the
    # candidate ranges the kernel splits each into
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
    ms, plain_ms = min(t_kern, t_kern2), min(t_plain, t_plain2)
    tflops = 2.0 * Q * C * D / (ms * 1e-3) / 1e12
    say('kernel_time', card=card, kernel_ms=[t_kern, t_kern2],
        plain_ms=[t_plain, t_plain2], kernel_tflops=tflops,
        ranges=nk.candidate_ranges(Q, C, n_sm)[0], short=short)
    return {'name': 'nn1', 'route': 'cuda',
            'source': 'tiler_tpu_torch/csrc/nn1.cu',
            'replaces': 'tiler_tpu/ops/pallas_kernels.py:35',
            'launches': 0, 'max_abs_err': max_abs, 'ms': ms,
            'plain_ms': plain_ms}


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
    from tiler_tpu_torch.ops import nn_kernels as nk
    from tiler_tpu_torch.ops.stats import psnr

    card = card_line()
    say('env', python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=card,
        tf32=[torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32])

    t0 = time.perf_counter()
    so = nk.build(force=True)
    with open(so.replace('.so', '.ptxas.txt')) as fh:
        ptxas = [ln.strip() for ln in fh if 'registers' in ln
                 or 'spill' in ln]
    say('build', seconds=time.perf_counter() - t0, library=so, ptxas=ptxas)

    record = check_kernel(card)

    # small clip: the card's encode agrees with the port's CPU encode
    small = synthetic_clip_v2(8, 120, 160)
    cfg_s = EncoderConfig(palette_count=16, max_tiles=400)
    _, blob_g, _ = encode(small, cfg_s, 'cuda')
    _, blob_c, _ = encode(small, cfg_s, 'cpu')
    p_g = psnr(decode_video(blob_g)[0], small)
    p_c = psnr(decode_video(blob_c)[0], small)
    if abs(p_g - p_c) > 0.05:
        raise AssertionError(f'small clip: cuda {p_g} vs cpu {p_c} dB')
    say('small_clip', psnr_cuda=p_g, psnr_cpu=p_c,
        same_stream=blob_g == blob_c)

    frames = synthetic_clip_v2(16, 1080, 1920)
    cfg = EncoderConfig(palette_count=128, tile_palette_size=16)
    _, _, warm_s = encode(frames, cfg, 'cuda')
    torch.cuda.reset_peak_memory_stats()
    nk.LAUNCHES = 0
    enc, blob, wall = encode(frames, cfg, 'cuda')
    launches = nk.LAUNCHES
    m = enc.state.metrics
    say('slice', card=card, warm_s=warm_s, wall_s=wall,
        fps=len(frames) / wall, step_times=enc.state.step_times,
        ft_phases=m['ft_phases'], dither_phases=m['dither_phases'],
        gt_phases=m['gt_phases'], gtm_bytes=m['gtm_bytes'],
        n_keyframes=m['n_keyframes'],
        ft_q_changed_frac=m['ft_q_changed_frac'],
        ft_knn_sizes=m['ft_knn_sizes'], ft_pair_dedup=m['ft_pair_dedup'],
        ft_nn_calls=m['ft_nn_calls'],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches)
    if launches <= 0 or launches != m['ft_nn_calls']:
        raise AssertionError(f'kernel launches {launches} != stage-3 '
                             f'1-NN calls {m["ft_nn_calls"]}')
    record['launches'] = launches

    decoded, stream = decode_video(blob)
    if decoded.shape != frames.shape:
        raise AssertionError(f'decoded {decoded.shape} != {frames.shape}')
    p = psnr(decoded, frames)
    say('decode', frames=len(decoded), width=stream.width,
        height=stream.height, psnr=p)
    if not p >= PSNR_FLOOR:
        raise AssertionError(f'PSNR {p} dB < {PSNR_FLOOR}')

    print(json.dumps({'kernels': [record]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
