"""Every EncoderConfig field that run_all reads and no other port test
compares, one case each: the 8x120x160 cuts_v2 clip at palette_count=16,
max_tiles=400 through both packages on the CPU. A case's stream is the
JAX package's byte for byte, or the first step whose output differs is
held by a tie-aware check: FrameTiling cells may differ only where the
two winners' distances to the cell's source features lie within RTOL_FT
of each other (relative to the norms the f32 1-NN sums), Smooth only at
its threshold. ROADMAP Queue 3 names each
difference.

Fields that neither Load nor Dither reads resume both packages from
their own state after the default config's Dither (a checkpoint, as the
CLI resumes), so that the costly Knoll scan runs once per package."""
import jax_native_lock  # noqa: F401  (first: builds tiler_tpu's library)

import dataclasses

import numpy as np
import pytest
import torch

from bench import synthetic_clip_v2
from tiler_tpu.config import EncoderConfig, FTQuality
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.utils import checkpoint as jckpt
from tiler_tpu_torch.constants import ENCODER_STEPS
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.ops import features
from tiler_tpu_torch.ops.stats import psnr
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.pipeline.frame_tiling import run_frame_tiling
from tiler_tpu_torch.pipeline.load import changed_mask, split_into_tiles
from tiler_tpu_torch.pipeline.state import from_reference_state
from tiler_tpu_torch.tools.common import sample_clip
from tiler_tpu_torch.utils import checkpoint as pckpt

torch.set_num_threads(1)

BASE = EncoderConfig(palette_count=16, max_tiles=400)
# the largest gap allowed between the distances of a FrameTiling cell's
# two winners, relative to |q|^2 + |c|^2: the 1-NN sums |c|^2 - 2 q.c in
# f32, whose rounding scales with the norms, not with the distance (16
# f32 ulps; the three cases that part measure 1.3e-7, 1.8e-7, 3.9e-7)
RTOL_FT = 1e-6
FIELDS = ['tiles_pal', 'tiles_rgb', 'tm_tile', 'tm_pal', 'tm_h', 'tm_v',
          'tile_use', 'tile_active', 'tile_dpi', 'palettes_rgb', 'keyframes',
          'stm_tile', 'stm_pal', 'stm_h', 'stm_v', 'stm_smooth']
_FT = ['tm_tile', 'tm_pal', 'tm_h', 'tm_v']
_SM = ['stm_tile', 'stm_pal', 'stm_h', 'stm_v', 'stm_smooth']

# id: (fields, resumed after Dither, the step where the streams part or
# None for byte-equal)
CASES = {
    'ft_quality_slow': (dict(ft_quality=FTQuality.SLOW), True, None),
    'ft_gamma': (dict(ft_gamma=True), True, None),
    'ft_palette_tol_0.3': (dict(ft_palette_tol=0.3), True, 'frame_tiling'),
    'dithering_gamma': (dict(dithering_gamma=True), False, None),
    'dl3_bpc_6': (dict(dl3_bpc=6), False, None),
    # one FrameTiling near tie that Smooth then overwrites: same bytes
    'dl3_bin_cap_256': (dict(dl3_bin_cap=256), False, 'frame_tiling'),
    'dl3_bpc_6_bin_cap_256': (dict(dl3_bpc=6, dl3_bin_cap=256), False,
                              'frame_tiling'),
    'yliluoma_mix_8': (dict(yliluoma_mix=8, use_thomas_knoll=False), False,
                       None),
    # encoder_gamma is read through the two gamma switches; visual_gamma
    # by neither package's encoder
    'encoder_gamma_2.2_visual_gamma_1': (
        dict(encoder_gamma=2.2, visual_gamma=1.0, dithering_gamma=True,
             ft_gamma=True), False, None),
    'smoothing_strength_0': (dict(smoothing_strength=0.0), True, 'smooth'),
    'smoothing_strength_0.2': (dict(smoothing_strength=0.2), True, None),
    'qb_tiles_1_max_tiles_0': (dict(qb_tiles=1.0, max_tiles=0), True, None),
    'lzma_mode_lc8': (dict(lzma_mode='lc8'), True, None),
    'lzma_mode_lc3': (dict(lzma_mode='lc3'), True, None),
    'lzma_mode_best': (dict(lzma_mode='best'), True, None),
}


def _snap(st) -> dict:
    """Copies of the state's FIELDS (a later step writes some in place)."""
    out = {}
    for f in FIELDS:
        v = st.peek_tiles_pal() if f == 'tiles_pal' else getattr(st, f)
        out[f] = None if v is None else np.array(v)
    return out


def _encode(enc, frames, fps, fast_lzma):
    snaps = {}
    blob = enc.run_all(frames, fps=fps, fast_lzma=fast_lzma,
                       step_hook=lambda s: snaps.__setitem__(
                           s, _snap(enc.state)))
    return blob, snaps


def _resumed(pkg, cfg, path, fast_lzma):
    """Encode from a package's own checkpoint after Dither."""
    cfg = dataclasses.replace(cfg, start_step='make_unique')
    if pkg == 'jax':
        enc, st = JaxEncoder(cfg), jckpt.load_checkpoint(path)
    else:
        enc, st = Encoder(cfg, device='cpu'), pckpt.load_checkpoint(path,
                                                                     'cpu')
    st.config = cfg
    enc.state = st
    return _encode(enc, st.frames_rgb, st.fps, fast_lzma)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """The clip, and each package's default encode checkpointed after
    Dither; a resumed default encode gives each package's own bytes."""
    d = tmp_path_factory.mktemp('fields')
    frames = synthetic_clip_v2(8, 120, 160)
    paths = {}
    for pkg, enc, save in (('jax', JaxEncoder(BASE), jckpt.save_checkpoint),
                           ('port', Encoder(BASE, device='cpu'),
                            pckpt.save_checkpoint)):
        paths[pkg] = str(d / f'{pkg}_dither.npz')

        def hook(step, enc=enc, save=save, path=paths[pkg]):
            if step == 'dither':
                save(path, enc.state)
        full = enc.run_all(frames, fps=24, fast_lzma=True, step_hook=hook)
        assert _resumed(pkg, BASE, paths[pkg], True)[0] == full
    return dict(frames=frames, paths=paths)


def _first_difference(got: dict, want: dict):
    for step in ENCODER_STEPS:
        if step not in got:
            continue
        for f in FIELDS:
            a, b = got[step][f], want[step][f]
            if (a is None) != (b is None) or a is not None and (
                    a.shape != b.shape or not np.array_equal(a, b)):
                return step
    return None


def _ft_gaps(got: dict, want: dict, frames, cfg,
             max_share: float = 0.001) -> np.ndarray:
    """FrameTiling: the cells that differ ran at most max_share of the
    1-NN queries (an unchanged cell copies its query's result forward); the
    gap between each differing cell's two winners' distances to its
    source tile's features (the port's f32 features, float64 sums),
    relative to the larger |q|^2 + |c|^2."""
    f_n, th, tw = got['tm_tile'].shape
    diff = np.flatnonzero(np.stack([got[f] != want[f] for f in _FT])
                          .any(0).ravel())
    queried = changed_mask(frames, th, tw)
    queried[want['keyframes'][:, 0]] = True
    assert queried.ravel()[diff].sum() <= max_share * f_n * th * tw
    gamma = cfg.encoder_gamma if cfg.ft_gamma else None
    src = torch.from_numpy(split_into_tiles(frames, th, tw)[diff])
    q = features.psyv_features_rgb(src, gamma_value=gamma,
                                   use_wavelets=cfg.use_wavelets).double()
    kf = np.zeros(f_n, np.int64)
    for k, (s, e) in enumerate(want['keyframes']):
        kf[s:e + 1] = k
    kf = kf[diff // (th * tw)]
    dists, scale = [], np.zeros(len(diff))
    for st in (got, want):
        tile, pal, hm, vm = (st[f].ravel()[diff] for f in _FT)
        c = features.psyv_features_pal(
            torch.from_numpy(st['tiles_pal'][tile]),
            torch.from_numpy(st['palettes_rgb'][kf, pal]), gamma_value=gamma,
            use_wavelets=cfg.use_wavelets, hmir=torch.from_numpy(hm),
            vmir=torch.from_numpy(vm)).double()
        dists.append(((q - c) ** 2).sum(1).numpy())
        scale = np.maximum(scale, (q ** 2).sum(1).numpy()
                           + (c ** 2).sum(1).numpy())
    return np.abs(dists[0] - dists[1]) / scale


def _render(st: dict) -> np.ndarray:
    """[F, cells, 64*3] the RGB pixels each cell of the FrameTiling
    output (tm_*) shows: its tile, mirrored, through its palette."""
    f_n = st['tm_tile'].shape[0]
    t = st['tiles_pal'][st['tm_tile'].reshape(f_n, -1)]     # [F,C,8,8]
    t = np.where(st['tm_h'].reshape(f_n, -1)[..., None, None],
                 t[..., ::-1], t)
    t = np.where(st['tm_v'].reshape(f_n, -1)[..., None, None],
                 t[..., ::-1, :], t)
    kf = np.zeros(f_n, np.int64)
    for k, (s, e) in enumerate(st['keyframes']):
        kf[s:e + 1] = k
    pals = st['palettes_rgb'][kf[:, None], st['tm_pal'].reshape(f_n, -1)]
    px = np.take_along_axis(pals, t.reshape(*t.shape[:2], 64, 1)
                            .astype(np.int64), axis=2)      # [F,C,64,3]
    return px.reshape(f_n, t.shape[1], -1)


def _smooth_at_zero(st: dict) -> dict:
    """Smooth at strength 0 as the reference defines it: a cell is near
    the same cell one frame earlier exactly when both show the same
    pixels (their RMS is 0), and the chain's forward and backward copies
    follow (main.pas:4071-4119)."""
    f_n = st['tm_tile'].shape[0]
    px = _render(st)
    cur = {f: st[f].reshape(f_n, -1) for f in _FT}
    out = {f: cur[f].copy() for f in _FT}
    out['smooth'] = np.zeros_like(cur['tm_h'])
    for s, e in st['keyframes']:
        shown = px[s].copy()
        for f in range(s + 1, e + 1):
            near = (px[f] == shown).all(1)
            fwd = near & (cur['tm_tile'][f] >= out['tm_tile'][f - 1])
            bwd = near & ~fwd
            for k in _FT:
                out[k][f - 1] = np.where(bwd, cur[k][f], out[k][f - 1])
                out[k][f] = np.where(fwd, out[k][f - 1], cur[k][f])
            out['smooth'][f - 1] &= ~bwd
            out['smooth'][f] = near
            shown = np.where(fwd[:, None], shown, px[f])
    return {'stm_tile': out['tm_tile'], 'stm_pal': out['tm_pal'],
            'stm_h': out['tm_h'], 'stm_v': out['tm_v'],
            'stm_smooth': out['smooth']}


@pytest.mark.parametrize('case', list(CASES))
def test_field_matches_jax(ref, case):
    kw, resume, parts = CASES[case]
    cfg = dataclasses.replace(BASE, **kw)
    frames = ref['frames']
    fast = not case.startswith('lzma_mode')
    if resume:
        want, jsnaps = _resumed('jax', cfg, ref['paths']['jax'], fast)
        got, snaps = _resumed('port', cfg, ref['paths']['port'], fast)
    else:
        want, jsnaps = _encode(JaxEncoder(cfg), frames, 24, fast)
        got, snaps = _encode(Encoder(cfg, device='cpu'), frames, 24, fast)
    step = _first_difference(snaps, jsnaps)
    assert step == parts, (step, len(got), len(want))
    if parts is None:
        assert got == want
        return
    if parts == 'frame_tiling':
        gaps = _ft_gaps(snaps[step], jsnaps[step], frames, cfg)
        assert 0 < gaps.size and gaps.max() <= RTOL_FT, gaps
        # what follows a near tie stays close
        assert abs(len(got) - len(want)) <= 0.001 * len(want)
    else:
        # the reference's semantics at strength 0: every cell that shows
        # the pixels of the cell before it is smoothed; the JAX package
        # misses some of them (its f32 RMS of two equal rows is not 0)
        oracle = _smooth_at_zero(snaps['reindex'])
        for f in _SM:
            np.testing.assert_array_equal(
                snaps[step][f].reshape(oracle[f].shape), oracle[f], f)
        n_port = int(snaps[step]['stm_smooth'].sum())
        n_jax = int(jsnaps[step]['stm_smooth'].sum())
        assert n_jax < n_port, (n_jax, n_port)
    p_port = psnr(decode_video(got)[0], frames)
    p_jax = psnr(decode_video(want)[0], frames)
    assert abs(p_port - p_jax) <= 0.01, (p_port, p_jax)


# the config of tools/gen_sample_stream.py, which encodes the plasma clip
PLASMA = EncoderConfig(palette_count=32, tile_palette_size=16, qb_tiles=1.0)


def plasma_encodes(frames) -> dict:
    """Both packages' fast-LZMA encodes of frames at PLASMA with each
    step's FIELDS ('jax'/'port': encoder, stream, snaps), and the port's
    FrameTiling resumed from tiler_tpu's state after GlobalTiling
    ('resumed')."""
    jenc, jsnaps, after_gt = JaxEncoder(PLASMA), {}, []

    def hook(step):
        jsnaps[step] = _snap(jenc.state)
        if step == 'global_tiling':
            after_gt.append(from_reference_state(jenc.state, 'cpu'))
    want = jenc.run_all(frames, fps=24, fast_lzma=True, step_hook=hook)
    enc = Encoder(PLASMA, device='cpu')
    got, snaps = _encode(enc, frames, 24, True)
    return {'jax': (jenc, want, jsnaps), 'port': (enc, got, snaps),
            'resumed': run_frame_tiling(after_gt[0])}


def test_plasma_clip_parts_only_at_frame_tiling_near_ties():
    """The plasma clip of the web player's sample stream at the sample
    tool's config, cut to 12 frames of 160x88: the first step whose
    output differs is FrameTiling, the port's FrameTiling resumed from
    tiler_tpu's state after GlobalTiling gives the port's own cells, and
    each cell that differs is a near tie of the two f32 1-NNs (ROADMAP
    Queue 3; tests/plasma_ft_ties.py reads the full clip)."""
    frames = sample_clip(160, 88, 12)
    run = plasma_encodes(frames)
    (_, want, jsnaps), (_, got, snaps) = run['jax'], run['port']
    assert _first_difference(snaps, jsnaps) == 'frame_tiling'
    for f in _FT:
        np.testing.assert_array_equal(getattr(run['resumed'], f),
                                      snaps['frame_tiling'][f], f)
    # the plasma's smooth gradients give more near-equidistant candidates
    # than cuts_v2: 8 of these 2,640 cells' queries part (50 of 42,240 at
    # the full 48 x 176 x 320), against the 0.1% bound set on cuts_v2
    gaps = _ft_gaps(snaps['frame_tiling'], jsnaps['frame_tiling'], frames,
                    PLASMA, max_share=0.005)
    assert 0 < gaps.size and gaps.max() <= RTOL_FT, gaps
    p_port = psnr(decode_video(got)[0], frames)
    p_jax = psnr(decode_video(want)[0], frames)
    assert abs(p_port - p_jax) <= 0.01, (p_port, p_jax)
