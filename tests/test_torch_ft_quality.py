"""The FrameTiling invariants of the JAX suite (tests/test_ft_quality.py)
held by the port's own functions on the CPU: candidate sets nest FAST <=
MEDIUM <= SLOW, MEDIUM's palette mask holds each palette itself, the
residual error does not grow with quality, the mirror dedup of stage 2
equals the direct features, the vectorised marking equals its loop form,
and the temporal query dedup equals a full per-cell assignment."""
import dataclasses

import numpy as np
import pytest
import torch

from tiler_tpu_torch.config import EncoderConfig, FTQuality
from tiler_tpu_torch.decode import decode_video
from tiler_tpu_torch.ops import features, knn
from tiler_tpu_torch.pipeline import frame_tiling as ft
from tiler_tpu_torch.pipeline import load
from tiler_tpu_torch.pipeline.encoder import Encoder

torch.set_num_threads(1)

QUALITIES = (FTQuality.FAST, FTQuality.MEDIUM, FTQuality.SLOW)


def _until_frame_tiling(frames, cfg):
    enc = Encoder(dataclasses.replace(cfg, end_step='global_tiling'),
                  device='cpu')
    enc.run_all(frames, fps=24.0)
    enc.state.config = cfg
    return enc


def _mark(state, k: int):
    """Stage 1 for keyframe k as run_frame_tiling runs it: the 8-NN of the
    keyframe's tiles in the mirrored dataset, expanded across palettes by
    the state's quality. Returns (used, tile_of, attrs_of, idx, keep,
    tile_inv)."""
    ds, tile_of, attrs_of = ft.build_global_dataset(state)
    uq, inv = ft._mark_queries_idx(state, k)
    q = state.device_tiles_pal()[torch.from_numpy(uq.astype(np.int64))]
    idx, keep = knn.nearest_k_keepmask(q.reshape(len(uq), -1), ds, 8)
    idx, keep = idx.numpy(), keep.numpy()
    pm = ft.palette_similarity_mask(state, k) \
        if state.config.ft_quality == FTQuality.MEDIUM else None
    used = ft._mark_from_knn(state, k, idx, keep, inv, len(uq), len(ds), pm)
    return used, tile_of, attrs_of, idx, keep, inv


@pytest.fixture(scope='module')
def clip():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (1, 64, 96, 3))
    frames = np.repeat(base, 5, axis=0).astype(np.uint8)
    for i in range(5):
        frames[i, (i * 8) % 56:(i * 8) % 56 + 8, :16] = [250, 30, 40]
    return frames


@pytest.fixture(scope='module')
def encoders(clip):
    """One encoder per quality, run through GlobalTiling (which no
    quality changes)."""
    return {q: _until_frame_tiling(clip, EncoderConfig(
        palette_count=8, tile_palette_size=16, max_tiles=80, ft_quality=q))
        for q in QUALITIES}


def test_candidate_sets_nest(encoders):
    fast, med, slow = (_mark(encoders[q].state, 0)[0] for q in QUALITIES)
    assert fast.shape == med.shape == slow.shape
    assert not (fast & ~med).any(), 'FAST must be a subset of MEDIUM'
    assert not (med & ~slow).any(), 'MEDIUM must be a subset of SLOW'
    assert fast.sum() <= med.sum() <= slow.sum()
    assert fast.sum() < slow.sum()


def test_palette_mask_includes_self(encoders):
    mask = ft.palette_similarity_mask(encoders[FTQuality.MEDIUM].state, 0)
    assert mask.diagonal().all(), 'd(q,q)=0 < tol*highest must hold'


def test_residual_error_non_increasing_with_quality(encoders, clip):
    residuals = {}
    for q in QUALITIES:
        enc = encoders[q]
        enc.frame_tiling()
        residuals[q] = enc.state.metrics['ft_residual_err']
        enc.reindex()
        enc.smooth()
        dec, _ = decode_video(enc.save())
        assert dec.shape == clip.shape
    assert residuals[FTQuality.SLOW] <= residuals[FTQuality.MEDIUM] + 1e-3
    assert residuals[FTQuality.MEDIUM] <= residuals[FTQuality.FAST] + 1e-3


def _gradient_clip(rng, f, h, w, step, mix, noise):
    frames = np.zeros((f, h, w, 3), np.uint8)
    _, xx = np.mgrid[0:h, 0:w]
    for i in range(f):
        frames[i] = np.clip(((xx * step[0] + i * step[1]) % 256)[..., None]
                            * np.array(mix)
                            + rng.normal(0, noise, (h, w, 3)), 0, 255)
    return frames


def test_candidate_features_mirror_dedup_matches_direct(rng, monkeypatch):
    """The mirror-dedup path (signed permutations of the wavelet
    coefficients, features.mirror_coeff_perms) gives the direct pixel
    path's candidates, with features equal up to f32 summation order.
    Every mirror of each marked (palette, tile) is used, so that the
    pair dedup reaches the path's gate of 2 (this clip's own marking
    dedups 1.6 and takes the direct path)."""
    frames = _gradient_clip(rng, 4, 48, 64, (4, 2), [1, .7, .4], 5)
    state = _until_frame_tiling(frames, EncoderConfig(
        palette_count=4, tile_palette_size=16)).state
    used, tile_of, attrs_of = _mark(state, 0)[:3]
    # the dataset holds each tile's four mirrors in a row
    used = np.repeat(used.reshape(len(used), -1, 4).any(2), 4, axis=1)
    f_fast, p_f, t_f, a_f = ft.candidate_features(state, 0, used, tile_of,
                                                  attrs_of)
    assert state.metrics['ft_pair_dedup'][0] >= 2.0     # the dedup path ran
    monkeypatch.setattr(features, 'mirror_coeff_perms', lambda w: None)
    f_dir, p_d, t_d, a_d = ft.candidate_features(state, 0, used, tile_of,
                                                 attrs_of)
    kf = (p_f.astype(np.int64) << 32) | (t_f.astype(np.int64) << 4) | a_f
    kd = (p_d.astype(np.int64) << 32) | (t_d.astype(np.int64) << 4) | a_d
    of_, od = np.argsort(kf), np.argsort(kd)
    np.testing.assert_array_equal(kf[of_], kd[od])
    assert np.abs(f_fast.numpy()[of_] - f_dir.numpy()[od]).max() < 1e-4


@pytest.mark.parametrize('quality', QUALITIES, ids=lambda q: q.name)
def test_mark_candidates_matches_loop_form(rng, quality):
    """The vectorised marking equals the per-palette loop form (pure set
    logic) on the same 8-NN results."""
    frames = _gradient_clip(rng, 3, 40, 56, (5, 4), [.9, .6, 1.], 6)
    state = _until_frame_tiling(frames, EncoderConfig(
        palette_count=4, tile_palette_size=16, ft_quality=quality)).state
    used, _, _, idxs, keep, tile_inv = _mark(state, 0)
    s, e = state.keyframes[0]
    cell_pals = state.tm_pal[s:e + 1].ravel()
    n_uq = len(np.unique(state.tm_tile[s:e + 1]))
    pm = ft.palette_similarity_mask(state, 0)
    ref = np.zeros_like(used)
    pair_ids = cell_pals.astype(np.int64) * n_uq + tile_inv
    uq_pairs = np.unique(pair_ids)
    pair_pal, pair_row = uq_pairs // n_uq, uq_pairs % n_uq
    for p in range(state.config.palette_count):
        rows = pair_row[pair_pal == p]
        if rows.size == 0:
            continue
        marked = np.unique(idxs[rows][keep[rows]])
        if quality == FTQuality.FAST:
            ref[p, marked] = True
        elif quality == FTQuality.SLOW:
            ref[:, marked] = True
        else:
            ref[np.ix_(pm[:, p], marked)] = True
    np.testing.assert_array_equal(used, ref)


def test_assign_temporal_dedup_matches_full(rng, monkeypatch):
    """The temporal query dedup (byte-static cells forward-fill their
    1-NN result) writes the stream of a full per-cell assignment, reached
    by making every cell count as changed."""
    bg = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    frames = np.stack([bg] * 6)
    for i in range(6):
        x = 8 + 10 * i
        frames[i, 24:40, x:x + 16] = [250, 40, 90]
    cfg = EncoderConfig(palette_count=4, tile_palette_size=16,
                        smoothing_strength=0.0)

    def encode():
        enc = Encoder(cfg, device='cpu')
        return enc.run_all(frames, fast_lzma=True), enc.state.metrics

    blob_dedup, metrics = encode()
    assert metrics['ft_q_changed_frac'] < 0.8       # the dedup fired
    monkeypatch.setattr(load, 'changed_mask',
                        lambda fr, th, tw: np.ones((len(fr), th * tw), bool))
    blob_full, metrics_full = encode()
    assert metrics_full['ft_q_changed_frac'] == 1.0
    assert blob_dedup == blob_full
