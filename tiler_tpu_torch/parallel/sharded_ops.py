"""Data-parallel sharded versions of the encoder's heavy device ops: the
counterpart of tiler_tpu/parallel/sharded_ops.py.

These shard the batch (tiles / cells / points) across the shards of a
mesh (parallel.mesh.make_mesh) and keep model-side state (centroids,
candidate sets) replicated, with the reductions the JAX package does
with psum written as explicit copies summed in shard order:

  - sharded_psyv_features : pure data parallel, no communication
  - sharded_kmeans        : local assign + summed (sums, counts) per
                            iteration
  - sharded_kmodes(_batch): points sharded, integer category counts summed
                            (bit-identical to the single-device solver)
  - sharded_nearest_1     : queries sharded, candidates replicated; K1
                            per shard on one Prepared set per device
  - sharded_unique        : hash-partitioned exact MakeUnique

Each function takes any mesh and runs on a 1-shard one too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import features
from ..pipeline.unique import dedupe_words, tile_words
from ..utils.dispatch import note
from .mesh import Mesh
from .mesh_pipeline import gather, map_rows, ranges, replicate, scatter


def sharded_psyv_features(mesh: Mesh, tiles_rgb: np.ndarray,
                          gamma_value=None, use_lab=False,
                          use_wavelets=False, q_weighting=False):
    """[N,8,8,3] u8 -> [N,192] f32 np with the batch sharded."""
    note('h2d', len(ranges(mesh, len(tiles_rgb))))
    note('d2h')
    return map_rows(mesh, features.psyv_features_rgb,
                    torch.from_numpy(np.ascontiguousarray(tiles_rgb)),
                    gamma_value, use_lab, use_wavelets,
                    q_weighting).cpu().numpy()


def _total(dev, parts: list) -> torch.Tensor:
    """The per-shard tensors summed in shard order on dev."""
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def sharded_kmeans(mesh: Mesh, feats: np.ndarray, k: int,
                   max_iters: int = 100, seed: int = 0x42381337):
    """Distributed Lloyd's k-means: features sharded, the per-cluster
    sums and counts of every shard summed in shard order each iteration
    (so the centroids may differ from one shard count to another in f32
    low bits; the labels of separated clusters do not). k-means++ seeds
    from the first 16384 rows. Returns (labels [N] i32, centroids [k,D]
    f32) as numpy."""
    from ..ops import prng
    from ..ops.kmeans import _plus_plus_init
    dev = mesh.flat[0]
    x = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
    note('h2d', 1 + len(ranges(mesh, len(x))))   # the seed rows, the shards
    sub = x[:16384].to(dev)
    cents = _plus_plus_init(sub, torch.sum(sub * sub, dim=1), k,
                            prng.prng_key(seed))
    parts = scatter(mesh, x)
    labels = None
    for _ in range(max_iters):
        labs, sums, counts = [], [], []
        for _, _, (xs,) in parts:
            c = cents.to(xs.device)
            d = (torch.sum(xs * xs, 1)[:, None]
                 + torch.sum(c * c, 1)[None, :] - 2.0 * (xs @ c.T))
            lab = torch.argmin(d, dim=1)
            onehot = torch.nn.functional.one_hot(lab, k).to(torch.float32)
            labs.append(lab)
            sums.append(onehot.T @ xs)
            counts.append(torch.sum(onehot, dim=0))
        sums, counts = _total(dev, sums), _total(dev, counts)
        labels = gather(mesh, labs)
        new_cents = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts, min=1.0)[:, None],
                                cents)
        note('d2h')
        moved = float(torch.sum(torch.abs(new_cents - cents)))
        cents = new_cents
        if moved == 0.0:
            break
    note('d2h', 2)
    return labels.to(torch.int32).cpu().numpy(), cents.cpu().numpy()


def sharded_kmodes_batch(mesh: Mesh, sigs: torch.Tensor, bins_sel: list,
                         bins_k: list, bins_start: list, n_modalities: int,
                         max_iters: int = 100, iters_out: list | None = None,
                         need_cents: bool = False):
    """ops.kmodes.kmodes_batch_gather with every solve's points sharded
    across the mesh: farthest-first init as a cross-shard first argmax
    (contiguous ordered shards, so the global first maximum), the
    integer category counts, member counts and costs summed across
    shards. Bit-identical to the single-device solver for any shard
    count (the SURVEY §5.8(b) centroid allreduce applied to the
    GlobalTiling clusterer, kmodes.pas:845-915)."""
    from ..ops.kmodes import kmodes_batch_gather
    return kmodes_batch_gather(sigs, bins_sel, bins_k, bins_start,
                               n_modalities, max_iters, iters_out,
                               need_cents, devices=mesh.flat)


def sharded_kmodes(mesh: Mesh, x: np.ndarray, k: int, start_point: int,
                   n_modalities: int, max_iters: int = 100):
    """One KModes problem, [n, A] uint8 rows into k groups, from row
    start_point (or |start_point| golden-ratio restarts when negative),
    points sharded. Returns (labels [n] int32, centroids [k, A] uint8)."""
    if not 0 < k <= len(x):
        raise ValueError(f'k={k} groups of {len(x)} rows')
    note('h2d')
    sigs = torch.from_numpy(np.ascontiguousarray(x, np.uint8)).to(
        mesh.flat[0])
    (labels, cents, _win), = sharded_kmodes_batch(
        mesh, sigs, [np.arange(len(x))], [k], [start_point], n_modalities,
        max_iters, need_cents=True)
    return labels.astype(np.int32), cents


def sharded_nearest_1(mesh: Mesh, queries: np.ndarray,
                      candidates: np.ndarray):
    """Exact 1-NN, queries sharded and candidates replicated: K1
    (ops.nn_kernels.nearest_1) per shard against one Prepared set per
    device. Returns (idx [Q] int32, err [Q] f32) as numpy."""
    from ..ops import nn_kernels
    note('h2d', 1 + len(ranges(mesh, len(queries))))
    note('d2h', 2)
    c = torch.from_numpy(np.ascontiguousarray(candidates, np.float32)).to(
        mesh.flat[0])
    idx, err = map_rows(mesh, nn_kernels.nearest_1, torch.from_numpy(
        np.ascontiguousarray(queries, np.float32)),
        replicate(mesh, c, nn_kernels.prepare))
    return idx.cpu().numpy(), err.cpu().numpy()


# -- distributed exact tile dedup (MakeUnique across the mesh) ------------

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h, c below 2^32, without overflowing
    int64: the product is formed from h's two 16-bit halves."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_words(words: torch.Tensor) -> torch.Tensor:
    """Cheap 32-bit mix of the [L,16] row words (Knuth multiplicative
    fold + final avalanche), in int64. Only bucket BALANCE depends on
    quality; the dedup is exact regardless: byte-equal rows always hash
    equal."""
    h = words[:, 0]
    for i in range(1, 16):
        h = _mul32(h, 2654435761) ^ words[:, i]
    h = h ^ (h >> 16)
    h = _mul32(h, 2246822519)
    return h ^ (h >> 13)


def _unique_count(tiles: torch.Tensor, idx: torch.Tensor, d: int):
    """The count half, on one shard: the words of rows idx, sorted
    (stably) by the shard their hash sends them to, and how many go to
    each of the d shards."""
    words = tile_words(tiles, idx)
    dst = _hash_words(words) % d
    order = torch.argsort(dst, stable=True)
    note('d2h', 2)      # bincount finds its length, then counts
    return words[order], idx[order], torch.bincount(dst, minlength=d)


def sharded_unique(mesh: Mesh, tiles_pal_dev: torch.Tensor, act: np.ndarray,
                   n_tiles: int):
    """Exact distributed MakeUnique: the active rows, cut into contiguous
    ranges, hash-partition across the shards (the exchange: each shard's
    rows for shard r copied to r, in source-shard order) and each shard
    dedups what it received with the single-device core, so per-shard
    work is ~A/D log A/D instead of A log A (the reference's tile-chunk
    MakeUnique fan-out, main.pas:933).

    Returns host (sidx, winner) pairs: winner = min tile index of each
    byte-equal group (CANONICAL: independent of the partitioning, so
    streams stay byte-identical to the single-device encode). n_tiles is
    the row count of the tiles (the JAX package's padding sentinel; no
    row here is padding)."""
    if len(act) and int(act.max()) >= n_tiles:
        raise ValueError(f'active row {int(act.max())} of {n_tiles} tiles')
    d = mesh.size
    tiles_rep = replicate(mesh, tiles_pal_dev)
    note('h2d', len(ranges(mesh, len(act))))
    sent = [(s, _unique_count(tiles_rep[dev], idx, d))
            for s, dev, (idx,) in scatter(
                mesh, torch.from_numpy(act.astype(np.int64)))]
    # the send counts of every (source, destination): one download a shard
    note('d2h', len(sent))
    bounds = {s: np.concatenate([[0], np.cumsum(c.cpu().numpy())])
              for s, (_, _, c) in sent}
    sidx, winner = [], []
    for r, dev in enumerate(mesh.flat):
        parts = [(w[bounds[s][r]:bounds[s][r + 1]].to(dev),
                  i[bounds[s][r]:bounds[s][r + 1]].to(dev))
                 for s, (w, i, _) in sent]
        w = torch.cat([p[0] for p in parts])
        if w.shape[0] == 0:
            continue
        i = torch.cat([p[1] for p in parts])
        sidx.append(i)
        # every byte-equal row landed on this shard: the single-device
        # dedup of what it received is globally exact
        winner.append(dedupe_words(w, i))
    if not sidx:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    note('d2h', 2)
    return (gather(mesh, sidx).cpu().numpy(),
            gather(mesh, winner).cpu().numpy())
