"""The plain reference of FrameTiling's stage 1 (the marking) and of the
candidate list that stage 2 computes features for: upstream's UseOne and
BuildPaletteCorrTriangle (b0nefish/tiler main.pas:3802-3853, 3855-3867;
SURVEY.md section 2) in plain torch, on any device.

- dataset(tiles_pal, active): every active tile's PalPixels (its 64
  palette indices) in each of its four mirrors, the global dataset of
  PrepareGlobalFT (main.pas:3736-3780);
- knn8(queries, ds): the exact 8 nearest dataset rows of each query in
  float64, ascending by (distance, row), with UseOne's consecutive-equal
  skip (main.pas:3832-3837): a neighbour at the same distance as the one
  before it marks nothing;
- mark(...): the used [P, 4A] matrix. Each cell of the keyframe marks its
  kept neighbours under its own palette; FAST keeps that, SLOW (ftSlow)
  uses every palette for every marked entry, MEDIUM uses palette j for
  the entries palette q marked where the squared distance of their
  centroids is under ft_palette_tol times the largest (APalTol,
  main.pas:3843-3847);
- candidates(used, tile_of, attrs_of): the (palette, tile, attrs) of each
  used entry in row-major order of `used`.

PalPixels are integers in [0, 255], so every squared distance is an
integer under 64 * 255^2 < 2^24 and exact in float64: a port's marks and
candidate lists compare with it exactly. Stage 3 is reference/nn.py; the
PsyV features are not derived again here.

Departures from upstream, each on purpose:
- upstream searches ANN's kd-tree (ann_kdtree_search_multi), which may
  return approximate neighbours; this is the exact 8-NN, as the port and
  the JAX package compute it;
- among equal distances the lower dataset row comes first; upstream's
  order there is the tree's;
- the dataset holds each tile's mirrors in the order attrs 0, 1, 3, 2
  (attrs = h | v << 1: none, h, both, v);
- with fewer than 8 dataset rows every row is a neighbour (the JAX
  package fails there);
- MEDIUM's centroid distances are computed once per keyframe in float64
  from the keyframe's palette centroids; a palette with no centroid (NaN)
  is near none.
"""
from __future__ import annotations

import torch

# as the benchmark's other references run: float32 products not in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

K = 8
ATTRS = (0, 1, 3, 2)        # the dataset's mirror order per tile
# the float64 distances of one block of dataset rows stay under 1 GiB
BLOCK_ELEMS = 1 << 27


def _quality(q) -> str:
    return getattr(q, 'name', q)


def dataset(tiles_pal: torch.Tensor, active: torch.Tensor):
    """tiles_pal [T, 8, 8] palette indices, active bool [T] -> (ds [4A, 64]
    float64, tile_of [4A] int64, attrs_of [4A] int64): each active tile's
    four mirrors in the order ATTRS (bit 0 mirrors the columns, bit 1 the
    rows)."""
    act = torch.nonzero(active.bool(), as_tuple=True)[0].to(tiles_pal.device)
    t = tiles_pal[act].double()
    variants = []
    for a in ATTRS:
        v = t
        if a & 1:
            v = v.flip(2)
        if a & 2:
            v = v.flip(1)
        variants.append(v.reshape(len(act), -1))
    ds = torch.stack(variants, dim=1).reshape(4 * len(act), -1)
    tile_of = act.repeat_interleave(4)
    attrs_of = torch.tensor(ATTRS, dtype=torch.int64,
                            device=act.device).repeat(len(act))
    return ds, tile_of, attrs_of


def knn8(queries: torch.Tensor, ds: torch.Tensor, k: int = K):
    """(idx [Q, k'] int64, keep [Q, k'] bool), k' = min(k, len(ds)): the
    nearest dataset rows of each query by squared L2 in float64, ascending
    by (distance, row); keep[:, j] is False where row j's distance equals
    row j-1's."""
    q = queries.reshape(len(queries), -1).double()
    c = ds.double()
    k = min(k, len(c))
    q2 = (q * q).sum(1)
    c2 = (c * c).sum(1)
    best_d = q.new_empty((len(q), 0))
    best_i = torch.empty((len(q), 0), dtype=torch.int64, device=q.device)
    block = max(K, BLOCK_ELEMS // max(len(q), 1))
    for lo in range(0, len(c), block):
        hi = min(len(c), lo + block)
        d = q2[:, None] + c2[None, lo:hi] - 2.0 * (q @ c[lo:hi].T)
        d, i = torch.sort(d, dim=1, stable=True)
        # the best so far hold lower rows: first, so a stable sort keeps
        # them ahead of this block's rows at an equal distance
        d = torch.cat([best_d, d[:, :k]], dim=1)
        i = torch.cat([best_i, i[:, :k] + lo], dim=1)
        d, order = torch.sort(d, dim=1, stable=True)
        best_d, best_i = d[:, :k], torch.gather(i, 1, order[:, :k])
    keep = torch.ones_like(best_i, dtype=torch.bool)
    keep[:, 1:] = best_d[:, 1:] != best_d[:, :-1]
    return best_i, keep


def palette_near(centroids: torch.Tensor, tol: float) -> torch.Tensor:
    """[P, P] bool: the squared distance of centroids q and j under tol
    times the largest finite one (BuildPaletteCorrTriangle, APalTol)."""
    c = centroids.double()
    d = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    finite = d[torch.isfinite(d)]
    highest = finite.max() if finite.numel() else d.new_zeros(())
    return d < tol * highest


def mark(quality, cell_pal: torch.Tensor, cell_nn: torch.Tensor,
         cell_keep: torch.Tensor, n_pal: int, n_ds: int,
         centroids: torch.Tensor | None = None,
         tol: float | None = None) -> torch.Tensor:
    """used bool [n_pal, n_ds] of one keyframe for `quality` ('FAST',
    'MEDIUM', 'SLOW' or an enum of those names): cell_pal [N] is each
    cell's palette, cell_nn / cell_keep [N, k] its tile's knn8. MEDIUM
    needs the keyframe's centroids [n_pal, 3] and ft_palette_tol."""
    quality = _quality(quality)
    dev = cell_nn.device
    marked = torch.zeros((n_pal, n_ds), dtype=torch.bool, device=dev)
    pal = cell_pal.to(dev, torch.int64)[:, None].expand_as(cell_nn)
    marked[pal[cell_keep], cell_nn[cell_keep]] = True
    if quality == 'FAST':
        return marked
    if quality == 'SLOW':
        return marked.any(0)[None, :].expand(n_pal, n_ds).clone()
    if quality != 'MEDIUM':
        raise ValueError(f'unknown FT quality {quality!r}')
    near = palette_near(centroids, tol).to(dev)
    used = torch.zeros_like(marked)
    for q in range(n_pal):
        if marked[q].any():
            used[near[q]] |= marked[q]
    return used


def candidates(used: torch.Tensor, tile_of: torch.Tensor,
               attrs_of: torch.Tensor):
    """(palette [C], tile [C], attrs [C]) int64 of the used entries, in
    row-major order of used [P, 4A]."""
    pal, entry = torch.nonzero(used, as_tuple=True)
    entry = entry.to(tile_of.device)
    return pal, tile_of[entry], attrs_of[entry]


def keyframe(qualities, tm_tile: torch.Tensor, tm_pal: torch.Tensor,
             tiles_pal: torch.Tensor, active: torch.Tensor, n_pal: int,
             centroids: torch.Tensor | None = None,
             tol: float | None = None):
    """Stage 1 of one keyframe from the tilemap before FrameTiling
    (tm_tile, tm_pal: the keyframe's frames' tile and palette per cell),
    at each of `qualities` over one knn8: ({quality: used [n_pal, 4A]},
    tile_of, attrs_of); candidates() lists each."""
    ds, tile_of, attrs_of = dataset(tiles_pal, active)
    tiles, inv = torch.unique(tm_tile.reshape(-1).to(torch.int64),
                              return_inverse=True)
    idx, keep = knn8(tiles_pal[tiles.to(tiles_pal.device)], ds)
    inv = inv.to(idx.device)
    used = {_quality(q): mark(q, tm_pal.reshape(-1), idx[inv], keep[inv],
                              n_pal, len(ds), centroids, tol)
            for q in qualities}
    return used, tile_of, attrs_of
