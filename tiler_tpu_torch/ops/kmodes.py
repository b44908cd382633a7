"""Batched KModes over uint8 tile signatures: the counterpart of the
GlobalTiling path of tiler_tpu/ops/kmodes.py (kmodes_batch_gather with
a single computed start per bin; restarts are not ported yet).

Every bin is a lane of one batched solve (the JAX package's vmap written
out as a leading dimension): farthest-first init, then batch Lloyd-style
iterations that stop per lane when the exact integer cost stops
improving or no point moves. The Hamming<<11 + L1 dissimilarity is one
batched f32 matmul of one-hot/threshold encodings; every operand and
partial sum is a small integer, exact in f32 on any device, so labels and
winners are byte-identical to the JAX package. Results do not depend on
how bins are grouped into lanes: padded points and centroids are masked
out of every argmin, argmax, count and cost.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tiler_tpu.constants import DISSIM_SUB_MATCHING_BITS

_BIG = 2 ** 30
_BITS = DISSIM_SUB_MATCHING_BITS
_MAX_ITERS = 100
# lanes x padded points per batched solve: the point-side encodings take
# ~10 KB per padded point, so this bounds them at ~4 GB
_POINT_BUDGET = 400_000


def _dis_to(xi: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[G,n,A] int32 points vs one [G,A] point per lane -> [G,n]."""
    d = torch.sum(xi != p[:, None, :], dim=2, dtype=torch.int32)
    l1 = torch.sum(torch.abs(xi - p[:, None, :]), dim=2, dtype=torch.int32)
    return (d << _BITS) + l1


def _farthest_first(x, xi, k: int, valid_n, start):
    """Farthest-first centroids [G,k,A] (kmodes.pas:698-776)."""
    g = x.shape[0]
    lanes = torch.arange(g, device=x.device)
    cents = torch.zeros((g, k, x.shape[2]), dtype=torch.uint8,
                        device=x.device)
    cents[:, 0] = x[lanes, start]
    mind = torch.where(valid_n, _dis_to(xi, xi[lanes, start]), -1)
    mind[lanes, start] = -1
    for i in range(1, k):
        far = torch.argmax(mind, dim=1)          # first maximum
        cents[:, i] = x[lanes, far]
        nd = _dis_to(xi, xi[lanes, far])
        mind = torch.where(valid_n, torch.minimum(mind, nd), -1)
        mind[lanes, far] = -1
    return cents


class _Encodings:
    """Point-side one-hot/threshold encodings, built once per solve:
    d = (A<<BITS) + sum(thr_x) + sum(thr_c) - X @ C.T with
    X = [onehot(x), thr(x)] and C = [onehot(c)<<BITS, 2*thr(c)]."""

    def __init__(self, xi: torch.Tensor, m: int):
        g, n, a = xi.shape
        self.a, self.m = a, m
        self.thr = torch.arange(m - 1, device=xi.device)
        self.ex = F.one_hot(xi.long(), m).to(torch.float32).reshape(
            g, n, a * m)
        gx = (xi[..., None] > self.thr).to(torch.float32).reshape(
            g, n, a * (m - 1))
        self.gx_sum = torch.sum(gx, dim=2)
        self.x_cat = torch.cat([self.ex, gx], dim=2)

    def dissim(self, cents: torch.Tensor, valid_k) -> torch.Tensor:
        g, k, a = cents.shape
        ci = cents.long()
        ec = F.one_hot(ci, self.m).to(torch.float32).reshape(
            g, k, a * self.m) * float(1 << _BITS)
        gc = (ci[..., None] > self.thr).to(torch.float32).reshape(
            g, k, a * (self.m - 1)) * 2.0
        dot = torch.bmm(self.x_cat, torch.cat([ec, gc], dim=2)
                        .transpose(1, 2))
        gc_sum = torch.sum(gc, dim=2) * 0.5
        d = (float(a << _BITS) + self.gx_sum[:, :, None]
             + gc_sum[:, None, :] - dot).to(torch.int32)
        return torch.where(valid_k[:, None, :], d, _BIG)


def _solve(x: torch.Tensor, valid_n, valid_k, start, m: int):
    """One batched solve: x [G,n,A] uint8. Returns (labels [G,n],
    winner [G,k] (negative = empty cluster), iters [G])."""
    g, n, a = x.shape
    k = valid_k.shape[1]
    lanes = torch.arange(g, device=x.device)
    xi = x.to(torch.int32)
    cents = _farthest_first(x, xi, k, valid_n, start)
    enc = _Encodings(xi, m)
    kr = torch.arange(k, device=x.device)

    def assign(cents):
        d = enc.dissim(cents, valid_k)
        lab = torch.argmin(d, dim=2)                 # first minimum
        dmin = torch.gather(d, 2, lab[:, :, None])[:, :, 0]
        # the exact total; the JAX package's normalized (hi, mid, lo)
        # int32 digit triple is its mixed-radix form, so they order alike
        cost = torch.sum(torch.where(valid_n, dmin, 0).long(), dim=1)
        return lab, cost

    def update(cents, labels):
        lab1h = ((labels[:, :, None] == kr) & valid_n[:, :, None]
                 ).to(torch.float32)
        counts = torch.bmm(lab1h.transpose(1, 2), enc.ex).reshape(
            g, k, a, m)
        new_c = torch.argmax(counts, dim=3).to(torch.uint8)
        empty = (torch.sum(lab1h, dim=1) == 0) & valid_k
        own = torch.gather(new_c, 1, labels[:, :, None].expand(-1, -1, a))
        d_own = torch.sum(torch.abs(xi - own.to(torch.int32)), dim=2,
                          dtype=torch.int32)
        worst = torch.argmax(torch.where(valid_n, d_own, -1), dim=1)
        return torch.where(empty[:, :, None], x[lanes, worst][:, None, :],
                           new_c)

    labels, cost = assign(cents)
    prev_cost = torch.full_like(cost, torch.iinfo(torch.int64).max)
    moves = torch.ones(g, dtype=torch.int64, device=x.device)
    iters = torch.zeros(g, dtype=torch.int64, device=x.device)
    active = torch.ones(g, dtype=torch.bool, device=x.device)
    while True:
        active = active & (cost < prev_cost) & (moves > 0) \
            & (iters < _MAX_ITERS)
        if not bool(active.any()):
            break
        new_cents = update(cents, labels)
        new_labels, new_cost = assign(new_cents)
        new_moves = torch.sum((new_labels != labels) & valid_n, dim=1)
        cents = torch.where(active[:, None, None], new_cents, cents)
        prev_cost = torch.where(active, cost, prev_cost)
        cost = torch.where(active, new_cost, cost)
        labels = torch.where(active[:, None], new_labels, labels)
        moves = torch.where(active, new_moves, moves)
        iters = iters + active.long()
    cents = update(cents, labels)
    labels, _ = assign(cents)
    return labels, _winner_from(x, xi, valid_n, labels, cents), iters


def _winner_from(x, xi, valid_n, labels, cents):
    """Per-cluster winner: the member with the smallest dissimilarity to
    its centroid, LAST index on ties (kmodes.pas:598-612); -1 for a
    cluster with no members."""
    g, n, a = x.shape
    k = cents.shape[1]
    ci = torch.gather(cents, 1, labels[:, :, None].expand(-1, -1, a))
    ci = ci.to(torch.int32)
    d = (torch.sum(xi != ci, dim=2, dtype=torch.int32) << _BITS) \
        + torch.sum(torch.abs(xi - ci), dim=2, dtype=torch.int32)
    d = torch.where(valid_n, d, _BIG).long()
    seg = (labels + k * torch.arange(g, device=x.device)[:, None]).reshape(-1)
    dmin = torch.full((g * k,), _BIG, dtype=torch.int64, device=x.device)
    dmin.scatter_reduce_(0, seg, d.reshape(-1), reduce='amin')
    ismin = valid_n.reshape(-1) & (d.reshape(-1) == dmin[seg])
    iota = torch.arange(n, device=x.device).repeat(g)
    win = torch.full((g * k,), -1, dtype=torch.int64, device=x.device)
    win.scatter_reduce_(0, seg, torch.where(ismin, iota, -1), reduce='amax')
    return win.reshape(g, k)


def kmodes_batch_gather(sigs: torch.Tensor, bins_sel: list[np.ndarray],
                        bins_k: list[int], bins_start: list[int],
                        n_modalities: int, iters_out: list | None = None):
    """Solve one KModes problem per bin against the device signature
    matrix sigs [A_rows, 80] uint8: bin i clusters rows bins_sel[i] into
    bins_k[i] groups, farthest-first from local row bins_start[i] (>= 0).

    Bins are grouped into lanes of one batched solve, smallest first, so
    that lanes x padded points stay within _POINT_BUDGET.

    Returns [(labels [n_i] int64 np, winner [k_i] np local member
    indices, negative for an empty cluster)]."""
    if n_modalities > 32:
        raise NotImplementedError('the matmul dissimilarity needs <= 32 '
                                  'modalities')
    if any(s < 0 for s in bins_start):
        raise NotImplementedError('KModes restarts are not ported')
    dev = sigs.device
    b = len(bins_sel)
    out: list = [None] * b
    order = sorted(range(b), key=lambda i: len(bins_sel[i]))
    chunks, cur = [], []
    for i in order:
        if cur and (len(cur) + 1) * len(bins_sel[i]) > _POINT_BUDGET:
            chunks.append(cur)
            cur = []
        cur.append(i)
    if cur:
        chunks.append(cur)
    for lanes in chunks:
        n_pad = max(len(bins_sel[i]) for i in lanes)
        k_pad = max(bins_k[i] for i in lanes)
        g = len(lanes)
        idxmat = np.zeros((g, n_pad), np.int64)
        valid_n = np.zeros((g, n_pad), bool)
        valid_k = np.zeros((g, k_pad), bool)
        for j, i in enumerate(lanes):
            idxmat[j, :len(bins_sel[i])] = bins_sel[i]
            valid_n[j, :len(bins_sel[i])] = True
            valid_k[j, :bins_k[i]] = True
        x = sigs[torch.from_numpy(idxmat).to(dev)]
        start = torch.tensor([bins_start[i] for i in lanes],
                             dtype=torch.int64, device=dev)
        labels, winner, iters = _solve(
            x, torch.from_numpy(valid_n).to(dev),
            torch.from_numpy(valid_k).to(dev), start, n_modalities)
        labels = labels.cpu().numpy()
        winner = winner.cpu().numpy()
        iters = iters.cpu().numpy()
        for j, i in enumerate(lanes):
            out[i] = (labels[j, :len(bins_sel[i])], winner[j, :bins_k[i]])
            if iters_out is not None:
                iters_out.append((len(bins_sel[i]), bins_k[i],
                                  int(iters[j])))
    return out
