"""Batched KModes over uint8 tile signatures: the counterpart of the
GlobalTiling path of tiler_tpu/ops/kmodes.py (kmodes_batch_gather).

Every (bin, start) pair is a lane of one batched solve (the JAX
package's vmap written out as a leading dimension): farthest-first init,
then batch Lloyd-style iterations that stop per lane when the exact
integer cost stops improving or no point moves. A bin with restarts
gets one lane per golden-ratio start, and the lane with the lowest cost
wins, the first on a tie. The Hamming<<11 + L1 dissimilarity is one
batched f32 matmul of one-hot/threshold encodings; every operand and
partial sum is an integer below 2^24 (at most (A<<11) + 2A(M-1) for M up
to 256), exact in f32 on any device. A lane whose encodings alone would
not fit the solve budget (a large bin at many modalities) takes the
broadcast compare and absolute difference in int32 instead, a block of
centroids at a time, at A*16 bytes per point. On the card the matmul is
the faster of the two at every M measured (PERF.md). Labels and winners
are byte-identical to the JAX package either way. Results do not depend
on how lanes are grouped into solves: padded points and centroids are
masked out of every argmin, argmax, count and cost.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tiler_tpu.constants import DISSIM_SUB_MATCHING_BITS

_BIG = 2 ** 30
_BITS = DISSIM_SUB_MATCHING_BITS
_MAX_ITERS = 100
# bytes of device temporaries per batched solve (~400,000 padded points
# at A=80, M=16)
_SOLVE_BYTES = 8 << 30
# broadcast dissimilarity: int32 elements of one centroid block's
# [lanes, points, block, A] compare
_BLOCK_ELEMS = 1 << 27


def _matmul_bytes(n_pad: int, k_pad: int, m: int, a: int) -> int:
    """Device bytes one lane of the matmul path holds: per padded point,
    the f32 one-hot and threshold encodings and their concatenation
    (A*(4M-2) floats); per cluster, the [A, M] category counts."""
    return n_pad * 4 * a * (4 * m - 2) + k_pad * a * m * 4


def _lane_bytes(n_pad: int, k_pad: int, m: int, a: int) -> int:
    """Device bytes one lane of a solve holds: the matmul path's when one
    lane of it fits _SOLVE_BYTES, else the broadcast path's (per padded
    point the int32 point and its running minimum, A*16 bytes, as the JAX
    package budgets its broadcast path)."""
    mm = _matmul_bytes(n_pad, k_pad, m, a)
    return mm if mm <= _SOLVE_BYTES else n_pad * a * 16 + k_pad * a * m * 4


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
    """The matmul path: point-side one-hot/threshold encodings, built
    once per solve: d = (A<<BITS) + sum(thr_x) + sum(thr_c) - X @ C.T
    with X = [onehot(x), thr(x)] and C = [onehot(c)<<BITS, 2*thr(c)]."""

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

    def assign(self, cents: torch.Tensor, valid_k):
        """(labels [G,n], their dissimilarities [G,n]): first minimum."""
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
        d = torch.where(valid_k[:, None, :], d, _BIG)
        lab = torch.argmin(d, dim=2)
        return lab, torch.gather(d, 2, lab[:, :, None])[:, :, 0]

    def counts(self, lab1h: torch.Tensor, labels, valid_n) -> torch.Tensor:
        """[G,k,A,M] category counts of the members lab1h [G,n,k] bool."""
        g, _, k = lab1h.shape
        return torch.bmm(lab1h.to(torch.float32).transpose(1, 2),
                         self.ex).reshape(g, k, self.a, self.m)


class _Broadcast:
    """The broadcast path, for lanes too large for the matmul's
    encodings (the JAX package's dissim_matrix and segment-sum update):
    the int32 Hamming<<11 + L1 of every point against a block of
    centroids at a time, keeping a running first minimum, so only the
    points and [G,n] minima stay resident."""

    def __init__(self, xi: torch.Tensor, m: int):
        self.xi, self.m = xi, m

    def assign(self, cents: torch.Tensor, valid_k):
        g, n, a = self.xi.shape
        k = cents.shape[1]
        ci = cents.to(torch.int32)
        block = max(1, _BLOCK_ELEMS // max(1, g * n * a))
        best = torch.full((g, n), _BIG + 1, dtype=torch.int32,
                          device=self.xi.device)
        lab = torch.zeros((g, n), dtype=torch.int64, device=self.xi.device)
        for k0 in range(0, k, block):
            c = ci[:, None, k0:k0 + block, :]
            x = self.xi[:, :, None, :]
            d = (torch.sum(x != c, dim=3, dtype=torch.int32) << _BITS) \
                + torch.sum(torch.abs(x - c), dim=3, dtype=torch.int32)
            d = torch.where(valid_k[:, None, k0:k0 + block], d, _BIG)
            j = torch.argmin(d, dim=2)
            v = torch.gather(d, 2, j[:, :, None])[:, :, 0]
            take = v < best                    # earlier block wins a tie
            best = torch.where(take, v, best)
            lab = torch.where(take, j + k0, lab)
        return lab, best

    def counts(self, lab1h: torch.Tensor, labels, valid_n) -> torch.Tensor:
        """[G,k,A,M] category counts of the valid points' labels, by an
        integer scatter-add (order-free, so exact on any device)."""
        g, n, k = lab1h.shape
        a, m = self.xi.shape[2], self.m
        dev = labels.device
        ids = ((labels[:, :, None] * a + torch.arange(a, device=dev)) * m
               + self.xi.long()
               + (torch.arange(g, device=dev) * (k * a * m))[:, None, None])
        counts = torch.zeros(g * k * a * m, dtype=torch.int32, device=dev)
        counts.index_add_(0, ids[valid_n].reshape(-1),
                          torch.ones(int(valid_n.sum()) * a,
                                     dtype=torch.int32, device=dev))
        return counts.reshape(g, k, a, m)


def _solve(x: torch.Tensor, valid_n, valid_k, start, m: int):
    """One batched solve: x [G,n,A] uint8. Returns (labels [G,n],
    winner [G,k] (negative = empty cluster), iters [G], cost [G])."""
    g, n, a = x.shape
    k = valid_k.shape[1]
    lanes = torch.arange(g, device=x.device)
    xi = x.to(torch.int32)
    cents = _farthest_first(x, xi, k, valid_n, start)
    enc = _Encodings(xi, m) if _matmul_bytes(n, k, m, a) <= _SOLVE_BYTES \
        else _Broadcast(xi, m)
    kr = torch.arange(k, device=x.device)

    def assign(cents):
        lab, dmin = enc.assign(cents, valid_k)       # first minimum
        # the exact total; the JAX package's normalized (hi, mid, lo)
        # int32 digit triple is its mixed-radix form, so they order alike
        cost = torch.sum(torch.where(valid_n, dmin, 0).long(), dim=1)
        return lab, cost

    def update(cents, labels):
        lab1h = (labels[:, :, None] == kr) & valid_n[:, :, None]
        new_c = torch.argmax(enc.counts(lab1h, labels, valid_n), dim=3) \
            .to(torch.uint8)
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
    labels, cost = assign(cents)
    return labels, _winner_from(x, xi, valid_n, labels, cents), iters, cost


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


def golden_ratio_starts(n: int, num_init: int) -> list[int]:
    """Multi-restart starting points spread by repeated multiplication
    with n^(1/num_init) (kmodes.pas:949-966): strictly increasing,
    clamped to [0, n-1]; float32 accumulation as in the reference's
    Single math and the JAX package."""
    inv = np.float32(float(n) ** (1.0 / num_init))
    acc = np.float32(1.0)
    out: list[int] = []
    for i in range(num_init):
        sp = int(np.round(acc)) - 1  # round half to even, as Pascal Round
        if i > 0 and sp <= out[-1]:
            sp = min(n - 1, out[-1] + 1)
        out.append(sp)
        acc = np.float32(acc * inv)
    return out


def kmodes_batch_gather(sigs: torch.Tensor, bins_sel: list[np.ndarray],
                        bins_k: list[int], bins_start: list[int],
                        n_modalities: int, iters_out: list | None = None):
    """Solve one KModes problem per bin against the device signature
    matrix sigs [A_rows, A] uint8: bin i clusters rows bins_sel[i] into
    bins_k[i] groups, farthest-first from local row bins_start[i] >= 0,
    or, for bins_start[i] < 0, from each of |bins_start[i]| golden-ratio
    starts, the lowest-cost run winning (the first on a tie,
    kmodes.pas:1046-1053).

    Every (bin, start) pair is a lane; lanes are grouped into batched
    solves, smallest first, so that each solve's temporaries stay within
    _SOLVE_BYTES (_lane_bytes per lane at the solve's padded sizes).

    Returns [(labels [n_i] int64 np, winner [k_i] np local member
    indices, negative for an empty cluster)]."""
    dev = sigs.device
    a = int(sigs.shape[1])
    exp_bin, exp_start = [], []
    for i, st in enumerate(bins_start):
        starts = [st] if st >= 0 else golden_ratio_starts(
            len(bins_sel[i]), -st)
        exp_bin += [i] * len(starts)
        exp_start += starts
    order = sorted(range(len(exp_bin)),
                   key=lambda e: len(bins_sel[exp_bin[e]]))
    chunks, cur, k_max = [], [], 0
    for e in order:
        n_e, k_e = len(bins_sel[exp_bin[e]]), bins_k[exp_bin[e]]
        if cur and (len(cur) + 1) * _lane_bytes(
                n_e, max(k_max, k_e), n_modalities, a) > _SOLVE_BYTES:
            chunks.append(cur)
            cur, k_max = [], 0
        cur.append(e)
        k_max = max(k_max, k_e)
    if cur:
        chunks.append(cur)
    results: list = [None] * len(exp_bin)
    for lanes in chunks:
        bins = [exp_bin[e] for e in lanes]
        n_pad = max(len(bins_sel[i]) for i in bins)
        k_pad = max(bins_k[i] for i in bins)
        g = len(lanes)
        idxmat = np.zeros((g, n_pad), np.int64)
        valid_n = np.zeros((g, n_pad), bool)
        valid_k = np.zeros((g, k_pad), bool)
        for j, i in enumerate(bins):
            idxmat[j, :len(bins_sel[i])] = bins_sel[i]
            valid_n[j, :len(bins_sel[i])] = True
            valid_k[j, :bins_k[i]] = True
        x = sigs[torch.from_numpy(idxmat).to(dev)]
        start = torch.tensor([exp_start[e] for e in lanes],
                             dtype=torch.int64, device=dev)
        labels, winner, iters, cost = _solve(
            x, torch.from_numpy(valid_n).to(dev),
            torch.from_numpy(valid_k).to(dev), start, n_modalities)
        labels = labels.cpu().numpy()
        winner = winner.cpu().numpy()
        iters = iters.cpu().numpy()
        cost = cost.cpu().numpy()
        for j, (e, i) in enumerate(zip(lanes, bins)):
            results[e] = (labels[j, :len(bins_sel[i])],
                          winner[j, :bins_k[i]], int(cost[j]))
            if iters_out is not None:
                iters_out.append((len(bins_sel[i]), bins_k[i],
                                  int(iters[j])))
    out: list = [None] * len(bins_sel)
    for e, i in enumerate(exp_bin):     # lanes in start order per bin
        if out[i] is None or results[e][2] < out[i][2]:
            out[i] = results[e]
    return [(lab, win) for lab, win, _cost in out]
