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
masked out of every argmin, argmax, count and cost. Nor on how a solve's
points are cut into contiguous ranges on several devices (a mesh's
shards, kmodes_batch_gather(devices=)): every cross-range reduction is
of integers, in range order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import DISSIM_SUB_MATCHING_BITS
from ..utils.dispatch import note

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


class _Shards:
    """The points of a batched solve as contiguous row ranges, one per
    device ([G, n_s, A] uint8 each, in row order): one range on one device
    is the plain solve, several are the mesh's (the JAX package's
    sharded_kmodes). Cross-range results come together on the first
    range's device, reduced in range order, and every reduction is of
    integers, so the solve gives the same bits however the points are cut.
    One range takes the direct index paths of the plain solve."""

    def __init__(self, xs: list, valid_ns: list):
        self.xs, self.valid = xs, valid_ns
        self.xi = [x.to(torch.int32) for x in xs]
        self.lo = np.cumsum([0] + [x.shape[1] for x in xs[:-1]]).tolist()
        self.dev = xs[0].device
        self.lanes = [torch.arange(x.shape[0], device=x.device) for x in xs]

    def total(self, parts: list) -> torch.Tensor:
        """Sum of per-range tensors, in range order, on the first device."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(self.dev)
        return out

    def cat(self, parts: list) -> torch.Tensor:
        """Per-range [G, n_s] tensors joined along the points."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.dev) for p in parts], dim=1)

    def _local(self, s: int, g: torch.Tensor):
        """Global point index g [G] as (clamped index into range s, owned)."""
        gl = g.to(self.xs[s].device) - self.lo[s]
        own = (gl >= 0) & (gl < self.xs[s].shape[1])
        return gl.clamp(0, self.xs[s].shape[1] - 1), own

    def fetch(self, g: torch.Tensor) -> torch.Tensor:
        """[G, A] uint8 point g[lane] of each lane, on the first device."""
        if len(self.xs) == 1:
            return self.xs[0][self.lanes[0], g]
        rows = []
        for s, x in enumerate(self.xs):
            gl, own = self._local(s, g)
            rows.append(torch.where(own[:, None], x[self.lanes[s], gl], 0))
        return self.total(rows)

    def mask(self, vals: list, g: torch.Tensor) -> None:
        """vals[s][lane, g[lane]] = -1 where range s owns point g[lane]."""
        if len(vals) == 1:
            note('h2d')     # the fill value
            vals[0][self.lanes[0], g] = -1
            return
        for s, v in enumerate(vals):
            gl, own = self._local(s, g)
            cur = torch.gather(v, 1, gl[:, None])[:, 0]
            v.scatter_(1, gl[:, None], torch.where(own, -1, cur)[:, None])

    def first_argmax(self, vals: list) -> torch.Tensor:
        """[G] global index of each lane's first maximum over all ranges."""
        if len(vals) == 1:
            return torch.argmax(vals[0], dim=1)
        best_v = best_i = None
        for s, v in enumerate(vals):
            li = torch.argmax(v, dim=1)
            bv = torch.gather(v, 1, li[:, None])[:, 0].to(self.dev)
            gi = (li + self.lo[s]).to(self.dev)
            if best_v is None:
                best_v, best_i = bv, gi
            else:
                take = bv > best_v          # an earlier range wins a tie
                best_v = torch.where(take, bv, best_v)
                best_i = torch.where(take, gi, best_i)
        return best_i


def _farthest_first(sh: _Shards, k: int, start):
    """Farthest-first centroids [G,k,A] (kmodes.pas:698-776)."""
    g, a = sh.xs[0].shape[0], sh.xs[0].shape[2]
    cents = torch.zeros((g, k, a), dtype=torch.uint8, device=sh.dev)
    far = start
    mind = None
    for i in range(k):
        p = sh.fetch(far)
        cents[:, i] = p
        nd = [_dis_to(xi, p.to(xi.device, torch.int32)) for xi in sh.xi]
        mind = [torch.where(v, d if m is None else torch.minimum(m, d), -1)
                for v, d, m in zip(sh.valid, nd, mind or [None] * len(nd))]
        sh.mask(mind, far)
        if i + 1 < k:
            far = sh.first_argmax(mind)          # first maximum
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
        note('d2h', 2)      # the mask's rows and their count
        counts.index_add_(0, ids[valid_n].reshape(-1),
                          torch.ones(int(valid_n.sum()) * a,
                                     dtype=torch.int32, device=dev))
        return counts.reshape(g, k, a, m)


def _solve(sh: _Shards, valid_k, start, m: int, max_iters: int):
    """One batched solve over the points of `sh`. Returns (labels [G,n],
    centroids [G,k,A], winner [G,k] (negative = empty cluster), iters
    [G], cost [G]), on the first range's device."""
    g, a = sh.xs[0].shape[0], sh.xs[0].shape[2]
    n = sum(x.shape[1] for x in sh.xs)
    k = valid_k.shape[1]
    dev = sh.dev
    cents = _farthest_first(sh, k, start)
    kind = _Encodings if _matmul_bytes(n, k, m, a) <= _SOLVE_BYTES \
        else _Broadcast
    encs = [kind(xi, m) for xi in sh.xi]
    vk = [valid_k.to(x.device) for x in sh.xs]
    krs = [torch.arange(k, device=x.device) for x in sh.xs]

    def assign(cents):
        out = [enc.assign(cents.to(v.device), v_k)        # first minimum
               for enc, v, v_k in zip(encs, sh.valid, vk)]
        # the exact total; the JAX package's normalized (hi, mid, lo)
        # int32 digit triple is its mixed-radix form, so they order alike
        cost = sh.total([torch.sum(torch.where(v, dmin, 0).long(), dim=1)
                         for v, (_, dmin) in zip(sh.valid, out)])
        return [lab for lab, _ in out], cost

    def update(cents, labels):
        lab1h = [(lab[:, :, None] == kr) & v[:, :, None]
                 for lab, kr, v in zip(labels, krs, sh.valid)]
        # category counts are integers below 2^24: exact in f32 however
        # the ranges are summed
        counts = sh.total([enc.counts(oh, lab, v) for enc, oh, lab, v in
                           zip(encs, lab1h, labels, sh.valid)])
        new_c = torch.argmax(counts, dim=3).to(torch.uint8)
        members = sh.total([torch.sum(oh, dim=1) for oh in lab1h])
        empty = (members == 0) & valid_k
        d_own = []
        for xi, lab, v in zip(sh.xi, labels, sh.valid):
            own = torch.gather(new_c.to(xi.device), 1,
                               lab[:, :, None].expand(-1, -1, a))
            d = torch.sum(torch.abs(xi - own.to(torch.int32)), dim=2,
                          dtype=torch.int32)
            d_own.append(torch.where(v, d, -1))
        worst = sh.fetch(sh.first_argmax(d_own))
        return torch.where(empty[:, :, None], worst[:, None, :], new_c)

    labels, cost = assign(cents)
    prev_cost = torch.full_like(cost, torch.iinfo(torch.int64).max)
    moves = torch.ones(g, dtype=torch.int64, device=dev)
    iters = torch.zeros(g, dtype=torch.int64, device=dev)
    active = torch.ones(g, dtype=torch.bool, device=dev)
    while True:
        active = active & (cost < prev_cost) & (moves > 0) \
            & (iters < max_iters)
        note('d2h')
        if not bool(active.any()):
            break
        new_cents = update(cents, labels)
        new_labels, new_cost = assign(new_cents)
        new_moves = sh.total([torch.sum((nl != lab) & v, dim=1) for
                              nl, lab, v in zip(new_labels, labels,
                                                sh.valid)])
        cents = torch.where(active[:, None, None], new_cents, cents)
        prev_cost = torch.where(active, cost, prev_cost)
        cost = torch.where(active, new_cost, cost)
        labels = [torch.where(active.to(nl.device)[:, None], nl, lab)
                  for nl, lab in zip(new_labels, labels)]
        moves = torch.where(active, new_moves, moves)
        iters = iters + active.long()
    cents = update(cents, labels)
    labels, cost = assign(cents)
    return sh.cat(labels), cents, _winner_from(sh, labels, cents), iters, \
        cost


def _winner_from(sh: _Shards, labels: list, cents):
    """Per-cluster winner: the member with the smallest dissimilarity to
    its centroid, LAST index on ties (kmodes.pas:598-612); -1 for a
    cluster with no members."""
    g, k, a = cents.shape
    ds, segs = [], []
    dmin = None
    for xi, lab, v in zip(sh.xi, labels, sh.valid):
        ci = torch.gather(cents.to(xi.device), 1,
                          lab[:, :, None].expand(-1, -1, a)).to(torch.int32)
        d = (torch.sum(xi != ci, dim=2, dtype=torch.int32) << _BITS) \
            + torch.sum(torch.abs(xi - ci), dim=2, dtype=torch.int32)
        d = torch.where(v, d, _BIG).long().reshape(-1)
        seg = (lab + k * torch.arange(g, device=xi.device)[:, None]) \
            .reshape(-1)
        part = torch.full((g * k,), _BIG, dtype=torch.int64, device=xi.device)
        part.scatter_reduce_(0, seg, d, reduce='amin')
        dmin = part.to(sh.dev) if dmin is None \
            else torch.minimum(dmin, part.to(sh.dev))
        ds.append(d)
        segs.append(seg)
    win = None
    for s, (d, seg, v) in enumerate(zip(ds, segs, sh.valid)):
        ismin = v.reshape(-1) & (d == dmin.to(d.device)[seg])
        iota = (torch.arange(v.shape[1], device=d.device)
                + sh.lo[s]).repeat(g)
        part = torch.full((g * k,), -1, dtype=torch.int64, device=d.device)
        part.scatter_reduce_(0, seg, torch.where(ismin, iota, -1),
                             reduce='amax')
        win = part.to(sh.dev) if win is None \
            else torch.maximum(win, part.to(sh.dev))
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
                        n_modalities: int, max_iters: int = _MAX_ITERS,
                        iters_out: list | None = None,
                        need_cents: bool = False, devices=None):
    """Solve one KModes problem per bin against the device signature
    matrix sigs [A_rows, A] uint8: bin i clusters rows bins_sel[i] into
    bins_k[i] groups, farthest-first from local row bins_start[i] >= 0,
    or, for bins_start[i] < 0, from each of |bins_start[i]| golden-ratio
    starts, the lowest-cost run winning (the first on a tie,
    kmodes.pas:1046-1053).

    Every (bin, start) pair is a lane; lanes are grouped into batched
    solves, smallest first, so that each solve's temporaries stay within
    _SOLVE_BYTES (_lane_bytes per lane at the solve's padded sizes).
    `devices` (a list of torch devices, the mesh's) cuts every solve's
    points into that many contiguous ranges, one on each device, with the
    same labels, centroids and winners as one range on sigs' device.

    Returns [(labels [n_i] int64 np, winner [k_i] np local member
    indices, negative for an empty cluster)], with the centroids [k_i, A]
    uint8 np between the two when need_cents."""
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
        note('h2d', 4)      # idxmat, valid_n, the starts and valid_k
        x = sigs[torch.from_numpy(idxmat).to(dev)]
        vn = torch.from_numpy(valid_n).to(dev)
        cuts = np.array_split(np.arange(n_pad), len(devices or [dev]))
        to = [d for d, c in zip(devices or [dev], cuts) if len(c)]
        cuts = [c for c in cuts if len(c)]
        sh = _Shards([x[:, c[0]:c[-1] + 1].to(d) for c, d in zip(cuts, to)],
                     [vn[:, c[0]:c[-1] + 1].to(d) for c, d in zip(cuts, to)])
        start = torch.tensor([exp_start[e] for e in lanes],
                             dtype=torch.int64, device=dev)
        labels, cents, winner, iters, cost = _solve(
            sh, torch.from_numpy(valid_k).to(dev), start, n_modalities,
            max_iters)
        note('d2h', 5)
        labels = labels.cpu().numpy()
        cents = cents.cpu().numpy()
        winner = winner.cpu().numpy()
        iters = iters.cpu().numpy()
        cost = cost.cpu().numpy()
        for j, (e, i) in enumerate(zip(lanes, bins)):
            results[e] = (labels[j, :len(bins_sel[i])],
                          cents[j, :bins_k[i]], winner[j, :bins_k[i]],
                          int(cost[j]))
            if iters_out is not None:
                iters_out.append((len(bins_sel[i]), bins_k[i],
                                  int(iters[j])))
    out: list = [None] * len(bins_sel)
    for e, i in enumerate(exp_bin):     # lanes in start order per bin
        if out[i] is None or results[e][3] < out[i][3]:
            out[i] = results[e]
    if need_cents:
        return [(lab, cen, win) for lab, cen, win, _cost in out]
    return [(lab, win) for lab, _cen, win, _cost in out]
