"""The plain reference of GlobalTiling's KModes solve (b0nefish/tiler
kmodes.pas), and the gap between the program's clustering of a bin and
the reference's, by what merging each line into its cluster's winner
costs.

A bin is the 80-byte KModes lines of its tiles (64 palette indices, 16
zone flags; values below `m`) and its cluster count k. The dissimilarity
of two lines is (mismatched bytes << 11) + the sum of the bytes' absolute
differences. A solve starts farthest-first from one line, then alternates
modes (per byte the most frequent value, the smallest on a tie; an empty
cluster takes the line farthest in L1 from its own new mode) and
assignments (the first nearest mode) while the total dissimilarity falls
and some line moves, at most 100 times, and ends with one more mode
update and assignment. A cluster's winner is its member nearest its
mode, the last one on a tie. One start is the line with the smallest
byte sum (the last one on a tie); with N restarts the starts spread by
powers of n^(1/N) in float32, and the lowest total wins, the first on a
tie.

Everything is integer: the dissimilarities come from float64 matmuls of
one-hot and threshold encodings, whose every product and sum is an
integer far below 2^53. Plain torch on any device.
"""
from __future__ import annotations

import numpy as np
import torch

BITS = 11           # kmodes.pas: cDissimSubMatchingSize
MAX_ITERS = 100
# float64 elements of one block of the [n, k] dissimilarity matmul
BLOCK_ELEMS = 1 << 26


def golden_ratio_starts(n: int, count: int) -> list:
    """kmodes.pas:949-966: round(acc) - 1 for acc = 1, r, r^2, ... with
    r = n^(1/count) in Single (float32), each start above the one before."""
    r = np.float32(float(n) ** (1.0 / count))
    acc = np.float32(1.0)
    out = []
    for i in range(count):
        sp = int(np.round(acc)) - 1
        if i > 0 and sp <= out[-1]:
            sp = min(n - 1, out[-1] + 1)
        out.append(sp)
        acc = np.float32(acc * r)
    return out


class _Lines:
    """One bin's lines [n, A] and their encodings: one-hot [n, A*m] for
    the matches and thresholds [n, A*(m-1)] for the absolute differences."""

    def __init__(self, x: torch.Tensor, m: int):
        self.x = x.to(torch.int64)
        self.n, self.a = self.x.shape
        self.m = m
        self.onehot, self.thr = self.encode(self.x)
        self.thr_sum = self.thr.sum(1)

    def encode(self, v: torch.Tensor):
        t = torch.arange(self.m - 1, device=v.device)
        oh = torch.nn.functional.one_hot(v, self.m).to(torch.float64)
        th = (v[..., None] > t).to(torch.float64)
        return oh.reshape(len(v), -1), th.reshape(len(v), -1)

    def dissim(self, c: torch.Tensor) -> torch.Tensor:
        """[n, k] int64 dissimilarities of every line to the lines c."""
        coh, cthr = self.encode(c.to(torch.int64))
        out = torch.empty((self.n, len(c)), dtype=torch.int64,
                          device=self.x.device)
        step = max(1, BLOCK_ELEMS // max(1, len(c)))
        for lo in range(0, self.n, step):
            match = self.onehot[lo:lo + step] @ coh.T
            both = self.thr[lo:lo + step] @ cthr.T
            l1 = self.thr_sum[lo:lo + step, None] + cthr.sum(1)[None] \
                - 2.0 * both
            out[lo:lo + step] = ((self.a - match).round().to(torch.int64)
                                 << BITS) + l1.round().to(torch.int64)
        return out

    def dissim_to(self, rows: torch.Tensor) -> torch.Tensor:
        """[n] dissimilarity of line i to rows[i] ([n, A])."""
        r = rows.to(torch.int64)
        return ((self.x != r).sum(1) << BITS) + (self.x - r).abs().sum(1)


def _farthest_first(lines: _Lines, k: int, start: int) -> torch.Tensor:
    x = lines.x
    cents = torch.empty((k, lines.a), dtype=torch.int64, device=x.device)
    far = start
    mind = None
    for i in range(k):
        cents[i] = x[far]
        d = lines.dissim_to(x[far].expand_as(x))
        mind = d if mind is None else torch.minimum(mind, d)
        mind[far] = -1
        if i + 1 < k:
            far = int(torch.argmax(mind))      # the first farthest
    return cents


def _assign(lines: _Lines, cents: torch.Tensor):
    d = lines.dissim(cents)
    lab = torch.argmin(d, dim=1)               # the first nearest
    return lab, int(d.gather(1, lab[:, None]).sum())


def _modes(lines: _Lines, cents: torch.Tensor, lab: torch.Tensor):
    k = len(cents)
    counts = torch.zeros((k, lines.a * lines.m), dtype=torch.float64,
                         device=lines.x.device)
    counts.index_add_(0, lab, lines.onehot)
    counts = counts.reshape(k, lines.a, lines.m)
    # the smallest value among the most frequent
    new = torch.argmax(counts, dim=2)
    empty = counts[:, 0].sum(1) == 0
    if bool(empty.any()):
        l1 = (lines.x - new[lab]).abs().sum(1)
        worst = lines.x[int(torch.argmax(l1))]
        new[empty] = worst
    return new


def solve(x: torch.Tensor, k: int, start: int, m: int,
          max_iters: int = MAX_ITERS):
    """One KModes solve of the lines x [n, A] into k clusters from line
    `start`: (labels [n], winners [k] (-1: no member), total)."""
    lines = _Lines(x, m)
    cents = _farthest_first(lines, k, start)
    lab, cost = _assign(lines, cents)
    prev, moves, iters = None, 1, 0
    while (prev is None or cost < prev) and moves > 0 and iters < max_iters:
        new = _modes(lines, cents, lab)
        new_lab, new_cost = _assign(lines, new)
        moves = int((new_lab != lab).sum())
        cents, lab, prev, cost = new, new_lab, cost, new_cost
        iters += 1
    cents = _modes(lines, cents, lab)
    lab, cost = _assign(lines, cents)
    return lab, winners(lines, cents, lab), cost


def winners(lines: _Lines, cents: torch.Tensor, lab: torch.Tensor):
    """Per cluster the member nearest its mode, the last on a tie."""
    k = len(cents)
    d = lines.dissim_to(cents[lab])
    best = torch.full((k,), 2 ** 62, dtype=torch.int64, device=d.device)
    best.scatter_reduce_(0, lab, d, reduce='amin')
    idx = torch.arange(lines.n, device=d.device)
    win = torch.full((k,), -1, dtype=torch.int64, device=d.device)
    win.scatter_reduce_(0, lab, torch.where(d == best[lab], idx, -1),
                        reduce='amax')
    return win


def best_solve(x: torch.Tensor, k: int, restarts: int, m: int):
    """The bin's solve as the configuration states it: from the smallest
    byte sum's line (the last one), or best of `restarts` golden-ratio
    starts. Returns (labels, winners)."""
    if restarts > 0:
        starts = golden_ratio_starts(len(x), restarts)
    else:
        s = x.to(torch.int64).sum(1)
        starts = [int(torch.nonzero(s == s.min())[-1, 0])]
    best = None
    for st in starts:
        lab, win, cost = solve(x, k, st, m)
        if best is None or cost < best[2]:
            best = (lab, win, cost)
    return best[0], best[1]


def merge_cost(x: torch.Tensor, labels: torch.Tensor,
               win: torch.Tensor) -> float | None:
    """The total dissimilarity of each line to its cluster's winner, the
    line that GlobalTiling merges it into; None where a label or a winner
    is out of range or a winner is not a member of its own cluster."""
    x = x.to(torch.int64)
    labels = labels.to(device=x.device, dtype=torch.int64)
    win = win.to(device=x.device, dtype=torch.int64)
    k = len(win)
    if len(labels) != len(x) or int(labels.min()) < 0 \
            or int(labels.max()) >= k or int(win.max()) >= len(x):
        return None
    w = win[labels]
    if int(w.min()) < 0 or bool((labels[w] != labels).any()):
        return None
    r = x[w]
    return float(((x != r).sum(1) << BITS).sum() + (x - r).abs().sum())


def gap(x: torch.Tensor, k: int, restarts: int, m: int,
        labels: torch.Tensor, win: torch.Tensor) -> float:
    """By how much the merge cost of the program's clustering labels/win
    of the bin's lines x differs from the reference solve's, either way,
    as a share of the reference's: 0 where the program solves as the
    configuration states. An invalid clustering is a gap of inf."""
    ref_lab, ref_win = best_solve(x, k, restarts, m)
    ref = merge_cost(x, ref_lab, ref_win)
    prog = merge_cost(x, labels, win)
    if prog is None:
        return float('inf')
    return abs(prog - ref) / max(ref, 1.0)
