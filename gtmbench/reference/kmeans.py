"""The plain reference of Dither's palette clustering: Lloyd's k-means
with k-means++ seeding of a keyframe's tile features into the palette
count's groups, in float64. Two numbers judge the program's grouping:
the gap by which it costs more than the reference's, and the share of
its cost that one more Lloyd step would take off (none where the program
ran Lloyd's iterations to their end).

The cost of a grouping is the sum over rows of the squared distance to
the mean of the row's group. k-means++ draws its first centre uniformly
and each next one with probability proportional to the squared distance
to the nearest centre so far; Lloyd's iterations then move every row to
the first nearest centre and every centre to its group's mean (an empty
group keeps its centre) until no row moves, at most 100 times. The draws
come from a torch.Generator seeded with the run's seed, so the reference
finds a local optimum of its own, not the program's. Plain torch on any
device.
"""
from __future__ import annotations

import torch

MAX_ITERS = 100


def _sqdist(x: torch.Tensor, x2: torch.Tensor, c: torch.Tensor):
    return (x2[:, None] + (c * c).sum(1)[None] - 2.0 * (x @ c.T)) \
        .clamp(min=0.0)


def _means(x: torch.Tensor, labels: torch.Tensor, k: int, old=None):
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, labels, x)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    means = sums / counts.clamp(min=1.0)[:, None]
    if old is not None:
        means = torch.where((counts == 0)[:, None], old, means)
    return means


def kmeans(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """Labels [n] of the reference's k-means of the rows x [n, D]."""
    x = x.to(torch.float64)
    n = len(x)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed) % (1 << 63))
    first = int(torch.randint(n, (1,), generator=gen, device=x.device))
    cents = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    d2 = ((x - x[first]) ** 2).sum(1)
    for i in range(1, k):
        w = d2 if float(d2.sum()) > 0 else torch.ones_like(d2)
        j = torch.multinomial(w, 1, generator=gen)
        cents[i] = x[j[0]]
        d2 = torch.minimum(d2, ((x - x[j]) ** 2).sum(1))
    x2 = (x * x).sum(1)
    labels = torch.argmin(_sqdist(x, x2, cents), dim=1)
    for _ in range(MAX_ITERS):
        cents = _means(x, labels, k, cents)
        new = torch.argmin(_sqdist(x, x2, cents), dim=1)
        if bool((new == labels).all()):
            break
        labels = new
    return labels


def cost(x: torch.Tensor, labels: torch.Tensor, k: int) -> float | None:
    """The grouping's cost in float64; None for a label outside 0..k-1."""
    x = x.to(torch.float64)
    labels = labels.to(device=x.device, dtype=torch.int64)
    if len(labels) != len(x) or int(labels.min()) < 0 \
            or int(labels.max()) >= k:
        return None
    return float(((x - _means(x, labels, k)[labels]) ** 2).sum())


def gap(x: torch.Tensor, k: int, labels: torch.Tensor, seed: int):
    """By how much the program's grouping `labels` of the rows x costs
    more than the reference's k-means from `seed`, as a share of the
    reference's; inf for an invalid grouping."""
    ref = cost(x, kmeans(x, k, seed), k)
    prog = cost(x, labels, k)
    if prog is None:
        return float('inf')
    return (prog - ref) / max(ref, 1e-300)


def step_gain(x: torch.Tensor, labels: torch.Tensor, k: int) -> float:
    """The share of the grouping's cost that one more Lloyd step takes
    off: every row moved to the nearest of the groups' means, in float64.
    inf for an invalid grouping."""
    x = x.to(torch.float64)
    labels = labels.to(device=x.device, dtype=torch.int64)
    before = cost(x, labels, k)
    if before is None:
        return float('inf')
    means = _means(x, labels, k)
    near = torch.argmin(_sqdist(x, (x * x).sum(1), means), dim=1)
    after = float(((x - means[near]) ** 2).sum())
    return max(before - after, 0.0) / max(before, 1e-300)
