"""The plain reference of Dither's Yliluoma-2 mixing plans: upstream's
DeviseBestMixingPlanYliluoma (b0nefish/tiler main.pas:1573-1826, the
scalar loop of :1753-1794) and the pixel's pick from its plan (DitherTile,
main.pas:2055-2066), in plain int64 torch on any device, one lane a
(colour, palette) key.

A plan holds up to 2L - 1 palette indices, L the mixed colours. It grows
in steps until it holds at least L: each step tries every palette entry
e, in palette order, repeated t = 1 .. max(len(plan), 1) times, and keeps
the first (e, t) of least ColorCompare (main.pas:1557-1571) between the
colour and the plan's running average, the sum of what the plan holds
and of e's t repeats, where the i-th repeat adds e's components plus
i - 1 (upstream's running `add` gains 1 a repeat), floor-divided by
len(plan) + t. The chosen entry is appended t times, even past L. The
plan is then sorted by the undivided luma 2126 r + 7152 g + 722 b of its
entries (PlanCompareLuma, main.pas:1544-1555), and the pixel at Bayer
rank b (0-63) takes entry (b * len(plan)) >> 6.

Departures from upstream, each on purpose: among entries of equal luma
the plan keeps the order in which they were appended (a stable sort), as
the JAX package sorts; upstream's sort is not in this repository. The SSE3
inner loop (main.pas:1602-1752) is the same sums in another order.
"""
from __future__ import annotations

import torch

LUMA = (2126, 7152, 722)


def color_compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ColorCompare of [..., 3] int64 rows a against b."""
    w = torch.tensor(LUMA, dtype=torch.int64, device=a.device)
    ld = torch.div(((a - b) * w).sum(-1), 10000, rounding_mode='trunc')
    return 13 * ((a - b) ** 2).sum(-1) + 32 * ld * ld


def plans(cols: torch.Tensor, pals: torch.Tensor, mixed_colors: int):
    """cols [M, 3] and pals [M, S, 3] (each key's palette) of any integer
    type -> (plans [M, 2L - 1] int64 palette indices, luma-sorted, zeros
    past the count; counts [M] int64)."""
    cols = cols.to(torch.int64)
    pals = pals.to(torch.int64)
    m, s = pals.shape[:2]
    L = mixed_colors
    dev = cols.device
    rows = torch.arange(m, device=dev)
    plan = torch.zeros((m, max(2 * L - 1, 1)), dtype=torch.int64, device=dev)
    count = torch.zeros(m, dtype=torch.int64, device=dev)
    so_far = torch.zeros((m, 3), dtype=torch.int64, device=dev)
    while bool((count < L).any()):
        growing = count < L
        tries = torch.clamp(count, min=1)
        least = torch.full((m,), -1, dtype=torch.int64, device=dev)
        chosen = torch.zeros(m, dtype=torch.int64, device=dev)
        amount = torch.ones(m, dtype=torch.int64, device=dev)
        for e in range(s):
            total = so_far.clone()
            add = pals[:, e].clone()
            for t in range(1, L + 1):
                total = total + add
                add = add + 1
                pen = color_compare(cols, total // (count + t)[:, None])
                better = (t <= tries) & ((least < 0) | (pen < least))
                least = torch.where(better, pen, least)
                chosen = torch.where(better, e, chosen)
                amount = torch.where(better, t, amount)
        amount = torch.where(growing, amount, 0)
        for i in range(L):
            put = i < amount
            plan[rows[put], (count + i)[put]] = chosen[put]
        so_far = so_far + pals[rows, chosen] * amount[:, None]
        count = count + amount
    w = torch.tensor(LUMA, dtype=torch.int64, device=dev)
    luma = torch.gather((pals * w).sum(-1), 1, plan)
    pos = torch.arange(plan.shape[1], device=dev)
    luma = torch.where(pos[None] < count[:, None], luma,
                       torch.iinfo(torch.int64).max)
    order = torch.sort(luma, dim=1, stable=True).indices
    plan = torch.gather(plan, 1, order)
    return torch.where(pos[None] < count[:, None], plan, 0), count


def pick(plans_: torch.Tensor, counts: torch.Tensor,
         bayer: torch.Tensor) -> torch.Tensor:
    """The entry each pixel takes: plans [..., 2L - 1], counts [...] and
    Bayer ranks broadcastable to counts."""
    at = (bayer.to(torch.int64) * counts) >> 6
    return torch.gather(plans_, -1, at[..., None])[..., 0]
