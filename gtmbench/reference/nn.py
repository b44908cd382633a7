"""The plain reference of FrameTiling's stage-3 search (the exact 1-NN of
each query's features among the keyframe's candidate features, squared
L2), and its control in TF32.

gap() judges the program's winners: per query, by how much the squared
distance to the program's winner lies above the reference's best, in
float64, as a share of |q|^2 + |c_best|^2, the scale at which the
distance |q|^2 + |c|^2 - 2 q.c is rounded. Plain torch, in blocks of
candidates so that it fits beside nothing else on the device.
"""
from __future__ import annotations

import torch

# the float64 distances of one block of candidates stay under 1 GiB
BLOCK_ELEMS = 1 << 27


def nearest(q: torch.Tensor, c: torch.Tensor):
    """Reference 1-NN in float64: (best index [S] int64, best squared
    distance [S] float64), the first index among equal distances."""
    q64 = q.double()
    q2 = (q64 * q64).sum(1)
    best_d = torch.full((len(q),), float('inf'), dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros(len(q), dtype=torch.int64, device=q.device)
    block = max(1024, BLOCK_ELEMS // max(len(q), 1))
    for lo in range(0, len(c), block):
        cb = c[lo:lo + block].double()
        d = q2[:, None] + (cb * cb).sum(1)[None, :] - 2.0 * (q64 @ cb.T)
        dmin, imin = d.min(1)
        take = dmin < best_d
        best_d = torch.where(take, dmin, best_d)
        best_i = torch.where(take, imin + lo, best_i)
    return best_i, best_d


def gap(q: torch.Tensor, c: torch.Tensor, idx: torch.Tensor):
    """(widest gap, share of queries whose winner is not the reference's
    best, number of queries) of the program's winners idx [S] for the
    queries q [S, D] among the candidates c [C, D]. An index outside the
    candidates is a gap of inf."""
    idx = idx.to(device=q.device, dtype=torch.int64)
    if len(q) == 0:
        return 0.0, 0.0, 0
    best_i, best_d = nearest(q, c)
    if int(idx.min()) < 0 or int(idx.max()) >= len(c):
        return float('inf'), 1.0, len(q)
    q64, cw = q.double(), c[idx].double()
    d_prog = ((q64 - cw) ** 2).sum(1)
    cb = c[best_i].double()
    # the reference's best recomputed the same way as d_prog
    d_best = ((q64 - cb) ** 2).sum(1)
    scale = (q64 * q64).sum(1) + (cb * cb).sum(1)
    g = (d_prog - d_best).clamp(min=0) / scale.clamp(min=1e-300)
    return float(g.max()), float((idx != best_i).double().mean()), len(q)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits, ties to even), kept
    f32: what the tensor cores take of an f32 operand with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def nearest_tf32(q: torch.Tensor, c: torch.Tensor, block: int = 8192):
    """The control: the reference's 1-NN computed in TF32, one step below
    the float32 with TF32 off that the configuration states. The dot of
    the TF32-rounded operands is an f32 matmul (every product exact, as on
    the tensor cores), the norms are f32 of the unrounded rows. Returns
    (idx [Q] int32, err [Q] float32) as the program's search does."""
    q2 = (q * q).sum(1)
    qr = tf32_round(q)
    best_e = torch.full((len(q),), float('inf'), dtype=torch.float32,
                        device=q.device)
    best_i = torch.zeros(len(q), dtype=torch.int32, device=q.device)
    for lo in range(0, len(c), block):
        cb = c[lo:lo + block]
        d = q2[:, None] + (cb * cb).sum(1)[None, :] \
            - 2.0 * (qr @ tf32_round(cb).T)
        e, i = d.min(1)
        take = e < best_e
        best_e = torch.where(take, e, best_e)
        best_i = torch.where(take, i.to(torch.int32) + lo, best_i)
    return best_i, best_e
