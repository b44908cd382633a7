"""Exact nearest-neighbour search as chunked distance matmuls: the
counterpart of tiler_tpu/ops/knn.py.

Distances are squared L2, d = |q|^2 + |c|^2 - 2 q.c, chunked over the
candidates so the [Q,C] matrix never exists whole.
"""
from __future__ import annotations

import torch


def nearest_k_keepmask(queries: torch.Tensor, candidates: torch.Tensor,
                       k: int, q_chunk: int = 8192, c_chunk: int = 32768):
    """Exact k-NN for FrameTiling's stage-1 marking: (idx [Q,k] int64,
    keep [Q,k] bool), ascending by (distance, index), with keep[j] =
    err[j] != err[j-1] and keep[0] = True (UseOne's consecutive-equal
    skip, main.pas:3832-3837).

    The inputs are small-integer PalPixels (64 * 255^2 < 2^24), so every
    distance is exact in f32 on any device. Ties are broken by the lower
    candidate index, as lax.top_k does, through a top-k over the unique
    composite key distance * C + index (torch.topk promises no order on
    equal values). With fewer than k candidates all of them are returned
    (the JAX package fails there, on a clip of one distinct tile)."""
    n_q, n_c = queries.shape[0], candidates.shape[0]
    dev = queries.device
    k = min(k, n_c)
    c = candidates.to(torch.float32)
    c2 = torch.sum(c * c, dim=1)
    idx_out = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    keep_out = torch.empty((n_q, k), dtype=torch.bool, device=dev)
    for qs in range(0, n_q, q_chunk):
        q = queries[qs:qs + q_chunk].to(torch.float32)
        q2 = torch.sum(q * q, dim=1)
        best = None
        for cs in range(0, n_c, c_chunk):
            ce = min(n_c, cs + c_chunk)
            d = q2[:, None] + c2[None, cs:ce] - 2.0 * (q @ c[cs:ce].T)
            key = d.to(torch.int64) * n_c \
                + torch.arange(cs, ce, device=dev)[None, :]
            top = torch.topk(key, min(k, ce - cs), dim=1, largest=False,
                             sorted=True).values
            if best is not None:
                top = torch.topk(torch.cat([best, top], dim=1), k, dim=1,
                                 largest=False, sorted=True).values
            best = top
        err = best // n_c
        idx_out[qs:qs + q_chunk] = best % n_c
        keep = torch.ones_like(err, dtype=torch.bool)
        keep[:, 1:] = err[:, 1:] != err[:, :-1]
        keep_out[qs:qs + q_chunk] = keep
    return idx_out, keep_out
