"""Lloyd's k-means with k-means++ seeding: the counterpart of
tiler_tpu/ops/kmeans.py.

Distances are one [N,D]@[D,k] float32 matmul; the update is a one-hot
[k,N]@[N,D+1] float32 matmul (per-cluster sums and counts together), not
`index_add_`, whose CUDA atomics reorder float sums from run to run. The
k-means++ draws come from ops.prng, bit-identical to jax.random. Their
keys hang on the seed alone, so the host computes a seeding's keys and
its first row up front (key_schedule) and uploads them once; on the card
each of the k-1 draws is then one launch of csrc/kmeans_pp.cu (the D^2
update, the gumbel scores and their first maximum in one pass), all
enqueued without a wait, and the drawn rows stay on the card. The first
wait is Lloyd's first convergence test, one per Lloyd iteration.
kmeans_core opens the Dither step's spans 'dither/kmeans_pp' around the
seeding (on the card: the upload and the enqueue) and 'dither/lloyd'
around Lloyd's iterations (utils.dispatch.span).
"""
from __future__ import annotations

import torch

from ..utils.dispatch import note, span
from . import nn_kernels, prng

_SEED = 0x42381337   # the JAX package's k-means++ seed
_MAX_ITERS = 100


def key_schedule(key, n: int, k: int) -> list:
    """The keys of a k-means++ seeding of k among n rows, which hang on
    the key alone: [(first, 0), kk_1, ..., kk_{k-1}], the first row
    (randint under split(key)[0]) and the key of each draw i (the second
    half of the i-th split of what the first split left), as Python
    ints."""
    k0, key = prng.split(key)
    rows = [(prng.randint(k0, 0, n), 0)]
    for _ in range(1, k):
        key, kk = prng.split(key)
        rows.append(kk)
    return rows


def plus_plus_plain(x: torch.Tensor, x2: torch.Tensor, sched: torch.Tensor):
    """The seeding's plain version: from the first row sched[0, 0], k-1
    draws, each a categorical gumbel-max draw over log D^2 under key
    sched[i], then D^2 updated with the drawn row. Every index stays a
    tensor, so nothing waits. Returns (cents [k, D], idx [k] int64)."""
    k = sched.shape[0]
    idx = [sched[0, :1]]
    c = x.index_select(0, idx[0])[0]
    cents = [c]
    d2 = torch.clamp(x2 + torch.sum(c ** 2) - 2.0 * (x @ c), min=0.0)
    for i in range(1, k):
        logits = torch.log(torch.clamp(d2, min=1e-30))
        idx.append(prng.categorical((sched[i, 0], sched[i, 1]),
                                    logits).view(1))
        c = x.index_select(0, idx[-1])[0]
        cents.append(c)
        if i < k - 1:
            nd2 = x2 + torch.sum(c * c) - 2.0 * (x @ c)
            d2 = torch.minimum(d2, torch.clamp(nd2, min=0.0))
    return torch.stack(cents), torch.cat(idx)


def plus_plus(x: torch.Tensor, x2: torch.Tensor, sched: torch.Tensor):
    """The seeding of len(sched) centroids among the rows x [N, D] f32
    with norms x2 [N] under the key schedule sched [k, 2] int64 (the
    rows of key_schedule, on x's device). CUDA tensors go through
    csrc/kmeans_pp.cu (D = 192 alone), k-1 launches enqueued back to
    back; CPU tensors through plus_plus_plain. Returns (cents [k, D] f32,
    idx [k] int64)."""
    if x.dim() != 2 or x2.shape != x.shape[:1] or sched.dim() != 2 \
            or sched.shape[1] != 2 or len(sched) < 1:
        raise ValueError(f'plus_plus takes x [N, D], x2 [N], sched [k, 2]; '
                         f'got {tuple(x.shape)}, {tuple(x2.shape)}, '
                         f'{tuple(sched.shape)}')
    (n, dim), k = x.shape, len(sched)
    if x.dtype != torch.float32 or x2.dtype != torch.float32 \
            or sched.dtype != torch.int64:
        raise TypeError('plus_plus takes float32 rows and norms and an '
                        'int64 schedule')
    if not (x.device == x2.device == sched.device):
        raise ValueError(f'rows on {x.device}, norms on {x2.device}, '
                         f'schedule on {sched.device}')
    if n < 1:
        raise ValueError('no rows')
    if x.device.type == 'cpu':
        return plus_plus_plain(x, x2, sched)
    if x.device.type != 'cuda':
        raise ValueError(f'plus_plus runs on cuda or cpu, not {x.device}')
    if dim != nn_kernels.KPP_DIM:
        raise ValueError(f'the seeding kernel takes rows of width '
                         f'{nn_kernels.KPP_DIM}, not {dim}')
    if not (x.is_contiguous() and x2.is_contiguous()
            and sched.is_contiguous()):
        raise ValueError('plus_plus takes contiguous tensors')
    cents = torch.empty((k, dim), dtype=torch.float32, device=x.device)
    idx = torch.empty(k, dtype=torch.int64, device=x.device)
    if k == 1:
        # no draw: the first row alone
        torch.index_select(x, 0, sched[0, :1], out=cents)
        idx.copy_(sched[0, :1])
        return cents, idx
    lib = nn_kernels.load_kmeans_pp()
    d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.tiler_kmeans_pp_scratch(n), dtype=torch.int32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tiler_kmeans_pp(x.data_ptr(), x2.data_ptr(),
                                 sched.data_ptr(), n, k, d2.data_ptr(),
                                 idx.data_ptr(), cents.data_ptr(),
                                 scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'kmeans_pp kernel launch failed: cudaError {rc}')
    nn_kernels._count('LAUNCHES_KPP', k - 1)
    return cents, idx


def _plus_plus_init(x: torch.Tensor, x2: torch.Tensor, k: int, key):
    """k-means++ seeding: first point uniform, then D^2-weighted sampling
    (a categorical gumbel-max draw over log D^2). The key schedule goes up
    to x's device in one upload; nothing comes back."""
    sched = key_schedule(key, x.shape[0], k)
    note('h2d')
    sched = torch.tensor(sched, dtype=torch.int64, device=x.device)
    return plus_plus(x, x2, sched)[0]


def _assign(x: torch.Tensor, x2: torch.Tensor, cents: torch.Tensor):
    """[N] labels (first minimum) via one matmul."""
    c2 = torch.sum(cents * cents, dim=1)
    d2 = x2[:, None] + c2[None, :] - 2.0 * (x @ cents.T)
    return torch.argmin(d2, dim=1)


def _update(x: torch.Tensor, labels: torch.Tensor, k: int,
            old_cents: torch.Tensor):
    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)
    xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                  device=x.device)], dim=1)
    sc = onehot.T @ xa
    sums, counts = sc[:, :-1], sc[:, -1]
    cents = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where((counts == 0)[:, None], old_cents, cents)


def kmeans_core(x: torch.Tensor, k: int, max_iters: int = _MAX_ITERS,
                seed: int = _SEED, assign=_assign):
    """Cluster [N,D] features into k groups; converges when assignments
    stop changing (at most max_iters Lloyd's iterations). `assign(x, x2,
    cents)` gives the [N] labels on x's device (the mesh passes one that
    assigns each shard's rows on its own device). Returns (labels [N]
    int32, centroids [k,D] f32, n_iters)."""
    x = x.to(torch.float32)
    x2 = torch.sum(x * x, dim=1)
    with span('dither/kmeans_pp'):
        cents = _plus_plus_init(x, x2, k, prng.prng_key(seed))
    with span('dither/lloyd'):
        labels = assign(x, x2, cents)
        it = 0
        while it < max_iters:
            cents = _update(x, labels, k, cents)
            new_labels = assign(x, x2, cents)
            note('d2h')
            changed = bool((new_labels != labels).any())
            labels = new_labels
            it += 1
            if not changed:
                break
        cents = _update(x, labels, k, cents)
    return labels.to(torch.int32), cents, it
