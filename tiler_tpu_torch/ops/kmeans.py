"""Lloyd's k-means with k-means++ seeding: the counterpart of
tiler_tpu/ops/kmeans.py.

Distances are one [N,D]@[D,k] float32 matmul; the update is a one-hot
[k,N]@[N,D+1] float32 matmul (per-cluster sums and counts together), not
`index_add_`, whose CUDA atomics reorder float sums from run to run. The
k-means++ draws come from ops.prng, bit-identical to jax.random. Each
draw makes the host wait on the card three times: two scalar uploads
(prng.uniform) and the drawn index's download (prng.categorical's int);
each Lloyd iteration once, for its convergence test. kmeans_core opens
the Dither step's spans 'dither/kmeans_pp' around the seeding and
'dither/lloyd' around Lloyd's iterations (utils.dispatch.span).
"""
from __future__ import annotations

import torch

from ..utils.dispatch import note, span
from . import prng

_SEED = 0x42381337   # the JAX package's k-means++ seed
_MAX_ITERS = 100


def _plus_plus_init(x: torch.Tensor, x2: torch.Tensor, k: int, key):
    """k-means++ seeding: first point uniform, then D^2-weighted sampling
    (a categorical gumbel-max draw over log D^2)."""
    n = x.shape[0]
    k0, key = prng.split(key, device=x.device)
    first = prng.randint(k0, 0, n, device=x.device)
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    d2 = x2 + torch.sum(x[first] ** 2) - 2.0 * (x @ x[first])
    d2 = torch.clamp(d2, min=0.0)
    for i in range(1, k):
        key, kk = prng.split(key, device=x.device)
        logits = torch.log(torch.clamp(d2, min=1e-30))
        c = x[prng.categorical(kk, logits)]
        cents[i] = c
        nd2 = x2 + torch.sum(c * c) - 2.0 * (x @ c)
        d2 = torch.minimum(d2, torch.clamp(nd2, min=0.0))
    return cents


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
