"""JAX's threefry2x32 PRNG, reproduced bit for bit in torch.

k-means++ seeding (ops.kmeans) draws from `jax.random` with a fixed seed
(tiler_tpu/ops/kmeans.py: PRNGKey -> split -> randint, then categorical
as a gumbel argmax). Reproducing the same bits is what lets the port's
palettes be compared with the JAX package's at all.

The variant is the one JAX uses with `jax_threefry_partitionable=True`
(the default since jax 0.5): `split` and `random_bits` hash a 64-bit
iota split into (hi, lo) 32-bit counter halves with the key. Values are
int64 tensors masked to 32 bits, because torch's uint32 coverage is
partial; a key is a python pair of 0-d int64 tensors or ints.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.dispatch import note

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2). Every argument is an int64 tensor (or int) holding
    uint32 values; returns two int64 tensors of x1's shape."""
    k1 = torch.as_tensor(k1, dtype=torch.int64) & _M32
    k2 = torch.as_tensor(k2, dtype=torch.int64) & _M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) for a non-negative seed below 2**64."""
    return (int(seed) >> 32) & _M32, int(seed) & _M32


def _key_tensors(key, device):
    # a key of Python ints goes up to the device; a split's key is there
    note('h2d', sum(not isinstance(k, torch.Tensor) for k in key))
    return (torch.as_tensor(key[0], dtype=torch.int64, device=device),
            torch.as_tensor(key[1], dtype=torch.int64, device=device))


def split(key, num: int = 2, device=None):
    """jax.random.split(key, num) -> list of num keys."""
    k1, k2 = _key_tensors(key, device)
    hi = torch.zeros(num, dtype=torch.int64, device=device)
    lo = torch.arange(num, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return [(b1[i], b2[i]) for i in range(num)]


def random_bits32(key, n: int | None, device=None):
    """32 random bits per element; n=None draws one scalar (shape ())."""
    k1, k2 = _key_tensors(key, device)
    m = 1 if n is None else n
    lo = torch.arange(m, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    bits = b1 ^ b2
    return bits[0] if n is None else bits


def randint(key, minval: int, maxval: int, device=None) -> int:
    """jax.random.randint(key, (), minval, maxval) for int32 output."""
    k1, k2 = split(key, device=device)
    note('d2h', 2)
    hi = int(random_bits32(k1, None, device))
    lo = int(random_bits32(k2, None, device))
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return minval + off % span


def uniform(key, n: int, minval: float, maxval: float, device=None):
    """jax.random.uniform(key, (n,), float32, minval, maxval)."""
    bits = random_bits32(key, n, device)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    note('h2d', 2)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, n: int, device=None):
    """jax.random.gumbel(key, (n,), float32) in its default 'low' mode."""
    u = uniform(key, n, _F32_TINY, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """jax.random.categorical over a 1-D logits vector: the gumbel-max
    trick, first maximum on ties (torch.argmax's documented rule)."""
    g = gumbel(key, logits.shape[0], logits.device)
    note('d2h')
    return int(torch.argmax(g + logits))
