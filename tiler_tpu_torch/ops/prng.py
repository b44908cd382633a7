"""JAX's threefry2x32 PRNG, reproduced bit for bit in torch.

k-means++ seeding (ops.kmeans) draws from `jax.random` with a fixed seed
(tiler_tpu/ops/kmeans.py: PRNGKey -> split -> randint, then categorical
as a gumbel argmax). Reproducing the same bits is what lets the port's
palettes be compared with the JAX package's at all.

The variant is the one JAX uses with `jax_threefry_partitionable=True`
(the default since jax 0.5): `split` and `random_bits` hash a 64-bit
iota split into (hi, lo) 32-bit counter halves with the key. A key is a
pair of Python ints, or of 0-d int64 tensors on the device that draws
with it. `split` and `randint` hang on the key alone and run on the host
in Python ints (ops.kmeans computes a seeding's keys up front with them);
`random_bits32`, `uniform`, `gumbel` and `categorical` draw over n
elements on a device, as int64 tensors masked to 32 bits, because
torch's uint32 coverage is partial.
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
    key (k1, k2). Every argument is a Python int or an int64 tensor
    holding uint32 values; returns two of x1's kind (tensors of its shape
    where any argument is a tensor)."""
    k1, k2 = k1 & _M32, k2 & _M32
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
    # a key of Python ints goes up to the device; a key already there stays
    note('h2d', sum(not isinstance(k, torch.Tensor) for k in key))
    return (torch.as_tensor(key[0], dtype=torch.int64, device=device),
            torch.as_tensor(key[1], dtype=torch.int64, device=device))


def split(key, num: int = 2):
    """jax.random.split(key, num) -> list of num keys, on the host."""
    k1, k2 = int(key[0]), int(key[1])
    return [threefry2x32(k1, k2, 0, i) for i in range(num)]


def random_bits32(key, n: int, device=None):
    """jax.random.bits(key, (n,), uint32): 32 random bits per element."""
    k1, k2 = _key_tensors(key, device)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def randint(key, minval: int, maxval: int) -> int:
    """jax.random.randint(key, (), minval, maxval) for int32 output, on
    the host."""
    hi, lo = [b1 ^ b2 for b1, b2 in
              (threefry2x32(k1, k2, 0, 0) for k1, k2 in split(key))]
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return minval + off % span


def uniform(key, n: int, minval: float, maxval: float, device=None):
    """jax.random.uniform(key, (n,), float32, minval, maxval). The bounds
    are float32 scalars (their difference taken in float32, as jax does),
    which torch applies in float32 without an upload."""
    bits = random_bits32(key, n, device)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    return torch.clamp(floats * float(scale) + float(lo), min=float(lo))


def gumbel(key, n: int, device=None):
    """jax.random.gumbel(key, (n,), float32) in its default 'low' mode."""
    u = uniform(key, n, _F32_TINY, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """jax.random.categorical over a 1-D logits vector: the gumbel-max
    trick, first maximum on ties (torch.argmax's documented rule). Returns
    the drawn index as a 0-d int64 tensor on the logits' device, without
    a wait."""
    g = gumbel(key, logits.shape[0], logits.device)
    return torch.argmax(g + logits)
