"""Frame-axis mesh execution for the encoder pipeline: the counterpart of
tiler_tpu/parallel/mesh_pipeline.py.

This wires a ('gop','frame') mesh (parallel.mesh.make_mesh) into the
pipeline steps. The axis being replaced is the reference's per-frame
thread fan-out (main.pas:972, 1095): frames and cells of
a GOP spread across the mesh's devices.

Design rules (all three matter for the byte-identity guarantee):
  * only embarrassingly-parallel stages shard: query rows split into
    contiguous ranges, one per shard, while model state (candidate
    features, tile tensors, palettes) is replicated. Per-row math is
    unchanged, so results are bit-identical to the single-device encode.
  * cross-row couplings stay on one device (the mesh's first): the
    dither plan dedup (a global sort), the k-means centroid update (its
    f32 sums would change with the grouping, so it runs on the gathered
    features) and the GTM writer.
  * each shard runs the single-device function on its rows (map_rows):
    the same torch code and, in stage 3, the same K1 kernel
    (nn_kernels.nearest_1) on a Prepared candidate set made once per
    device.
A shard's work is enqueued on its device without a sync between shards;
results come together on the first device in shard order. `replicate`
copies a tensor once per distinct device, so a mesh that names one card
N times holds one copy. Every encode runs through map_rows: on its
device's 1-shard mesh the one range is all the rows, on the device they
are on, and the result is the function's own.

Sharded so (at the call sites): stage 3 assign, stage 2 candidate
features, stage 1 8-NN marking (pipeline.frame_tiling); the dither
prepare's PsyV features and k-means assignment and the Knoll plan counts
and rank selection (pipeline.dither_step, ops.dither); smooth's cell
axis (pipeline.smooth); the GlobalTiling signatures and, with
config.mesh_kmodes, its KModes solves (ops.kmodes, devices=); MakeUnique
on a mesh_ok mesh (sharded_ops.sharded_unique).
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh


def mesh_ok(mesh) -> bool:
    """A mesh the hash-partitioned MakeUnique takes (the JAX package's
    rule for a production mesh): more than 1 shard and a power of two."""
    if not isinstance(mesh, Mesh):
        return False
    n = mesh.size
    return n > 1 and (n & (n - 1)) == 0


class Replicated(dict):
    """One value per distinct device of a mesh (replicate)."""


def replicate(mesh: Mesh, t: torch.Tensor, make=None) -> Replicated:
    """t on every distinct device of the mesh, copied once per device and
    not at all onto the device it is on; make (e.g. nn_kernels.prepare),
    when given, is applied once per device to the copy there."""
    out = Replicated()
    for d in mesh.flat:
        if d not in out:
            v = t if t.device == d else t.to(d)
            out[d] = v if make is None else make(v)
    return out


def ranges(mesh: Mesh, n: int) -> list:
    """The non-empty contiguous row ranges of n rows, at most one per
    shard, in shard order: [(shard, device, lo, hi)]. Zero rows are the
    first shard's empty range, so a function still runs once."""
    cuts = np.linspace(0, n, mesh.size + 1).round().astype(np.int64)
    out = [(s, d, int(lo), int(hi)) for s, (d, lo, hi) in
           enumerate(zip(mesh.flat, cuts[:-1], cuts[1:])) if hi > lo]
    return out or [(0, mesh.flat[0], 0, 0)]


def _cut(a, lo: int, hi: int, device, dim: int):
    a = a[(slice(None),) * dim + (slice(lo, hi),)]
    return a.to(device) if isinstance(a, torch.Tensor) else a


def scatter(mesh: Mesh, rows, dim: int = 0) -> list:
    """rows, an array or a tuple of arrays of one length along dim, cut
    by `ranges`: [(shard, device, parts)], parts one range of each
    array. A tensor's ranges go to their shard's device (a view where it
    is there already), a numpy array's stay on the host. A host tensor's
    ranges are so many uploads, which the caller notes (utils.dispatch)
    as len(ranges(mesh, n))."""
    rows = rows if isinstance(rows, tuple) else (rows,)
    return [(s, d, tuple(_cut(a, lo, hi, d, dim) for a in rows))
            for s, d, lo, hi in ranges(mesh, rows[0].shape[dim])]


def gather(mesh: Mesh, parts: list, dim: int = 0) -> torch.Tensor:
    """Per-shard tensors joined in shard order on the mesh's first device
    (the collective: explicit copies, a fixed order)."""
    dev = mesh.flat[0]
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def map_rows(mesh: Mesh, fn, rows, *args, dim: int = 0):
    """fn(*range_s, *args) on each shard's range of `rows` (scatter; a
    tuple of arrays is cut alike), each on its shard's device: tensor
    args are replicated (a Replicated is taken as is), anything else is
    passed unchanged. Returns fn's results joined in shard order on the
    mesh's first device: a tensor along dim, and in a tuple each tensor
    so and anything else as a list of mesh.size entries, None for a
    shard without rows."""
    parts = scatter(mesh, rows, dim)
    args = [replicate(mesh, a) if isinstance(a, torch.Tensor) else a
            for a in args]
    outs = [(s, fn(*p, *(a[d] if isinstance(a, Replicated) else a
                         for a in args))) for s, d, p in parts]
    if not isinstance(outs[0][1], tuple):
        return gather(mesh, [o for _, o in outs], dim)
    joined = []
    for i, first in enumerate(outs[0][1]):
        if isinstance(first, torch.Tensor):
            joined.append(gather(mesh, [o[i] for _, o in outs], dim))
        else:
            col = [None] * mesh.size
            for s, o in outs:
                col[s] = o[i]
            joined.append(col)
    return tuple(joined)
