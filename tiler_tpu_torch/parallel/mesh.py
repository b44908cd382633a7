"""Device mesh: the counterpart of tiler_tpu/parallel/mesh.py.

A mesh is a 2-D grid of torch devices with the axis names ('gop',
'frame') (SURVEY.md §5.8). The port's sharded functions
(parallel.sharded_ops, parallel.mesh_pipeline) loop over its shards in
row-major order: each shard's rows go to its device and the work is
enqueued without a sync between shards. A mesh may name one device more
than once (['cpu'] * 8, ['cuda:0'] * 4): those are logical shards of one
device, as the JAX package's tests run 8 virtual CPU devices of one host.
No torch.distributed here: one process drives every device of the mesh.
Every encode runs on a mesh: without one it is the 1-shard mesh of its
device (make_mesh(devices=[device])).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray                 # [gop, frame] of torch.device
    axis_names: tuple = ('gop', 'frame')

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list:
        """The shards' devices in row-major order."""
        return list(self.devices.reshape(-1))


def _device(d) -> torch.device:
    """torch.device with an explicit index for CUDA (what tensors report)."""
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', 0)
    return d


def make_mesh(n_devices: int | None = None, gop_axis: int | None = None,
              devices=None) -> Mesh:
    """2-D mesh ('gop','frame') of n_devices shards. `devices` names them
    (a device may repeat: ['cpu'] * 8 is 8 logical shards of the CPU);
    without it, the first n_devices CUDA cards (all of them when
    n_devices is None), and too few cards is an error: a mesh is never
    put on the CPU unless asked. gop_axis defaults to the largest
    power-of-2 divisor <= sqrt(n) so both axes are populated when
    possible."""
    if devices is not None:
        devices = [_device(d) for d in devices][:n_devices]
    else:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = avail if n_devices is None else n_devices
        if n > avail:
            raise ValueError(f'{n} devices asked for: only {avail} '
                             f'device(s) available')
        devices = [torch.device('cuda', i) for i in range(n)]
    n = len(devices)
    if n == 0:
        raise ValueError('a mesh needs at least one device')
    if gop_axis is None:
        # largest power-of-2 divisor of n not exceeding sqrt(n)
        gop_axis = 1
        d = 2
        while n % d == 0 and d * d <= n:
            gop_axis = d
            d *= 2
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(gop_axis, n // gop_axis))


def check_device(mesh: Mesh, device) -> None:
    """Raise unless every shard of the mesh is a device of `device`'s
    type: a caller that asked for the card gets no CPU mesh in its place,
    and the reverse."""
    kind = torch.device(device).type
    other = sorted({str(d) for d in mesh.flat if d.type != kind})
    if other:
        raise ValueError(f'the mesh holds {", ".join(other)} but the '
                         f'encode was asked to run on {kind}')
