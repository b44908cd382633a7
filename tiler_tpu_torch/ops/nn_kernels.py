"""Exact 1-NN for FrameTiling's stage 3: the hand-written CUDA kernel
(csrc/nn1.cu, the port of tiler_tpu/ops/pallas_kernels.py `_nn_kernel`)
and its plain torch version.

`nearest_1(q, c)` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never routes a CUDA tensor to the
plain version. The kernel library is built with nvcc for sm_90a at first
use, from the sources in this package, into build/tiler_tpu_torch/ at
the repository root, and loaded with ctypes. `LAUNCHES` counts kernel
launches (and nothing else), so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import torch

LAUNCHES = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, 'csrc', 'nn1.cu')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'tiler_tpu_torch')
_SO = os.path.join(BUILD_DIR, 'libnn1.so')
_MAX_DIM = 384   # the 128-query tile must fit the block's shared memory
_BQ = _BC = 128  # the kernel's query and candidate tile rows (csrc/nn1.cu)
_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the 1-NN kernel is built with '
                           'the CUDA toolkit at first use')
    return path


def build(force: bool = False) -> str:
    """Compile csrc/nn1.cu into BUILD_DIR/libnn1.so unless it is up to
    date. Returns the library path."""
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
           '-std=c++17', '-O3', '-Xptxas', '-v', '-shared',
           '-Xcompiler', '-fPIC', '-o', tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                               f'{res.stderr[-4000:]}')
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(os.path.join(BUILD_DIR, 'libnn1.ptxas.txt'), 'w') as fh:
        fh.write(res.stderr)
    return _SO


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.tiler_nn1.restype = ctypes.c_int
            lib.tiler_nn1.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
    return _lib


def _check(q: torch.Tensor, c: torch.Tensor) -> None:
    if q.dim() != 2 or c.dim() != 2:
        raise ValueError('nearest_1 takes 2-D [Q,D] queries and [C,D] '
                         'candidates')
    if q.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError('nearest_1 takes float32 tensors')
    if q.device != c.device:
        raise ValueError(f'queries on {q.device}, candidates on {c.device}')
    if q.shape[1] != c.shape[1]:
        raise ValueError(f'feature widths differ: {q.shape[1]} vs '
                         f'{c.shape[1]}')
    if not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError('nearest_1 takes contiguous tensors')
    if c.shape[0] == 0:
        raise ValueError('no candidates')


def candidate_ranges(n_q: int, n_c: int, n_sm: int) -> tuple[int, int]:
    """(n_range, tiles_per_range): how the kernel splits the candidate
    tiles into ranges, one block per (query tile, range) and one block
    per SM at a time. r ranges take ceil(q_tiles * r / n_sm) waves of
    1/r of the walk each; the fewest ranges within 5% of the best such
    time win, so a full query chunk keeps one range and a short one
    spreads over the SMs. No range is empty."""
    q_tiles = -(-n_q // _BQ)
    c_tiles = -(-n_c // _BC)
    r_max = min(c_tiles, 4 * n_sm)
    cost = [-(-q_tiles * r // n_sm) / r for r in range(1, r_max + 1)]
    want = next(r for r, t in enumerate(cost, 1) if t <= 1.05 * min(cost))
    per = -(-c_tiles // want)
    return -(-c_tiles // per), per


def nearest_1_plain(q: torch.Tensor, c: torch.Tensor, c_chunk: int = 8192):
    """The plain version: d = |q|^2 + |c|^2 - 2 q@c.T per candidate
    chunk, first argmin per chunk, strict `<` across chunks. Returns
    (idx [Q] int32, err [Q] float32)."""
    q2 = torch.sum(q * q, dim=1)
    best_err = torch.full((q.shape[0],), float('inf'), dtype=torch.float32,
                          device=q.device)
    best_idx = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for cs in range(0, c.shape[0], c_chunk):
        chunk = c[cs:cs + c_chunk]
        c2 = torch.sum(chunk * chunk, dim=1)
        d = q2[:, None] + c2[None, :] - 2.0 * (q @ chunk.T)
        idx = torch.argmin(d, dim=1)                 # first minimum
        err = torch.gather(d, 1, idx[:, None])[:, 0]
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_idx = torch.where(take, idx.to(torch.int32) + cs, best_idx)
    return best_idx, best_err


def nearest_1(q: torch.Tensor, c: torch.Tensor):
    """Exact 1-NN of each query row among the candidate rows: (idx [Q]
    int32, err [Q] float32 squared L2), the lexicographic minimum of
    (distance, index). CUDA tensors go through the kernel, CPU tensors
    through nearest_1_plain."""
    global LAUNCHES
    _check(q, c)
    if q.device.type == 'cpu':
        return nearest_1_plain(q, c)
    if q.device.type != 'cuda':
        raise ValueError(f'nearest_1 runs on cuda or cpu, not {q.device}')
    if q.shape[1] > _MAX_DIM:
        raise ValueError(f'feature width {q.shape[1]} > {_MAX_DIM}')
    n_q, dim = q.shape
    err = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    if n_q == 0:
        return idx, err
    lib = _load()
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_range, per = candidate_ranges(n_q, c.shape[0], n_sm)
    part_err = part_idx = None
    if n_range > 1:
        part_err = torch.empty((n_range, n_q), dtype=torch.float32,
                               device=q.device)
        part_idx = torch.empty((n_range, n_q), dtype=torch.int32,
                               device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tiler_nn1(
            q.data_ptr(), c.data_ptr(), n_q, c.shape[0], dim, n_range, per,
            err.data_ptr(), idx.data_ptr(),
            None if part_err is None else part_err.data_ptr(),
            None if part_idx is None else part_idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'nn1 kernel launch failed: cudaError {rc}')
    LAUNCHES += 1
    return idx, err
