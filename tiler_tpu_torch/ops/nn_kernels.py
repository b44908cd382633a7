"""Exact 1-NN kernels: the hand-written CUDA ports of the three Pallas
kernels in tiler_tpu/ops/pallas_kernels.py, each with its plain torch
version.

- `nearest_1` (csrc/nn1.cu, `_nn_kernel`): FrameTiling's stage 3.
- `nearest_1_aug` (csrc/nn1.cu in its augmented mode, `_nn_kernel_aug`):
  the same 1-NN with the norms folded into augmented operands
  (tools/assign_opt_bench.py).
- `nearest_1_bf16` (csrc/nn1_bf16.cu, `_nn_kernel_bf16`): the dot on the
  tensor cores with bf16 operands and f32 accumulation
  (tools/nn_prec_bench.py).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never routes a CUDA tensor to the plain
version. The libraries are built with nvcc for sm_90a at first use, from
the sources in this package, into build/tiler_tpu_torch/ at the
repository root (one nvcc per source, started together), and loaded with
ctypes. `LAUNCHES`, `LAUNCHES_AUG` and `LAUNCHES_BF16` count each
kernel's launches (and nothing else), so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

LAUNCHES = 0
LAUNCHES_AUG = 0
LAUNCHES_BF16 = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'tiler_tpu_torch')
# library name -> its CUDA source
SOURCES = {'nn1': os.path.join(_PKG, 'csrc', 'nn1.cu'),
           'nn1_bf16': os.path.join(_PKG, 'csrc', 'nn1_bf16.cu')}
_MAX_DIM = 384   # the 128-query tile must fit the block's shared memory
_BQ = _BC = 128  # the kernel's query and candidate tile rows (csrc/nn1.cu)
_AUG_PAD = 7     # zero columns after the augmented operands' extra column
_lock = threading.Lock()
_lib = None       # libnn1.so: K1 and its augmented mode
_lib_bf16 = None  # libnn1_bf16.so


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the 1-NN kernels are built with '
                           'the CUDA toolkit at first use')
    return path


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f'lib{name}.so')


_SO = library_path('nn1')


def _nvcc_one(nvcc: str, name: str) -> None:
    """nvcc SOURCES[name] into lib<name>.so by way of a temporary file,
    with its ptxas report beside it as lib<name>.ptxas.txt."""
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(
            [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
             '-O3', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC',
             '-o', tmp, SOURCES[name]], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f'nvcc {SOURCES[name]} failed '
                               f'({r.returncode}):\n{r.stderr[-4000:]}')
        os.replace(tmp, library_path(name))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(os.path.join(BUILD_DIR, f'lib{name}.ptxas.txt'), 'w') as fh:
        fh.write(r.stderr)


def build(force: bool = False) -> dict:
    """Compile every source in SOURCES that is stale (or all, with force)
    into BUILD_DIR/lib<name>.so, one nvcc per source, all started
    together. Returns {name: library path}."""
    out = {name: library_path(name) for name in SOURCES}
    todo = [name for name, so in out.items()
            if force or not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(SOURCES[name])]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        with ThreadPoolExecutor(len(todo)) as pool:
            for job in [pool.submit(_nvcc_one, nvcc, n) for n in todo]:
                job.result()
    return out


_RANGE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p]


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()['nn1'])
            for fn in (lib.tiler_nn1, lib.tiler_nn1_aug):
                fn.restype = ctypes.c_int
                fn.argtypes = _RANGE_ARGS
            _lib = lib
    return _lib


def _load_bf16():
    global _lib_bf16
    with _lock:
        if _lib_bf16 is None:
            lib = ctypes.CDLL(build()['nn1_bf16'])
            lib.tiler_nn1_bf16.restype = ctypes.c_int
            lib.tiler_nn1_bf16.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            _lib_bf16 = lib
    return _lib_bf16


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
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'nearest_1 runs on cuda or cpu, not {q.device}')


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


def _argmin_chunks(dist_of, n_q: int, n_c: int, c_chunk: int, device):
    """First argmin per candidate chunk, strict `<` across chunks (the TPU
    kernels' rule); dist_of(cs, ce) gives the [Q, ce - cs] distances of
    candidates cs..ce-1. Returns (idx [Q] int32, err [Q] float32)."""
    best_err = torch.full((n_q,), float('inf'), dtype=torch.float32,
                          device=device)
    best_idx = torch.zeros(n_q, dtype=torch.int32, device=device)
    for cs in range(0, n_c, c_chunk):
        d = dist_of(cs, min(n_c, cs + c_chunk))
        idx = torch.argmin(d, dim=1)                 # first minimum
        err = torch.gather(d, 1, idx[:, None])[:, 0]
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_idx = torch.where(take, idx.to(torch.int32) + cs, best_idx)
    return best_idx, best_err


def nearest_1_plain(q: torch.Tensor, c: torch.Tensor, c_chunk: int = 8192):
    """The plain version: d = |q|^2 + |c|^2 - 2 q@c.T per candidate
    chunk, first argmin per chunk, strict `<` across chunks. Returns
    (idx [Q] int32, err [Q] float32)."""
    q2 = torch.sum(q * q, dim=1)

    def dist_of(cs, ce):
        chunk = c[cs:ce]
        c2 = torch.sum(chunk * chunk, dim=1)
        return q2[:, None] + c2[None, :] - 2.0 * (q @ chunk.T)
    return _argmin_chunks(dist_of, q.shape[0], c.shape[0], c_chunk,
                          q.device)


def _range_launch(fn, q, c):
    """Allocate the outputs (and per-range scratch) and launch a kernel
    of libnn1.so over candidate ranges. Returns (idx, err, launched)."""
    n_q, dim = q.shape
    if dim > _MAX_DIM:
        raise ValueError(f'feature width {dim} > {_MAX_DIM}')
    err = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    if n_q == 0:
        return idx, err, False
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
        rc = fn(q.data_ptr(), c.data_ptr(), n_q, c.shape[0], dim, n_range,
                per, err.data_ptr(), idx.data_ptr(),
                None if part_err is None else part_err.data_ptr(),
                None if part_idx is None else part_idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} kernel launch failed: '
                           f'cudaError {rc}')
    return idx, err, True


def nearest_1(q: torch.Tensor, c: torch.Tensor):
    """Exact 1-NN of each query row among the candidate rows: (idx [Q]
    int32, err [Q] float32 squared L2), the lexicographic minimum of
    (distance, index). CUDA tensors go through the kernel, CPU tensors
    through nearest_1_plain."""
    global LAUNCHES
    _check(q, c)
    if q.device.type == 'cpu':
        return nearest_1_plain(q, c)
    idx, err, launched = _range_launch(_load().tiler_nn1, q, c)
    LAUNCHES += launched
    return idx, err


def augment(q: torch.Tensor, c: torch.Tensor):
    """The augmented operands of `_augment` (pallas_kernels.py):
    qa = [q, 1, 0 x 7], ca = [-2c, |c|^2, 0 x 7], and |q|^2, so that
    qa @ ca.T = |c|^2 - 2 q.c. Returns (qa, ca, q2)."""
    q2 = torch.sum(q * q, dim=1)
    c2 = torch.sum(c * c, dim=1)
    qa = torch.cat([q, torch.ones_like(q[:, :1]),
                    q.new_zeros((q.shape[0], _AUG_PAD))], dim=1)
    ca = torch.cat([-2.0 * c, c2[:, None],
                    c.new_zeros((c.shape[0], _AUG_PAD))], dim=1)
    return qa, ca, q2


def nearest_1_aug_plain(q: torch.Tensor, c: torch.Tensor,
                        c_chunk: int = 8192):
    """The augmented 1-NN's plain version: the scores qa @ ca.T per
    candidate chunk in f32, first argmin per chunk, strict `<` across
    chunks, plus |q|^2. Returns (idx [Q] int32, err [Q] float32)."""
    qa, ca, q2 = augment(q, c)
    idx, score = _argmin_chunks(lambda cs, ce: qa @ ca[cs:ce].T,
                                q.shape[0], c.shape[0], c_chunk, q.device)
    return idx, score + q2


def nearest_1_aug(q: torch.Tensor, c: torch.Tensor):
    """nearest_1 through the augmented operands (`_nn_call_aug`): the
    kernel finds the lexicographic minimum of (|c|^2 - 2 q.c, index) over
    width D + 8 rows, and |q|^2 is added to the winning score. CUDA
    tensors go through the kernel's augmented mode, CPU tensors through
    nearest_1_aug_plain. Returns (idx [Q] int32, err [Q] float32)."""
    global LAUNCHES_AUG
    _check(q, c)
    if q.device.type == 'cpu':
        return nearest_1_aug_plain(q, c)
    qa, ca, q2 = augment(q, c)
    idx, score, launched = _range_launch(_load().tiler_nn1_aug, qa, ca)
    LAUNCHES_AUG += launched
    return idx, score + q2


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest bf16 (ties to even), kept f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def nearest_1_bf16_plain(q: torch.Tensor, c: torch.Tensor,
                         c_chunk: int = 8192):
    """The bf16 1-NN's plain version: norms from the f32 rows, the dot of
    the bf16-rounded rows as an f32 matmul (TF32 off, so every product
    is exact, as on the matrix unit), first argmin per chunk, strict `<`
    across chunks. Returns (idx [Q] int32, err [Q] float32)."""
    q2 = torch.sum(q * q, dim=1)
    qb = bf16_round(q)

    def dist_of(cs, ce):
        chunk = c[cs:ce]
        c2 = torch.sum(chunk * chunk, dim=1)
        return q2[:, None] + c2[None, :] - 2.0 * (qb @ bf16_round(chunk).T)
    return _argmin_chunks(dist_of, q.shape[0], c.shape[0], c_chunk,
                          q.device)


def nearest_1_bf16(q: torch.Tensor, c: torch.Tensor):
    """1-NN with the dot's operands rounded to bf16 and accumulated in f32
    (`_nn_call_bf16`), the norms in f32: (idx [Q] int32, err [Q]
    float32), the lexicographic minimum of (distance, index). CUDA
    tensors go through the tensor-core kernel, CPU tensors through
    nearest_1_bf16_plain."""
    global LAUNCHES_BF16
    _check(q, c)
    if q.device.type == 'cpu':
        return nearest_1_bf16_plain(q, c)
    n_q, dim = q.shape
    err = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    if n_q == 0:
        return idx, err
    lib = _load_bf16()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tiler_nn1_bf16(q.data_ptr(), c.data_ptr(), n_q, c.shape[0],
                                dim, err.data_ptr(), idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'nn1_bf16 kernel launch failed: cudaError {rc}')
    LAUNCHES_BF16 += 1
    return idx, err
