"""Exact 1-NN kernels: the hand-written CUDA ports of the three Pallas
kernels in tiler_tpu/ops/pallas_kernels.py, each with its plain torch
version.

- `nearest_1` (csrc/nn1.cu, `_nn_kernel`): FrameTiling's stage 3. The
  kernel walks candidates that `prepare` (the kernel `nn1_prepare_kernel`
  of the same source) has written k-major with their norms; the encoder
  prepares a keyframe's candidates once and reuses them for every query
  chunk, `nearest_1(q, c)` on raw rows prepares inside.
- `nearest_1_aug` (csrc/nn1.cu in its augmented mode, `_nn_kernel_aug`):
  the same 1-NN with the norms folded into augmented operands
  (tools/assign_opt_bench.py).
- `nearest_1_bf16` (csrc/nn1_bf16.cu, `_nn_kernel_bf16`): the dot on the
  tensor cores (wgmma) with bf16 operands and f32 accumulation
  (tools/nn_prec_bench.py). Its candidates are rounded once by
  `prepare_bf16` (the kernel `nn1_bf16_prepare_kernel` of the same
  source) into the swizzled bf16 tiles the walk copies into shared
  memory; `nearest_1_bf16(q, c)` on raw rows prepares inside.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never routes a CUDA tensor to the plain
version. The libraries are built with nvcc for sm_90a at first use, from
the sources in this package, into build/tiler_tpu_torch/ at the
repository root (one nvcc per source, started together), and loaded with
ctypes. `LAUNCHES`, `LAUNCHES_PREP`, `LAUNCHES_AUG`, `LAUNCHES_BF16` and
`LAUNCHES_BF16_PREP` count each kernel's launches (and nothing else), so
a run can show that its path went through the kernels; host threads that
share a card (parallel.gop_exact) update them under a lock.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

LAUNCHES = 0
LAUNCHES_PREP = 0
LAUNCHES_AUG = 0
LAUNCHES_BF16 = 0
LAUNCHES_BF16_PREP = 0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'tiler_tpu_torch')
# library name -> its CUDA source
SOURCES = {'nn1': os.path.join(_PKG, 'csrc', 'nn1.cu'),
           'nn1_bf16': os.path.join(_PKG, 'csrc', 'nn1_bf16.cu')}
# csrc/nn1.cu's tiles: queries per block, candidates per tile (prepared
# candidates are padded to it) and the granule the feature width is padded
# to; checked against the library when it is loaded
_BQ, _BC, _KG = 128, 256, 8
# the k-major 128-query tile stays in shared memory beside the ring of
# 3 x 33 KB, which leaves room for this width (the encoder's are 192, 200)
_MAX_DIM = 216
_AUG_PAD = 7     # zero columns after the augmented operands' extra column
# csrc/nn1_bf16.cu's tiles: queries per block, candidates per tile, and the
# K-chunk the feature width is padded to (64 bf16: one 128-byte swizzled
# row of 8 groups of 8)
_BQ_BF16, _BC_BF16, _KC_BF16 = 256, 128, 64
# four K-chunks of the 256-query tile fit beside the ring
_MAX_DIM_BF16 = 256
_lock = threading.Lock()
_count_lock = threading.Lock()   # the LAUNCHES* updates
_lib = None       # libnn1.so: K1, its augmented mode and the prepare
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


def nvcc_build(nvcc: str, source: str, out: str) -> None:
    """nvcc `source` into the shared library `out` by way of a temporary
    file, with its ptxas report beside it as <out minus .so>.ptxas.txt."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=os.path.dirname(out))
    os.close(fd)
    try:
        r = subprocess.run(
            [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
             '-O3', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC',
             '-o', tmp, source],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f'nvcc {source} failed '
                               f'({r.returncode}):\n{r.stderr[-4000:]}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(out[:-len('.so')] + '.ptxas.txt', 'w') as fh:
        fh.write(r.stderr)


def source_files(source: str) -> set:
    """`source` and every header it includes by a quoted name, found
    beside the including file, headers of headers too."""
    found, todo = set(), [source]
    while todo:
        path = todo.pop()
        if path in found or not os.path.exists(path):
            continue
        found.add(path)
        with open(path) as fh:
            names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', fh.read(),
                               re.M)
        todo += [os.path.join(os.path.dirname(path), n) for n in names]
    return found


def build(force: bool = False) -> dict:
    """Compile every source in SOURCES that is stale (or all, with force)
    into BUILD_DIR/lib<name>.so, one nvcc per source, all started
    together. A library is stale when its source or a header that the
    source includes is newer. Returns {name: library path}."""
    out = {name: library_path(name) for name in SOURCES}
    todo = [name for name, so in out.items()
            if force or not os.path.exists(so)
            or os.path.getmtime(so) < max(
                os.path.getmtime(f) for f in source_files(SOURCES[name]))]
    if todo:
        nvcc = _nvcc()
        with ThreadPoolExecutor(len(todo)) as pool:
            for job in [pool.submit(nvcc_build, nvcc, SOURCES[n], out[n])
                        for n in todo]:
                job.result()
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, ct, n_q, n_c, dim, dim_pad, n_range, tiles_per_range, err_out,
# idx_out, part_err, part_idx, stream
_RANGE_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]


def bind_nn1(path: str):
    """Load a library built from csrc/nn1.cu and declare its functions;
    its tiles must be the ones this module pads to."""
    lib = ctypes.CDLL(path)
    for fn in (lib.tiler_nn1, lib.tiler_nn1_aug):
        fn.restype = _I
        fn.argtypes = _RANGE_ARGS
    lib.tiler_nn1_prepare.restype = _I
    lib.tiler_nn1_prepare.argtypes = [_P, _I, _I, _I, _P, _P]
    tiles = [ctypes.c_int() for _ in range(3)]
    lib.tiler_nn1_tiles.restype = None
    lib.tiler_nn1_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.tiler_nn1_tiles(*[ctypes.byref(t) for t in tiles])
    if [t.value for t in tiles] != [_BQ, _BC, _KG]:
        raise RuntimeError(f'{path}: tiles {[t.value for t in tiles]} != '
                           f'{[_BQ, _BC, _KG]}')
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind_nn1(build()['nn1'])
    return _lib


def bind_nn1_bf16(path: str):
    """Load a library built from csrc/nn1_bf16.cu and declare its
    functions; its tiles must be the ones this module pads to."""
    lib = ctypes.CDLL(path)
    lib.tiler_nn1_bf16.restype = _I
    lib.tiler_nn1_bf16.argtypes = _RANGE_ARGS
    lib.tiler_nn1_bf16_prepare.restype = _I
    lib.tiler_nn1_bf16_prepare.argtypes = [_P, _I, _I, _I, _P, _P]
    tiles = [ctypes.c_int() for _ in range(3)]
    lib.tiler_nn1_bf16_tiles.restype = None
    lib.tiler_nn1_bf16_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.tiler_nn1_bf16_tiles(*[ctypes.byref(t) for t in tiles])
    if [t.value for t in tiles] != [_BQ_BF16, _BC_BF16, _KC_BF16]:
        raise RuntimeError(f'{path}: tiles {[t.value for t in tiles]} != '
                           f'{[_BQ_BF16, _BC_BF16, _KC_BF16]}')
    return lib


def _load_bf16():
    global _lib_bf16
    with _lock:
        if _lib_bf16 is None:
            _lib_bf16 = bind_nn1_bf16(build()['nn1_bf16'])
    return _lib_bf16


def _count(name: str, n: int) -> None:
    """Add n to the launch counter `name` under a lock: host threads
    that share a card launch concurrently."""
    with _count_lock:
        globals()[name] += n


def _check_operand(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError('nearest_1 takes 2-D [Q,D] queries and [C,D] '
                         'candidates')
    if x.dtype != torch.float32:
        raise TypeError('nearest_1 takes float32 tensors')
    if not x.is_contiguous():
        raise ValueError('nearest_1 takes contiguous tensors')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'nearest_1 runs on cuda or cpu, not {x.device}')


def _check(q: torch.Tensor, c: torch.Tensor) -> None:
    _check_operand(q)
    _check_operand(c)
    if q.device != c.device:
        raise ValueError(f'queries on {q.device}, candidates on {c.device}')
    if q.shape[1] != c.shape[1]:
        raise ValueError(f'feature widths differ: {q.shape[1]} vs '
                         f'{c.shape[1]}')
    if c.shape[0] == 0:
        raise ValueError('no candidates')


def candidate_ranges(n_q: int, n_c: int, n_sm: int, bq: int = _BQ,
                     bc: int = _BC) -> tuple[int, int]:
    """(n_range, tiles_per_range): how a kernel whose blocks own bq
    queries and walk tiles of bc candidates (K1's by default) splits the
    candidate tiles into ranges, one block per (query tile, range) and
    one block per SM at a time. r ranges take ceil(q_tiles * r / n_sm)
    waves of 1/r of the walk each; the fewest ranges within 5% of the
    best such time win, so a full query chunk keeps one range and a short
    one spreads over the SMs. No range is empty."""
    q_tiles = -(-n_q // bq)
    c_tiles = -(-n_c // bc)
    r_max = min(c_tiles, 4 * n_sm)
    cost = [-(-q_tiles * r // n_sm) / r for r in range(1, r_max + 1)]
    want = next(r for r, t in enumerate(cost, 1) if t <= 1.05 * min(cost))
    per = -(-c_tiles // want)
    return -(-c_tiles // per), per


def full_chunk(device) -> int:
    """The query chunk that gives every SM of `device` one query tile (a
    CPU has no tiles to fill: the TPU kernel's 16384)."""
    if torch.device(device).type != 'cuda':
        return 16384
    return _BQ * torch.cuda.get_device_properties(
        device).multi_processor_count


@dataclasses.dataclass
class Prepared:
    """Candidates as the K1 kernel walks them: `ct` [tiles, dim_pad + 1,
    256] f32, per 256-candidate tile the features k-major (rows dim.. and
    the columns past n_c zero) and, as its last row, the candidates'
    squared norms (+inf past n_c), of `n_c` candidates of width `dim`."""
    ct: torch.Tensor
    n_c: int
    dim: int

    @property
    def dim_pad(self) -> int:
        return self.ct.shape[1] - 1

    def rows(self) -> torch.Tensor:
        """The candidates back as contiguous [n_c, dim] rows."""
        return self.ct[:, :self.dim].permute(0, 2, 1).reshape(
            -1, self.dim)[:self.n_c].contiguous()

    def norms(self) -> torch.Tensor:
        """The [n_c] squared norms."""
        return self.ct[:, -1].reshape(-1)[:self.n_c]


def _prepared_shape(n_c: int, dim: int) -> tuple[int, int, int]:
    return -(-n_c // _BC), -(-dim // _KG) * _KG + 1, _BC


def _norms_plain(c: torch.Tensor) -> torch.Tensor:
    """The [n_c] squared norms in the prepare kernels' order: 32 strided
    partial sums over k = lane, lane + 32, ... then the xor tree 16, 8,
    4, 2, 1. Each step p + v*v is formed in float64 and rounded to f32,
    which is the kernels' fmaf but for a double rounding (about one step
    in 2^29), so it equals them bit for bit wherever the sums are
    exact."""
    n_c, dim = c.shape
    k32 = -(-dim // 32) * 32
    x = c.new_zeros((n_c, k32), dtype=torch.float64)
    x[:, :dim] = c
    x = x.view(n_c, k32 // 32, 32)
    part = c.new_zeros((n_c, 32))
    for s in range(k32 // 32):
        part = (part.double() + x[:, s] * x[:, s]).float()
    lanes = torch.arange(32, device=c.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ off]
    return part[:, 0]


def nn1_prepare_plain(c: torch.Tensor) -> Prepared:
    """The plain version of the prepare kernel: the padded per-tile
    transpose, and the norms in the kernel's order (_norms_plain)."""
    n_c, dim = c.shape
    tiles, rows, bc = _prepared_shape(n_c, dim)
    wide = c.new_zeros((tiles * bc, rows))      # [c_pad, dim_pad + 1]
    wide[:n_c, :dim] = c
    wide[:, -1] = float('inf')
    wide[:n_c, -1] = _norms_plain(c)
    ct = wide.view(tiles, bc, rows).permute(0, 2, 1).contiguous()
    return Prepared(ct, n_c, dim)


def prepare(c: torch.Tensor) -> Prepared:
    """Candidates [C, D] f32 -> Prepared, once per candidate set: the
    prepare kernel on the card, nn1_prepare_plain on the CPU."""
    _check_operand(c)
    n_c, dim = c.shape
    if n_c == 0:
        raise ValueError('no candidates')
    if dim > _MAX_DIM:
        raise ValueError(f'feature width {dim} > {_MAX_DIM}')
    if c.device.type == 'cpu':
        return nn1_prepare_plain(c)
    shape = _prepared_shape(n_c, dim)
    ct = torch.empty(shape, dtype=torch.float32, device=c.device)
    lib = _load()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.tiler_nn1_prepare(c.data_ptr(), n_c, dim, shape[1] - 1,
                                   ct.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'nn1_prepare kernel launch failed: cudaError '
                           f'{rc}')
    _count('LAUNCHES_PREP', 1)
    return Prepared(ct, n_c, dim)


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


def _range_launch(fn, q: torch.Tensor, prep, bq: int = _BQ, bc: int = _BC):
    """Allocate the outputs (and per-range scratch) and launch a 1-NN
    kernel with bq x bc tiles over candidate ranges of the prepared set.
    Returns (idx, err, launched)."""
    n_q, dim = q.shape
    err = torch.empty(n_q, dtype=torch.float32, device=q.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q.device)
    if n_q == 0:
        return idx, err, False
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_range, per = candidate_ranges(n_q, prep.n_c, n_sm, bq, bc)
    part_err = part_idx = None
    if n_range > 1:
        part_err = torch.empty((n_range, n_q), dtype=torch.float32,
                               device=q.device)
        part_idx = torch.empty((n_range, n_q), dtype=torch.int32,
                               device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), prep.ct.data_ptr(), n_q, prep.n_c, dim,
                prep.dim_pad, n_range, per,
                err.data_ptr(), idx.data_ptr(),
                None if part_err is None else part_err.data_ptr(),
                None if part_idx is None else part_idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} kernel launch failed: '
                           f'cudaError {rc}')
    return idx, err, True


def _check_prepared(q: torch.Tensor, prep) -> None:
    """q against a Prepared or a PreparedBf16 set."""
    _check_operand(q)
    if isinstance(prep, PreparedBf16):
        dtype, shape_of, maker = torch.uint8, _prepared_bf16_shape, \
            'prepare_bf16'
    else:
        dtype, shape_of, maker = torch.float32, _prepared_shape, 'prepare'
    if prep.n_c < 1 or prep.dim < 1 or prep.ct.dtype != dtype \
            or prep.ct.shape != shape_of(prep.n_c, prep.dim) \
            or not prep.ct.is_contiguous():
        raise ValueError(f'candidates not as {maker}() makes them')
    if q.device != prep.ct.device:
        raise ValueError(f'queries on {q.device}, candidates on '
                         f'{prep.ct.device}')
    if q.shape[1] != prep.dim:
        raise ValueError(f'feature widths differ: {q.shape[1]} vs '
                         f'{prep.dim}')


def nearest_1(q: torch.Tensor, c):
    """Exact 1-NN of each query row among the candidates, raw rows [C, D]
    or a Prepared set: (idx [Q] int32, err [Q] float32 squared L2), the
    lexicographic minimum of (distance, index). CUDA tensors go through
    the kernels (prepare first for raw rows), CPU tensors through
    nearest_1_plain."""
    if isinstance(c, Prepared):
        _check_prepared(q, c)
        if q.device.type == 'cpu':
            return nearest_1_plain(q, c.rows())
        prep = c
    else:
        if isinstance(c, PreparedBf16):
            raise TypeError('nearest_1 takes raw rows or prepare()\'s '
                            'candidates, not prepare_bf16()\'s')
        _check(q, c)
        if q.device.type == 'cpu':
            return nearest_1_plain(q, c)
        prep = prepare(c)
    idx, err, launched = _range_launch(_load().tiler_nn1, q, prep)
    _count('LAUNCHES', launched)
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
    _check(q, c)
    if q.device.type == 'cpu':
        return nearest_1_aug_plain(q, c)
    qa, ca, q2 = augment(q, c)
    idx, score, launched = _range_launch(_load().tiler_nn1_aug, qa,
                                         prepare(ca))
    _count('LAUNCHES_AUG', launched)
    return idx, score + q2


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest bf16 (ties to even), kept f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def nearest_1_bf16_plain(q: torch.Tensor, c: torch.Tensor,
                         c_chunk: int = 8192, c2: torch.Tensor = None):
    """The bf16 1-NN's plain version: norms from the f32 rows (or the
    candidates' norms c2 where the caller has them), the dot of the
    bf16-rounded rows as an f32 matmul (TF32 off, so every product is
    exact, as on the matrix unit), first argmin per chunk, strict `<`
    across chunks. Returns (idx [Q] int32, err [Q] float32)."""
    q2 = torch.sum(q * q, dim=1)
    qb = bf16_round(q)

    def dist_of(cs, ce):
        chunk = c[cs:ce]
        n2 = torch.sum(chunk * chunk, dim=1) if c2 is None else c2[cs:ce]
        return q2[:, None] + n2[None, :] - 2.0 * (qb @ bf16_round(chunk).T)
    return _argmin_chunks(dist_of, q.shape[0], c.shape[0], c_chunk,
                          q.device)


@dataclasses.dataclass
class PreparedBf16:
    """Candidates as the bf16 kernel walks them: `ct` [tiles, 128 *
    (2 * dim_pad + 4)] uint8, per 128-candidate tile dim_pad / 64 blocks
    [128, 64] bf16 (one per 64-wide K-chunk of the features, zero past
    dim and past n_c), each row 128 bytes whose 16-byte group g sits at
    g ^ (row % 8) (the 128-byte swizzle), then the tile's 128 f32 squared
    norms of the unrounded rows (+inf past n_c), of `n_c` candidates of
    width `dim`."""
    ct: torch.Tensor
    n_c: int
    dim: int

    @property
    def dim_pad(self) -> int:
        return -(-self.dim // _KC_BF16) * _KC_BF16

    def _split(self):
        """(bf16 [tiles, chunks, 128, 8, 8] swizzled, f32 [tiles, 128])."""
        cut = _BC_BF16 * 2 * self.dim_pad
        feats = self.ct[:, :cut].contiguous().view(torch.bfloat16)
        norms = self.ct[:, cut:].contiguous().view(torch.float32)
        return feats.view(-1, self.dim_pad // _KC_BF16, _BC_BF16, 8, 8), norms

    def rows(self) -> torch.Tensor:
        """The rounded candidates back as contiguous [n_c, dim] f32 rows."""
        feats = _swizzle_groups(self._split()[0]).permute(0, 2, 1, 3, 4)
        return feats.reshape(-1, self.dim_pad)[:self.n_c, :self.dim] \
            .float().contiguous()

    def norms(self) -> torch.Tensor:
        """The [n_c] squared norms (of the unrounded rows)."""
        return self._split()[1].reshape(-1)[:self.n_c]


def _prepared_bf16_shape(n_c: int, dim: int) -> tuple[int, int]:
    dim_pad = -(-dim // _KC_BF16) * _KC_BF16
    return -(-n_c // _BC_BF16), _BC_BF16 * (2 * dim_pad + 4)


def _swizzle_groups(x: torch.Tensor) -> torch.Tensor:
    """x [..., rows, 8, 8] -> the same with group g of each row at
    g ^ (row % 8); applying it twice gives x back."""
    rows = x.shape[-3]
    at = (torch.arange(8, device=x.device)[None, :]
          ^ (torch.arange(rows, device=x.device) % 8)[:, None])
    return torch.gather(x, -2, at[:, :, None].expand_as(x))


def nn1_bf16_prepare_plain(c: torch.Tensor) -> PreparedBf16:
    """The plain version of the bf16 prepare kernel: the rows rounded to
    bf16 (ties to even), padded, cut into tiles and K-chunks and
    swizzled, and the norms of the unrounded rows in the kernel's order
    (_norms_plain), byte for byte the kernel's output."""
    n_c, dim = c.shape
    tiles, tile_bytes = _prepared_bf16_shape(n_c, dim)
    chunks = -(-dim // _KC_BF16)
    wide = torch.zeros((tiles * _BC_BF16, chunks * _KC_BF16),
                       dtype=torch.bfloat16, device=c.device)
    wide[:n_c, :dim] = c.to(torch.bfloat16)
    feats = _swizzle_groups(wide.view(tiles, _BC_BF16, chunks, 8, 8)
                            .permute(0, 2, 1, 3, 4)).contiguous()
    norms = c.new_full((tiles * _BC_BF16,), float('inf'))
    norms[:n_c] = _norms_plain(c)
    ct = torch.cat([feats.view(torch.uint8).view(tiles, -1),
                    norms.view(torch.uint8).view(tiles, -1)], dim=1)
    assert ct.shape == (tiles, tile_bytes)
    return PreparedBf16(ct, n_c, dim)


def prepare_bf16(c: torch.Tensor) -> PreparedBf16:
    """Candidates [C, D] f32 -> PreparedBf16, once per candidate set: the
    bf16 prepare kernel on the card, nn1_bf16_prepare_plain on the CPU."""
    _check_operand(c)
    n_c, dim = c.shape
    if n_c == 0:
        raise ValueError('no candidates')
    if not 1 <= dim <= _MAX_DIM_BF16:
        raise ValueError(f'feature width {dim} not in 1..{_MAX_DIM_BF16}')
    if c.device.type == 'cpu':
        return nn1_bf16_prepare_plain(c)
    prep = PreparedBf16(torch.empty(_prepared_bf16_shape(n_c, dim),
                                    dtype=torch.uint8, device=c.device),
                        n_c, dim)
    lib = _load_bf16()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.tiler_nn1_bf16_prepare(c.data_ptr(), n_c, dim, prep.dim_pad,
                                        prep.ct.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f'nn1_bf16_prepare kernel launch failed: '
                           f'cudaError {rc}')
    _count('LAUNCHES_BF16_PREP', 1)
    return prep


def candidate_ranges_bf16(n_q: int, n_c: int, n_sm: int) -> tuple[int, int]:
    """candidate_ranges at the bf16 kernel's tiles."""
    return candidate_ranges(n_q, n_c, n_sm, _BQ_BF16, _BC_BF16)


def nearest_1_bf16(q: torch.Tensor, c):
    """1-NN with the dot's operands rounded to bf16 and accumulated in f32
    (`_nn_call_bf16`), the norms in f32 from the unrounded rows, among raw
    rows [C, D] or a PreparedBf16 set: (idx [Q] int32, err [Q] float32),
    the lexicographic minimum of (distance, index). CUDA tensors go
    through the kernels (prepare_bf16 first for raw rows), CPU tensors
    through nearest_1_bf16_plain."""
    if isinstance(c, PreparedBf16):
        _check_prepared(q, c)
        if q.device.type == 'cpu':
            return nearest_1_bf16_plain(q, c.rows(), c2=c.norms())
        prep = c
    else:
        if isinstance(c, Prepared):
            raise TypeError('nearest_1_bf16 takes raw rows or '
                            'prepare_bf16()\'s candidates, not prepare()\'s')
        _check(q, c)
        if q.shape[1] > _MAX_DIM_BF16:
            raise ValueError(f'feature width {q.shape[1]} > '
                             f'{_MAX_DIM_BF16}')
        if q.device.type == 'cpu':
            return nearest_1_bf16_plain(q, c)
        prep = prepare_bf16(c)
    idx, err, launched = _range_launch(_load_bf16().tiler_nn1_bf16, q, prep,
                                       _BQ_BF16, _BC_BF16)
    _count('LAUNCHES_BF16', launched)
    return idx, err
