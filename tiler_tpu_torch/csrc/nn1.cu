// Fused exact 1-NN for Hopper (sm_90a): for every query row, the index and
// squared L2 distance of its nearest candidate row.
//
// Replaces the TPU kernel `_nn_kernel` / `_nn_call` in
// tiler_tpu/ops/pallas_kernels.py, which FrameTiling's stage 3 runs once
// per 16k-query chunk against up to ~1M candidate PsyV features (D=192).
// What it computes is the same, not a block-by-block copy:
//   d(q, c) = (|q|^2 + |c|^2) - 2 * q.c   in f32, norms in f32;
//   out     = the lexicographic minimum of (d, candidate index), i.e. the
//             first minimum within the candidate walk, with an earlier
//             candidate winning on an equal distance (the TPU kernel's
//             first-argmin per chunk plus strict `<` across chunks).
// Candidates padded with 1e9 components (as FrameTiling's JAX layout
// pads) have distances near 2e20 and never win; ragged Q and C are masked
// here, so callers need no padding.
//
// Design. The TPU walked candidate chunks along a sequential grid axis and
// carried the running (err, idx) in the output block. Blocks on a GPU run
// in no order, so one block owns a tile of BQ=128 queries and walks ALL
// candidate tiles in a loop; the running pairs live in registers. The
// query tile (D x 128 floats, 96 KB at D=192) stays in shared memory for
// the whole walk. Each candidate tile (128 rows) streams through shared
// memory in BK=32-wide slices of D, double-buffered: the next slice's
// global loads are in flight while the current one is multiplied, so one
// barrier per slice suffices. 256 threads form a 16x16 grid; each owns an
// 8x8 register micro-tile of dot products, accumulated with FP32 FFMA (no
// tensor cores, no TF32, so the sums are plain f32), fed by four 16-byte
// shared loads per 64 FFMAs. Candidate norms are summed by the threads
// that stage the slices, off the FFMA loop. The epilogue forms the
// distances, reduces each query's row across the 16 threads that share it
// with warp shuffles, and merges into the running pair.
//
// Bound on this card: 2*Q*C*D FP32 operations against the non-tensor FP32
// rate (67 TFLOP/s dense at 700 W on an H100 SXM); the candidate matrix is
// re-read from L2/HBM once per query tile, about 1/64 of an operation per
// byte of FFMA work, so the FFMA pipe and not memory is the limit. One
// block per SM (the query tile takes most of its shared memory): when the
// query tiles alone cannot fill the SMs (a keyframe's last, short query
// chunk), the caller splits the candidates into ranges along the grid's
// second axis, each block writes its range's (err, idx), and nn1_merge
// takes the lexicographic minimum over the ranges. Tensor cores (wgmma,
// TMA staging) and more blocks per SM are later work.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int BQ = 128;              // queries per block
constexpr int BC = 128;              // candidates per tile
constexpr int BK = 32;               // D-slice staged per step
constexpr int NT = 256;              // threads per block (16 x 16)
constexpr int LDC = BC + 4;          // padded rows, still 16-byte aligned
constexpr int LOADS = BC * BK / NT;  // candidate elements staged per thread
constexpr int ROWS_PER_PASS = NT / BK;
constexpr int TM = BQ / 16;          // micro-tile: TM queries x 8 candidates

// the query row of a thread's micro-tile row i: 4ty..4ty+3, then +64
__device__ __forceinline__ int q_row(int ty, int i) {
  return (i >> 2) * 64 + ty * 4 + (i & 3);
}

__device__ __forceinline__ bool lex_less(float e1, int i1, float e2, int i2) {
  return e1 < e2 || (e1 == e2 && i1 < i2);
}

__device__ __forceinline__ int kpad_of(int dim) {
  return (dim + BK - 1) / BK * BK;
}

__global__ void __launch_bounds__(NT, 1)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ c,
           int n_q, int n_c, int dim, int tiles_per_range,
           float* __restrict__ err_out, int* __restrict__ idx_out) {
  extern __shared__ float4 smem4[];
  const int kpad = kpad_of(dim);
  float* qs = reinterpret_cast<float*>(smem4);  // [kpad][BQ], zero-padded
  float* cs = qs + kpad * BQ;                   // [2][BK][LDC]
  float* c2s = cs + 2 * BK * LDC;               // [2][BC] tile norms
  float* q2s = c2s + 2 * BC;                    // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // candidate lane: columns 4tx..4tx+3, +64
  const int ty = tid >> 4;  // query lane: rows 4ty..4ty+3, +64
  const int q0 = blockIdx.x * BQ;
  const float inf = __int_as_float(0x7f800000);
  const int n_k = kpad / BK;
  // this block's candidate range [c_lo, c_hi) (the whole set when the
  // grid has one range); the outputs are offset to the range's slot
  const int c_lo = blockIdx.y * tiles_per_range * BC;
  const int c_hi = min(n_c, c_lo + tiles_per_range * BC);
  const int steps = c_hi > c_lo ? (c_hi - c_lo + BC - 1) / BC * n_k : 0;
  err_out += (size_t)blockIdx.y * n_q;
  idx_out += (size_t)blockIdx.y * n_q;

  // stage the query tile, transposed (once per block)
  for (int e = tid; e < BQ * kpad; e += NT) {
    const int r = e / kpad, k = e - r * kpad;
    const int gq = q0 + r;
    qs[k * BQ + r] = (gq < n_q && k < dim) ? q[(size_t)gq * dim + k] : 0.f;
  }

  // candidate staging: thread holds slice column kl of rows
  // tid/BK + ROWS_PER_PASS*i, and sums their squares for the norms
  const int kl = tid % BK;
  float pre[LOADS], part[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) part[i] = 0.f;

  auto load = [&](int st) {
    const int t = st / n_k;
    const int gk = (st - t * n_k) * BK + kl;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int gc = c_lo + t * BC + tid / BK + ROWS_PER_PASS * i;
      pre[i] = (gc < c_hi && gk < dim) ? __ldg(c + (size_t)gc * dim + gk)
                                      : 0.f;
    }
  };
  auto commit = [&](int st) {
    const int t = st / n_k;
    float* cb = cs + (st & 1) * BK * LDC;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      cb[kl * LDC + tid / BK + ROWS_PER_PASS * i] = pre[i];
      part[i] = fmaf(pre[i], pre[i], part[i]);
    }
    if (st - t * n_k == n_k - 1) {  // the tile's last slice: norms done
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        float v = part[i];
#pragma unroll
        for (int off = BK / 2; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (kl == 0) c2s[(t & 1) * BC + tid / BK + ROWS_PER_PASS * i] = v;
        part[i] = 0.f;
      }
    }
  };

  if (steps > 0) {
    load(0);
    commit(0);
  }
  __syncthreads();
  if (tid < BQ) {
    float s = 0.f;
    for (int k = 0; k < dim; ++k)
      s = fmaf(qs[k * BQ + tid], qs[k * BQ + tid], s);
    q2s[tid] = s;
  }
  __syncthreads();
  float q2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) q2[i] = q2s[q_row(ty, i)];

  float run_e[TM];
  int run_i[TM];
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    run_e[i] = inf;
    run_i[i] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int st = 0; st < steps; ++st) {
    const int t = st / n_k;
    const int s = st - t * n_k;
    const bool more = st + 1 < steps;
    if (more) load(st + 1);  // in flight during the FFMAs below

    const float* cb = cs + (st & 1) * BK * LDC;
    const float* qb = qs + s * BK * BQ;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 v =
            *reinterpret_cast<const float4*>(qb + k * BQ + i4 * 64 + ty * 4);
        a[4 * i4] = v.x;
        a[4 * i4 + 1] = v.y;
        a[4 * i4 + 2] = v.z;
        a[4 * i4 + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(cb + k * LDC + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(cb + k * LDC + 64 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    // the other buffer was last read in step st-1, before its barrier
    if (more) commit(st + 1);

    if (s == n_k - 1) {
      // epilogue: distances, per-row minimum over the tile, running merge
      const float* c2b = c2s + (t & 1) * BC;
      const int c0 = c_lo + t * BC;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float be = inf;
        int bi = INT_MAX;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (j >> 2) * 64 + tx * 4 + (j & 3);
          const int gc = c0 + col;
          if (gc < c_hi) {
            const float d = (q2[i] + c2b[col]) - 2.f * acc[i][j];
            if (lex_less(d, gc, be, bi)) { be = d; bi = gc; }
          }
          acc[i][j] = 0.f;
        }
        // the 16 threads of one query row are 16 consecutive lanes
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float oe = __shfl_xor_sync(0xffffffffu, be, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (lex_less(oe, oi, be, bi)) { be = oe; bi = oi; }
        }
        if (lex_less(be, bi, run_e[i], run_i[i])) {
          run_e[i] = be;
          run_i[i] = bi;
        }
      }
    }
    __syncthreads();
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gq = q0 + q_row(ty, i);
      if (gq < n_q) {
        err_out[gq] = run_e[i];
        idx_out[gq] = run_i[i];
      }
    }
  }
}

// Lexicographic (err, idx) minimum over n_range per-range results
// [n_range][n_q], in range order.
__global__ void nn1_merge(const float* __restrict__ part_err,
                          const int* __restrict__ part_idx, int n_q,
                          int n_range, float* __restrict__ err_out,
                          int* __restrict__ idx_out) {
  const int gq = blockIdx.x * blockDim.x + threadIdx.x;
  if (gq >= n_q) return;
  float be = part_err[gq];
  int bi = part_idx[gq];
  for (int r = 1; r < n_range; ++r) {
    const float e = part_err[(size_t)r * n_q + gq];
    const int i = part_idx[(size_t)r * n_q + gq];
    if (lex_less(e, i, be, bi)) { be = e; bi = i; }
  }
  err_out[gq] = be;
  idx_out[gq] = bi;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for a feature width of `dim`.
size_t tiler_nn1_smem_bytes(int dim) {
  const size_t kpad = (size_t)(dim + BK - 1) / BK * BK;
  return sizeof(float) * (kpad * BQ + 2 * BK * LDC + 2 * BC + BQ);
}

// Launch on `stream` (a cudaStream_t); allocates nothing, does not
// synchronise. The candidates are walked as n_range ranges of
// tiles_per_range 128-row tiles; with n_range > 1 the caller provides
// part_err/part_idx of n_range * n_q elements and no range may be empty.
// Returns cudaGetLastError() after the launches (0 = success).
int tiler_nn1(const void* q, const void* c, int n_q, int n_c, int dim,
              int n_range, int tiles_per_range, void* err_out,
              void* idx_out, void* part_err, void* part_idx, void* stream) {
  if (n_q <= 0) return 0;
  if (n_range < 1 || tiles_per_range < 1 ||
      (n_range > 1 && (part_err == nullptr || part_idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiler_nn1_smem_bytes(dim);
  cudaError_t rc = cudaFuncSetAttribute(
      nn1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n_q + BQ - 1) / BQ, n_range);
  nn1_kernel<<<grid, NT, smem, st>>>(
      (const float*)q, (const float*)c, n_q, n_c, dim, tiles_per_range,
      (float*)(n_range > 1 ? part_err : err_out),
      (int*)(n_range > 1 ? part_idx : idx_out));
  rc = cudaGetLastError();
  if (rc != cudaSuccess || n_range == 1) return (int)rc;
  nn1_merge<<<(n_q + 255) / 256, 256, 0, st>>>(
      (const float*)part_err, (const int*)part_idx, n_q, n_range,
      (float*)err_out, (int*)idx_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
