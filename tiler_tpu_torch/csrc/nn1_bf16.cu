// Exact-argmin 1-NN with a bf16 tensor-core dot, for Hopper (sm_90a): for
// every query row, the index and distance of its nearest candidate row,
// where the distance is
//   d(q, c) = (|q|^2 + |c|^2) - 2 * dot(bf16(q), bf16(c))
// with the norms summed in f32 from the unrounded f32 rows, the dot's
// operands rounded to bf16 (round to nearest even, as astype(bfloat16)
// rounds) and their products accumulated in f32. The result is the
// lexicographic minimum of (d, candidate index): an earlier candidate wins
// an equal distance.
//
// Replaces the TPU kernel `_nn_kernel_bf16` / `_nn_call_bf16` in
// tiler_tpu/ops/pallas_kernels.py, an experiment (tools/nn_prec_bench.py)
// that asks what one bf16 matrix-unit pass instead of f32 math buys, and
// how many 1-NN winners it changes. The encoder never calls it.
//
// Design. One block owns BQ = 128 queries (8 warps, 16 query rows each)
// and walks every candidate tile of BC = 64 rows in a loop; the running
// (err, idx) pairs stay in registers. The query tile is converted to bf16
// once and stays in shared memory; each candidate tile is loaded with
// coalesced row reads, converted to bf16 and stored to shared memory by
// the same threads that sum its f32 norms. Each warp's dot products run on
// the tensor cores as mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// per 16-wide k-step one A fragment (its 16 query rows) against the tile's
// 8 column fragments of 8 candidates, accumulating in f32 registers. In
// the accumulator, lane l holds rows l/4 and l/4 + 8 and columns
// 2 (l % 4) + {0, 1} of each 16 x 8 tile; the epilogue forms d, keeps each
// row's lexicographic minimum over the lane's 16 columns, and reduces the
// four lanes of a quad with shuffles. Ragged Q and C are masked (padded
// rows are zero and never written or chosen); 1e9 padding rows have
// distances near 2e20 and never win.
//
// Bound on this card: the tensor cores do 2*Q*C*D operations at up to 989
// TFLOP/s dense bf16, so this simple kernel is bound by staging instead:
// every block re-reads and converts the whole f32 candidate matrix through
// shared memory, with no pipelining of loads against the mma. wgmma, TMA
// staging of pre-converted candidates and candidate-range splitting for
// short query chunks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // queries per block
constexpr int BC = 64;        // candidates per tile
constexpr int NW = BQ / 16;   // warps per block, 16 query rows each
constexpr int NT = NW * 32;   // threads per block
constexpr int NJ = BC / 8;    // 8-column mma tiles per candidate tile
constexpr int PAD = 8;        // bf16 row padding against bank conflicts

__device__ __forceinline__ bool lex_less(float e1, int i1, float e2, int i2) {
  return e1 < e2 || (e1 == e2 && i1 < i2);
}

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + n_rows) of the f32 matrix src [n_src, dim] into
// dst [n_rows][ld] as bf16 (zero beyond dim and beyond n_src), and write
// each row's f32 squared norm to norm[]. One warp per row at a time,
// lanes striding the row, so global reads are coalesced.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int n_src, int dim, int kpad, int r0,
                                      int n_rows, int ld,
                                      __nv_bfloat16* dst, float* norm) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < n_rows; r += NW) {
    const int g = r0 + r;
    const bool live = g < n_src;
    const float* row = src + (size_t)g * dim;
    float s = 0.f;
    for (int k = lane; k < kpad; k += 32) {
      const float v = (live && k < dim) ? __ldg(row + k) : 0.f;
      s = fmaf(v, v, s);
      dst[r * ld + k] = __float2bfloat16_rn(v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) norm[r] = s;
  }
}

__global__ void __launch_bounds__(NT)
nn1_bf16_kernel(const float* __restrict__ q, const float* __restrict__ c,
                int n_q, int n_c, int dim, float* __restrict__ err_out,
                int* __restrict__ idx_out) {
  extern __shared__ uint4 smem16[];
  const int kpad = (dim + 15) / 16 * 16;
  const int ld = kpad + PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem16);  // [BQ][ld]
  __nv_bfloat16* cs = qs + BQ * ld;                              // [BC][ld]
  float* q2s = reinterpret_cast<float*>(cs + BC * ld);           // [BQ]
  float* c2s = q2s + BQ;                                         // [BC]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // accumulator rows g and g + 8
  const int t2 = (lane & 3) * 2;  // accumulator columns t2 and t2 + 1
  const int q0 = blockIdx.x * BQ;
  const float inf = __int_as_float(0x7f800000);

  stage(q, n_q, dim, kpad, q0, BQ, ld, qs, q2s);
  __syncthreads();
  const __nv_bfloat16* qa = qs + (warp * 16 + g) * ld + t2;
  const float q2[2] = {q2s[warp * 16 + g], q2s[warp * 16 + g + 8]};
  float run_e[2] = {inf, inf};
  int run_i[2] = {0, 0};

  for (int c0 = 0; c0 < n_c; c0 += BC) {
    stage(c, n_c, dim, kpad, c0, BC, ld, cs, c2s);
    __syncthreads();

    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < kpad; k0 += 16) {
      // A fragment: rows g, g + 8 of the warp's 16; columns t2 + {0,1}
      // and t2 + 8 + {0,1} of this k-step
      const uint32_t a0 = ld_b32(qa + k0);
      const uint32_t a1 = ld_b32(qa + 8 * ld + k0);
      const uint32_t a2 = ld_b32(qa + k0 + 8);
      const uint32_t a3 = ld_b32(qa + 8 * ld + k0 + 8);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // B fragment (column-major 16 x 8): candidate j*8 + g, k rows
        // t2 + {0,1} and t2 + 8 + {0,1}
        const __nv_bfloat16* cb = cs + (j * 8 + g) * ld + k0 + t2;
        mma_bf16(acc[j], a0, a1, a2, a3, ld_b32(cb), ld_b32(cb + 8));
      }
    }

    // epilogue: each lane's two rows over its 16 columns, then the quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float be = inf;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * 8 + t2 + e;
          const int gc = c0 + col;
          if (gc < n_c) {
            const float d = (q2[h] + c2s[col]) - 2.f * acc[j][2 * h + e];
            if (lex_less(d, gc, be, bi)) { be = d; bi = gc; }
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float oe = __shfl_xor_sync(0xffffffffu, be, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (lex_less(oe, oi, be, bi)) { be = oe; bi = oi; }
      }
      if (lex_less(be, bi, run_e[h], run_i[h])) {
        run_e[h] = be;
        run_i[h] = bi;
      }
    }
    __syncthreads();  // the next tile overwrites cs and c2s
  }

  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + warp * 16 + g + 8 * h;
      if (gq < n_q) {
        err_out[gq] = run_e[h];
        idx_out[gq] = run_i[h];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t); allocates nothing, does not
// synchronise. q [n_q, dim] and c [n_c, dim] are f32, row-major; err_out
// [n_q] f32 and idx_out [n_q] int32. Returns cudaGetLastError() after the
// launch (0 = success).
int tiler_nn1_bf16(const void* q, const void* c, int n_q, int n_c, int dim,
                   void* err_out, void* idx_out, void* stream) {
  if (n_q <= 0) return 0;
  if (n_c <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const size_t ld = (size_t)(dim + 15) / 16 * 16 + PAD;
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + BC) * ld +
                      sizeof(float) * (BQ + BC);
  cudaError_t rc = cudaFuncSetAttribute(
      nn1_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  nn1_bf16_kernel<<<(n_q + BQ - 1) / BQ, NT, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, n_q, n_c, dim, (float*)err_out,
      (int*)idx_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
