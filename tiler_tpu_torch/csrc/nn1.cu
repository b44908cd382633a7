// Fused exact 1-NN for Hopper (sm_90a): for every query row, the index and
// squared L2 distance of its nearest candidate row.
//
// Replaces the TPU kernel `_nn_kernel` / `_nn_call` in
// tiler_tpu/ops/pallas_kernels.py, which FrameTiling's stage 3 runs once
// per query chunk against up to ~1.6M candidate PsyV features (D=192).
// What it computes is the same, not a block-by-block copy:
//   d(q, c) = (|q|^2 + |c|^2) - 2 * q.c   in f32, norms in f32;
//   out     = the lexicographic minimum of (d, candidate index), i.e. the
//             first minimum within the candidate walk, with an earlier
//             candidate winning on an equal distance (the TPU kernel's
//             first-argmin per chunk plus strict `<` across chunks).
// Every dot is one sequential fmaf chain over k = 0..D-1 and every norm
// has one fixed summation order (nn1_prepare_kernel), so the results do
// not depend on the tiling below. No tensor cores, no TF32.
//
// What bounds it: 2*Q*C*D FP32 operations against the card's non-tensor
// FP32 rate (67 TFLOP/s on the data sheet of an H100 SXM; 8 x 8
// outer-product FFMAs from registers alone reach 48.3 on an NVIDIA H100
// 80GB HBM3 at 700 W, tools/card_bench.py). The candidates are re-read
// once per query tile, mostly from L2, so memory is far from the limit.
// An FFMA kernel gets near that rate only if the math warps do nothing
// but FFMAs and shared loads, and enough of them are resident to hide the
// loads. The design:
//
// 1. nn1_prepare_kernel writes the candidates once per candidate set,
//    tile by tile and k-major within a tile: ct[C_pad/256][D_pad+1][256]
//    (D padded to 8 with zero rows, C to the 256-candidate tile with zero
//    columns); row D_pad of a tile holds its candidates' norms (+inf in
//    the padding). The TPU kernel sums the norms in its own body; here
//    they are summed once, not once per query tile.
// 2. A [BK][256] slice of a candidate tile is then one contiguous run of
//    BK KB. One lane copies it with a single cp.async.bulk (TMA's 1-D
//    bulk copy: no tensor map, no registers) into a ring of STAGES
//    buffers, AHEAD steps ahead of the math; each buffer has a `full`
//    mbarrier (the copy's bytes) and an `empty` one (one arrival per
//    warp). There is no __syncthreads in the walk. A tile's norms are the
//    row after its last slice and ride with it. (One copy per row, 16 to
//    32 a step, cost 7 ms of 44 at Q=16896, C=262144 on that card.)
// 3. A block owns 128 queries (k-major in shared memory for the whole
//    walk) and walks its candidate tiles with 16 warps. A warp tile is
//    32 queries x 64 candidates, 4 x 8 lanes with 8 x 8 accumulators each:
//    per k a lane issues four 16-byte shared loads for 64 FFMAs. The lanes
//    are interleaved so that any 4 consecutive ones form a 2 x 2 patch:
//    the card serves a 16-byte load in 2.1 cycles when every such 4 lanes
//    read at most 2 distinct chunks and in 4.0 otherwise (the same
//    tool), and no load has a bank conflict.
// 4. 512 threads at <= 128 registers: 4 warps per scheduler. The 64
//    accumulators, 16 to 32 operand registers and 8 running minima leave
//    no room for the running indices, which live in shared memory (they
//    are written only when a minimum improves), and the inner loop is
//    unrolled by 4, not 8: so ptxas spills nothing.
// 5. D is sliced in 8-row granules, so the augmented mode's 200 columns
//    cost 200 and not 224.
// 6. Each lane keeps the running (err, idx) minimum of its own columns
//    (it meets them in rising index order, so a strict `<` keeps the
//    lowest index); lanes and warps are merged once, after the walk.
//
// When the query tiles alone cannot fill the SMs (a keyframe's last, short
// query chunk), the caller splits the candidate tiles into ranges along
// the grid's second axis, each block writes its range's (err, idx), and
// nn1_merge takes the lexicographic minimum over the ranges.
//
// Augmented mode (AUG = true) replaces `_nn_kernel_aug` / `_nn_call_aug`
// in the same file: the caller folds the norms and the -2 into augmented
// operands qa = [q, 1, 0 x 7] and ca = [-2c, |c|^2, 0 x 7] (D + 8 = 200
// columns at D = 192), the score is the plain dot qa.ca = |c|^2 - 2 q.c,
// and the wrapper adds |q|^2 afterwards. The walk is the same; the norms
// are neither copied nor added.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;              // queries per block
constexpr int BC = 256;              // candidates per tile
constexpr int BK = 32;               // k rows per ring buffer
constexpr int KG = 8;                // granule of D: rows are padded to it
constexpr int STAGES = 3;            // ring buffers
constexpr int AHEAD = 1;             // steps the copies run ahead
constexpr int NT = 512;              // threads per block
constexpr int LANES_Q = 4;           // a warp is LANES_Q x LANES_C lanes
constexpr int LANES_C = 32 / LANES_Q;
constexpr int UNROLL = 4;            // k steps per trip of the inner loop
constexpr int WQ = LANES_Q * 8;      // warp tile: WQ queries x WC candidates
constexpr int WC = LANES_C * 8;
constexpr int WARPS_C = BC / WC;
constexpr int STAGE_FLOATS = (BK + 1) * BC;   // BK rows and the norms
constexpr int PREP_ROWS = 32;        // candidates per block of the prepare
constexpr int PREP_NT = 256;

static_assert(BC % PREP_ROWS == 0 && PREP_ROWS == 32, "prepare");
static_assert(BK % KG == 0 && KG % UNROLL == 0, "slices");
static_assert(AHEAD >= 1 && AHEAD < STAGES, "ring");
static_assert((BQ / WQ) * WARPS_C * 32 == NT, "warp grid");
static_assert(2 * WARPS_C * BQ <= STAGES * STAGE_FLOATS, "final merge");

__device__ __forceinline__ bool lex_less(float e1, int i1, float e2, int i2) {
  return e1 < e2 || (e1 == e2 && i1 < i2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared; its bytes complete on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Candidates [n_c][dim] row-major -> ct[c_pad / BC][dim_pad + 1][BC]:
// per 256-candidate tile the features k-major with zero padding, then the
// row of squared norms, each summed as per-lane partial sums over k =
// lane, lane + 32, ... (fmaf chains) and the xor tree 16, 8, 4, 2, 1; +inf
// for the padding candidates.
__global__ void __launch_bounds__(PREP_NT)
nn1_prepare_kernel(const float* __restrict__ c, int n_c, int dim,
                   int dim_pad, float* __restrict__ ct) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // [PREP_ROWS][dim_pad + 1]
  const int ld = dim_pad + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * PREP_ROWS;
  // this block's 32 columns of its tile
  float* out = ct + (size_t)(c0 / BC) * (dim_pad + 1) * BC + c0 % BC + lane;
  for (int r = warp; r < PREP_ROWS; r += PREP_NT / 32) {
    const int gc = c0 + r;
    float part = 0.f;
    for (int k = lane; k < dim_pad; k += 32) {
      const float v =
          (gc < n_c && k < dim) ? __ldg(c + (size_t)gc * dim + k) : 0.f;
      tile[r * ld + k] = v;
      part = fmaf(v, v, part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0)
      out[dim_pad * BC + r] = gc < n_c ? part : __int_as_float(0x7f800000);
  }
  __syncthreads();
  for (int k = warp; k < dim_pad; k += PREP_NT / 32)
    out[k * BC] = tile[lane * ld + k];
}

// One candidate tile's distances folded into the lane's running minima.
// The lane meets its columns in rising index order: strict `<`.
template <bool AUG, bool MASKED>
__device__ __forceinline__ void fold_tile(float (&acc)[8][8],
                                          const float* __restrict__ q2v,
                                          const float* __restrict__ c2v,
                                          int gc0, int c_hi,
                                          float (&run_e)[8], int* run_is) {
  float c2r[8] = {};
  if constexpr (!AUG) {
    const float4 x0 = *reinterpret_cast<const float4*>(c2v);
    const float4 x1 = *reinterpret_cast<const float4*>(c2v + LANES_C * 4);
    c2r[0] = x0.x; c2r[1] = x0.y; c2r[2] = x0.z; c2r[3] = x0.w;
    c2r[4] = x1.x; c2r[5] = x1.y; c2r[6] = x1.z; c2r[7] = x1.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float q2r = 0.f;   // one row's norm at a time: registers are scarce
    if constexpr (!AUG) q2r = q2v[(i >> 2) * (LANES_Q * 4) + (i & 3)];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = gc0 + (j >> 2) * (LANES_C * 4) + (j & 3);
      float d = acc[i][j];
      if constexpr (!AUG) d = (q2r + c2r[j]) - 2.f * d;
      if ((!MASKED || gc < c_hi) && d < run_e[i]) {
        run_e[i] = d;
        run_is[i * NT] = gc;
      }
      acc[i][j] = 0.f;
    }
  }
}

template <bool AUG>
__global__ void __launch_bounds__(NT, 1)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ ct,
           int n_q, int n_c, int c_tiles, int dim, int dim_pad,
           int tiles_per_range, float* __restrict__ err_out,
           int* __restrict__ idx_out) {
  extern __shared__ float4 smem4[];
  float* q2s = reinterpret_cast<float*>(smem4);  // [BQ] query norms
  float* qs = q2s + BQ;                          // [dim_pad][BQ], k-major
  float* ring = qs + dim_pad * BQ;               // [STAGES][STAGE_FLOATS]
  // the lanes' running indices [8][NT]: registers are the scarce resource
  int* run_is = reinterpret_cast<int*>(ring + STAGES * STAGE_FLOATS) +
                threadIdx.x;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_FLOATS + 8 * NT);
  const uint32_t full0 = smem_u32(bars);        // full[STAGES]
  const uint32_t empty0 = full0 + 8 * STAGES;   // empty[STAGES]
  const uint32_t ring0 = smem_u32(ring);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // lanes interleaved so that every 4 consecutive lanes are 2 x 2: they
  // read 2 distinct 16-byte chunks of each operand, which the card
  // serves at twice the rate of 4 distinct ones
  const int tx = (lane & 1) | ((lane >> 2) % (LANES_C / 2)) << 1;  // cand.
  const int ty = ((lane >> 1) & 1) | (lane / (2 * LANES_C)) << 1;  // query
  const int wq0 = (warp / WARPS_C) * WQ;
  const int wc0 = (warp % WARPS_C) * WC;
  const int q0 = blockIdx.x * BQ;
  const float inf = __int_as_float(0x7f800000);

  // this block's candidate tiles [t_lo, t_hi) (all of them when the grid
  // has one range); the outputs are offset to the range's slot
  const int t_lo = blockIdx.y * tiles_per_range;
  const int t_hi = min(c_tiles, t_lo + tiles_per_range);
  const int n_k = (dim_pad + BK - 1) / BK;
  const int steps = max(t_hi - t_lo, 0) * n_k;
  err_out += (size_t)blockIdx.y * n_q;
  idx_out += (size_t)blockIdx.y * n_q;

  if (tid == 0) {
    for (int b = 0; b < STAGES; ++b) {
      mbar_init(full0 + 8 * b, 1);
      mbar_init(empty0 + 8 * b, NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // stage the query tile, transposed (once per block)
  for (int e = tid; e < BQ * dim_pad; e += NT) {
    const int r = e / dim_pad, k = e - r * dim_pad;
    const int gq = q0 + r;
    qs[k * BQ + r] = (gq < n_q && k < dim) ? q[(size_t)gq * dim + k] : 0.f;
  }
  __syncthreads();
  if (!AUG && tid < BQ) {
    float s = 0.f;
    for (int k = 0; k < dim; ++k)
      s = fmaf(qs[k * BQ + tid], qs[k * BQ + tid], s);
    q2s[tid] = s;
  }
  __syncthreads();

  // one lane issues step (tile lt, slice ls) into buffer lb: a single
  // copy of the slice's rows, plus the norms' row after a tile's last
  // slice; `refill` says the buffer was used before, and `parity` is that
  // use's phase
  auto issue = [&](int lt, int ls, int lb, bool refill, uint32_t parity) {
    const int rows = min(BK, dim_pad - ls * BK) +
                     (!AUG && ls == n_k - 1 ? 1 : 0);
    const uint32_t full = full0 + 8 * lb;
    if (refill) mbar_wait(empty0 + 8 * lb, parity);
    mbar_arrive_expect_tx(full, (uint32_t)rows * BC * 4);
    bulk_copy(ring0 + (uint32_t)lb * STAGE_FLOATS * 4,
              ct + ((size_t)lt * (dim_pad + 1) + ls * BK) * BC,
              (uint32_t)rows * BC * 4, full);
  };
  if (tid == 0) {
    int lt = t_lo, ls = 0;
    for (int i = 0; i < AHEAD && i < steps; ++i) {
      issue(lt, ls, i, false, 0);
      if (++ls == n_k) { ls = 0; ++lt; }
    }
  }

  float run_e[8];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run_e[i] = inf;
    run_is[i * NT] = t_lo * BC + wc0 + tx * 4;  // the lane's first column
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const float* q_lane = qs + wq0 + ty * 4;
  const int c_lane = wc0 + tx * 4;
  int b = 0, s = 0, t = t_lo;
  uint32_t phase = 0;
  for (int st = 0; st < steps; ++st) {
    if (tid == 0 && st + AHEAD < steps) {
      // step st + AHEAD, from this step's position
      int lt = t, ls = s + AHEAD, lb = b + AHEAD;
#pragma unroll
      for (int i = 0; i < AHEAD; ++i)
        if (ls >= n_k) { ls -= n_k; ++lt; }
      const bool wrap = lb >= STAGES;
      if (wrap) lb -= STAGES;
      issue(lt, ls, lb, st + AHEAD >= STAGES, phase ^ (wrap ? 0u : 1u));
    }
    mbar_wait(full0 + 8 * b, phase);
    const float* cb = ring + b * STAGE_FLOATS + c_lane;
    const float* qb = q_lane + s * BK * BQ;
    const int rows = min(BK, dim_pad - s * BK);
    for (int kk = 0; kk < rows; kk += UNROLL) {
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(qb + (kk + k) * BQ);
        const float4 a1 = *reinterpret_cast<const float4*>(
            qb + (kk + k) * BQ + LANES_Q * 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(cb + (kk + k) * BC);
        const float4 b1 = *reinterpret_cast<const float4*>(
            cb + (kk + k) * BC + LANES_C * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w,
                             b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    if (s == n_k - 1) {
      const float* c2v = cb + rows * BC;  // the row after the last slice
      const float* q2v = q_lane - BQ;     // q2s lies just before qs
      const int gc0 = t * BC + c_lane;
      if ((t + 1) * BC <= n_c)
        fold_tile<AUG, false>(acc, q2v, c2v, gc0, n_c, run_e, run_is);
      else
        fold_tile<AUG, true>(acc, q2v, c2v, gc0, n_c, run_e, run_is);
      s = 0;
      ++t;
    } else {
      ++s;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * b);
    if (++b == STAGES) { b = 0; phase ^= 1; }
  }

  // merge the lanes that share a query row, then the warps
#pragma unroll
  int run_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run_i[i] = run_is[i * NT];
#pragma unroll
    for (int bit = 1; bit < LANES_C; bit <<= 1) {
      const int off = bit == 1 ? 1 : 2 * bit;  // tx's bits: lane bit 0, 2..
      const float oe = __shfl_xor_sync(0xffffffffu, run_e[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, run_i[i], off);
      if (lex_less(oe, oi, run_e[i], run_i[i])) {
        run_e[i] = oe;
        run_i[i] = oi;
      }
    }
  }
  __syncthreads();  // every copy has landed and been read: reuse the ring
  float* red_e = ring;                                   // [WARPS_C][BQ]
  int* red_i = reinterpret_cast<int*>(ring + WARPS_C * BQ);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = wq0 + (i >> 2) * (LANES_Q * 4) + ty * 4 + (i & 3);
      red_e[(warp % WARPS_C) * BQ + row] = run_e[i];
      red_i[(warp % WARPS_C) * BQ + row] = run_i[i];
    }
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < n_q) {
    float be = red_e[tid];
    int bi = red_i[tid];
    for (int w = 1; w < WARPS_C; ++w) {
      const float e = red_e[w * BQ + tid];
      const int i = red_i[w * BQ + tid];
      if (lex_less(e, i, be, bi)) { be = e; bi = i; }
    }
    err_out[q0 + tid] = be;
    idx_out[q0 + tid] = bi;
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

// Shared memory the kernel needs for a padded feature width of dim_pad.
size_t smem_bytes(int dim_pad) {
  return sizeof(float) * (BQ + (size_t)dim_pad * BQ + STAGES * STAGE_FLOATS +
                          8 * NT) +
         2 * STAGES * sizeof(uint64_t);
}

template <bool AUG>
int launch(const void* q, const void* ct, int n_q, int n_c, int dim,
           int dim_pad, int n_range, int tiles_per_range, void* err_out,
           void* idx_out, void* part_err, void* part_idx, void* stream) {
  if (n_q <= 0) return 0;
  const int c_tiles = (n_c + BC - 1) / BC;
  if (n_c < 1 || dim_pad % KG != 0 || dim_pad < dim || n_range < 1 ||
      tiles_per_range < 1 ||
      (size_t)n_range * tiles_per_range < (size_t)c_tiles ||
      (size_t)(n_range - 1) * tiles_per_range >= (size_t)c_tiles ||
      (n_range > 1 && (part_err == nullptr || part_idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dim_pad);
  cudaError_t rc = cudaFuncSetAttribute(
      nn1_kernel<AUG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n_q + BQ - 1) / BQ, n_range);
  nn1_kernel<AUG><<<grid, NT, smem, st>>>(
      (const float*)q, (const float*)ct, n_q, n_c, c_tiles, dim, dim_pad,
      tiles_per_range,
      (float*)(n_range > 1 ? part_err : err_out),
      (int*)(n_range > 1 ? part_idx : idx_out));
  rc = cudaGetLastError();
  if (rc != cudaSuccess || n_range == 1) return (int)rc;
  nn1_merge<<<(n_q + 255) / 256, 256, 0, st>>>(
      (const float*)part_err, (const int*)part_idx, n_q, n_range,
      (float*)err_out, (int*)idx_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile sizes the wrappers must pad to: queries per block, candidates
// per tile, and the granule of the feature width.
void tiler_nn1_tiles(int* bq, int* bc, int* kg) {
  *bq = BQ;
  *bc = BC;
  *kg = KG;
}

// Candidates c [n_c][dim] -> ct [ceil(n_c / bc)][dim_pad + 1][bc] (see
// nn1_prepare_kernel); dim_pad a multiple of the granule. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success).
int tiler_nn1_prepare(const void* c, int n_c, int dim, int dim_pad, void* ct,
                      void* stream) {
  if (n_c < 1 || dim < 1 || dim_pad % KG != 0 || dim_pad < dim)
    return (int)cudaErrorInvalidValue;
  const int c_pad = (n_c + BC - 1) / BC * BC;
  const size_t smem = sizeof(float) * PREP_ROWS * (size_t)(dim_pad + 1);
  cudaError_t rc = cudaFuncSetAttribute(
      nn1_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  nn1_prepare_kernel<<<c_pad / PREP_ROWS, PREP_NT, smem,
                       (cudaStream_t)stream>>>((const float*)c, n_c, dim,
                                               dim_pad, (float*)ct);
  return (int)cudaGetLastError();
}

// 1-NN of q [n_q][dim] among the n_c prepared candidates ct. The
// candidate tiles are walked as n_range ranges of tiles_per_range tiles;
// with n_range > 1 the caller provides part_err/part_idx of n_range * n_q
// elements and no range may be empty. Launches on `stream` (a
// cudaStream_t); allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launches (0 = success).
int tiler_nn1(const void* q, const void* ct, int n_q, int n_c, int dim,
              int dim_pad, int n_range, int tiles_per_range, void* err_out,
              void* idx_out, void* part_err, void* part_idx, void* stream) {
  return launch<false>(q, ct, n_q, n_c, dim, dim_pad, n_range,
                       tiles_per_range, err_out, idx_out, part_err,
                       part_idx, stream);
}

// The augmented mode: q and ct are the augmented operands, the tiles'
// norm rows are not read, and err_out receives the scores |c|^2 - 2 q.c
// (|q|^2 not added).
int tiler_nn1_aug(const void* q, const void* ct, int n_q, int n_c, int dim,
                  int dim_pad, int n_range, int tiles_per_range,
                  void* err_out, void* idx_out, void* part_err,
                  void* part_idx, void* stream) {
  return launch<true>(q, ct, n_q, n_c, dim, dim_pad, n_range,
                      tiles_per_range, err_out, idx_out, part_err, part_idx,
                      stream);
}

}  // extern "C"
