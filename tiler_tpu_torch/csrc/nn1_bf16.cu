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
// how many 1-NN winners it changes. The encoder never calls it. What it
// computes is the same; it is designed for this card, not carried over.
//
// What bounds it: 2*Q*C*D operations against the tensor cores' 989 TFLOP/s
// in dense bf16 (1.67 ms at Q=16384, C=262144, D=192); the inputs are read
// once in far less. Two things stand between a kernel and that bound: the
// candidates must reach shared memory as bf16 without any thread touching
// them, and every one of the Q*C distances costs three to five lane
// operations to form and compare, which on this card run beside the
// tensor cores far less than one would hope (see 4). The design:
//
// 1. nn1_bf16_prepare_kernel reads the f32 candidates once per candidate
//    set and writes, per tile of BC candidates, exactly the bytes the walk
//    wants in shared memory: for each 64-wide K-chunk a [BC][64] bf16
//    block, K-major, rows of 128 bytes whose 16-byte groups sit at
//    (group ^ row % 8) (the 128-byte swizzle that wgmma descriptors name
//    B128), D padded with zeros to a multiple of 64; then the tile's BC f32
//    norms, +inf past n_c so that a padding candidate never wins:
//      ct[tiles][ D_pad/64 x [BC][64] bf16 | BC f32 ]   (bytes)
//    The norms are summed from the unrounded rows, lanes striding the row
//    (fmaf chains over k = lane, lane + 32, ...) and then the xor tree
//    16..1: the order of csrc/nn1.cu's prepare kernel.
// 2. A K-chunk of a tile is one contiguous run (the last one with the
//    norms behind it), so one lane of the producer warpgroup moves it with
//    a single cp.async.bulk into a ring of slots (7 at D=192), each with a
//    `full` mbarrier (the copy's bytes) and an `empty` one (one arrival
//    per consumer warp). No tensor map, no __syncthreads in the walk.
// 3. A block owns BQ = 256 queries. Their rows are rounded once, written
//    K-major in the same swizzle and stay in shared memory; their norms
//    are summed in the same order. Two consumer warpgroups own 128 rows
//    each and multiply them (two 64-row passes) with every candidate tile
//    by wgmma.mma_async m64n128k16 f32 += bf16 * bf16, both operands read
//    from shared memory through descriptors, 128 accumulator registers a
//    thread. 256 queries a block halve the candidate bytes that a query
//    tile pulls from L2 against 128; a full chunk of 16384 queries is 64
//    query tiles, so the candidate tiles are split into 2 ranges to fill
//    the SMs. (128 queries a block with m64n256k16 measured the same time
//    within the spread between runs and twice the L2 traffic.)
// 4. The two warpgroups run out of phase: named barriers hand the turn at
//    the tensor cores from one to the other, so that one forms and
//    compares its distances while the other's wgmmas run (15-19% faster
//    than both starting at will). Even so one block's walk measures as
//    long as its wgmmas and its epilogues one after the other, so the
//    epilogue is kept short: three operations a distance (add, fused
//    multiply-add, minimum) give the tile's minimum per row and lane, and
//    only where that beats the row's best so far (seldom, and less often
//    as the walk goes on) does the lane look for the column: the lowest
//    one that attains the minimum. The four lanes that share a row share
//    that bound by shuffles; a column that merely equals it comes later in
//    the walk and loses. Each lane keeps its (err, idx) per row for the
//    whole walk and the four merge once, after it. The distance is
//    (q2 + c2) - 2 * acc, the plain version's order. No column is masked:
//    a padding candidate's +inf norm keeps it out.
// 5. When the query tiles alone cannot fill the SMs (a short query chunk),
//    the caller splits the candidate tiles into ranges along the grid's
//    second axis, each block writes its range's (err, idx), and
//    nn1_bf16_merge takes the lexicographic minimum over the ranges.
// 6. The compiler must see the warpgroup converged at every wgmma, or it
//    serializes them (ptxas C7520, 4.2 instead of 2.7 ms): the warp's
//    number comes from a shuffle, which makes the roles uniform to it, and
//    the mbarrier wait spins inside one asm statement.
//
// 7. ptxas budgets the block's 384 threads at 168 registers each, which
//    the accumulators and the epilogue overrun; setmaxnreg moves the
//    producer warpgroup's registers to the consumers (40 and 232 a
//    thread, 176 used, nothing spilled).
//
// On an NVIDIA H100 80GB HBM3 at 700 W: 2.4 ms at Q=16384, C=262144,
// D=192, 70% of the bound; the walk holds the card at its power limit (SM
// clock about 1.6 GHz under a loop of launches, 9% slower than a quarter
// of the SMs run alone); with the epilogue cut out it takes 2.0 ms.
//
// The widest row is 256 columns (four K-chunks beside the ring).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MW = 2;                 // 64-row passes per consumer warpgroup
constexpr int BC = 128;               // candidates per tile, the wgmma's N
constexpr int WGS = 2;                // consumer warpgroups
constexpr int BQ = WGS * MW * 64;     // queries per block
constexpr int KC = 64;                // a K-chunk: 64 bf16, one swizzled row
constexpr int MAX_CHUNKS = 4;         // widest row: MAX_CHUNKS * KC columns
constexpr int CHUNK_BYTES = BC * 128;
constexpr int SLOT_BYTES = CHUNK_BYTES + 1024;  // a chunk, then its norms
constexpr int MAX_STAGES = 8;         // ring slots: as many as fit, up to it
constexpr int NT = (WGS + 1) * 128;   // the consumers and the producer's
constexpr int SMEM_LIMIT = 232448;    // bytes a block may have on this card
constexpr int PREP_ROWS = 32;         // candidates per block of the prepare
constexpr int PREP_NT = 256;

static_assert(BC * 4 <= 1024 && SLOT_BYTES % 1024 == 0, "slot");
static_assert(BC % PREP_ROWS == 0 && PREP_ROWS % 8 == 0, "prepare");
static_assert(BC == 128, "the wgmma is m64n128k16");

__device__ __forceinline__ bool lex_less(float e1, int i1, float e2, int i2) {
  return e1 < e2 || (e1 == e2 && i1 < i2);
}

// The distance, in the plain version's order: (q2 + c2) - 2 * dot. The
// product by 2 is exact, so the fused form rounds as the unfused.
__device__ __forceinline__ float dist(float q2, float c2, float dot) {
  return fmaf(-2.f, dot, q2 + c2);
}

// One warp rounds a row of f32 (dim columns; all zero unless live) to bf16
// and writes it as row r of K-major swizzled chunks: chunk k / 64 starts
// at dst + (k / 64) * chunk_stride, its row r 128 * r bytes further, and
// the 16-byte group g of that row at (g ^ r % 8). Returns the squared norm
// of the unrounded row in every lane: per-lane fmaf chains over k = lane,
// lane + 32, ..., then the xor tree 16, 8, 4, 2, 1.
__device__ __forceinline__ float stage_row(const float* __restrict__ row,
                                           bool live, int dim, int dim_pad,
                                           uint8_t* dst, int chunk_stride,
                                           int r) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < dim_pad; k += 32) {
    const float v = (live && k < dim) ? __ldg(row + k) : 0.f;
    s = fmaf(v, v, s);
    const int kk = k & (KC - 1);
    const int at = (((kk >> 3) ^ (r & 7)) << 4) | ((kk & 7) << 1);
    *reinterpret_cast<__nv_bfloat16*>(dst + (k / KC) * chunk_stride +
                                      r * 128 + at) = __float2bfloat16_rn(v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Candidates [n_c][dim] f32 -> ct, the tiles described at the top; one
// block per PREP_ROWS candidates, whose rows of one K-chunk are one 4 KB
// run of the tile.
__global__ void __launch_bounds__(PREP_NT)
nn1_bf16_prepare_kernel(const float* __restrict__ c, int n_c, int dim,
                        int dim_pad, uint8_t* __restrict__ ct) {
  extern __shared__ uint4 smem16[];
  uint8_t* rows = reinterpret_cast<uint8_t*>(smem16);  // [chunks][32][128]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = dim_pad / KC;
  const int c0 = blockIdx.x * PREP_ROWS;
  const int r0 = c0 % BC;   // this block's first row within its tile
  uint8_t* tile = ct + (size_t)(c0 / BC) * BC * (128 * chunks + 4);
  float* norms = reinterpret_cast<float*>(tile + chunks * CHUNK_BYTES) + r0;
  for (int r = warp; r < PREP_ROWS; r += PREP_NT / 32) {
    const int gc = c0 + r;
    const float s = stage_row(c + (size_t)gc * dim, gc < n_c, dim, dim_pad,
                              rows, PREP_ROWS * 128, r);
    if (lane == 0) norms[r] = gc < n_c ? s : __int_as_float(0x7f800000);
  }
  __syncthreads();
  constexpr int RUN = PREP_ROWS * 128 / 16;   // 16-byte pieces of a run
  for (int e = threadIdx.x; e < chunks * RUN; e += PREP_NT) {
    const int kc = e / RUN, w = e % RUN;
    reinterpret_cast<uint4*>(tile + kc * CHUNK_BYTES + r0 * 128)[w] =
        reinterpret_cast<const uint4*>(rows + kc * PREP_ROWS * 128)[w];
  }
}

__global__ void __launch_bounds__(NT, 1)
nn1_bf16_kernel(const float* __restrict__ q, const uint8_t* __restrict__ ct,
                int n_q, int c_tiles, int dim, int dim_pad,
                int tiles_per_range, int stages, float* __restrict__ err_out,
                int* __restrict__ idx_out) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle wants every operand tile on a 1024-byte boundary
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int chunks = dim_pad / KC;
  // qs [chunks][BQ][128]: the query tile, K-major, swizzled
  uint8_t* ring = qs + chunks * BQ * 128;            // [stages][SLOT_BYTES]
  float* q2s = reinterpret_cast<float*>(ring + stages * SLOT_BYTES);  // [BQ]
  const uint32_t full0 = smem_u32(q2s + BQ);         // full[stages]
  const uint32_t empty0 = full0 + 8 * stages;        // empty[stages]
  const uint32_t ring0 = smem_u32(ring);

  const int tid = threadIdx.x;
  // the warp's number by way of a shuffle: the compiler then knows that it
  // is the same in every lane, and the roles below are no divergence
  const int lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int q0 = blockIdx.x * BQ;
  // this block's candidate tiles [t_lo, t_hi) (all of them when the grid
  // has one range); the outputs are offset to the range's slot
  const int t_lo = blockIdx.y * tiles_per_range;
  const int t_hi = min(c_tiles, t_lo + tiles_per_range);
  err_out += (size_t)blockIdx.y * n_q;
  idx_out += (size_t)blockIdx.y * n_q;

  if (tid == 0) {
    for (int b = 0; b < stages; ++b) {
      mbar_init(full0 + 8 * b, 1);
      mbar_init(empty0 + 8 * b, WGS * 4);
    }
    mbar_init_fence();
  }
#pragma unroll 4   // four rows' loads in flight
  for (int r = warp; r < BQ; r += NT / 32) {
    const int gq = q0 + r;
    const float s = stage_row(q + (size_t)gq * dim, gq < n_q, dim, dim_pad,
                              qs, BQ * 128, r);
    if (lane == 0) q2s[r] = s;
  }
  fence_proxy_async();   // the wgmmas read qs through the async proxy
  __syncthreads();

  if (warp >= WGS * 4) {
    // the producer's warpgroup gives its registers to the consumers; one
    // lane of it keeps the ring full, a K-chunk a slot
    reg_dealloc<40>();
    if (warp == WGS * 4 && lane == 0) {
      const size_t tile_bytes = (size_t)BC * (128 * chunks + 4);
      int b = 0;
      uint32_t phase = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        for (int kc = 0; kc < chunks; ++kc) {
          // the slot's last use has been read (at once on its first use)
          mbar_wait(empty0 + 8 * b, phase ^ 1);
          const uint32_t bytes =
              CHUNK_BYTES + (kc == chunks - 1 ? BC * 4 : 0);  // + the norms
          mbar_arrive_expect_tx(full0 + 8 * b, bytes);
          bulk_copy(ring0 + b * SLOT_BYTES,
                    ct + t * tile_bytes + (size_t)kc * CHUNK_BYTES, bytes,
                    full0 + 8 * b);
          if (++b == stages) { b = 0; phase ^= 1; }
        }
      }
    }
  } else {
    reg_alloc<232>();   // 3 x 168 a thread at launch = 2 x 232 + 40
    const int wg = warp >> 2;
    // accumulator d[4 j + 2 h + e] of pass m is row 64 m + row_lo + 8 h,
    // column 8 j + col_lo + e of the tile
    const int row_lo = wg * MW * 64 + (warp & 3) * 16 + (lane >> 2);
    const int col_lo = (lane & 3) * 2;
    const float inf = __int_as_float(0x7f800000);
    // per row: the lane's best (err, idx) among the columns it took up,
    // and the best err of the four lanes that share the row, which a
    // column must beat to be taken up
    float q2[MW][2], run_e[MW][2], bound[MW][2];
    int run_i[MW][2];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        q2[m][h] = q2s[row_lo + 64 * m + 8 * h];
        run_e[m][h] = bound[m][h] = inf;
        run_i[m][h] = 0;
      }
    float acc[MW][BC / 2];
    const uint32_t qa = smem_u32(qs) + wg * MW * 64 * 128;

    // the turn at the tensor cores alternates: warpgroup w waits on
    // barrier 1 + w and, once its tile's wgmmas are committed, arrives on
    // the other's
    if (wg == 1) bar_arrive(1, 2 * 128);
    int b = 0;
    uint32_t phase = 0;
    for (int t = t_lo; t < t_hi; ++t) {
      bar_sync(1 + wg, 2 * 128);
      int bb = b;
      uint32_t ph = phase;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(full0 + 8 * bb, ph);
        wgmma_fence();   // after the wait's loop: straight-line to the wgmmas
        const uint32_t cb = ring0 + bb * SLOT_BYTES;
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
#pragma unroll
          for (int m = 0; m < MW; ++m)
            wgmma_m64n128k16(
                acc[m],
                desc_k_major_b128(qa + kc * BQ * 128 + m * 64 * 128 + k * 32),
                desc_k_major_b128(cb + k * 32), (kc | k) != 0);
        if (++bb == stages) { bb = 0; ph ^= 1; }
      }
      wgmma_commit();
      if (!(wg == 1 && t + 1 == t_hi)) bar_arrive(2 - wg, 2 * 128);
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MW; ++m) fence_registers(acc[m]);
      // every chunk but the last is free; the last holds the norms
      for (int kc = 0; kc < chunks - 1; ++kc) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * b);
        if (++b == stages) { b = 0; phase ^= 1; }
      }
      const float* c2s = reinterpret_cast<const float*>(
                             ring + b * SLOT_BYTES + CHUNK_BYTES) + col_lo;
      const int gc0 = t * BC + col_lo;
      // three operations a distance: the tile's minimum per row first
      float low[MW][2];
#pragma unroll
      for (int m = 0; m < MW; ++m) low[m][0] = low[m][1] = inf;
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        const float2 c2 = *reinterpret_cast<const float2*>(c2s + 8 * j);
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              low[m][h] = fminf(low[m][h], dist(q2[m][h], e ? c2.y : c2.x,
                                                acc[m][4 * j + 2 * h + e]));
      }
      // seldom, and less often as the walk goes on, a row improves. Its
      // lane then finds the lowest column that attains the minimum
      // (walking down, the last hit stays) and the row's lanes share the
      // new bound. A column that only equals the bound comes later in the
      // walk than the bound's and loses to it.
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool better = low[m][h] < bound[m][h];
          if (__any_sync(0xffffffffu, better)) {
            if (better) {
              run_e[m][h] = low[m][h];
              // the norms are read again, as volatile: or the compiler
              // keeps all the tile's distances in registers for this path
              const volatile float* c2v = c2s;
              const float q2v = *const_cast<const volatile float*>(
                  q2s + row_lo + 64 * m + 8 * h);
#pragma unroll
              for (int j = BC / 8 - 1; j >= 0; --j)
#pragma unroll
                for (int e = 1; e >= 0; --e)
                  if (dist(q2v, c2v[8 * j + e],
                           acc[m][4 * j + 2 * h + e]) == low[m][h])
                    run_i[m][h] = gc0 + 8 * j + e;
            }
            float lowest = run_e[m][h];
            lowest = fminf(lowest, __shfl_xor_sync(0xffffffffu, lowest, 1));
            lowest = fminf(lowest, __shfl_xor_sync(0xffffffffu, lowest, 2));
            bound[m][h] = lowest;
          }
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * b);
      if (++b == stages) { b = 0; phase ^= 1; }
    }

    // the four lanes that share a row
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float be = run_e[m][h];
        int bi = run_i[m][h];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float oe = __shfl_xor_sync(0xffffffffu, be, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (lex_less(oe, oi, be, bi)) { be = oe; bi = oi; }
        }
        const int gq = q0 + row_lo + 64 * m + 8 * h;
        if ((lane & 3) == 0 && gq < n_q) {
          err_out[gq] = be;
          idx_out[gq] = bi;
        }
      }
  }
}

// Lexicographic (err, idx) minimum over n_range per-range results
// [n_range][n_q], in range order.
__global__ void nn1_bf16_merge(const float* __restrict__ part_err,
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

// The sizes the wrappers must pad to: queries per block, candidates per
// tile, and the granule of the feature width.
void tiler_nn1_bf16_tiles(int* bq, int* bc, int* kc) {
  *bq = BQ;
  *bc = BC;
  *kc = KC;
}

// Candidates c [n_c][dim] f32 -> ct, ceil(n_c / bc) tiles of
// bc * (2 * dim_pad + 4) bytes (see the top); dim_pad a multiple of kc.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success).
int tiler_nn1_bf16_prepare(const void* c, int n_c, int dim, int dim_pad,
                           void* ct, void* stream) {
  if (n_c < 1 || dim < 1 || dim_pad % KC != 0 || dim_pad < dim)
    return (int)cudaErrorInvalidValue;
  const int c_pad = (n_c + BC - 1) / BC * BC;
  const size_t smem = (size_t)(dim_pad / KC) * PREP_ROWS * 128;
  cudaError_t rc = cudaFuncSetAttribute(
      nn1_bf16_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  nn1_bf16_prepare_kernel<<<c_pad / PREP_ROWS, PREP_NT, smem,
                            (cudaStream_t)stream>>>(
      (const float*)c, n_c, dim, dim_pad, (uint8_t*)ct);
  return (int)cudaGetLastError();
}

// 1-NN of q [n_q][dim] f32 among the n_c prepared candidates ct. The
// candidate tiles are walked as n_range ranges of tiles_per_range tiles;
// with n_range > 1 the caller provides part_err/part_idx of n_range * n_q
// elements and no range may be empty. err_out [n_q] f32, idx_out [n_q]
// int32. Launches on `stream` (a cudaStream_t); allocates nothing, does
// not synchronise. Returns cudaGetLastError() after the launches
// (0 = success).
int tiler_nn1_bf16(const void* q, const void* ct, int n_q, int n_c, int dim,
                   int dim_pad, int n_range, int tiles_per_range,
                   void* err_out, void* idx_out, void* part_err,
                   void* part_idx, void* stream) {
  if (n_q <= 0) return 0;
  const int c_tiles = (n_c + BC - 1) / BC;
  const int chunks = dim_pad / KC;
  if (n_c < 1 || dim < 1 || dim_pad % KC != 0 || dim_pad < dim ||
      chunks > MAX_CHUNKS || n_range < 1 || tiles_per_range < 1 ||
      (size_t)n_range * tiles_per_range < (size_t)c_tiles ||
      (size_t)(n_range - 1) * tiles_per_range >= (size_t)c_tiles ||
      (n_range > 1 && (part_err == nullptr || part_idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  // 1024 for the alignment, the query tile, its norms, the barriers; the
  // ring takes what is left
  const int fixed = 1024 + chunks * BQ * 128 + BQ * 4 + 2 * MAX_STAGES * 8;
  const int stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) / SLOT_BYTES);
  if (stages < chunks) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)fixed + (size_t)stages * SLOT_BYTES;
  cudaError_t rc = cudaFuncSetAttribute(
      nn1_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n_q + BQ - 1) / BQ, n_range);
  nn1_bf16_kernel<<<grid, NT, smem, st>>>(
      (const float*)q, (const uint8_t*)ct, n_q, c_tiles, dim, dim_pad,
      tiles_per_range, stages, (float*)(n_range > 1 ? part_err : err_out),
      (int*)(n_range > 1 ? part_idx : idx_out));
  rc = cudaGetLastError();
  if (rc != cudaSuccess || n_range == 1) return (int)rc;
  nn1_bf16_merge<<<(n_q + 255) / 256, 256, 0, st>>>(
      (const float*)part_err, (const int*)part_idx, n_q, n_range,
      (float*)err_out, (int*)idx_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
