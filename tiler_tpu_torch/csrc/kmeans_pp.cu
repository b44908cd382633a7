// k-means++ seeding for Hopper (sm_90a): one launch per draw, each one pass
// over the feature rows that updates D^2 with the centroid drawn last, scores
// every row with a gumbel draw over log D^2, and takes the first maximum.
//
// Replaces no TPU kernel: the JAX package seeds in plain XLA
// (tiler_tpu/ops/kmeans.py `_plus_plus_init`, a lax.fori_loop). Run as
// eager PyTorch ops, each draw was some 390 launches of tiny kernels (the
// threefry hash's 20 rounds op by op, twice) and three host waits, so the
// card idled while the host launched; here a draw is one launch, and the
// host enqueues the k-1 launches of a seeding back to back without a wait.
//
// What it computes, per draw i = 1..k-1 (launch `draw` = i), the plain
// version's (ops/kmeans.py `plus_plus_plain`) arithmetic op for op:
//   c      = x[idx[i-1]]               (idx[0] = the schedule's first row)
//   nd2[r] = (x2[r] + |c|^2) - 2 * x[r].c
//   d2[r]  = min(d2[r], max(nd2[r], 0))    (d2 is +inf before draw 1)
//   bits   = b1 ^ b2 of threefry2x32 under draw i's key on counter (0, r)
//   u      = max(tiny, ((bits >> 9 | 0x3F800000) as f32 - 1) * (1 - tiny)
//                      + tiny)             (jax.random.uniform)
//   score  = -log(-log(u)) + log(max(d2[r], 1e-30))   (gumbel + logit)
//   idx[i] = the first row of the highest score; cents[i] = x[idx[i]]
// The multiplies and adds of u and the score are the _rn intrinsics (no FMA
// contraction) and logf is the accurate one (no fast math), so a row scores
// as PyTorch's own kernels score it; only the order of the sums in x[r].c
// and |c|^2 (one fixed order here, cuBLAS's and torch.sum's there) differs.
//
// What bounds it: device memory. A draw reads the N x 192 f32 rows once
// (N = 194,400 at 1080p: 149 MB, more than the 50 MB L2, so nothing is
// reused from one draw to the next) plus x2 and d2, and writes d2: about
// 45 us at 3.35 TB/s. The threefry hash is about 100 integer operations a
// row, hidden under the loads. The design:
//
// 1. A warp owns 32 consecutive rows. It reads two rows at a time, each with
//    16 lanes and three 16-byte loads a lane (chunks s, s+16, s+32 of the
//    row's 48): every load instruction reads two runs of 256 contiguous
//    bytes. Four row pairs are loaded before their sums are formed, so a
//    lane keeps 12 loads in flight, 96 KB an SM at two blocks of 8 warps
//    (the loop over the four groups is not unrolled, or the compiler
//    hoists all 48 loads and spills).
// 2. The previous centroid's chunks s, s+16, s+32 stay in a lane's registers
//    for the whole pass (read from L2); |c|^2 is summed by every warp in the
//    one fixed order of the dot below, so every block gets the same value.
// 3. The dot of a row pair is 12 fmaf a lane and a butterfly over the 16
//    lanes of a half; lane l keeps the dot of row 2t + (l & 1) at pair t = l/2,
//    so that after the 16 pairs each lane owns one row and the D^2 update,
//    the hash and the logs run on all 32 lanes.
// 4. The argmax: each block reduces its rows to (score, lowest index), writes
//    it to a partial slot and takes a ticket; the last block to finish (after
//    a __threadfence) reduces the partials in the same order-free way,
//    writes idx[i] and cents[i], and resets the ticket for the next launch.
//    So a draw is one launch and no second pass, and the drawn index stays
//    on the card for the next launch to read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DIM = 192;                  // the port's feature width
constexpr int CHUNKS = DIM / 4;           // float4 chunks of a row
constexpr int HALF = 16;                  // lanes that share a row
constexpr int PER_LANE = CHUNKS / HALF;   // chunks of a row a lane reads
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int ROWS = WARPS * 32;          // rows a block owns
constexpr int AHEAD = 4;                  // row pairs loaded before use
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;      // above every row

static_assert(CHUNKS == HALF * PER_LANE, "a row is 16 lanes x PER_LANE chunks");

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// 32 random bits of jax.random.bits under key (k1, k2) at counter (0, r):
// Threefry-2x32, 20 rounds, the two output words xor'ed.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t r) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = ks[0];            // counter high word 0
  uint32_t b = r + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, ROT[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return a ^ b;
}

// (s, i) is better than (t, j): a higher score, or the same score at a
// lower row (the first maximum, as torch.argmax and jnp.argmax).
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float t = __shfl_xor_sync(FULL, s, off);
    const int j = __shfl_xor_sync(FULL, i, off);
    if (better(t, j, s, i)) {
      s = t;
      i = j;
    }
  }
}

// The block's best (score, row) in lane 0 of warp 0; every thread calls it.
__device__ __forceinline__ void block_best(float& s, int& i, float* sh_s,
                                           int* sh_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(s, i);
  if (lane == 0) {
    sh_s[warp] = s;
    sh_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? sh_s[lane] : -INFINITY;
    i = lane < WARPS ? sh_i[lane] : NO_ROW;
    warp_best(s, i);
  }
}

__global__ void __launch_bounds__(NT, 2)
kmeans_pp_draw_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                      const long long* __restrict__ sched, int n, int draw,
                      float* __restrict__ d2, long long* __restrict__ idx,
                      float* __restrict__ cents, float* __restrict__ part_s,
                      int* __restrict__ part_i, unsigned* __restrict__ ticket) {
  __shared__ float sh_s[WARPS];
  __shared__ int sh_i[WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, s = lane & (HALF - 1);
  const int prev = (int)(draw == 1 ? sched[0] : idx[draw - 1]);
  const uint32_t k1 = (uint32_t)sched[2 * draw];
  const uint32_t k2 = (uint32_t)sched[2 * draw + 1];
  const float4* x4 = reinterpret_cast<const float4*>(x);

  float4 c[PER_LANE];
  float cc = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    c[j] = __ldg(x4 + (size_t)prev * CHUNKS + s + HALF * j);
    cc = fmaf(c[j].x, c[j].x, cc);
    cc = fmaf(c[j].y, c[j].y, cc);
    cc = fmaf(c[j].z, c[j].z, cc);
    cc = fmaf(c[j].w, c[j].w, cc);
  }
#pragma unroll
  for (int off = HALF / 2; off >= 1; off >>= 1)
    cc += __shfl_xor_sync(FULL, cc, off);

  const int row0 = (blockIdx.x * WARPS + warp) * 32;
  float dot_mine = 0.0f;
#pragma unroll 1
  for (int t0 = 0; t0 < 16; t0 += AHEAD) {
    float4 v[AHEAD][PER_LANE];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int r = row0 + 2 * (t0 + u) + half;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        v[u][j] = r < n ? __ldg(x4 + (size_t)r * CHUNKS + s + HALF * j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        dot = fmaf(v[u][j].x, c[j].x, dot);
        dot = fmaf(v[u][j].y, c[j].y, dot);
        dot = fmaf(v[u][j].z, c[j].z, dot);
        dot = fmaf(v[u][j].w, c[j].w, dot);
      }
#pragma unroll
      for (int off = HALF / 2; off >= 1; off >>= 1)
        dot += __shfl_xor_sync(FULL, dot, off);
      // lane l keeps row 2t + (l & 1), whose dot lane (l & 1) * 16 holds
      const float got = __shfl_sync(FULL, dot, (lane & 1) * HALF);
      if ((lane >> 1) == t0 + u) dot_mine = got;
    }
  }

  float best_s = -INFINITY;
  int best_i = NO_ROW;
  const int r = row0 + lane;
  if (r < n) {
    const float nd2 = __fsub_rn(__fadd_rn(x2[r], cc), 2.0f * dot_mine);
    const float old = draw == 1 ? INFINITY : d2[r];
    const float dn = fminf(old, fmaxf(nd2, 0.0f));
    d2[r] = dn;
    const float tiny = 1.17549435e-38f;   // FLT_MIN, jax's minval
    const uint32_t bits = threefry_bits(k1, k2, (uint32_t)r);
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, tiny)),
                                          tiny));
    const float g = -logf(-logf(u));
    best_s = __fadd_rn(g, logf(fmaxf(dn, 1e-30f)));
    best_i = r;
  }
  block_best(best_s, best_i, sh_s, sh_i);
  if (threadIdx.x == 0) {
    part_s[blockIdx.x] = best_s;
    part_i[blockIdx.x] = best_i;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: the card-wide first maximum over the blocks' partials
  __threadfence();
  best_s = -INFINITY;
  best_i = NO_ROW;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += NT) {
    const float t = __ldcg(part_s + b);
    const int j = __ldcg(part_i + b);
    if (better(t, j, best_s, best_i)) {
      best_s = t;
      best_i = j;
    }
  }
  __syncthreads();   // sh_s, sh_i are reused
  block_best(best_s, best_i, sh_s, sh_i);
  if (threadIdx.x == 0) {
    sh_i[0] = best_i;
    idx[draw] = best_i;
    if (draw == 1) idx[0] = prev;
    *ticket = 0u;
  }
  __syncthreads();
  float4* c4 = reinterpret_cast<float4*>(cents);
  for (int j = threadIdx.x; j < CHUNKS; j += NT)
    c4[(size_t)draw * CHUNKS + j] = x4[(size_t)sh_i[0] * CHUNKS + j];
  if (draw == 1)
    for (int j = threadIdx.x; j < CHUNKS; j += NT)
      c4[j] = x4[(size_t)prev * CHUNKS + j];
}

int blocks_for(int n) { return (n + ROWS - 1) / ROWS; }

}  // namespace

extern "C" {

// The feature width the kernel takes, and the int32 words of scratch a
// seeding over n rows needs (a partial score and row per block, the ticket).
int tiler_kmeans_pp_dim() { return DIM; }

int tiler_kmeans_pp_scratch(int n) { return 2 * blocks_for(n) + 1; }

// k-means++ seeding of k centroids among the rows x [n][192] with norms x2
// [n]: launches 1..k-1 of the draw kernel on `stream`, back to back, after
// zeroing the ticket. sched [k][2] int64: row 0 holds the first row's index
// (then 0), row i draw i's threefry key. Writes d2 [n] (D^2 to the first k-1
// centroids), idx [k] int64 and cents [k][192]. Returns the first non-zero
// cudaError of the launches (0 = success).
int tiler_kmeans_pp(const void* x, const void* x2, const void* sched, int n,
                    int k, void* d2, void* idx, void* cents, void* scratch,
                    void* stream) {
  if (n < 1 || k < 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_for(n);
  float* part_s = (float*)scratch;
  int* part_i = (int*)scratch + blocks;
  unsigned* ticket = (unsigned*)scratch + 2 * blocks;
  cudaError_t rc = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (rc != cudaSuccess) return (int)rc;
  for (int draw = 1; draw < k; ++draw) {
    kmeans_pp_draw_kernel<<<blocks, NT, 0, st>>>(
        (const float*)x, (const float*)x2, (const long long*)sched, n, draw,
        (float*)d2, (long long*)idx, (float*)cents, part_s, part_i, ticket);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

}  // extern "C"
