// Two measurements of the card that the design of nn1.cu rests on
// (tools/card_bench.py builds and runs this file):
//  1. cycles per warp-wide shared-memory load, by width and by which
//     16/8/4-byte chunk each lane reads: 16 warps per SM issue independent
//     loads back to back, timed with clock64();
//  2. the FP32 rate of 8 x 8 outer-product FFMAs from registers alone (no
//     memory traffic), 16 and 8 warps per SM, timed with CUDA events: the
//     practical ceiling for a kernel whose inner loop is that product.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <functional>

namespace {

constexpr int SMEM_BYTES = 65536;
__constant__ int OFF[32];   // the chunk each lane reads

template <int W>
__device__ __forceinline__ float lds(uint32_t a) {
  if (W == 16) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
    return v.x + v.y + v.z + v.w;
  }
  if (W == 8) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];"
                 : "=f"(v.x), "=f"(v.y) : "r"(a));
    return v.x + v.y;
  }
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

template <int W>
__global__ void __launch_bounds__(512, 1)
lds_kernel(int iters, float* out, long long* cyc) {
  extern __shared__ float4 sm[];
  for (int i = threadIdx.x; i < SMEM_BYTES / 16; i += blockDim.x)
    sm[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t base =
      (uint32_t)__cvta_generic_to_shared(sm) + OFF[lane] * W;
  float acc = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
      acc += lds<W>(base + ((it * 16 + u) & 63) * 1024);
  }
  const long long t1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int NT>
__global__ void __launch_bounds__(NT, 1)
ffma_kernel(int iters, float* out, const float* in) {
  const int lane = threadIdx.x & 31;
  float acc[8][8], a[8], b[8];
  for (int i = 0; i < 8; ++i) {
    a[i] = in[i + lane];
    b[i] = in[8 + i + lane];
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  float s = 0;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int n_sm = 0;
float* out = nullptr;
long long* cyc = nullptr;
float* zeros = nullptr;
bool failed = false;

void check(const char* what) {
  const cudaError_t rc = cudaDeviceSynchronize();
  if (rc != cudaSuccess) {
    printf("%s: %s\n", what, cudaGetErrorString(rc));
    failed = true;
  }
}

template <int W>
void run_lds(const char* name, std::function<int(int)> chunk_of_lane) {
  int h_off[32];
  for (int l = 0; l < 32; ++l) h_off[l] = chunk_of_lane(l);
  cudaMemcpyToSymbol(OFF, h_off, sizeof(h_off));
  const int iters = 1000;
  cudaFuncSetAttribute(lds_kernel<W>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  for (int rep = 0; rep < 2; ++rep)
    lds_kernel<W><<<n_sm, 512, SMEM_BYTES>>>(iters, out, cyc);
  check(name);
  long long h[1024];
  cudaMemcpy(h, cyc, n_sm * sizeof(long long), cudaMemcpyDeviceToHost);
  double mean = 0;
  for (int i = 0; i < n_sm; ++i) mean += h[i];
  mean /= n_sm;
  printf("LDS.%-3d chunk = %-14s %.3f cycles per warp-wide load\n", W * 8,
         name, mean / (16.0 * iters * 16));
}

template <int NT>
void run_ffma() {
  const int iters = 20000;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  ffma_kernel<NT><<<n_sm, NT>>>(1000, out, zeros);
  cudaEventRecord(e0);
  ffma_kernel<NT><<<n_sm, NT>>>(iters, out, zeros);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  check("ffma");
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * n_sm * NT * 64.0 * 16 * iters;
  printf("FFMA 8x8 outer products from registers, %2d warps per SM: "
         "%.2f ms, %.2f TFLOP/s\n", NT / 32, ms, flop / ms / 1e9);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    printf("no CUDA device\n");
    return 1;
  }
  n_sm = prop.multiProcessorCount;
  printf("%s, %d SMs, %d MHz\n", prop.name, n_sm, prop.clockRate / 1000);
  cudaMalloc(&out, n_sm * 512 * sizeof(float));
  cudaMalloc(&cyc, 1024 * sizeof(long long));
  cudaMalloc(&zeros, 4096);
  cudaMemset(zeros, 0, 4096);
  run_lds<16>("lane", [](int l) { return l; });
  run_lds<16>("lane%8", [](int l) { return l % 8; });
  run_lds<16>("lane%4", [](int l) { return l % 4; });
  run_lds<16>("lane%2", [](int l) { return l % 2; });
  run_lds<16>("lane/2", [](int l) { return l / 2; });
  run_lds<16>("lane/4", [](int l) { return l / 4; });
  run_lds<16>("lane/8", [](int l) { return l / 8; });
  run_lds<16>("(lane%8)/2", [](int l) { return (l % 8) / 2; });
  run_lds<16>("(lane/2)%8", [](int l) { return (l / 2) % 8; });
  // the two operands of nn1.cu's 2 x 2 interleaved 4 x 8 lane grid
  run_lds<16>("nn1 candidate",
              [](int l) { return (l & 1) | ((l >> 2) % 4) << 1; });
  run_lds<16>("nn1 query",
              [](int l) { return ((l >> 1) & 1) | (l / 16) << 1; });
  run_lds<16>("0", [](int) { return 0; });
  run_lds<8>("lane", [](int l) { return l; });
  run_lds<8>("lane%8", [](int l) { return l % 8; });
  run_lds<8>("lane/2", [](int l) { return l / 2; });
  run_lds<8>("0", [](int) { return 0; });
  run_lds<4>("lane", [](int l) { return l; });
  run_lds<4>("lane/4", [](int l) { return l / 4; });
  run_lds<4>("0", [](int) { return 0; });
  run_ffma<512>();
  run_ffma<256>();
  return failed ? 1 : 0;
}
