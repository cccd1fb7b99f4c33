// Block-vector sketch kernels (CUDA, sm_90a; kernels/sketch_sim.py).
//
//   sketch_sim   (B, S) doc sketches x (S, K) mean sketches -> (B, K), S <= 64
//   doc_sketch   (B, P) tuples -> (B, S) per-group L2 norms
//
// sketch_sim: a block owns a tile of kTileB documents x kTileK columns.  It
// stages the tile's doc sketches and the (S, kTileK) slab of the mean
// sketches in shared memory, then each thread computes a 4 x 4 micro-tile:
// rows rg + 8*i, columns lane + 32*j, where rg is the thread's warp.  Within
// a warp every lane reads the same doc-sketch entry (a broadcast) and 32
// consecutive mean-sketch entries (no bank conflict); the output stores are
// 128 contiguous bytes per warp.  Every output adds its S rounded products
// in s order (__fmul_rn/__fadd_rn, no fused multiply-add), the order and
// rounding of the plain version in kernels/ref.py, so the two agree bit for
// bit.  No tensor cores, no TF32.
//
// doc_sketch: one warp per document.  Lane l owns slots l and l + 32.  The
// warp reads the row's tuples 32 at a time (one coalesced load per lane) and
// broadcasts them by shuffle in p order; the lane whose slot is
// clip(id / g, 0, S-1) adds v*v.  Dead slots (v = 0) add nothing.  No
// atomics, so the sums are in p order on every run, as in the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxS = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMicro = 4;
constexpr int kTileB = kWarps * kMicro;  // 32 documents
constexpr int kTileK = 32 * kMicro;      // 128 columns

__global__ void __launch_bounds__(kThreads)
sketch_sim_kernel(const float* __restrict__ x, const float* __restrict__ m,
                  int B, int S, int K, float* __restrict__ out) {
  __shared__ float s_x[kTileB][kMaxS];
  __shared__ float s_m[kMaxS][kTileK];
  const int b0 = blockIdx.y * kTileB;
  const int k0 = blockIdx.x * kTileK;
  for (int i = threadIdx.x; i < kTileB * S; i += kThreads) {
    const int r = i / S, s = i - r * S;
    const int b = b0 + r;
    s_x[r][s] = b < B ? x[static_cast<size_t>(b) * S + s] : 0.0f;
  }
  for (int i = threadIdx.x; i < S * kTileK; i += kThreads) {
    const int s = i / kTileK, c = i - s * kTileK;
    const int k = k0 + c;
    s_m[s][c] = k < K ? m[static_cast<size_t>(s) * K + k] : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int rg = threadIdx.x >> 5;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < S; ++s) {
    float xv[kMicro], mv[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) xv[i] = s_x[rg + kWarps * i][s];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) mv[j] = s_m[s][lane + 32 * j];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], mv[j]));
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int b = b0 + rg + kWarps * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int k = k0 + lane + 32 * j;
      if (k < K) out[static_cast<size_t>(b) * K + k] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
doc_sketch_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                  int B, int P, int g, int S, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const size_t row = static_cast<size_t>(b) * P;
  float a0 = 0.0f, a1 = 0.0f;
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    const int my_id = p < P ? ids[row + p] : 0;
    const float my_v = p < P ? vals[row + p] : 0.0f;
    const int n = min(32, P - p0);
    for (int j = 0; j < n; ++j) {
      const int id = __shfl_sync(0xffffffffu, my_id, j);
      const float v = __shfl_sync(0xffffffffu, my_v, j);
      if (v == 0.0f) continue;  // dead slot: the same for every lane
      const int slot = min(max(id / g, 0), S - 1);
      const float sq = __fmul_rn(v, v);
      if (slot == lane) a0 = __fadd_rn(a0, sq);
      if (slot == lane + 32) a1 = __fadd_rn(a1, sq);
    }
  }
  const size_t o = static_cast<size_t>(b) * S;
  if (lane < S) out[o + lane] = __fsqrt_rn(a0);
  if (lane + 32 < S) out[o + lane + 32] = __fsqrt_rn(a1);
}

}  // namespace

extern "C" int sketch_max_rows() { return 65535 * kTileB; }

extern "C" int sketch_sim_launch(const void* x, const void* m, int B, int S,
                                 int K, void* out, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + kTileK - 1) / kTileK, (B + kTileB - 1) / kTileB);
  sketch_sim_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m), B, S, K,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int doc_sketch_launch(const void* ids, const void* vals, int B,
                                 int P, int g, int S, void* out,
                                 void* stream) {
  if (S < 1 || S > kMaxS || g < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  doc_sketch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(vals), B, P, g,
      S, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
