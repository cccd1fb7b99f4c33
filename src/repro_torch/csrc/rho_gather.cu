// rho_self refresh: rho[b] = x_b . mu_{assign_b}, 0 when assign_b lies
// outside [0, K) (CUDA, sm_90a; kernels/rho_gather.py).
//
// Documents run in centroid order.  A counting sort by assignment (a
// histogram over K + 1 bins, bin K for every assignment outside [0, K), an
// exclusive scan, a scatter with per-bin cursors) lists them by centroid,
// and the gather runs one warp per listed document.  A block's warps and
// the neighbouring blocks then work on the same and adjacent centroids, so
// the 32-byte sector means_t[t, a & ~7 ..] of a term t that many of those
// documents hold is fetched from device memory about once for all of them,
// not once per document as in row order.  Which document of a bin a warp
// takes may change from run to run; each writes only out[b], so the result
// does not.  Documents outside [0, K) write 0 and read no means.
//
// Per document: lane l walks the slots l, l+32, ... below the row's length
// (nnz[b] when given, else P) and adds v * means_t[id, assign_b] for each
// slot with v != 0 and id in [0, D), the rounded product to a sum from +0;
// a butterfly of shuffles over offsets 16, 8, 4, 2, 1 folds the lanes.
// The plain version in kernels/ref.py repeats this order exactly.  A lane
// loads eight of its tuples before it reads their means entries, so a row
// of up to 256 live slots needs one round of each.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kAhead = 8;

__device__ __forceinline__ int bin_of(int a, int K) {
  return static_cast<unsigned>(a) < static_cast<unsigned>(K) ? a : K;
}

__global__ void __launch_bounds__(kThreads)
rho_count_kernel(const int* __restrict__ assign, int B, int K,
                 int* __restrict__ bins) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b < B) atomicAdd(bins + bin_of(assign[b], K), 1);
}

// Exclusive scan of n counts in place, one block: each thread sums a
// contiguous run, the block scans the 1024 run sums, each thread writes
// its run's offsets.
__global__ void __launch_bounds__(kScanThreads)
rho_scan_kernel(int* __restrict__ bins, int n) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int start = min(tid * per, n), end = min(start + per, n);
  int sum = 0;
  for (int i = start; i < end; ++i) sum += bins[i];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sum[lane];
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    warp_sum[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int i = start; i < end; ++i) {
    const int c = bins[i];
    bins[i] = run;
    run += c;
  }
}

__global__ void __launch_bounds__(kThreads)
rho_scatter_kernel(const int* __restrict__ assign, int B, int K,
                   int* __restrict__ bins, int* __restrict__ order) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b < B) order[atomicAdd(bins + bin_of(assign[b], K), 1)] = b;
}

__global__ void __launch_bounds__(kThreads)
rho_gather_kernel(const int* __restrict__ order,
                  const int* __restrict__ assign, const int* __restrict__ nnz,
                  const int* __restrict__ ids, const float* __restrict__ vals,
                  const float* __restrict__ means_t, int B, int P, int D,
                  int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= B) return;  // the whole warp leaves together
  const int b = order[i];
  const int a = assign[b];
  float acc = 0.0f;
  if (static_cast<unsigned>(a) < static_cast<unsigned>(K)) {
    const int n = nnz != nullptr ? min(max(nnz[b], 0), P) : P;
    const size_t row = static_cast<size_t>(b) * P;
    const float* col = means_t + a;
    for (int p0 = 0; p0 < n; p0 += kAhead * 32) {
      float v[kAhead], m[kAhead];
      int id[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int p = p0 + u * 32 + lane;
        v[u] = p < n ? vals[row + p] : 0.0f;
        id[u] = p < n ? ids[row + p] : 0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool live = v[u] != 0.0f && id[u] >= 0 && id[u] < D;
        m[u] = live ? __ldg(col + static_cast<size_t>(id[u]) * K) : 0.0f;
        if (!live) v[u] = 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (v[u] != 0.0f) acc = __fadd_rn(acc, __fmul_rn(v[u], m[u]));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[b] = acc;
}

}  // namespace

// scratch: B + K + 1 int32 (the K + 1 bins, then the order), from the
// caller's allocator.  nnz may be null (every row P slots long).
extern "C" int rho_gather_launch(const void* assign, const void* ids,
                                 const void* vals, const void* nnz,
                                 const void* means_t, int B, int P, int D,
                                 int K, void* scratch, void* out,
                                 void* stream) {
  if (B == 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bins = static_cast<int*>(scratch);
  int* order = bins + K + 1;
  const int* a = static_cast<const int*>(assign);
  cudaError_t err = cudaMemsetAsync(bins, 0, (K + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kThreads - 1) / kThreads;
  rho_count_kernel<<<blocks, kThreads, 0, s>>>(a, B, K, bins);
  rho_scan_kernel<<<1, kScanThreads, 0, s>>>(bins, K + 1);
  rho_scatter_kernel<<<blocks, kThreads, 0, s>>>(a, B, K, bins, order);
  rho_gather_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      order, a, static_cast<const int*>(nnz), static_cast<const int*>(ids),
      static_cast<const float*>(vals), static_cast<const float*>(means_t), B,
      P, D, K, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rho_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
