// ES filter: ub = rho12 + y*v_th, mask = (ub > rho_max[b]) & col_ok,
// count[b] = sum_k mask (CUDA, sm_90a; kernels/esicp_filter.py).
//
// One block per object row: the threads stride over the row's K columns
// (coalesced), and the row's count is a warp-shuffle then shared-memory
// reduction of integers, so it is exact in any order.  The bound is the
// rounded product plus the rounded sum (no fused multiply-add), as in the
// plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
esicp_filter_kernel(const float* __restrict__ rho12,
                    const float* __restrict__ y,
                    const float* __restrict__ rho_max,
                    const unsigned char* __restrict__ col_ok, float v_th,
                    int K, unsigned char* __restrict__ mask,
                    int* __restrict__ count) {
  __shared__ int warp_sums[kThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  const float r = rho_max[blockIdx.x];
  int local = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float ub = __fadd_rn(rho12[base + k], __fmul_rn(y[base + k], v_th));
    const bool ok = (ub > r) && col_ok[base + k];
    mask[base + k] = ok ? 1 : 0;
    local += ok ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    count[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" int esicp_filter_launch(const void* rho12, const void* y,
                                   const void* rho_max, const void* col_ok,
                                   float v_th, int B, int K, void* mask,
                                   void* count, void* stream) {
  esicp_filter_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rho12), static_cast<const float*>(y),
      static_cast<const float*>(rho_max),
      static_cast<const unsigned char*>(col_ok), v_th, K,
      static_cast<unsigned char*>(mask), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* esicp_filter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
