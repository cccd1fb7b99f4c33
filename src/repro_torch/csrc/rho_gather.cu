// rho_self refresh: rho[b] = x_b . mu_{assign_b}, 0 when assign_b lies
// outside [0, K) (CUDA, sm_90a; kernels/rho_gather.py).
//
// One warp per document.  Lane l walks the slots l, l+32, ... and reads
// means_t[id, assign_b] for each live slot (a strided 4-byte read), adding
// the rounded product; a butterfly of shuffles folds the 32 lanes.  The
// plain version in kernels/ref.py repeats this order exactly.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rho_gather_kernel(const int* __restrict__ assign, const int* __restrict__ ids,
                  const float* __restrict__ vals,
                  const float* __restrict__ means_t, int B, int P, int D,
                  int K, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int a = assign[b];
  float acc = 0.0f;
  if (a >= 0 && a < K) {
    const size_t row = static_cast<size_t>(b) * P;
    for (int p = lane; p < P; p += 32) {
      const float v = vals[row + p];
      const int id = ids[row + p];
      if (v != 0.0f && id >= 0 && id < D)
        acc = __fadd_rn(acc, __fmul_rn(v, __ldg(means_t + static_cast<size_t>(id) * K + a)));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[b] = acc;
}

}  // namespace

extern "C" int rho_gather_launch(const void* assign, const void* ids,
                                 const void* vals, const void* means_t, int B,
                                 int P, int D, int K, void* out,
                                 void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  rho_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(assign), static_cast<const int*>(ids),
      static_cast<const float*>(vals), static_cast<const float*>(means_t), B, P,
      D, K, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rho_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
