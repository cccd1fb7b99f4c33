// Update-step cluster sums as a deterministic segmented reduction
// (CUDA, sm_90a; kernels/segment_update.py).
//
// Input: the live tuples' flat output indices key = id*K + assign, sorted
// stably (so equal keys keep their row order), and their values in the same
// order.  One thread per sorted position: the head of each run of equal keys
// sums the run sequentially and stores the sum at lam_t[key]; every other
// thread exits.  No atomics, so the result is the same on every run, and
// each sum is taken in row order, the order of the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const long long* __restrict__ keys,
                   const float* __restrict__ vals, long long n,
                   float* __restrict__ lam_t) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long key = keys[i];
  if (i > 0 && keys[i - 1] == key) return;  // not the head of its run
  float acc = 0.0f;
  for (long long j = i; j < n && keys[j] == key; ++j)
    acc = __fadd_rn(acc, vals[j]);
  lam_t[key] = acc;
}

}  // namespace

extern "C" int segment_update_launch(const void* keys, const void* vals,
                                     long long n, void* lam_t, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  segment_sum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const float*>(vals), n,
      static_cast<float*>(lam_t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
