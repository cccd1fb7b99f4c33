// FP32 issue-rate probe (CUDA, sm_90a; scripts/sketch_sim_probe.py).
//
// Each thread runs kChains independent dependency chains for `iters`
// steps, entirely in registers.  Mode 0 steps a chain with one
// __fmul_rn and one __fadd_rn (two FP32 instructions, the no-FMA rule of
// csrc/sketch.cu); mode 1 with one __fmaf_rn (one instruction, two
// operations).  32 chains per thread hide the pipe's latency, so the rate
// is the FP32 pipe's issue rate for that instruction mix.  Each thread's
// sum is stored so nothing is optimised away.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 32;

template <int kMode>
__global__ void __launch_bounds__(256) rate_kernel(float* out, float b,
                                                   float c, int iters) {
  float acc[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc[i] = threadIdx.x * 1e-6f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (kMode == 0) {
        acc[i] = __fadd_rn(__fmul_rn(acc[i], b), c);
      } else {
        acc[i] = __fmaf_rn(acc[i], b, c);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Instructions issued: blocks * 256 * iters * kChains * (mode 0 ? 2 : 1).
extern "C" int fp32_rate_launch(void* out, int blocks, int iters, int mode,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (mode == 0) {
    rate_kernel<0><<<blocks, 256, 0, st>>>(o, 0.999999f, 1e-7f, iters);
  } else {
    rate_kernel<1><<<blocks, 256, 0, st>>>(o, 0.999999f, 1e-7f, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fp32_rate_chains() { return kChains; }

extern "C" const char* fp32_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
