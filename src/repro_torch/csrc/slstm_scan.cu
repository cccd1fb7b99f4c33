// sLSTM scan over time: the exponentially gated scalar LSTM of an xLSTM
// sLSTM layer (CUDA, sm_90a; kernels/slstm_scan.py).
//
// gates (B, S, 4D) float32 hold z | i | f | o along the last axis; the
// state (c, n, m) starts from c0, n0, m0 (B, D).  Per step, as the plain
// version (kernels/ref.py:slstm_scan) writes it:
//
//   m' = max(f + m, i)
//   c  = exp(f + m - m')·c + exp(i - m')·tanh(z)
//   n  = exp(f + m - m')·n + exp(i - m')
//   h  = (1 / (1 + exp(-o)))·c / max(n, 1)
//
// One thread per (b, d) channel walks t = 0..S-1 with its state in
// registers; a block is one warp of 32 consecutive channels of one row b,
// so each gate load and each h store is one coalesced 128-byte line.  The
// gates of the next kStep steps are loaded while the current kStep steps
// compute (two register buffers), so a load's latency does not add to the
// recurrence's.  Every product, sum, difference and quotient is a rounded
// intrinsic (no contracted multiply-add) and exp/tanh are expf/tanhf, the
// functions torch's CUDA ops call, so the kernel repeats the plain version
// on the card operation for operation.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kStep = 16;

__device__ __forceinline__ void load_steps(const float* __restrict__ g,
                                           size_t row_stride, int t0, int S,
                                           int D, float (&buf)[kStep][4]) {
#pragma unroll
  for (int u = 0; u < kStep; ++u) {
    if (t0 + u < S) {
      const float* p = g + static_cast<size_t>(t0 + u) * row_stride;
#pragma unroll
      for (int q = 0; q < 4; ++q) buf[u][q] = p[static_cast<size_t>(q) * D];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
slstm_scan_kernel(const float* __restrict__ gates,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, int S, int D,
                  float* __restrict__ hs, float* __restrict__ c_out,
                  float* __restrict__ n_out, float* __restrict__ m_out) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row_stride = static_cast<size_t>(4) * D;
  const float* g = gates + static_cast<size_t>(b) * S * row_stride + d;
  float* h = hs + static_cast<size_t>(b) * S * D + d;
  const size_t s_idx = static_cast<size_t>(b) * D + d;
  float c = c0[s_idx], n = n0[s_idx], m = m0[s_idx];

  float cur[kStep][4], nxt[kStep][4];
  load_steps(g, row_stride, 0, S, D, cur);
  for (int t0 = 0; t0 < S; t0 += kStep) {
    if (t0 + kStep < S) load_steps(g, row_stride, t0 + kStep, S, D, nxt);
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      if (t0 + u < S) {
        const float z = cur[u][0], i = cur[u][1], f = cur[u][2],
                    o = cur[u][3];
        const float fm = __fadd_rn(f, m);
        const float m_new = fmaxf(fm, i);
        const float i_e = expf(__fsub_rn(i, m_new));
        const float f_e = expf(__fsub_rn(fm, m_new));
        c = __fadd_rn(__fmul_rn(f_e, c), __fmul_rn(i_e, tanhf(z)));
        n = __fadd_rn(__fmul_rn(f_e, n), i_e);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o)));
        h[static_cast<size_t>(t0 + u) * D] =
            __fdiv_rn(__fmul_rn(sig, c), fmaxf(n, 1.0f));
        m = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[u][q] = nxt[u][q];
  }
  c_out[s_idx] = c;
  n_out[s_idx] = n;
  m_out[s_idx] = m;
}

}  // namespace

extern "C" int slstm_scan_launch(const void* gates, const void* c0,
                                 const void* n0, const void* m0, int B, int S,
                                 int D, void* hs, void* c, void* n, void* m,
                                 void* stream) {
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  slstm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0), S, D,
      static_cast<float*>(hs), static_cast<float*>(c), static_cast<float*>(n),
      static_cast<float*>(m));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
