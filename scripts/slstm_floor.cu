// The sLSTM scan's chain floor (scripts/slstm_probe.py): only the carried
// chains of csrc/slstm_scan.cu, rounded as there,
//
//   m = max(f + m, i);  c = f_e·c + u;  n = f_e·n + i_e,
//
// over S steps for `groups` blocks of one warp, a lane a channel.  The
// operands come from registers (kU values an operand a lane, loaded once
// and reused every kU steps), so no load, store or other arithmetic lies
// beside the chain: its time is the least that any design keeping the
// plain loop's sequential rounded order can take.
#include <cuda_runtime.h>

namespace {

constexpr int kU = 8;

__global__ void __launch_bounds__(32)
chain_floor_kernel(const float* __restrict__ seed, int S,
                   float* __restrict__ out) {
  const int lane = threadIdx.x;
  float f[kU], i[kU], e[kU], u[kU], ie[kU];
#pragma unroll
  for (int s = 0; s < kU; ++s) {
    f[s] = seed[(0 * kU + s) * 32 + lane];
    i[s] = seed[(1 * kU + s) * 32 + lane];
    e[s] = seed[(2 * kU + s) * 32 + lane];
    u[s] = seed[(3 * kU + s) * 32 + lane];
    ie[s] = seed[(4 * kU + s) * 32 + lane];
  }
  float m = -1e30f, c = 0.0f, n = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kU) {
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      m = fmaxf(__fadd_rn(f[s], m), i[s]);
      c = __fadd_rn(__fmul_rn(e[s], c), u[s]);
      n = __fadd_rn(__fmul_rn(e[s], n), ie[s]);
    }
  }
  float* o = out + 3 * (blockIdx.x * 32 + lane);
  o[0] = m;
  o[1] = c;
  o[2] = n;
}

}  // namespace

// seed: 5·kU·32 floats (f, i, f_e, u, i_e); out: 3·32·groups floats.
extern "C" int slstm_floor_launch(const void* seed, int groups, int S,
                                  void* out, void* stream) {
  chain_floor_kernel<<<groups, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), S, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slstm_floor_unroll() { return kU; }
