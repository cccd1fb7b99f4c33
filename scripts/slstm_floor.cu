// The sLSTM scan's chain floors (scripts/slstm_probe.py): only the carried
// chains of csrc/slstm_scan.cu, rounded as there,
//
//   m = max(f + m, i);  c = f_e·c + u;  n = f_e·n + i_e,
//
// and those of the backward's adjoints (csrc/slstm_scan_bwd.cu), either
// chain A's pair or chain B's,
//
//   gc' = gc + a;  gn' = gn - b;  gc = gc'·f_e;  gn = gn'·f_e
//   gm' = (gm - ga) - gb;  gm = ga + gm'·w,
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

// The adjoints' chains: chain A (gc, gn) when pair, else chain B (gm).
__global__ void __launch_bounds__(32)
adjoint_floor_kernel(const float* __restrict__ seed, int S, int pair,
                     float* __restrict__ out) {
  const int lane = threadIdx.x;
  float a[kU], b[kU], e[kU];
#pragma unroll
  for (int s = 0; s < kU; ++s) {
    a[s] = seed[(0 * kU + s) * 32 + lane];
    b[s] = seed[(1 * kU + s) * 32 + lane];
    e[s] = seed[(2 * kU + s) * 32 + lane];
  }
  float* o = out + 2 * (blockIdx.x * 32 + lane);
  if (pair) {
    float gc = 0.0f, gn = 0.0f;
    for (int t0 = 0; t0 < S; t0 += kU) {
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        const float gc1 = __fadd_rn(gc, a[s]), gn1 = __fsub_rn(gn, b[s]);
        gc = __fmul_rn(gc1, e[s]);
        gn = __fmul_rn(gn1, e[s]);
      }
    }
    o[0] = gc;
    o[1] = gn;
  } else {
    float gm = 0.0f;
    for (int t0 = 0; t0 < S; t0 += kU) {
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        const float gm1 = __fsub_rn(__fsub_rn(gm, a[s]), b[s]);
        gm = __fadd_rn(a[s], __fmul_rn(gm1, e[s]));
      }
    }
    o[0] = gm;
    o[1] = 0.0f;
  }
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

// seed: 3·kU·32 floats (chain A: gq·sig, (gq·h)·w, f_e; chain B: ga, gb,
// w); out: 2·32·groups floats.
extern "C" int slstm_adjoint_floor_launch(const void* seed, int groups,
                                          int S, int pair, void* out,
                                          void* stream) {
  adjoint_floor_kernel<<<groups, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), S, pair, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
