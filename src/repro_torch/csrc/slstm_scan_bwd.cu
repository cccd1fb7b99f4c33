// Backward of the sLSTM scan over time (CUDA, sm_90a;
// kernels/slstm_scan.py).
//
//   gates (B, S, 4D) z | i | f | o, the initial state c0, n0, m0 (B, D),
//   the output's adjoints dhs (B, S, D) and the final state's dc, dn, dm
//   (B, D), all float32
//     -> dgates (B, S, 4D), dc0, dn0, dm0 (B, D) float32
//
// The forward step (slstm_scan.cu, kernels/ref.py:slstm_scan) and, per
// step in reverse, its adjoints as the plain version
// (kernels/ref.py:slstm_scan_bwd) writes them, with w(a, b) = 1 if a > b,
// 1/2 if a == b, else 0 (JAX's rule for max, which repro differentiates):
//
//   fm = f + m;  m' = max(fm, i);  ie = exp(i - m');  fe = exp(fm - m')
//   u = tanh(z);  c' = fe·c + ie·u;  n' = fe·n + ie
//   sig = 1 / (1 + exp(-o));  den = max(n', 1);  h = sig·c' / den
//
//   gq = gh / den;  go = (gq·c')·sig·(1 - sig)
//   gc' += gq·sig;  gn' -= (gq·h)·w(n', 1)
//   gfe = gc'·c + gn'·n;  gie = gc'·u + gn';  gu = gc'·ie
//   gz = (gu + gu·u)·(1 - u);  ga = gfe·fe;  gb = gie·ie
//   gm' = gm' - ga - gb
//   gi = gb + gm'·w(i, fm);  gf = gm = ga + gm'·w(fm, i)
//   gc = gc'·fe;  gn = gn'·fe
//
// The n' == 1 tie is at step 0 of every prefill (from c = n = 0, m =
// -1e30: m' = i, n' = exp(0) = 1), so the half weight matters.
//
// One thread a (b, d) channel, a block one warp of 32 channels of a row:
// the walk of slstm_scan.cu's short scans, run twice.  First forward,
// writing the state after every step to the scratch (c, n, m planes of
// B·S·D floats: 12·B·S·D bytes), then backward in time, reading each step's
// gates, adjoint and the state before it (the state after it is the
// previous iteration's).  Neither pass's loads depend on its chains, so
// they are issued kAhead (forward) or kBack (backward) steps before their
// use, into registers (the scratch, which this kernel writes and then
// reads, is no __restrict__ pointer: no read of it may take the read-only
// path).  Every product, sum, difference and quotient is a
// rounded intrinsic (no contracted multiply-add) and exp/tanh are
// expf/tanhf, in the plain version's order, so the two agree bit for bit
// on the card.
//
// What bounds it.  Its bytes: gates and dhs read, dgates written, 36·B·S·D
// (226 MB at B 2, S 4096, D 768: 0.068 ms at 3.35 TB/s); the state's
// round trip through the scratch doubles the bytes moved.  But each
// thread walks 2·S dependent steps, each some 60 instructions of latency,
// on B·D / 32 warps (48 at xlstm-125m): the latency of the chains, not
// the bytes, sets its time.  It is the simple design, slow by that.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Steps whose loads are in flight ahead of the arithmetic: the forward
// pass's gates, the backward pass's gates, adjoint and state before the
// step (none of them depends on the carried chains).
constexpr int kAhead = 16;
constexpr int kBack = 8;

__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// z, i, f of steps t0 .. t0 + kAhead - 1 (those below S).
__device__ __forceinline__ void load_fwd(const float* __restrict__ g,
                                         size_t row, int D, int t0, int S,
                                         float (&buf)[kAhead][3]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (t0 + u < S) {
      const float* gt = g + static_cast<size_t>(t0 + u) * row;
#pragma unroll
      for (int q = 0; q < 3; ++q) buf[u][q] = gt[static_cast<size_t>(q) * D];
    }
}

// Step t = base - u (u < kBack, t >= 0): its gates z, i, f, o, its hs
// adjoint and the state (c, n, m) before it.
struct Back {
  float x[kBack][8];
};

__device__ __forceinline__ void load_back(
    const float* __restrict__ g, const float* __restrict__ gh,
    const float* cs, const float* ns, const float* ms, float c0, float n0,
    float m0, size_t row,
    int D, int base, Back& buf) {
#pragma unroll
  for (int u = 0; u < kBack; ++u) {
    const int t = base - u;
    if (t < 0) continue;
    const float* gt = g + static_cast<size_t>(t) * row;
#pragma unroll
    for (int q = 0; q < 4; ++q) buf.x[u][q] = gt[static_cast<size_t>(q) * D];
    buf.x[u][4] = gh[static_cast<size_t>(t) * D];
    if (t > 0) {
      const size_t at = static_cast<size_t>(t - 1) * D;
      buf.x[u][5] = cs[at];
      buf.x[u][6] = ns[at];
      buf.x[u][7] = ms[at];
    } else {
      buf.x[u][5] = c0;
      buf.x[u][6] = n0;
      buf.x[u][7] = m0;
    }
  }
}

__global__ void __launch_bounds__(32)
slstm_bwd_kernel(const float* __restrict__ gates,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0, const float* __restrict__ dhs,
                 const float* __restrict__ dc, const float* __restrict__ dn,
                 const float* __restrict__ dm, int B, int S, int D,
                 float* states, float* __restrict__ dgates,
                 float* __restrict__ dc0, float* __restrict__ dn0,
                 float* __restrict__ dm0) {
  const int d = blockIdx.x * 32 + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = static_cast<size_t>(4) * D;
  const size_t plane = static_cast<size_t>(B) * S * D;
  const float* g = gates + static_cast<size_t>(b) * S * row + d;
  float* dg = dgates + static_cast<size_t>(b) * S * row + d;
  const float* gh = dhs + static_cast<size_t>(b) * S * D + d;
  float* cs = states + static_cast<size_t>(b) * S * D + d;
  float* ns = cs + plane;
  float* ms = ns + plane;
  const size_t s_idx = static_cast<size_t>(b) * D + d;
  const float c_0 = c0[s_idx], n_0 = n0[s_idx], m_0 = m0[s_idx];

  // Forward again: the state after every step.
  float c = c_0, n = n_0, m = m_0;
  float cur[kAhead][3], nxt[kAhead][3];
  load_fwd(g, row, D, 0, S, cur);
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    if (t0 + kAhead < S) load_fwd(g, row, D, t0 + kAhead, S, nxt);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < S) {
        const float z = cur[u][0], i = cur[u][1], f = cur[u][2];
        const float fm = __fadd_rn(f, m);
        m = fmaxf(fm, i);
        const float ie = expf(__fsub_rn(i, m));
        const float fe = expf(__fsub_rn(fm, m));
        c = __fadd_rn(__fmul_rn(fe, c), __fmul_rn(ie, tanhf(z)));
        n = __fadd_rn(__fmul_rn(fe, n), ie);
        const size_t at = static_cast<size_t>(t0 + u) * D;
        cs[at] = c;
        ns[at] = n;
        ms[at] = m;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int q = 0; q < 3; ++q) cur[u][q] = nxt[u][q];
  }

  // Backward in time; (c1, n1, m1) the state after step t.
  float gc = dc[s_idx], gn = dn[s_idx], gm = dm[s_idx];
  float c1 = c, n1 = n, m1 = m;
  Back bc, bn;
  load_back(g, gh, cs, ns, ms, c_0, n_0, m_0, row, D, S - 1, bc);
  for (int base = S - 1; base >= 0; base -= kBack) {
    if (base - kBack >= 0)
      load_back(g, gh, cs, ns, ms, c_0, n_0, m_0, row, D, base - kBack, bn);
#pragma unroll
    for (int u = 0; u < kBack; ++u) {
      const int t = base - u;
      if (t < 0) continue;
      const float z = bc.x[u][0], i = bc.x[u][1], f = bc.x[u][2],
                  o = bc.x[u][3], ght = bc.x[u][4], cp = bc.x[u][5],
                  np = bc.x[u][6], mp = bc.x[u][7];
      const float fm = __fadd_rn(f, mp);
      const float ie = expf(__fsub_rn(i, m1));
      const float fe = expf(__fsub_rn(fm, m1));
      const float uz = tanhf(z);
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-o)));
      const float den = fmaxf(n1, 1.0f);
      const float h = __fdiv_rn(__fmul_rn(sig, c1), den);

      const float gq = __fdiv_rn(ght, den);
      const float go = __fmul_rn(__fmul_rn(__fmul_rn(gq, c1), sig),
                                 __fsub_rn(1.0f, sig));
      const float gc1 = __fadd_rn(gc, __fmul_rn(gq, sig));
      const float gn1 = __fsub_rn(gn, __fmul_rn(__fmul_rn(gq, h),
                                                wmax(n1, 1.0f)));
      const float gfe = __fadd_rn(__fmul_rn(gc1, cp), __fmul_rn(gn1, np));
      const float gie = __fadd_rn(__fmul_rn(gc1, uz), gn1);
      const float gu = __fmul_rn(gc1, ie);
      const float gz = __fmul_rn(__fadd_rn(gu, __fmul_rn(gu, uz)),
                                 __fsub_rn(1.0f, uz));
      const float ga = __fmul_rn(gfe, fe);
      const float gb = __fmul_rn(gie, ie);
      const float gm1 = __fsub_rn(__fsub_rn(gm, ga), gb);
      const float gi = __fadd_rn(gb, __fmul_rn(gm1, wmax(i, fm)));
      const float gfm = __fadd_rn(ga, __fmul_rn(gm1, wmax(fm, i)));

      float* dgt = dg + static_cast<size_t>(t) * row;
      dgt[0] = gz;
      dgt[D] = gi;
      dgt[2 * D] = gfm;
      dgt[3 * D] = go;
      gc = __fmul_rn(gc1, fe);
      gn = __fmul_rn(gn1, fe);
      gm = gfm;
      c1 = cp;
      n1 = np;
      m1 = mp;
    }
    bc = bn;
  }
  dc0[s_idx] = gc;
  dn0[s_idx] = gn;
  dm0[s_idx] = gm;
}

}  // namespace

// states: 3·B·S·D float32 scratch.
extern "C" int slstm_scan_bwd_launch(const void* gates, const void* c0,
                                     const void* n0, const void* m0,
                                     const void* dhs, const void* dc,
                                     const void* dn, const void* dm, int B,
                                     int S, int D, void* states, void* dgates,
                                     void* dc0, void* dn0, void* dm0,
                                     void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  slstm_bwd_kernel<<<dim3((D + 31) / 32, B), 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gates), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<const float*>(dhs), static_cast<const float*>(dc),
      static_cast<const float*>(dn), static_cast<const float*>(dm), B, S, D,
      static_cast<float*>(states), static_cast<float*>(dgates),
      static_cast<float*>(dc0), static_cast<float*>(dn0),
      static_cast<float*>(dm0));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slstm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
