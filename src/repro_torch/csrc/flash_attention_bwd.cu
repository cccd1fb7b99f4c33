// Backward of banded-causal flash attention (CUDA, sm_90a;
// kernels/flash_attention.py).
//
//   q, dO (BH, Sq, hd), k, v (BH, Sk, hd), lse (BH, Sq) float32
//     -> dq (BH, Sq, hd), dk, dv (BH, Sk, hd) float32
//
// The gradient of the forward (flash_attention.cu) under its mask: key
// k_pos is live for query q_pos iff k_pos <= q_pos, q_pos - k_pos < window
// (window < 0: full causal) and k_pos < sk_real.  With s = q·kᵀ·scale and
// the forward's lse (+inf on a row with no live key), over the live pairs
//
//   P~ = exp(s - lse),  Z = rowsum(P~),  P = P~ / Z,  dP = dO·vᵀ
//   D = rowsum(P ∘ dP),  dS = P ∘ (dP - D)
//   dv = Pᵀ·dO,  dk = dSᵀ·q·scale,  dq = dS·k·scale
//
// and a pair that is not live adds nothing, so a row with no live key and
// a key at or past sk_real get zero gradient.  repro differentiates the
// jnp attention (models/layers.py:_attn_core) and has no backward Pallas
// kernel; this computes that function's gradient.  Z is 1 but for the
// rounding of the forward's lse (its running sum over up to S keys, ~1e-6
// of the row's mass at S 4096), and D equals rowsum(dO ∘ o); taken from
// the forward, either carries the forward's rounding into every P and dS
// of the row (dq then came out 2.7× autograd's own float32 error through
// the plain version).  Summed here from the same P~ and dP as dS (in
// double, each P~·dP exact there), they cancel as the softmax's own
// backward does: a row with one live key gets P = 1 and dS = 0 exactly.
//
// What bounds it.  10·hd operations a live pair (the two score products
// again, dv, dk, dq): at BH 8, S 4096, hd 256 full causal 1.72·10^11, 2.56
// ms in fp32 on the CUDA cores (67 TFLOP/s), 0.60 ms at window 512; the
// bytes (q, k, v, dO, lse read, dq, dk, dv written) take 0.08 ms.  So
// operations.  This first design runs them in fp32 on the CUDA cores
// (fused multiply-adds; no tensor cores, so no TF32 rounding to correct)
// and computes the scores and dP three times (twice in the query launch,
// whose first pass sums each row's Z and D, once in the key launch): 18·hd
// operations a live pair.
//
// Two launches, no atomics, so two runs give the same bits:
//   flash_bwd_q: a block per (bh, kB queries) walks the key tiles its rows
//     see twice: each row's Z and D into the scratch, then dq;
//   flash_bwd_kv: a block per (bh, kB keys) walks the query tiles of kB
//     rows that see any of its keys: dk and dv.
// Both skip the tiles the forward skips: wholly above the diagonal, wholly
// outside the window, at or past sk_real.  In a tile, thread (tq, tk)
// computes the 2 × 2 scores and dP of rows tq, tq + 16 and keys tk, tk + 16
// (float4 reads of rows hd + 4 floats apart: no bank conflict), writes
// its products to shared memory, and then each thread accumulates kRows
// rows × hd / kCG columns of its outputs (columns lane, lane + kCG, ...:
// no bank conflict).  A tile's sums run from zero and are added to the
// running ones once a tile, so no fp32 chain runs longer than kB + the
// tiles; the scores' and dP's dot products run in chunks of 32 dims; Z and
// D's sums run in double.
//
// Shared memory: four tiles of kB × (hd + 4) floats, two of kB × (kB +
// 4) and three rows of kB: 142,720 bytes at hd 256, one block an SM.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kB = 32;                 // rows of a tile (queries or keys)
constexpr int kThreads = 256;
constexpr int kSP = kB + 4;            // row stride of P and dS
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Tiles {
  static constexpr int kS = HD + 4;                  // row stride of a tile
  static constexpr int kCG = HD < 32 ? HD : 32;      // column lanes
  static constexpr int kCols = HD / kCG;             // columns a thread
  static constexpr int kRows = kB * kCG / kThreads;  // output rows a thread
  static constexpr size_t kBytes =
      sizeof(float) * (4 * kB * kS + 2 * kB * kSP + 3 * kB);
  static_assert(HD % 16 == 0 && HD <= 256, "hd must be a multiple of 16");
  static_assert(kRows * kThreads == kB * kCG, "thread layout");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Rows r0 .. r0 + kB - 1 of a (rows, HD) matrix into a tile of stride
// HD + 4, rows at or past n zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n) {
  constexpr int kC4 = HD / 4;
  for (int i = threadIdx.x; i < kB * kC4; i += kThreads) {
    const int r = i / kC4, c = i - r * kC4;
    const bool in = r0 + r < n;
    cp_async16(dst + r * Tiles<HD>::kS + 4 * c,
               in ? src + static_cast<size_t>(r0 + r) * HD + 4 * c : src, in);
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int Sq, int sk_real,
                                     int window) {
  return qp < Sq && kp < sk_real && kp <= qp &&
         (window < 0 || qp - kp < window);
}

// Thread (tq, tk) of the tile's scores: s[i][j] = q row tq + 16i · k row
// tk + 16j and dp[i][j] = dO row tq + 16i · v row tk + 16j.  Each runs as
// chains of fused multiply-adds over 32 dims from zero, added in order:
// a chain over all hd dims left about twice the rounding of autograd's
// float32 products through the plain version in dq at S 300, hd 256.
template <int HD>
__device__ __forceinline__ void scores(const float* sq, const float* sk,
                                       const float* sdo, const float* sv,
                                       int tq, int tk, float (&s)[2][2],
                                       float (&dp)[2][2]) {
  constexpr int kS = Tiles<HD>::kS;
  constexpr int kChunk = HD < 32 ? HD : 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < HD; d0 += kChunk) {
    float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float cd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int d = d0; d < d0 + kChunk; d += 4) {
      float4 a[2], b[2], x[2], y[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = *reinterpret_cast<const float4*>(sq + (tq + 16 * i) * kS + d);
        x[i] = *reinterpret_cast<const float4*>(sdo + (tq + 16 * i) * kS + d);
        b[i] = *reinterpret_cast<const float4*>(sk + (tk + 16 * i) * kS + d);
        y[i] = *reinterpret_cast<const float4*>(sv + (tk + 16 * i) * kS + d);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          cs[i][j] = fmaf(a[i].x, b[j].x, cs[i][j]);
          cs[i][j] = fmaf(a[i].y, b[j].y, cs[i][j]);
          cs[i][j] = fmaf(a[i].z, b[j].z, cs[i][j]);
          cs[i][j] = fmaf(a[i].w, b[j].w, cs[i][j]);
          cd[i][j] = fmaf(x[i].x, y[j].x, cd[i][j]);
          cd[i][j] = fmaf(x[i].y, y[j].y, cd[i][j]);
          cd[i][j] = fmaf(x[i].z, y[j].z, cd[i][j]);
          cd[i][j] = fmaf(x[i].w, y[j].w, cd[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] += cs[i][j];
        dp[i][j] += cd[i][j];
      }
  }
}

// dk, dv of keys k0 .. k0 + kB - 1 of row bh.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ zsum, float* __restrict__ dk,
             float* __restrict__ dv, int BH, int Sq,
             int Sk, int sk_real, int window, float scale) {
  using T = Tiles<HD>;
  constexpr int kS = T::kS, kCG = T::kCG, kCols = T::kCols,
                kRows = T::kRows;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + kB * kS;
  float* s_q = s_v + kB * kS;
  float* s_do = s_q + kB * kS;
  float* s_p = s_do + kB * kS;
  float* s_ds = s_p + kB * kSP;
  float* s_lse = s_ds + kB * kSP;
  float* s_d = s_lse + kB;
  float* s_z = s_d + kB;

  const int bh = blockIdx.x % BH;
  const int k0 = static_cast<int>(blockIdx.x / BH) * kB;
  const int tid = threadIdx.x;
  const int tq = tid / 16, tk = tid % 16;
  const int cg = tid % kCG, r0 = (tid / kCG) * kRows;
  const size_t qoff = static_cast<size_t>(bh) * Sq;
  const size_t koff = static_cast<size_t>(bh) * Sk;

  load_tile<HD>(s_k, k + koff * HD, k0, Sk);
  load_tile<HD>(s_v, v + koff * HD, k0, Sk);

  // Query rows that see a key of the tile: [q_lo, q_hi].
  const int k_last = min(k0 + kB, sk_real) - 1;
  const int q_lo = k0;
  const int q_hi = window >= 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int t_lo = q_lo / kB;
  const int t_hi = k_last >= k0 && q_hi >= q_lo ? q_hi / kB : t_lo - 1;

  float ak[kRows][kCols], av[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) ak[r][c] = av[r][c] = 0.f;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int q0 = tile * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(s_q, q + qoff * HD, q0, Sq);
    load_tile<HD>(s_do, dout + qoff * HD, q0, Sq);
    if (tid < kB) {
      const bool in = q0 + tid < Sq;
      s_lse[tid] = in ? lse[qoff + q0 + tid] : 0.f;
      s_d[tid] = in ? delta[qoff + q0 + tid] : 0.f;
      s_z[tid] = in ? zsum[qoff + q0 + tid] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float s[2][2], dp[2][2];
    scores<HD>(s_q, s_k, s_do, s_v, tq, tk, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = tq + 16 * i, kj = tk + 16 * j;
        const bool ok = live(q0 + qi, k0 + kj, Sq, sk_real, window);
        const float p =
            ok ? expf(s[i][j] * scale - s_lse[qi]) / s_z[qi] : 0.f;
        s_p[qi * kSP + kj] = p;
        s_ds[qi * kSP + kj] = p * (dp[i][j] - s_d[qi]);
      }
    __syncthreads();

    // dv[key][c] += Σ_q P[q][key] dO[q][c];  dk[key][c] += Σ_q dS[q][key] q[q][c]
    float pk[kRows][kCols], pv[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pk[r][c] = pv[r][c] = 0.f;
#pragma unroll 2
    for (int qi = 0; qi < kB; ++qi) {
      float x[kCols], y[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        x[c] = s_do[qi * kS + cg + kCG * c];
        y[c] = s_q[qi * kS + cg + kCG * c];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = s_p[qi * kSP + r0 + r];
        const float ds = s_ds[qi * kSP + r0 + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          pv[r][c] = fmaf(p, x[c], pv[r][c]);
          pk[r][c] = fmaf(ds, y[c], pk[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        av[r][c] += pv[r][c];
        ak[r][c] += pk[r][c];
      }
  }

  cp_async_wait_all();  // a block with no tile never waited for its copies
  for (int r = 0; r < kRows; ++r) {
    const int kp = k0 + r0 + r;
    if (kp >= Sk) continue;
    float* dkr = dk + (koff + kp) * HD;
    float* dvr = dv + (koff + kp) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkr[cg + kCG * c] = ak[r][c] * scale;
      dvr[cg + kCG * c] = av[r][c];
    }
  }
}

// dq of queries q0 .. q0 + kB - 1 of row bh, and each row's D and Z for
// flash_bwd_kv.  Two passes over the row's key tiles: the first sums, in
// double, Z = Σ P~ and D~ = Σ P~·dP (P~ = exp(s - lse); each product P~·dP
// exact in double); then D = D~ / Z, and the second pass forms dS = (P~ /
// Z)·(dP - D) pair by pair and dq = Σ dS·k·scale.  A row with one live key
// gets P = 1, D = dP and dS = 0 exactly, as the softmax's own backward.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_q(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ dq,
            float* __restrict__ delta, float* __restrict__ zsum, int BH,
            int Sq, int Sk, int sk_real, int window, float scale) {
  using T = Tiles<HD>;
  constexpr int kS = T::kS, kCG = T::kCG, kCols = T::kCols,
                kRows = T::kRows;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = s_q + kB * kS;
  float* s_k = s_do + kB * kS;
  float* s_v = s_k + kB * kS;
  float* s_ds = s_v + kB * kS;     // dS of the tile
  float* s_lse = s_ds + 2 * kB * kSP;
  float* s_d = s_lse + kB;
  float* s_z = s_d + kB;

  const int bh = blockIdx.x % BH;
  const int n_qt = (Sq + kB - 1) / kB;
  // The tiles of most keys first, so the long causal rows start early.
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kB;
  const int tid = threadIdx.x;
  const int tq = tid / 16, tk = tid % 16;
  const int cg = tid % kCG, r0 = (tid / kCG) * kRows;
  const size_t qoff = static_cast<size_t>(bh) * Sq;
  const size_t koff = static_cast<size_t>(bh) * Sk;

  load_tile<HD>(s_q, q + qoff * HD, q0, Sq);
  load_tile<HD>(s_do, dout + qoff * HD, q0, Sq);
  if (tid < kB) s_lse[tid] = q0 + tid < Sq ? lse[qoff + q0 + tid] : 0.f;

  // Keys any row of the tile sees: [k_lo, k_hi].
  const int q_last = min(q0 + kB, Sq) - 1;
  const int k_hi = min(q_last, sk_real - 1);
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kB;
  const int t_hi = k_hi >= k_lo ? k_hi / kB : t_lo - 1;

  // Pass 1: Z and D~ of rows tq, tq + 16 over this thread's keys.
  double z[2] = {0.0, 0.0}, dd[2] = {0.0, 0.0};
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kB;
    __syncthreads();
    load_tile<HD>(s_k, k + koff * HD, k0, Sk);
    load_tile<HD>(s_v, v + koff * HD, k0, Sk);
    cp_async_wait_all();
    __syncthreads();
    float s[2][2], dp[2][2];
    scores<HD>(s_q, s_k, s_do, s_v, tq, tk, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = tq + 16 * i, kj = tk + 16 * j;
        if (!live(q0 + qi, k0 + kj, Sq, sk_real, window)) continue;
        const float p = expf(s[i][j] * scale - s_lse[qi]);
        z[i] += p;
        dd[i] += static_cast<double>(p) * static_cast<double>(dp[i][j]);
      }
  }
  // The 16 threads of a row are lanes 0-15 or 16-31 of a warp: a fixed
  // shuffle tree, then through shared memory.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) {
      z[i] += __shfl_xor_sync(kFull, z[i], m);
      dd[i] += __shfl_xor_sync(kFull, dd[i], m);
    }
    const int qi = tq + 16 * i;
    const float d = z[i] > 0.0 ? static_cast<float>(dd[i] / z[i]) : 0.f;
    if (tk == 0) {
      s_z[qi] = static_cast<float>(z[i]);
      s_d[qi] = d;
      if (q0 + qi < Sq) {
        delta[qoff + q0 + qi] = d;
        zsum[qoff + q0 + qi] = static_cast<float>(z[i]);
      }
    }
  }

  // Pass 2: dq[query][c] = Σ_key dS[query][key] k[key][c]·scale.
  float aq[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) aq[r][c] = 0.f;
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kB;
    __syncthreads();  // the previous tile's readers (and s_z, s_d) are done
    load_tile<HD>(s_k, k + koff * HD, k0, Sk);
    load_tile<HD>(s_v, v + koff * HD, k0, Sk);
    cp_async_wait_all();
    __syncthreads();
    float s[2][2], dp[2][2];
    scores<HD>(s_q, s_k, s_do, s_v, tq, tk, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = tq + 16 * i, kj = tk + 16 * j;
        const bool ok = live(q0 + qi, k0 + kj, Sq, sk_real, window);
        const float p =
            ok ? expf(s[i][j] * scale - s_lse[qi]) / s_z[qi] : 0.f;
        s_ds[qi * kSP + kj] = p * (dp[i][j] - s_d[qi]);
      }
    __syncthreads();
    float pq[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pq[r][c] = 0.f;
#pragma unroll 2
    for (int kj = 0; kj < kB; ++kj) {
      float y[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) y[c] = s_k[kj * kS + cg + kCG * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ds = s_ds[(r0 + r) * kSP + kj];
#pragma unroll
        for (int c = 0; c < kCols; ++c) pq[r][c] = fmaf(ds, y[c], pq[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) aq[r][c] += pq[r][c];
  }

  cp_async_wait_all();  // a block with no tile never waited for its copies
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Sq) continue;
    float* dqr = dq + (qoff + qp) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqr[cg + kCG * c] = aq[r][c] * scale;
  }
}

template <int HD>
cudaError_t configure() {
  const int bytes = static_cast<int>(Tiles<HD>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        flash_bwd_q<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* scratch,
           int BH, int Sq, int Sk, int sk_real, int window, float scale,
           cudaStream_t stream) {
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* delta = scratch;
  float* zsum = scratch + static_cast<size_t>(BH) * Sq;
  const long long kv_blocks = static_cast<long long>((Sk + kB - 1) / kB) * BH;
  const long long q_blocks = static_cast<long long>((Sq + kB - 1) / kB) * BH;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = Tiles<HD>::kBytes;
  flash_bwd_q<HD><<<static_cast<unsigned>(q_blocks), kThreads, bytes,
                    stream>>>(q, k, v, dout, lse, dq, delta, zsum, BH, Sq,
                              Sk, sk_real, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_kv<HD><<<static_cast<unsigned>(kv_blocks), kThreads, bytes,
                     stream>>>(q, k, v, dout, lse, delta, zsum, dk, dv, BH,
                               Sq, Sk, sk_real, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int resources(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = configure<HD>();
  *smem_bytes = static_cast<int>(Tiles<HD>::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_bwd_kv<HD>, kThreads, Tiles<HD>::kBytes);
  return static_cast<int>(err);
}

}  // namespace

// scratch: 2·BH·Sq float32 (each row's D and Z, written by the
// query launch for the key launch).  Returns cudaGetLastError() after the
// two launches (or the first that failed).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* scratch, int BH,
    int Sq, int Sk, int hd, int sk_real, int window, float scale,
    void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || sk_real < 0 || sk_real > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(H)                                                     \
  case H:                                                                     \
    return launch<H>(                                                         \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), static_cast<const float*>(lse),         \
        static_cast<const float*>(dout), static_cast<float*>(dq),             \
        static_cast<float*>(dk), static_cast<float*>(dv),                     \
        static_cast<float*>(scratch), BH, Sq, Sk, sk_real, window, scale, s);
  switch (hd) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

// Dynamic shared bytes and blocks an SM of flash_bwd_kv at head dim hd
// (flash_bwd_q takes the same shared memory).
extern "C" int flash_attention_bwd_resources(int hd, int* smem_bytes,
                                             int* blocks_per_sm) {
  switch (hd) {
    case 16: return resources<16>(smem_bytes, blocks_per_sm);
    case 32: return resources<32>(smem_bytes, blocks_per_sm);
    case 64: return resources<64>(smem_bytes, blocks_per_sm);
    case 128: return resources<128>(smem_bytes, blocks_per_sm);
    case 256: return resources<256>(smem_bytes, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
