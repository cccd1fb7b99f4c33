// Block-vector sketch kernels (CUDA, sm_90a; kernels/sketch_sim.py).
//
//   sketch_sim   (B, S) doc sketches x (S, K) mean sketches -> (B, K), S <= 64
//   doc_sketch   (B, P) tuples -> (B, S) per-group L2 norms
//
// sketch_sim: persistent blocks, one per SM, each walking 128-document x
// 128-column output tiles (tile t, t + gridDim.x, ...).  A tile's operands
// are the doc sketches of its 128 rows (row-major, as in device memory) and
// the (S, 128) slab of the mean sketches, 64 KB at S 64; cp.async copies
// them into shared memory, double-buffered, so the next tile's copy runs
// under this tile's arithmetic and a block waits on memory only for its
// first tile.  Thread (ty, tx) of 16 x 16 keeps an 8 x 8 register
// micro-tile, rows {4ty..4ty+3, 64+4ty..64+4ty+3} x columns {4tx..4tx+3,
// 64+4tx..64+4tx+3}.  Per group of 4 s it reads its 8 rows' x as 16-byte
// loads (two distinct addresses per warp: broadcasts) and per s its 8
// m-values as two 16-byte loads (256 contiguous bytes per warp), against
// 128 FP32 instructions per s: the FP32 pipe, not shared memory, sets the
// pace.  Output stores: each warp instruction writes 2 rows x 256
// contiguous bytes (whole 128-byte lines).
//
// Order and rounding: every output adds its rounded products in s order,
// starting from +0, with __fmul_rn/__fadd_rn (no fused multiply-add, no
// TF32, no tensor cores): the order and rounding of the plain version in
// kernels/ref.py, so the two agree bit for bit.  Zero skip: a warp leaves
// out an s whose x is 0 in all 16 of its rows, decided once per tile from
// shared memory, so all its lanes take the same branch; a warp with at most
// an eighth of its s dead adds them all in a loop with no branch in it.
// Leaving out or adding a zero x is exact when the mean sketches are finite
// (0·m is then ±0, and adding ±0 to an accumulator that started at +0
// changes no bit: round-to-nearest never makes it -0).  Sketches are group norms or 0/1 counts, finite and >= 0.
// It pays on the Region-3 tail sketch of bounds-esicp, zero below t_th.
// S or K not a multiple of 4, or an unaligned operand, take plain loads
// into the same layout (S padded to a multiple of 4 with zeros).
//
// doc_sketch: one warp per document.  Lane l owns slots l and l + 32.  The
// warp reads the row's tuples 32 at a time (one coalesced load per lane) and
// broadcasts them by shuffle in p order; the lane whose slot is
// clip(id / g, 0, S-1) adds v*v.  Dead slots (v = 0) add nothing.  No
// atomics, so the sums are in p order on every run, as in the plain version.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxS = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// sketch_sim: 128 x 128 output tiles, 16 x 16 threads of 8 x 8 outputs.
constexpr int kTile = 128;
constexpr int kHalf = kTile / 2;
constexpr int kSide = 16;

// Shared memory of one tile's operands, S rounded up to a multiple of 4.
__host__ __device__ constexpr size_t stage_bytes(int S) {
  return 2 * static_cast<size_t>((S + 3) & ~3) * kTile * sizeof(float);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Stage tile t: x rows b0.. as [128][S4], the m slab as [S4][128]; rows
// past B, columns past K and s past S are zero.  One cp.async group.
__device__ void stage_tile(const float* __restrict__ x,
                           const float* __restrict__ m, int B, int S, int K,
                           bool vec, int n_col, int t, float* dst) {
  const int S4 = (S + 3) & ~3;
  const int b0 = (t / n_col) * kTile, k0 = (t % n_col) * kTile;
  float* dx = dst;
  float* dm = dst + kTile * S4;
  const int tid = threadIdx.x;
  if (vec) {  // S4 == S: whole 16-byte chunks of x rows and m rows
    const int per_row = S >> 2;
    for (int i = tid; i < kTile * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) << 2;
      const bool ok = b0 + r < B;
      cp_async16(dx + r * S4 + c,
                 ok ? x + static_cast<size_t>(b0 + r) * S + c : x, ok);
    }
    for (int i = tid; i < S * (kTile / 4); i += kThreads) {
      const int s = i >> 5, c = (i & 31) << 2;
      const bool ok = k0 + c < K;
      cp_async16(dm + s * kTile + c,
                 ok ? m + static_cast<size_t>(s) * K + k0 + c : m, ok);
    }
  } else {
    for (int i = tid; i < kTile * S4; i += kThreads) {
      const int r = i / S4, s = i - r * S4;
      dx[i] = s < S && b0 + r < B ? x[static_cast<size_t>(b0 + r) * S + s]
                                  : 0.0f;
    }
    for (int i = tid; i < S4 * kTile; i += kThreads) {
      const int s = i >> 7, k = k0 + (i & (kTile - 1));
      dm[i] = s < S && k < K ? m[static_cast<size_t>(s) * K + k] : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc += x[:, s0 + Q] m[s0 + Q, :] for this thread's 8 x 8 outputs; xv
// holds its rows' x at s0..s0+3, mr points at m[s0, 4tx] in shared memory.
template <int Q>
__device__ __forceinline__ void add_s(float (&acc)[8][8],
                                      const float4 (&xv)[8],
                                      const float* mr) {
  const float4 ma = *reinterpret_cast<const float4*>(mr + Q * kTile);
  const float4 mb = *reinterpret_cast<const float4*>(mr + Q * kTile + kHalf);
  const float mv[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xq = Q == 0 ? xv[i].x : Q == 1 ? xv[i].y
                   : Q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xq, mv[j]));
  }
}

// The s0..s0+3 of nib (bit q: s0 + q) for this thread's outputs; x is
// read once for the group.  kAll: all four, with no branch between them.
template <bool kAll>
__device__ __forceinline__ void add_group(float (&acc)[8][8],
                                          const float* xs, const float* ms,
                                          const int (&rows)[8], int S4,
                                          int tx, int s0, unsigned nib) {
  float4 xv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    xv[i] = *reinterpret_cast<const float4*>(xs + rows[i] * S4 + s0);
  const float* mr = ms + s0 * kTile + 4 * tx;
  if (kAll || nib == 15u) {
    add_s<0>(acc, xv, mr);
    add_s<1>(acc, xv, mr);
    add_s<2>(acc, xv, mr);
    add_s<3>(acc, xv, mr);
  } else {
    if (nib & 1u) add_s<0>(acc, xv, mr);
    if (nib & 2u) add_s<1>(acc, xv, mr);
    if (nib & 4u) add_s<2>(acc, xv, mr);
    if (nib & 8u) add_s<3>(acc, xv, mr);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sketch_sim_kernel(const float* __restrict__ x, const float* __restrict__ m,
                  int B, int S, int K, bool vec, bool out_vec, int n_col,
                  int n_tiles, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int S4 = (S + 3) & ~3;
  const int G = S4 >> 2;  // groups of 4 s
  const int stage_floats = 2 * kTile * S4;
  float* const buf = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid % kSide, ty = tid / kSide;
  int rows[8];  // this thread's 8 rows within a tile
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = (i < 4 ? 0 : kHalf - 4) + 4 * ty + i;

  int t = blockIdx.x;
  stage_tile(x, m, B, S, K, vec, n_col, t, buf);
  for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
    const float* xs = buf + (it & 1) * stage_floats;
    const float* ms = xs + kTile * S4;
    const int next = t + gridDim.x;
    if (next < n_tiles) {
      stage_tile(x, m, B, S, K, vec, n_col, next,
                 buf + ((it + 1) & 1) * stage_floats);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tile's operands are in shared memory

    // The s with a nonzero x in any of this warp's 16 rows (2 x 32 bits).
    unsigned live_lo = 0, live_hi = 0;
    for (int c = lane; c < 16 * G; c += 32) {
      const int ri = c / G, g = c - ri * G;
      const int r = (ri < 8 ? 0 : kHalf - 8) + 8 * warp + ri;
      const float4 v = *reinterpret_cast<const float4*>(xs + r * S4 + 4 * g);
      const unsigned nib = (v.x != 0.0f) | (v.y != 0.0f) << 1 |
                           (v.z != 0.0f) << 2 | (v.w != 0.0f) << 3;
      if (g < 8) live_lo |= nib << (4 * g);
      else live_hi |= nib << (4 * g - 32);
    }
    live_lo = __reduce_or_sync(kFull, live_lo);
    live_hi = __reduce_or_sync(kFull, live_hi);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    // At most an eighth of the s dead (the usual gate): adding their ±0
    // products costs less than branching around them, so a loop with no
    // branch in its body runs over every s.
    const int dead = 4 * G - __popc(live_lo) - __popc(live_hi);
    const bool dense = 8 * dead <= 4 * G;
    if (dense) {
      for (int g = 0; g < G; ++g)
        add_group<true>(acc, xs, ms, rows, S4, tx, 4 * g, 15u);
    } else {
      for (int g = 0; g < G; ++g) {
        const unsigned nib =
            (g < 8 ? live_lo >> (4 * g) : live_hi >> (4 * g - 32)) & 15u;
        if (nib) add_group<false>(acc, xs, ms, rows, S4, tx, 4 * g, nib);
      }
    }

    const int b0 = (t / n_col) * kTile, k0 = (t % n_col) * kTile;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = b0 + rows[i];
      if (b >= B) continue;
      float* orow = out + static_cast<size_t>(b) * K;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + h * kHalf + 4 * tx;
        if (out_vec) {
          if (k < K)
            *reinterpret_cast<float4*>(orow + k) = make_float4(
                acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k + j < K) orow[k + j] = acc[i][4 * h + j];
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
}

__global__ void __launch_bounds__(kThreads)
doc_sketch_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                  int B, int P, int g, int S, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const size_t row = static_cast<size_t>(b) * P;
  float a0 = 0.0f, a1 = 0.0f;
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    const int my_id = p < P ? ids[row + p] : 0;
    const float my_v = p < P ? vals[row + p] : 0.0f;
    const int n = min(32, P - p0);
    for (int j = 0; j < n; ++j) {
      const int id = __shfl_sync(0xffffffffu, my_id, j);
      const float v = __shfl_sync(0xffffffffu, my_v, j);
      if (v == 0.0f) continue;  // dead slot: the same for every lane
      const int slot = min(max(id / g, 0), S - 1);
      const float sq = __fmul_rn(v, v);
      if (slot == lane) a0 = __fadd_rn(a0, sq);
      if (slot == lane + 32) a1 = __fadd_rn(a1, sq);
    }
  }
  const size_t o = static_cast<size_t>(b) * S;
  if (lane < S) out[o + lane] = __fsqrt_rn(a0);
  if (lane + 32 < S) out[o + lane + 32] = __fsqrt_rn(a1);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int sketch_max_rows() { return 0x7fffffff - kTile; }

extern "C" int sketch_sim_launch(const void* x, const void* m, int B, int S,
                                 int K, void* out, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  // The SM count and the shared-memory opt-in, once per device.
  static int sms_of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sketch_sim_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(2 * stage_bytes(kMaxS)));
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const bool out_vec = (K & 3) == 0 && aligned16(out);
  const bool vec = (S & 3) == 0 && out_vec && aligned16(x) && aligned16(m);
  const int n_col = (K + kTile - 1) / kTile;
  const long long n_tiles =
      static_cast<long long>((B + kTile - 1) / kTile) * n_col;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const int blocks = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  sketch_sim_kernel<<<blocks, kThreads, 2 * stage_bytes(S),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m), B, S, K,
      vec, out_vec, n_col, static_cast<int>(n_tiles),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int doc_sketch_launch(const void* ids, const void* vals, int B,
                                 int P, int g, int S, void* out,
                                 void* stream) {
  if (S < 1 || S > kMaxS || g < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  doc_sketch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(vals), B, P, g,
      S, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
