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
// doc_sketch: a block of 128 threads takes 16 consecutive documents (their
// tuples are one contiguous range) with 8 threads per document; thread
// (r, q) owns the slots [q*w, (q+1)*w) of document r, w = ceil(S/8).  The
// rows are walked in chunks of 128 slots, copied into shared memory by
// cp.async two chunks deep, so the next chunk's copy runs under this one's
// work.  A warp converts four of the chunk's rows: each tuple's slot is
// computed once, clip(id / g, 0, S-1) with a multiply-high reciprocal of g
// (exact for every id < 2^31; kernels/sketch_sim.py:group_reciprocal), and
// stored with v*v in place, slot -1 for a dead tuple (v = 0).  Each thread
// then walks its document's chunk in p order up to the row's last live
// tuple, eight tuples read at a time: the running sum of the own slot it
// touched last stays in a register and trades places with shared memory
// when another own slot comes up, and a tuple of no own slot adds +0,
// which changes no bit.  So each slot adds its rounded squares in p order
// from +0, as the plain version does, whatever the order of the ids, with
// no branch on the data and no atomics in a sum.  The block's (16, S)
// output rows are contiguous and are stored whole from shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxS = 64;
constexpr int kThreads = 256;
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

// doc_sketch: documents per block, threads per document, slots per chunk,
// slots a thread owns at most.
constexpr int kDsThreads = 128;
constexpr int kDsRows = 16;
constexpr int kDsSplit = kDsThreads / kDsRows;
constexpr int kDsChunk = 128;
constexpr int kDsWarps = kDsThreads / 32;
constexpr int kDsOwn = kMaxS / kDsSplit;
constexpr int kDsAhead = 8;  // staged tuples a thread reads at once
// Odd (no bank conflict), with room for the columns read past the last.
constexpr int kDsStride = kDsChunk + kDsAhead - 1;
static_assert(kDsChunk == kDsThreads, "a thread copies one column a row");

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Copy columns p0.. of the block's rows into dst as (id, v) pairs, zeros
// past P and past B; one cp.async group.
__device__ __forceinline__ void ds_copy(const int* __restrict__ ids,
                                        const float* __restrict__ vals,
                                        int b0, int rows, int P, int p0,
                                        int2 (*dst)[kDsStride]) {
  const int p = p0 + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int i = 0; i < kDsRows; ++i) {
    const bool ok = i < rows && p < P;
    const size_t o = ok ? static_cast<size_t>(b0 + i) * P + p : 0;
    cp_async4(&dst[i][threadIdx.x].x, ids + o, ok);
    cp_async4(&dst[i][threadIdx.x].y, vals + o, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kDsThreads)
doc_sketch_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                  int B, int P, unsigned magic, int shift, int S,
                  float* __restrict__ out) {
  // Two chunks of (id, v), converted in place to (slot, bits of v*v).
  __shared__ int2 stage[2][kDsRows][kDsStride];
  __shared__ int last[kDsRows];  // the row's last live column in the chunk
  __shared__ float sums[kDsOwn][kDsThreads];  // a thread's own slots
  __shared__ float sketch[kDsRows][kMaxS + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kDsRows;
  const int rows = min(kDsRows, B - b0);
  const int r = tid % kDsRows, q = tid / kDsRows;
  const int own = (S + kDsSplit - 1) / kDsSplit;
  const int lo = q * own;
  const unsigned cnt = static_cast<unsigned>(max(0, min(own, S - lo)));
#pragma unroll
  for (int k = 0; k < kDsOwn; ++k) sums[k][tid] = 0.0f;
  // The sum of own slot lo + cur, kept in a register while tuples of that
  // slot come; sums[k][tid] holds the others.
  int cur = 0;
  float run = 0.0f;
  // The columns past the chunk hold dead tuples (no slot) for good.
  for (int i = tid; i < 2 * kDsRows * (kDsAhead - 1); i += kDsThreads) {
    const int row = i / (kDsAhead - 1);
    stage[row / kDsRows][row % kDsRows][kDsChunk + i % (kDsAhead - 1)] =
        make_int2(-1, 0);
  }

  const int chunks = (P + kDsChunk - 1) / kDsChunk;
  if (chunks > 0) ds_copy(ids, vals, b0, rows, P, 0, stage[0]);
  for (int c = 0; c < chunks; ++c) {
    int2 (*st)[kDsStride] = stage[c & 1];
    if (c + 1 < chunks) {  // the next chunk's copy runs under this one
      ds_copy(ids, vals, b0, rows, P, (c + 1) * kDsChunk, stage[(c + 1) & 1]);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c is in shared memory
    // Warp w converts rows w, w + 4, ..., four columns a lane.
#pragma unroll
    for (int ii = 0; ii < kDsRows / kDsWarps; ++ii) {
      const int i = ii * kDsWarps + warp;
      int seen = -1;
#pragma unroll
      for (int u = 0; u < kDsChunk / 32; ++u) {
        const int j = u * 32 + lane;
        const int2 t = st[i][j];
        const float v = __int_as_float(t.y);
        const int g_of = static_cast<int>(
            (static_cast<unsigned long long>(static_cast<unsigned>(t.x)) *
             magic) >> shift);
        int slot = min(g_of, S - 1);
        slot = t.x <= 0 ? 0 : slot;
        slot = v == 0.0f ? -1 : slot;
        st[i][j] = make_int2(slot, __float_as_int(__fmul_rn(v, v)));
        seen = slot >= 0 ? j : seen;
      }
      seen = __reduce_max_sync(kFull, seen);
      if (lane == 0) last[i] = seen;
    }
    __syncthreads();
    const int n = last[r];
    // A tuple of another own slot parks the running sum and takes that
    // slot's (read before the park: it is another address); tuples of no
    // own slot add +0, which changes no bit (sums start at +0 and add
    // squares, so none is ever -0).  No branch on the data.
    for (int j0 = 0; j0 <= n; j0 += kDsAhead) {
      int2 t[kDsAhead];  // read before this group parks anything
#pragma unroll
      for (int u = 0; u < kDsAhead; ++u) t[u] = st[r][j0 + u];
#pragma unroll
      for (int u = 0; u < kDsAhead; ++u) {
        const unsigned k_of = static_cast<unsigned>(t[u].x - lo);
        const bool mine = k_of < cnt;  // past n: dead, no slot
        const int k = mine ? static_cast<int>(k_of) : cur;
        const float parked = sums[k][tid];
        if (k != cur) sums[cur][tid] = run;
        run = k != cur ? parked : run;
        cur = k;
        run = __fadd_rn(run, mine ? __int_as_float(t[u].y) : 0.0f);
      }
    }
    __syncthreads();  // every thread is done with this chunk's buffer
  }
  sums[cur][tid] = run;
#pragma unroll
  for (int k = 0; k < kDsOwn; ++k)
    if (static_cast<unsigned>(k) < cnt)
      sketch[r][lo + k] = __fsqrt_rn(sums[k][tid]);
  __syncthreads();
  float* o = out + static_cast<size_t>(b0) * S;
  for (int i = tid; i < rows * S; i += kDsThreads) {
    const int rr = i / S;
    o[i] = sketch[rr][i - rr * S];
  }
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

// magic, shift: group_reciprocal(g) of kernels/sketch_sim.py, so that
// (id * magic) >> shift == id / g for 0 <= id < 2^31.
extern "C" int doc_sketch_launch(const void* ids, const void* vals, int B,
                                 int P, unsigned magic, int shift, int S,
                                 void* out, void* stream) {
  if (S < 1 || S > kMaxS || shift < 0 || shift > 63)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int blocks = (B + kDsRows - 1) / kDsRows;
  doc_sketch_kernel<<<blocks, kDsThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(vals), B, P,
      magic, shift, S, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
