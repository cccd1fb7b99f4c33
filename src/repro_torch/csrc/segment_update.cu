// Update-step cluster sums, term-major (CUDA, sm_90a;
// kernels/segment_update.py).
//
//   lam_t[d, k] = sum over the postings (row, v) of term d with
//                 assign[row] = k, in (row, slot) order, from +0
//
// Input: the corpus's term-major layout (SparseDocs.by_term, built once
// by sparse/matrix.py:term_major): ptr (D+1,) int64, rows (nnz,)
// int32, vals (nnz,) float32, each term's postings in (row, slot) order,
// dead slots dropped, and order (D,) int32, the terms by posting count,
// longest first.  One block per (term, column tile), the longest posting
// lists first.  A block holds its tile of the K-float row of lam_t in
// shared memory (40 KB at K 10,000), zeroes it, walks the term's postings
// 512 at a time and then writes the whole tile to lam_t, zeros included,
// with 16-byte stores: lam_t is written exactly once and never zero-filled
// by anyone else, and nothing is sorted per call.  A term with no posting
// writes zeros straight from registers.
//
// Order, which decides the bits: each warp owns a contiguous eighth of the
// tile's columns and reads every staged posting, 32 at a time.  Among the
// 32, __match_any_sync groups the lanes that hit the same column; the
// lowest lane of each group reads the column once, adds its peers' values
// in lane order (= posting order) and stores once; __syncwarp() orders one
// batch of 32 after the previous.  So every lam_t[d, k] adds its tuples in
// (row, slot) order from +0, as the CPU's sequential index_add_ does, with
// no atomics: the same bits on every run and as the plain version.
// Duplicate ids within a row are consecutive postings of one term and add
// in slot order.  Assignments outside [0, K) match no column.
//
// Column tiles: K above kMaxCols floats (43 KB) splits into equal tiles
// (multiples of 4 columns), one block each; the shared row stays within
// the 48 KB default, five blocks per SM.
//
// What bounds it: bytes.  lam_t (D·K·4, 19.8 GB at the NYT widths) is
// written once; the postings (nnz · 8 bytes), ptr, order and the gathered
// assignments are read once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;                  // postings per thread per pass
constexpr int kChunk = kPer * kThreads;  // postings staged per pass
constexpr int kMaxCols = 11008;          // 43 KB of shared row per block
constexpr unsigned kFull = 0xffffffffu;

__device__ void store_row(float* __restrict__ out, const float* src, int nc,
                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    float4* o = reinterpret_cast<float4*>(out);
    const float4* s = reinterpret_cast<const float4*>(src);
    for (int i = tid; i < (nc >> 2); i += kThreads)
      o[i] = src ? s[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int i = tid; i < nc; i += kThreads) out[i] = src ? src[i] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
term_row_kernel(const long long* __restrict__ ptr,
                const int* __restrict__ rows, const float* __restrict__ vals,
                const int* __restrict__ order,
                const int* __restrict__ assign, int K, int kc, int n_tiles,
                bool vec, float* __restrict__ lam_t) {
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);  // the tile's columns
  __shared__ int s_col[kChunk];
  __shared__ float s_val[kChunk];
  const long long blk = blockIdx.x;
  const int d = order[blk / n_tiles];
  const int c0 = static_cast<int>(blk % n_tiles) * kc;
  const int nc = min(kc, K - c0);
  float* out = lam_t + static_cast<size_t>(d) * K + c0;
  const long long p0 = ptr[d], p1 = ptr[d + 1];
  const int tid = threadIdx.x;
  if (p0 == p1) {  // an unused term: the whole block leaves together
    store_row(out, nullptr, nc, vec);
    return;
  }
  for (int i = tid; i < ((nc + 3) >> 2); i += kThreads)
    smem[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int lane = tid & 31, warp = tid >> 5;
  const int span = (nc + kWarps - 1) / kWarps;
  const int lo = warp * span, hi = min(lo + span, nc);
  // A two-deep pipeline: while chunk c is summed, the assignments of
  // chunk c + 1 and the postings of chunk c + 2 are in flight, so a long
  // posting list waits on memory about once, not once per chunk.
  int a_cur[kPer], r_nxt[kPer], a_nxt[kPer], r_far[kPer];
  float v_cur[kPer], v_nxt[kPer], v_far[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const long long i = p0 + tid + q * kThreads, i2 = i + kChunk;
    const int r = i < p1 ? rows[i] : -1;
    v_cur[q] = i < p1 ? vals[i] : 0.0f;
    r_nxt[q] = i2 < p1 ? rows[i2] : -1;
    v_nxt[q] = i2 < p1 ? vals[i2] : 0.0f;
    a_cur[q] = r >= 0 ? assign[r] : -1;
  }
  for (long long base = p0; base < p1; base += kChunk) {
    const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                       p1 - base));
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = tid + q * kThreads;
      if (j < n) {
        const int a = a_cur[q];
        s_col[j] = (a >= c0 && a < c0 + nc) ? a - c0 : -1;
        s_val[j] = v_cur[q];
      }
      const long long i = base + 2 * kChunk + j;
      a_nxt[q] = r_nxt[q] >= 0 ? assign[r_nxt[q]] : -1;
      r_far[q] = i < p1 ? rows[i] : -1;
      v_far[q] = i < p1 ? vals[i] : 0.0f;
    }
    __syncthreads();  // the chunk is staged (and, first time, acc zeroed)
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const int c = j < n ? s_col[j] : -1;
      const bool mine = c >= lo && c < hi;
      const unsigned peers = __match_any_sync(kFull, mine ? c : -1);
      if (mine && lane == __ffs(peers) - 1) {
        float a = acc[c];
        for (unsigned p = peers; p; p &= p - 1)
          a = __fadd_rn(a, s_val[j0 + __ffs(p) - 1]);
        acc[c] = a;
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with the chunk
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      a_cur[q] = a_nxt[q];
      v_cur[q] = v_nxt[q];
      r_nxt[q] = r_far[q];
      v_nxt[q] = v_far[q];
    }
  }
  store_row(out, acc, nc, vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int segment_update_launch(const void* ptr, const void* rows,
                                     const void* vals, const void* order,
                                     const void* assign, int D, int K,
                                     void* lam_t, void* stream) {
  if (D < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = (K + kMaxCols - 1) / kMaxCols;
  const int kc = ((K + n_tiles - 1) / n_tiles + 3) & ~3;
  n_tiles = (K + kc - 1) / kc;
  const long long blocks = static_cast<long long>(D) * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (K & 3) == 0 && aligned16(lam_t);
  const size_t bytes = static_cast<size_t>((kc + 3) & ~3) * sizeof(float);
  term_row_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ptr), static_cast<const int*>(rows),
      static_cast<const float*>(vals), static_cast<const int*>(order),
      static_cast<const int*>(assign), K, kc, n_tiles, vec,
      static_cast<float*>(lam_t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
