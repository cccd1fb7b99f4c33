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
// Accumulating launch (segment_update_accumulate_launch, the streaming
// fit's chunks after the first): lam_t already holds the earlier chunks'
// sums and is updated in place; a term with no posting in the chunk is not
// touched.  A term whose chunk postings number more than an eighth of the
// tile's columns goes to term_row_kernel<true>, which loads the tile from
// lam_t instead of zeroing it: its postings touch most of the row, so a
// whole-row read and write moves fewer bytes than cell by cell.  Every
// other term (most of them: ≈ 17 postings a term in a 32,768-document
// chunk at the NYT widths) goes to term_warp_kernel, one warp a term and
// no shared tile: 32 postings at a time, the lowest lane of each column's
// group reads lam_t[d, c] from global memory, adds its peers' values in
// lane order and writes the cell back; __syncwarp() orders one batch's
// stores before the next batch's loads.  The long terms are a prefix of
// `order` (longest first), so the tile kernel's grid is bounded by
// n_postings over the threshold, and the warp kernel's by the touched
// terms.  Either way every lam_t[d, k] adds the chunk's tuples in (row,
// slot) order onto the earlier chunks' sum, so chunk after chunk equals
// one launch over the whole corpus bit for bit.
//
// Column tiles: K above kMaxCols floats (43 KB) splits into equal tiles
// (multiples of 4 columns), one block each; the shared row stays within
// the 48 KB default, five blocks per SM.
//
// What bounds it: bytes.  lam_t (D·K·4, 19.8 GB at the NYT widths) is
// written once; the postings (nnz · 8 bytes), ptr, order and the gathered
// assignments are read once.  The accumulating launch reads the postings
// and reads and writes each (term, cluster) cell they touch.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;                  // postings per thread per pass
constexpr int kChunk = kPer * kThreads;  // postings staged per pass
constexpr int kMaxCols = 11008;          // 43 KB of shared row per block
constexpr unsigned kFull = 0xffffffffu;

__device__ void load_row(float4* smem, const float* __restrict__ src, int nc,
                         bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const float4* s = reinterpret_cast<const float4*>(src);
    for (int i = tid; i < (nc >> 2); i += kThreads) smem[i] = s[i];
  } else {
    float* acc = reinterpret_cast<float*>(smem);
    for (int i = tid; i < nc; i += kThreads) acc[i] = src[i];
  }
}

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

// A term with more postings than this goes to the tile kernel in the
// accumulating launch; the others to term_warp_kernel.
__host__ __device__ inline long long long_list_min(int kc) {
  return kc / 8 + 1;
}

// kAccumulate is a template argument so that the one-call launch compiles
// to the kernel it was before the accumulating one existed (its registers
// and its time).
template <bool kAccumulate>
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
  if (kAccumulate && p1 - p0 < long_list_min(kc)) return;  // the warp's
  if (p0 == p1) {  // an unused term: the whole block leaves together
    store_row(out, nullptr, nc, vec);
    return;
  }
  if (kAccumulate) {
    load_row(smem, out, nc, vec);
  } else {
    for (int i = tid; i < ((nc + 3) >> 2); i += kThreads)
      smem[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

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
    __syncthreads();  // the chunk is staged (and, first time, acc set)
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

// The accumulating launch's short terms: warp w of block b takes term
// order[8b + w] when it has postings, fewer than long_list_min(kc).
__global__ void __launch_bounds__(kThreads)
term_warp_kernel(const long long* __restrict__ ptr,
                 const int* __restrict__ rows, const float* __restrict__ vals,
                 const int* __restrict__ order,
                 const int* __restrict__ assign, int K, int kc,
                 long long n_terms, float* lam_t) {
  __shared__ float s_val[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (t >= n_terms) return;
  const int d = order[t];
  const long long p0 = ptr[d], p1 = ptr[d + 1];
  if (p0 == p1 || p1 - p0 >= long_list_min(kc)) return;
  float* row = lam_t + static_cast<size_t>(d) * K;
  for (long long base = p0; base < p1; base += 32) {
    const long long i = base + lane;
    int c = -1;
    float v = 0.0f;
    if (i < p1) {
      const int a = assign[rows[i]];
      c = (a >= 0 && a < K) ? a : -1;
      v = vals[i];
    }
    s_val[warp][lane] = v;
    const unsigned peers = __match_any_sync(kFull, c);
    __syncwarp();  // the batch's values are staged
    if (c >= 0 && lane == __ffs(peers) - 1) {
      float a = row[c];
      for (unsigned p = peers; p; p &= p - 1)
        a = __fadd_rn(a, s_val[warp][__ffs(p) - 1]);
      row[c] = a;
    }
    __syncwarp();  // its stores land before the next batch's loads
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

struct Tiles {
  int n_tiles, kc;
};

Tiles column_tiles(int K) {
  int n_tiles = (K + kMaxCols - 1) / kMaxCols;
  const int kc = ((K + n_tiles - 1) / n_tiles + 3) & ~3;
  return {(K + kc - 1) / kc, kc};
}

template <bool kAccumulate>
cudaError_t launch_rows(const void* ptr, const void* rows, const void* vals,
                        const void* order, const void* assign, long long terms,
                        int K, Tiles t, void* lam_t, cudaStream_t stream) {
  const long long blocks = terms * t.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const bool vec = (K & 3) == 0 && aligned16(lam_t);
  const size_t bytes = static_cast<size_t>((t.kc + 3) & ~3) * sizeof(float);
  term_row_kernel<kAccumulate><<<static_cast<unsigned>(blocks), kThreads,
                                  bytes, stream>>>(
      static_cast<const long long*>(ptr), static_cast<const int*>(rows),
      static_cast<const float*>(vals), static_cast<const int*>(order),
      static_cast<const int*>(assign), K, t.kc, t.n_tiles, vec,
      static_cast<float*>(lam_t));
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_update_launch(const void* ptr, const void* rows,
                                     const void* vals, const void* order,
                                     const void* assign, int D, int K,
                                     void* lam_t, void* stream) {
  if (D < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rows<false>(
      ptr, rows, vals, order, assign, D, K, column_tiles(K), lam_t,
      static_cast<cudaStream_t>(stream)));
}

// n_postings: the layout's posting count (rows' length), which bounds both
// grids without a read of the device.
extern "C" int segment_update_accumulate_launch(
    const void* ptr, const void* rows, const void* vals, const void* order,
    const void* assign, int D, int K, long long n_postings, void* lam_t,
    void* stream) {
  if (D < 1 || K < 1 || n_postings < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiles t = column_tiles(K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_long = std::min(static_cast<long long>(D),
                                    n_postings / long_list_min(t.kc));
  cudaError_t rc = launch_rows<true>(ptr, rows, vals, order, assign, n_long,
                                     K, t, lam_t, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long n_terms = std::min(static_cast<long long>(D), n_postings);
  const long long blocks = (n_terms + kWarps - 1) / kWarps;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  term_warp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const long long*>(ptr), static_cast<const int*>(rows),
      static_cast<const float*>(vals), static_cast<const int*>(order),
      static_cast<const int*>(assign), K, t.kc, n_terms,
      static_cast<float*>(lam_t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
