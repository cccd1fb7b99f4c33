// Routed scan of a two-level model: per document, the exact similarities
// to the fine centroids of its probed coarse cells, and their first maximum
// (CUDA, sm_90a; kernels/routed_scan.py).
//
// Candidate j of document b is probe rank r = j / cmax, slot s = j mod
// cmax: the centroid column starts[c] + s of cell c = cells[b, r] when
// s < sizes[c], else a dead slot whose similarity is -inf.  No sentinel
// column exists in means_t; the dead slots read nothing.
//
// One block per document, one thread per candidate (the block strides over
// the J = n_probe * cmax candidates 256 at a time).  The document's first
// nnz[b] slots are staged in shared memory, 512 at a time, and every
// thread walks them in ascending slot order: a slot with v != 0 adds the
// rounded product v * means_t[id, col] with a rounded add, from +0 (a slot
// with v = 0 would add a zero).  That is the flat sparse_sim's order and
// arithmetic for that column, so the winning similarity equals the flat
// classify's bit for bit.  The consecutive slots of one cell are
// consecutive columns of a means_t row, so a warp's reads of one term
// coalesce.
//
// The argmax keeps the first maximum in j order (probe rank major, then
// slot), jnp.argmax's rule: a thread takes its candidates in ascending j
// and replaces its best only on a strictly larger value, and the block's
// reduction keeps the lower j among equal values.  assign is the winner's
// global fine id, best its similarity, scored K_c + the probed cells' sizes.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;  // document slots staged at a time

// (v2, j2) ranks before (v1, j1): a larger value, or the lower candidate
// among equal values.
__device__ __forceinline__ bool before(float v2, int j2, float v1, int j1) {
  return v2 > v1 || (v2 == v1 && j2 < j1);
}

__global__ void __launch_bounds__(kThreads)
routed_scan_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                   const int* __restrict__ nnz,
                   const float* __restrict__ means_t,
                   const int* __restrict__ cells,
                   const int* __restrict__ starts,
                   const int* __restrict__ sizes, int P, int K, int n_probe,
                   int cmax, int k_c, int* __restrict__ assign,
                   float* __restrict__ best, int* __restrict__ scored) {
  __shared__ int s_id[kTile];
  __shared__ float s_v[kTile];
  __shared__ float w_v[kWarps];
  __shared__ int w_j[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = min(max(nnz[b], 0), P);
  const int J = n_probe * cmax;
  const size_t row = static_cast<size_t>(b) * P;
  const int* my_cells = cells + static_cast<size_t>(b) * n_probe;
  float top_v = -INFINITY;
  int top_j = INT_MAX;
  for (int j0 = 0; j0 < J; j0 += kThreads) {
    const int j = j0 + tid;
    int col = -1;
    if (j < J) {
      const int r = j / cmax, s = j - r * cmax;
      const int c = my_cells[r];
      if (s < sizes[c]) col = starts[c] + s;
    }
    float acc = 0.0f;
    for (int p0 = 0; p0 < n; p0 += kTile) {
      const int m = min(kTile, n - p0);
      __syncthreads();  // the previous tile's readers are done
      for (int q = tid; q < m; q += kThreads) {
        s_id[q] = ids[row + p0 + q];
        s_v[q] = vals[row + p0 + q];
      }
      __syncthreads();
      if (col >= 0) {
        const float* mc = means_t + col;
        for (int q = 0; q < m; ++q) {
          const float v = s_v[q];
          if (v != 0.0f)
            acc = __fadd_rn(
                acc, __fmul_rn(v, __ldg(mc + static_cast<size_t>(s_id[q]) *
                                                 K)));
        }
      }
    }
    const float sim = col >= 0 ? acc : -INFINITY;
    if (j < J && before(sim, j, top_v, top_j)) {
      top_v = sim;
      top_j = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, top_v, off);
    const int j = __shfl_down_sync(0xffffffffu, top_j, off);
    if (before(v, j, top_v, top_j)) {
      top_v = v;
      top_j = j;
    }
  }
  if ((tid & 31) == 0) {
    w_v[tid >> 5] = top_v;
    w_j[tid >> 5] = top_j;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (before(w_v[w], w_j[w], top_v, top_j)) {
        top_v = w_v[w];
        top_j = w_j[w];
      }
    const int r = top_j / cmax;
    assign[b] = starts[my_cells[r]] + (top_j - r * cmax);
    best[b] = top_v;
    int total = k_c;
    for (int q = 0; q < n_probe; ++q) total += sizes[my_cells[q]];
    scored[b] = total;
  }
}

}  // namespace

extern "C" int routed_scan_launch(const void* ids, const void* vals,
                                  const void* nnz, const void* means_t,
                                  const void* cells, const void* starts,
                                  const void* sizes, int B, int P, int K,
                                  int n_probe, int cmax, int k_c,
                                  void* assign, void* best, void* scored,
                                  void* stream) {
  if (B == 0) return 0;
  if (P < 0 || K < 1 || n_probe < 1 || cmax < 1 || k_c < 1 ||
      static_cast<long long>(n_probe) * cmax > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  routed_scan_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(vals),
      static_cast<const int*>(nnz), static_cast<const float*>(means_t),
      static_cast<const int*>(cells), static_cast<const int*>(starts),
      static_cast<const int*>(sizes), P, K, n_probe, cmax, k_c,
      static_cast<int*>(assign), static_cast<float*>(best),
      static_cast<int*>(scored));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* routed_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
