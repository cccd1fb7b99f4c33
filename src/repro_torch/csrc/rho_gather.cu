// rho_self refresh: rho[b] = x_b . mu_{assign_b}, 0 when assign_b lies
// outside [0, K) (CUDA, sm_90a; kernels/rho_gather.py).
//
// Documents run in centroid order.  A counting sort by assignment (a
// histogram over K + 1 bins, bin K for every assignment outside [0, K), an
// exclusive scan, a scatter with per-bin cursors) lists them by centroid,
// and the gather runs one warp per listed document.  A block's warps and
// the neighbouring blocks then work on the same and adjacent centroids, so
// the 32-byte sector means_t[t, a & ~7 ..] of a term t that many of those
// documents hold is fetched from device memory about once for all of them,
// not once per document as in row order.  Which document of a bin a warp
// takes may change from run to run; each writes only out[b], so the result
// does not.  Documents outside [0, K) write 0 and read no means.
//
// Per document, one warp, the row's first nnz[b] slots: a slot adds the
// rounded product v * means_t[id, assign_b] when v != 0 and id lies in
// [0, D), and the products are summed in repro's float32 order over the
// row's padded width P (kernels/ref.py window_sum): level-1 windows of 32
// slots with half of P's padding to a multiple of 32 in front, each window
// summed in order from +0; when there are more than 32 windows, level-2
// windows of 32 windows padded the same way; then the last level's
// partials in order.  A slot past nnz, a dead slot and a padding slot add
// +0, which leaves a sum that never is -0 unchanged, so only the windows
// that hold a live slot are computed.  The warp loads 8 windows' slots
// (8 a lane, coalesced), gathers their means entries and stages the
// products in shared memory, one window a row padded to 33 floats (lane w
// then reads window w's slot o from bank (w + o) mod 32); 8 lanes sum a
// window each, and every lane folds the 8 partials into the level-2 and
// final sums in order by shuffles.  Rows up to 32 x 32 x 32 slots.
//
// A row of at most 32 slots is summed in repro's other order, that of XLA's
// vectorised CPU loop with each product contracted into its add
// (kernels/ref.py short_row_stages, short_row_sum): the warp stages the
// row's values and means entries, and lane 0 runs the stages (lanes
// accumulators, slot j to lane j mod lanes, folded by halving) and the
// remaining slots with __fmaf_rn.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kWin = 32;              // slots (or partials) in a window
constexpr int kGroup = 8;             // windows staged at a time
constexpr int kStride = kWin + 1;     // a staged window, padded
constexpr int kMaxWidth = kWin * kWin * kWin;

// The stages of a row of at most kWin slots: (lanes, slots) twice, a
// count of 0 for a stage that does not run.
struct ShortOrder {
  int lanes[2];
  int count[2];
};

ShortOrder short_order_of(int P, int K) {
  if (P <= 18 || (K == 1 && P <= 21)) return {{1, 1}, {0, 0}};
  if (P == 19) return {{8, 2}, {16, 2}};
  if (P <= 23) return {{4, 4}, {16, 4}};
  return {{8, 1}, {P / 8 * 8, 0}};
}

__device__ float short_row_sum(const float* v, const float* m, int P,
                               ShortOrder o) {
  float acc = 0.0f;
  int pos = 0;
  for (int s = 0; s < 2; ++s) {
    const int w = o.lanes[s], c = o.count[s];
    if (c == 0) continue;
    float lane[8];
    lane[0] = acc;
    for (int i = 1; i < 8; ++i) lane[i] = 0.0f;
    for (int j = 0; j < c; ++j)
      lane[j % w] = __fmaf_rn(v[pos + j], m[pos + j], lane[j % w]);
    for (int h = w / 2; h >= 1; h /= 2)
      for (int i = 0; i < h; ++i) lane[i] = __fadd_rn(lane[i], lane[i + h]);
    acc = lane[0];
    pos += c;
  }
  for (int j = pos; j < P; ++j) acc = __fmaf_rn(v[j], m[j], acc);
  return acc;
}

__device__ __forceinline__ int bin_of(int a, int K) {
  return static_cast<unsigned>(a) < static_cast<unsigned>(K) ? a : K;
}

__global__ void __launch_bounds__(kThreads)
rho_count_kernel(const int* __restrict__ assign, int B, int K,
                 int* __restrict__ bins) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b < B) atomicAdd(bins + bin_of(assign[b], K), 1);
}

// Exclusive scan of n counts in place, one block: each thread sums a
// contiguous run, the block scans the 1024 run sums, each thread writes
// its run's offsets.
__global__ void __launch_bounds__(kScanThreads)
rho_scan_kernel(int* __restrict__ bins, int n) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int start = min(tid * per, n), end = min(start + per, n);
  int sum = 0;
  for (int i = start; i < end; ++i) sum += bins[i];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sum[lane];
    int wi = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    warp_sum[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int i = start; i < end; ++i) {
    const int c = bins[i];
    bins[i] = run;
    run += c;
  }
}

__global__ void __launch_bounds__(kThreads)
rho_scatter_kernel(const int* __restrict__ assign, int B, int K,
                   int* __restrict__ bins, int* __restrict__ order) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b < B) order[atomicAdd(bins + bin_of(assign[b], K), 1)] = b;
}

__global__ void __launch_bounds__(kThreads)
rho_gather_kernel(const int* __restrict__ order,
                  const int* __restrict__ assign, const int* __restrict__ nnz,
                  const int* __restrict__ ids, const float* __restrict__ vals,
                  const float* __restrict__ means_t, int B, int P, int D,
                  int K, int lo1, int lo2, ShortOrder short_order,
                  float* __restrict__ out) {
  __shared__ float stage[kWarps][kGroup * kStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= B) return;  // the whole warp leaves together
  const int b = order[i];
  const int a = assign[b];
  float total = 0.0f;
  if (static_cast<unsigned>(a) < static_cast<unsigned>(K)) {
    const int n = min(max(nnz[b], 0), P);
    const size_t row = static_cast<size_t>(b) * P;
    const float* col = means_t + a;
    float* buf = stage[warp];
    if (P <= kWin) {
      const bool in = lane < n;
      const float v = in ? vals[row + lane] : 0.0f;
      const int id = in ? ids[row + lane] : 0;
      const bool live = v != 0.0f && id >= 0 && id < D;
      buf[lane] = live ? v : 0.0f;
      buf[kStride + lane] =
          live ? __ldg(col + static_cast<size_t>(id) * K) : 0.0f;
      __syncwarp();
      if (lane == 0)
        out[b] = short_row_sum(buf, buf + kStride, P, short_order);
      return;
    }
    // Level-1 windows 0 .. w_end-1 hold the live slots (slot p sits at
    // padded position p + lo1); window w is in level-2 window (w + lo2)/32.
    const int w_end = n > 0 ? (n - 1 + lo1) / kWin + 1 : 0;
    float group = 0.0f;
    int cur = 0;
    for (int w0 = 0; w0 < w_end; w0 += kGroup) {
      float v[kGroup];
      int id[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int p = (w0 + u) * kWin + lane - lo1;
        const bool in = p >= 0 && p < n;
        v[u] = in ? vals[row + p] : 0.0f;
        id[u] = in ? ids[row + p] : 0;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool live = v[u] != 0.0f && id[u] >= 0 && id[u] < D;
        const float m =
            live ? __ldg(col + static_cast<size_t>(id[u]) * K) : 0.0f;
        buf[u * kStride + lane] = live ? __fmul_rn(v[u], m) : 0.0f;
      }
      __syncwarp();
      float win = 0.0f;
      if (lane < kGroup) {
        const float* r = buf + lane * kStride;
#pragma unroll
        for (int o = 0; o < kWin; ++o) win = __fadd_rn(win, r[o]);
      }
      __syncwarp();  // the next round overwrites buf
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float part = __shfl_sync(0xffffffffu, win, u);
        const int w = w0 + u;
        if (w < w_end) {
          const int j = (w + lo2) / kWin;
          if (j != cur) {
            total = __fadd_rn(total, group);
            group = 0.0f;
            cur = j;
          }
          group = __fadd_rn(group, part);
        }
      }
    }
    total = __fadd_rn(total, group);
  }
  if (lane == 0) out[b] = total;
}

}  // namespace

// scratch: B + K + 1 int32 (the K + 1 bins, then the order), from the
// caller's allocator.  P at most kMaxWidth.
extern "C" int rho_gather_launch(const void* assign, const void* ids,
                                 const void* vals, const void* nnz,
                                 const void* means_t, int B, int P, int D,
                                 int K, void* scratch, void* out,
                                 void* stream) {
  if (B == 0) return 0;
  if (K < 0 || P < 0 || P > kMaxWidth || nnz == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // The window levels of a P-slot row: half the padding in front.
  const int nw1 = (P + kWin - 1) / kWin;
  const int lo1 = (nw1 * kWin - P) / 2;
  const int nw2 = (nw1 + kWin - 1) / kWin;
  const int lo2 = nw1 > kWin ? (nw2 * kWin - nw1) / 2 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bins = static_cast<int*>(scratch);
  int* order = bins + K + 1;
  const int* a = static_cast<const int*>(assign);
  cudaError_t err = cudaMemsetAsync(bins, 0, (K + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kThreads - 1) / kThreads;
  rho_count_kernel<<<blocks, kThreads, 0, s>>>(a, B, K, bins);
  rho_scan_kernel<<<1, kScanThreads, 0, s>>>(bins, K + 1);
  rho_scatter_kernel<<<blocks, kThreads, 0, s>>>(a, B, K, bins, order);
  rho_gather_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      order, a, static_cast<const int*>(nnz), static_cast<const int*>(ids),
      static_cast<const float*>(vals), static_cast<const float*>(means_t), B,
      P, D, K, lo1, lo2, short_order_of(P, K), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rho_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
